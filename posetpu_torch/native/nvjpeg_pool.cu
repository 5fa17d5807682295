// nvjpeg_pool: the card's JPEG decode for the port's loader, a plain C
// interface over nvJPEG for ctypes (posetpu_torch/native/nvjpeg.py).
//
// nvJPEG does what libjpeg's entropy decode and IDCT do in the host pool
// (posetpu/native/decode_pool.cpp): it writes a file's component planes, at
// their stored (subsampled) sizes, into device buffers the caller owns
// (NVJPEG_OUTPUT_YUV).  The upsampling, color conversion, crop and pad that
// follow in libjpeg and in the pool are the ycc_canvas kernel's
// (native/kernels/ycc_canvas.cu).
//
// One decoder: one nvJPEG handle on the default backend (the Huffman decode
// on the calling host thread, the IDCT on the card) and one nvjpegJpegState.
// A state serves one decode at a time: the caller serialises calls, and each
// call waits for its file's work on the card (nvj_decode).
//
// Status codes: 0 success, > 0 an nvjpegStatus_t, < 0 minus a cudaError_t.
//
// Build (nvjpeg.py, through utils/cuda_build.py):
//   nvcc <NVCC_FLAGS> -o <lib> nvjpeg_pool.cu -L<cuda>/lib64 -lnvjpeg

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Decoder {
  int device = 0;
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

// Upsampling factors (h, v) of the chroma components for the subsamplings
// libjpeg's fancy upsampler covers; (0, 0) for the others (4:1:1, 4:1:0,
// unknown), which the caller refuses.
void chroma_factors(nvjpegChromaSubsampling_t css, int* hf, int* vf) {
  *hf = *vf = 0;
  switch (css) {
    case NVJPEG_CSS_444:
    case NVJPEG_CSS_GRAY:
      *hf = 1; *vf = 1; break;
    case NVJPEG_CSS_422:
      *hf = 2; *vf = 1; break;
    case NVJPEG_CSS_440:
      *hf = 1; *vf = 2; break;
    case NVJPEG_CSS_420:
      *hf = 2; *vf = 2; break;
    default:
      break;
  }
}

}  // namespace

extern "C" {

void* nvj_create(int device, int* status) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) {
    *status = -static_cast<int>(e);
    return nullptr;
  }
  auto* d = new Decoder();
  d->device = device;
  nvjpegStatus_t s = nvjpegCreateSimple(&d->handle);
  if (s == NVJPEG_STATUS_SUCCESS) s = nvjpegJpegStateCreate(d->handle, &d->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (d->handle) nvjpegDestroy(d->handle);
    delete d;
    *status = static_cast<int>(s);
    return nullptr;
  }
  *status = 0;
  return d;
}

void nvj_destroy(void* ptr) {
  auto* d = static_cast<Decoder*>(ptr);
  if (!d) return;
  cudaSetDevice(d->device);
  if (d->state) nvjpegJpegStateDestroy(d->state);
  if (d->handle) nvjpegDestroy(d->handle);
  delete d;
}

// info (11 ints): components, the chroma's upsampling factors (h, v), the
// subsampling as nvJPEG names it, then nvJPEG's widths[0..2] and
// heights[0..2] of the components.
int nvj_info(void* ptr, const unsigned char* data, size_t length, int* info) {
  auto* d = static_cast<Decoder*>(ptr);
  int nc = 0;
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegStatus_t s = nvjpegGetImageInfo(d->handle, data, length, &nc, &css, widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  info[0] = nc;
  chroma_factors(css, &info[1], &info[2]);
  info[3] = static_cast<int>(css);
  for (int c = 0; c < 3; ++c) {
    info[4 + c] = widths[c];
    info[7 + c] = heights[c];
  }
  return 0;
}

// Decode one file's planes into the caller's device buffers (Y, Cb, Cr with
// their row pitches; a grayscale file writes Y) on `stream`, and wait for
// it.  nvjpegDecode returns after its host phase (the Huffman decode into
// the state's pinned buffer) with the copy of that buffer and the IDCT
// queued on `stream`; the next call's host phase writes the same buffer.
// So the stream is synchronised before returning: without it, planes came
// out wrong whenever the queued work ran late (the card shared with other
// processes, or the stream held by earlier work).
int nvj_decode(void* ptr, const unsigned char* data, size_t length, void* y, void* cb,
               void* cr, long long pitch_y, long long pitch_cb, long long pitch_cr,
               void* stream) {
  auto* d = static_cast<Decoder*>(ptr);
  cudaError_t e = cudaSetDevice(d->device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  nvjpegImage_t img = {};
  img.channel[0] = static_cast<unsigned char*>(y);
  img.channel[1] = static_cast<unsigned char*>(cb);
  img.channel[2] = static_cast<unsigned char*>(cr);
  img.pitch[0] = static_cast<size_t>(pitch_y);
  img.pitch[1] = static_cast<size_t>(pitch_cb);
  img.pitch[2] = static_cast<size_t>(pitch_cr);
  nvjpegStatus_t s = nvjpegDecode(d->handle, d->state, data, length, NVJPEG_OUTPUT_YUV, &img,
                                  static_cast<cudaStream_t>(stream));
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  e = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  return e == cudaSuccess ? 0 : -static_cast<int>(e);
}

}  // extern "C"

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
// One decoder is the counterpart of the host pool's Pool and
// pool_decode_batch: one nvJPEG handle on the default backend (the Huffman
// decode on a host thread, the IDCT on the card) and `num_threads` worker
// threads, each with its own nvjpegJpegState and its own stream.  nvJPEG's
// documentation ("Thread Safety") lets threads share the handle and asks for
// one decoder state per thread.  nvj_decode_batch hands a batch's files to
// the workers, which take them in turn from a shared counter, and returns
// once every file is decoded.
//
// A state serves one decode at a time, and its next host phase rewrites the
// pinned buffer that the previous decode's copy reads on the card: so each
// worker waits for its file's work on its own stream before it takes the
// next file.  Without that wait, planes came out wrong whenever the queued
// work ran late (the card shared with other processes, or the stream held
// by earlier work).  When nvj_decode_batch returns, every plane is written.
//
// Status codes: 0 success, > 0 an nvjpegStatus_t, < 0 minus a cudaError_t,
// NVJ_STATUS_EXCEPTION for a C++ exception inside a worker (reported for
// that file, as the host pool's catch does), NVJ_STATUS_THREADS when the
// workers cannot start.
//
// Build (nvjpeg.py, through utils/cuda_build.py):
//   nvcc <NVCC_FLAGS> -o <lib> nvjpeg_pool.cu -L<cuda>/lib64 -lnvjpeg -lpthread

#include <atomic>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

#define NVJ_STATUS_EXCEPTION 65536
#define NVJ_STATUS_THREADS 65537

namespace {

// One batch handed to the workers: the caller's arrays, n files.
struct Job {
  const unsigned char* const* datas;
  const size_t* lengths;
  int n;
  void* const* planes;     // 3 per file: Y, Cb, Cr
  const long long* pitches;  // 3 per file
  int* statuses;           // 1 per file
  std::atomic<int> next{0};
};

struct Worker {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
};

struct Decoder {
  int device = 0;
  nvjpegHandle_t handle = nullptr;
  std::vector<Worker> workers;
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable wake;  // a new job, or stop
  std::condition_variable idle;  // every worker has left the job
  Job* job = nullptr;
  unsigned long long generation = 0;
  int finished = 0;  // workers done with the current job
  bool stop = false;
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

// Decode file i of the job with worker w's state on its stream, then wait
// for that work (the state's pinned buffer is reused by the next decode).
int decode_one(Decoder* d, Worker& w, const Job& job, int i) {
  nvjpegImage_t img = {};
  for (int c = 0; c < 3; ++c) {
    img.channel[c] = static_cast<unsigned char*>(job.planes[3 * i + c]);
    img.pitch[c] = static_cast<size_t>(job.pitches[3 * i + c]);
  }
  nvjpegStatus_t s = nvjpegDecode(d->handle, w.state, job.datas[i], job.lengths[i],
                                  NVJPEG_OUTPUT_YUV, &img, w.stream);
  // waited for even after a failed decode: whatever it queued must end
  // before the state's next host phase
  cudaError_t e = cudaStreamSynchronize(w.stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  return e == cudaSuccess ? 0 : -static_cast<int>(e);
}

void run_worker(Decoder* d, int index) {
  Worker& w = d->workers[index];
  const bool on_device = cudaSetDevice(d->device) == cudaSuccess;
  unsigned long long seen = 0;
  for (;;) {
    Job* job;
    {
      std::unique_lock<std::mutex> lk(d->mu);
      d->wake.wait(lk, [&] { return d->stop || d->generation != seen; });
      if (d->stop) return;
      seen = d->generation;
      job = d->job;
    }
    for (int i; (i = job->next.fetch_add(1)) < job->n;) {
      int st;
      try {
        st = on_device ? decode_one(d, w, *job, i) : -static_cast<int>(cudaErrorInvalidDevice);
      } catch (...) {
        // e.g. std::bad_alloc from a forged-dimension header: an escaping
        // exception would std::terminate the process; report the file
        st = NVJ_STATUS_EXCEPTION;
      }
      job->statuses[i] = st;
    }
    {
      std::lock_guard<std::mutex> lk(d->mu);
      if (++d->finished == static_cast<int>(d->workers.size())) d->idle.notify_all();
    }
  }
}

void stop_threads(Decoder* d) {
  {
    std::lock_guard<std::mutex> lk(d->mu);
    d->stop = true;
  }
  d->wake.notify_all();
  for (auto& t : d->threads) t.join();
  d->threads.clear();
}

void destroy(Decoder* d) {
  stop_threads(d);
  cudaSetDevice(d->device);
  for (auto& w : d->workers) {
    if (w.state) nvjpegJpegStateDestroy(w.state);
    if (w.stream) cudaStreamDestroy(w.stream);
  }
  if (d->handle) nvjpegDestroy(d->handle);
  delete d;
}

}  // namespace

extern "C" {

// A decoder on `device` with `num_threads` workers, or NULL with the
// failure in *status.  It never starts fewer workers than asked.
void* nvj_create(int device, int num_threads, int* status) {
  if (num_threads < 1) {
    *status = NVJ_STATUS_THREADS;
    return nullptr;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) {
    *status = -static_cast<int>(e);
    return nullptr;
  }
  auto* d = new Decoder();
  d->device = device;
  d->workers.resize(num_threads);
  nvjpegStatus_t s = nvjpegCreateSimple(&d->handle);
  for (auto& w : d->workers) {
    if (s != NVJPEG_STATUS_SUCCESS) break;
    s = nvjpegJpegStateCreate(d->handle, &w.state);
    if (s == NVJPEG_STATUS_SUCCESS) {
      e = cudaStreamCreateWithFlags(&w.stream, cudaStreamNonBlocking);
      if (e != cudaSuccess) break;
    }
  }
  if (s != NVJPEG_STATUS_SUCCESS || e != cudaSuccess) {
    *status = s != NVJPEG_STATUS_SUCCESS ? static_cast<int>(s) : -static_cast<int>(e);
    destroy(d);
    return nullptr;
  }
  try {
    for (int i = 0; i < num_threads; ++i) d->threads.emplace_back(run_worker, d, i);
  } catch (...) {
    *status = NVJ_STATUS_THREADS;
    destroy(d);
    return nullptr;
  }
  *status = 0;
  return d;
}

void nvj_destroy(void* ptr) {
  if (ptr) destroy(static_cast<Decoder*>(ptr));
}

// Worker i's stream (a cudaStream_t), or NULL past the last worker.
void* nvj_stream(void* ptr, int i) {
  auto* d = static_cast<Decoder*>(ptr);
  if (i < 0 || i >= static_cast<int>(d->workers.size())) return nullptr;
  return d->workers[i].stream;
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

// Decode n files on the workers: file i's bytes datas[i] (lengths[i]) into
// the caller's device buffers planes[3i..3i+2] (Y, Cb, Cr) with row pitches
// pitches[3i..3i+2] (a grayscale file writes Y), its status in statuses[i].
// Returns once every file is decoded and its work on the card has ended.
// Calls on one decoder must not overlap (the caller serialises them).
void nvj_decode_batch(void* ptr, const unsigned char* const* datas, const size_t* lengths,
                      int n, void* const* planes, const long long* pitches, int* statuses) {
  auto* d = static_cast<Decoder*>(ptr);
  if (n <= 0) return;
  Job job;
  job.datas = datas;
  job.lengths = lengths;
  job.n = n;
  job.planes = planes;
  job.pitches = pitches;
  job.statuses = statuses;
  std::unique_lock<std::mutex> lk(d->mu);
  d->job = &job;
  d->finished = 0;
  ++d->generation;
  d->wake.notify_all();
  // every worker leaves the job before it goes out of scope
  d->idle.wait(lk, [&] { return d->finished == static_cast<int>(d->workers.size()); });
  d->job = nullptr;
}

}  // extern "C"

// posetpu_torch native decode pool: parallel JPEG decode on the host.
//
// The port's own copy of posetpu/native/decode_pool.cpp, with the same C
// API.  All augmentation runs on the device; the host decodes variable-size
// JPEGs and pads them to one static shape, in parallel, writing straight
// into the caller's buffer (pinned host memory on the CUDA path), with no
// GIL held during decode (ctypes releases it).
//
// API (extern "C", ctypes-friendly):
//   pool_create(num_threads) -> opaque handle
//   pool_decode_batch(pool, paths[n], n, pad_h, pad_w,
//                     centers[n*2],            // person centers (x, y)
//                     out_images[n*ph*pw*3],   // uint8 RGB, zero-padded
//                     out_wh[n*2],             // valid (w, h) after crop
//                     out_offset[n*2])         // integer crop offset (x, y)
//     returns number of successfully decoded images; a failed slot reads
//     out_wh = (0, 0) and an all-zero image (the caller falls back to PIL).
//   pool_destroy(pool)
//   pool_decode_planes(path, out, cap, info)
//     one file's component planes as stored, before libjpeg's upsampling
//     and color conversion (raw_data_out): the tests' oracle for the planes
//     the card's route decodes (posetpu_torch/native/jpeg_gpu.py).
//
// Oversized images are integer-cropped around the person center (same
// lossless-translation rule as posetpu_torch.data.loader.load_sample).
//
// Build (posetpu_torch/native/bindings.py, through utils/cuda_build.py):
//   g++ -O3 -shared -fPIC -std=c++17 -o <lib> decode_pool.cpp -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file into an RGB8 buffer. Returns false on any error.
bool decode_jpeg(const char* path, std::vector<uint8_t>& rgb, int& w, int& h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = static_cast<int>(cinfo.output_width);
  h = static_cast<int>(cinfo.output_height);
  rgb.resize(static_cast<size_t>(w) * h * 3);
  const int stride = w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

struct Pool {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> tasks;
  std::mutex mu;
  std::condition_variable cv;
  bool stop = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i) {
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lk(mu);
            cv.wait(lk, [this] { return stop || !tasks.empty(); });
            if (stop && tasks.empty()) return;
            task = std::move(tasks.front());
            tasks.pop();
          }
          task();
        }
      });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : workers) t.join();
  }

  void submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu);
      tasks.push(std::move(fn));
    }
    cv.notify_one();
  }
};

// Decode + center-crop-to-window + pad one sample into the batch buffer.
// Output stays uint8: the device converts to f32 inside the fused program,
// and uint8 host->device transfers are 4x cheaper (measured; BASELINE.md).
bool process_one(const char* path, int pad_h, int pad_w, float cx, float cy,
                 uint8_t* out_img, int32_t* out_wh, int32_t* out_off) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(path, rgb, w, h)) {
    // the caller's buffer may be uninitialised (pinned torch.empty memory)
    std::memset(out_img, 0, static_cast<size_t>(pad_h) * pad_w * 3);
    out_wh[0] = out_wh[1] = 0;
    out_off[0] = out_off[1] = 0;
    return false;
  }
  int off_x = 0, off_y = 0;
  if (h > pad_h || w > pad_w) {
    // integer crop window centered on the person (lossless translation,
    // same rule as data/loader.py)
    off_y = static_cast<int>(cy + 0.5f) - pad_h / 2;
    if (off_y < 0) off_y = 0;
    if (off_y > h - pad_h && h > pad_h) off_y = h - pad_h;
    if (h <= pad_h) off_y = 0;
    off_x = static_cast<int>(cx + 0.5f) - pad_w / 2;
    if (off_x < 0) off_x = 0;
    if (off_x > w - pad_w && w > pad_w) off_x = w - pad_w;
    if (w <= pad_w) off_x = 0;
  }
  const int vw = (w - off_x) < pad_w ? (w - off_x) : pad_w;
  const int vh = (h - off_y) < pad_h ? (h - off_y) : pad_h;

  // zero the canvas, then memcpy the valid region row by row
  std::memset(out_img, 0, static_cast<size_t>(pad_h) * pad_w * 3);
  for (int y = 0; y < vh; ++y) {
    const uint8_t* src = rgb.data() + (static_cast<size_t>(y + off_y) * w + off_x) * 3;
    uint8_t* dst = out_img + (static_cast<size_t>(y) * pad_w) * 3;
    std::memcpy(dst, src, static_cast<size_t>(vw) * 3);
  }
  out_wh[0] = vw;
  out_wh[1] = vh;
  out_off[0] = off_x;
  out_off[1] = off_y;
  return true;
}

// info: image width, height, component count, libjpeg's jpeg_color_space,
// then for each of up to 4 components h_samp, v_samp, stored width, stored
// height (ceil(W * h / hmax), ceil(H * v / vmax)).
int64_t decode_planes(const char* path, uint8_t* out, int64_t cap, int32_t* info) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  // declared before setjmp: a longjmp back to it must not skip destructors
  std::vector<uint8_t> rows;  // one iMCU row of every component
  std::vector<JSAMPROW> ptrs[4];
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  const int nc = cinfo.num_components;
  if (nc > 4) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return -1;
  }
  const int64_t W = cinfo.image_width, H = cinfo.image_height;
  info[0] = static_cast<int32_t>(W);
  info[1] = static_cast<int32_t>(H);
  info[2] = nc;
  info[3] = static_cast<int32_t>(cinfo.jpeg_color_space);
  int64_t need = 0;
  int64_t cw[4], ch[4];
  for (int c = 0; c < nc; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    cw[c] = (W * comp.h_samp_factor + cinfo.max_h_samp_factor - 1) / cinfo.max_h_samp_factor;
    ch[c] = (H * comp.v_samp_factor + cinfo.max_v_samp_factor - 1) / cinfo.max_v_samp_factor;
    int32_t* ci = info + 4 + 4 * c;
    ci[0] = comp.h_samp_factor;
    ci[1] = comp.v_samp_factor;
    ci[2] = static_cast<int32_t>(cw[c]);
    ci[3] = static_cast<int32_t>(ch[c]);
    need += cw[c] * ch[c];
  }
  if (cap < need) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return need;
  }
  cinfo.raw_data_out = TRUE;
  cinfo.out_color_space = cinfo.jpeg_color_space;
  jpeg_start_decompress(&cinfo);
  // jpeg_read_raw_data gives one iMCU row a call: v_samp * DCTSIZE rows of
  // width_in_blocks * DCTSIZE samples for each component
  JSAMPARRAY planes[4];
  int64_t pitch[4], band[4], base[4];
  size_t total = 0;
  for (int c = 0; c < nc; ++c) {
    const jpeg_component_info& comp = cinfo.comp_info[c];
    pitch[c] = static_cast<int64_t>(comp.width_in_blocks) * DCTSIZE;
    band[c] = static_cast<int64_t>(comp.v_samp_factor) * DCTSIZE;
    total += static_cast<size_t>(pitch[c] * band[c]);
  }
  rows.resize(total);
  uint8_t* at = rows.data();
  int64_t dst = 0;
  for (int c = 0; c < nc; ++c) {
    ptrs[c].resize(band[c]);
    for (int64_t r = 0; r < band[c]; ++r) ptrs[c][r] = at + r * pitch[c];
    at += pitch[c] * band[c];
    planes[c] = ptrs[c].data();
    base[c] = dst;
    dst += cw[c] * ch[c];
  }
  const JDIMENSION lines = cinfo.max_v_samp_factor * DCTSIZE;
  for (int64_t imcu = 0; cinfo.output_scanline < cinfo.output_height; ++imcu) {
    if (jpeg_read_raw_data(&cinfo, planes, lines) == 0) longjmp(jerr.setjmp_buffer, 1);
    for (int c = 0; c < nc; ++c) {
      for (int64_t r = 0; r < band[c]; ++r) {
        const int64_t y = imcu * band[c] + r;
        if (y >= ch[c]) break;
        std::memcpy(out + base[c] + y * cw[c], planes[c][r], static_cast<size_t>(cw[c]));
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return need;
}

}  // namespace

extern "C" {

// returns the bytes one file's planes need, tightly packed, component after
// component, and writes them to out when cap holds that many; -1 when the
// file does not decode (or has more than 4 components)
int64_t pool_decode_planes(const char* path, uint8_t* out, int64_t cap, int32_t* info) {
  try {
    return decode_planes(path, out, cap, info);
  } catch (...) {  // std::bad_alloc from a forged header
    return -1;
  }
}

void* pool_create(int num_threads) {
  if (num_threads < 1) num_threads = 1;
  return new Pool(num_threads);
}

void pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

int pool_decode_batch(void* pool_ptr, const char** paths, int n, int pad_h,
                      int pad_w, const float* centers, uint8_t* out_images,
                      int32_t* out_wh, int32_t* out_offset) {
  auto* pool = static_cast<Pool*>(pool_ptr);
  std::atomic<int> ok{0};
  std::atomic<int> done{0};
  std::mutex mu;
  std::condition_variable cv;
  const size_t img_stride = static_cast<size_t>(pad_h) * pad_w * 3;
  for (int i = 0; i < n; ++i) {
    pool->submit([&, i] {
      bool good = false;
      try {
        good = process_one(paths[i], pad_h, pad_w, centers[2 * i],
                           centers[2 * i + 1], out_images + i * img_stride,
                           out_wh + 2 * i, out_offset + 2 * i);
      } catch (...) {
        // e.g. std::bad_alloc from a forged-dimension JPEG header: an
        // escaping exception in a pool thread would std::terminate the
        // whole process; report the sample as failed (PIL fallback)
        std::memset(out_images + i * img_stride, 0, img_stride);
        out_wh[2 * i] = out_wh[2 * i + 1] = 0;
        out_offset[2 * i] = out_offset[2 * i + 1] = 0;
      }
      if (good) ok.fetch_add(1);
      if (done.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lk(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done.load() == n; });
  return ok.load();
}

}  // extern "C"

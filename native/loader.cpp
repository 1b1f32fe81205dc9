// Native frame loader: threaded PNG decode + prefetch for TUM RGB-D streams.
//
// Plays the runtime role the reference delegates to its ROS nodelet pipeline
// (launch/kinect_normal.launch: image decode -> metric convert -> organized
// cloud, running concurrently with the tracker): a C++ thread pool decodes
// frames AHEAD of the consumer so disk IO + PNG inflate overlap with device
// compute, handing Python dense float buffers through a bounded ring.
//
// PNG subset decoded here (all that TUM sequences use):
//   - 16-bit grayscale (depth; big-endian samples, value/5000 m, 0 -> NaN)
//   - 8-bit RGB / RGBA / grayscale (color, -> [0,1] float RGB)
//   - non-interlaced, one IDAT stream (multiple IDAT chunks concatenated)
// Inflate via zlib; filters per the PNG spec (None/Sub/Up/Average/Paeth).
//
// C ABI (consumed via ctypes from tracking_sdf_tpu.data.native):
//   tsdf_loader_open(paths...)        -> handle (probes first frame for dims)
//   tsdf_loader_dims(handle, &w, &h)
//   tsdf_loader_next(handle, depth_out, rgb_out) -> frame idx or -1 at end
//   tsdf_loader_close(handle)
// Plus one-shot decoders tsdf_decode_depth / tsdf_decode_rgb.

#include <zlib.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <limits>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0, height = 0;
  int channels = 0;    // decoded source channels
  int bit_depth = 0;   // 8 or 16
  std::vector<uint8_t> data;  // unfiltered scanline bytes
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool read_file_once(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(size_t(n));
  size_t got = std::fread(out.data(), 1, size_t(n), f);
  std::fclose(f);
  return got == size_t(n);
}

// fopen/fread can fail TRANSIENTLY under fd pressure (EMFILE with many
// concurrent processes — observed as rare silently-colorless frames in
// parallel test runs). Retry with backoff; a persistent failure is then a
// real one and is REPORTED by the caller, never silent.
bool read_file(const char* path, std::vector<uint8_t>& out) {
  for (int attempt = 0; attempt < 4; ++attempt) {
    if (read_file_once(path, out)) return true;
    std::this_thread::sleep_for(std::chrono::milliseconds(2 << attempt));
  }
  return false;
}

// Decode a PNG byte stream into unfiltered raw scanlines.
bool decode_png(const std::vector<uint8_t>& buf, Image& img) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || std::memcmp(buf.data(), magic, 8) != 0) return false;

  size_t pos = 8;
  std::vector<uint8_t> idat;
  int color_type = -1;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    if (pos + 12 + len > buf.size()) return false;
    const uint8_t* type = &buf[pos + 4];
    const uint8_t* payload = &buf[pos + 8];
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return false;
      img.width = int(be32(payload));
      img.height = int(be32(payload + 4));
      img.bit_depth = payload[8];
      color_type = payload[9];
      if (payload[12] != 0) return false;  // interlaced unsupported
      switch (color_type) {
        case 0: img.channels = 1; break;   // gray
        case 2: img.channels = 3; break;   // rgb
        case 4: img.channels = 2; break;   // gray+alpha
        case 6: img.channels = 4; break;   // rgba
        default: return false;             // palette unsupported
      }
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  // Reject absurd IHDR dims from corrupt/fuzzed files BEFORE sizing
  // buffers: width*height ~2^60 would bad_alloc out of the extern "C"
  // boundary (std::terminate kills the Python process instead of
  // returning -1), and 32-bit element-count math downstream overflows.
  constexpr int kMaxDim = 16384;
  if (img.width <= 0 || img.height <= 0 || img.width > kMaxDim ||
      img.height > kMaxDim || idat.empty())
    return false;

  const int bpp_bits = img.channels * img.bit_depth;
  const size_t stride = (size_t(img.width) * bpp_bits + 7) / 8;
  const size_t raw_size = (stride + 1) * size_t(img.height);
  std::vector<uint8_t> raw(raw_size);

  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(idat.data());
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int zr = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zr != Z_STREAM_END && !(zr == Z_OK && zs.avail_out == 0)) return false;

  // Unfilter in place into img.data.
  const int fbpp = (bpp_bits + 7) / 8;  // filter unit, bytes
  img.data.assign(stride * size_t(img.height), 0);
  const uint8_t* prev = nullptr;
  for (int y = 0; y < img.height; ++y) {
    const uint8_t* src = &raw[(stride + 1) * size_t(y)];
    uint8_t filter = src[0];
    ++src;
    uint8_t* dst = &img.data[stride * size_t(y)];
    switch (filter) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (size_t x = 0; x < stride; ++x) {
          uint8_t a = x >= size_t(fbpp) ? dst[x - fbpp] : 0;
          dst[x] = uint8_t(src[x] + a);
        }
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x) {
          uint8_t b = prev ? prev[x] : 0;
          dst[x] = uint8_t(src[x] + b);
        }
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x) {
          uint8_t a = x >= size_t(fbpp) ? dst[x - fbpp] : 0;
          uint8_t b = prev ? prev[x] : 0;
          dst[x] = uint8_t(src[x] + ((int(a) + int(b)) >> 1));
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; ++x) {
          uint8_t a = x >= size_t(fbpp) ? dst[x - fbpp] : 0;
          uint8_t b = prev ? prev[x] : 0;
          uint8_t c = (prev && x >= size_t(fbpp)) ? prev[x - fbpp] : 0;
          dst[x] = uint8_t(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return false;
    }
    prev = dst;
  }
  return true;
}

constexpr float kDepthScale = 5000.0f;  // TUM: png value / 5000 = meters

// 16-bit gray PNG -> raw uint16 (0 = hole; TUM wire format). The raw path
// ships 2 B/px instead of 4 B/px floats to the device, which decodes
// v/5000 -> meters itself (pipeline.runner.process_chunk).
bool depth_to_u16(const Image& img, uint16_t* out) {
  if (img.channels != 1 || img.bit_depth != 16) return false;
  const size_t n = size_t(img.width) * img.height;
  for (size_t i = 0; i < n; ++i)
    out[i] = (uint16_t(img.data[2 * i]) << 8) | img.data[2 * i + 1];
  return true;
}

// Any 8-bit PNG -> raw uint8 RGB (1 B/channel on the wire; device /255).
bool rgb_to_u8(const Image& img, uint8_t* out) {
  if (img.bit_depth != 8) return false;
  const size_t n = size_t(img.width) * img.height;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* px = &img.data[i * img.channels];
    uint8_t r, g, b;
    switch (img.channels) {
      case 1: case 2: r = g = b = px[0]; break;
      case 3: case 4: r = px[0]; g = px[1]; b = px[2]; break;
      default: return false;
    }
    out[3 * i] = r;
    out[3 * i + 1] = g;
    out[3 * i + 2] = b;
  }
  return true;
}

// 16-bit gray PNG -> float meters (0 -> NaN). Returns false on mismatch.
bool depth_to_float(const Image& img, float* out) {
  if (img.bit_depth != 16 || img.channels != 1) return false;
  const float nan = std::numeric_limits<float>::quiet_NaN();
  const size_t n = size_t(img.width) * size_t(img.height);
  for (size_t i = 0; i < n; ++i) {
    uint16_t v = (uint16_t(img.data[2 * i]) << 8) | img.data[2 * i + 1];
    out[i] = v == 0 ? nan : float(v) / kDepthScale;
  }
  return true;
}

// Any 8-bit PNG -> float RGB in [0, 1].
bool rgb_to_float(const Image& img, float* out) {
  if (img.bit_depth != 8) return false;
  const size_t n = size_t(img.width) * size_t(img.height);
  // true division (not reciprocal-multiply): bit-exact with numpy's /255.0
  const float s = 255.0f;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* px = &img.data[size_t(img.channels) * i];
    float r, g, b;
    switch (img.channels) {
      case 1: r = g = b = px[0] / s; break;
      case 2: r = g = b = px[0] / s; break;
      case 3: case 4: r = px[0] / s; g = px[1] / s; b = px[2] / s; break;
      default: return false;
    }
    out[3 * i] = r;
    out[3 * i + 1] = g;
    out[3 * i + 2] = b;
  }
  return true;
}

struct Frame {
  int index = -1;
  bool ok = false;
  std::vector<float> depth;       // w*h (float mode)
  std::vector<float> rgb;         // 3*w*h or empty (float mode)
  std::vector<uint16_t> depth16;  // w*h (raw mode)
  std::vector<uint8_t> rgb8;      // 3*w*h or empty (raw mode)
};

struct Loader {
  std::vector<std::string> depth_paths;
  std::vector<std::string> rgb_paths;  // empty string = no rgb for frame
  int width = 0, height = 0;
  int prefetch = 8;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<Frame> ready;        // decoded, ordered by emit logic below
  std::atomic<int> next_to_fetch{0};
  bool raw = false;  // emit u16/u8 wire buffers instead of floats
  int next_to_emit = 0;
  std::vector<Frame> out_of_order;  // holding area
  bool stop = false;

  void worker() {
    for (;;) {
      int idx = next_to_fetch.fetch_add(1);
      if (idx >= int(depth_paths.size())) return;
      Frame fr;
      fr.index = idx;
      std::vector<uint8_t> buf;
      Image img;
      fr.ok = read_file(depth_paths[idx].c_str(), buf) && decode_png(buf, img) &&
              img.width == width && img.height == height;
      if (fr.ok) {
        if (raw) {
          fr.depth16.resize(size_t(width) * height);
          fr.ok = depth_to_u16(img, fr.depth16.data());
        } else {
          fr.depth.resize(size_t(width) * height);
          fr.ok = depth_to_float(img, fr.depth.data());
        }
      }
      if (fr.ok && !rgb_paths[idx].empty()) {
        std::vector<uint8_t> cbuf;
        Image cimg;
        bool cok = read_file(rgb_paths[idx].c_str(), cbuf) &&
                   decode_png(cbuf, cimg) && cimg.width == width &&
                   cimg.height == height;
        if (!cok) {
          // never drop color silently: the consumer sees rgb=None and the
          // operator sees why
          std::fprintf(stderr,
                       "tsdf_native: rgb read/decode failed after retries, "
                       "frame %d: %s\n", idx, rgb_paths[idx].c_str());
        }
        if (cok) {
          if (raw) {
            fr.rgb8.resize(size_t(width) * height * 3);
            cok = rgb_to_u8(cimg, fr.rgb8.data());
            if (!cok) fr.rgb8.clear();
          } else {
            fr.rgb.resize(size_t(width) * height * 3);
            cok = rgb_to_float(cimg, fr.rgb.data());
            if (!cok) fr.rgb.clear();
          }
        }
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_produce.wait(lk, [&] {
        return stop || int(ready.size()) + int(out_of_order.size()) < prefetch ||
               fr.index == next_to_emit;
      });
      if (stop) return;
      out_of_order.push_back(std::move(fr));
      // move any in-order frames to the ready queue
      bool moved = true;
      while (moved) {
        moved = false;
        for (auto it = out_of_order.begin(); it != out_of_order.end(); ++it) {
          if (it->index == next_to_emit + int(ready.size())) {
            ready.push_back(std::move(*it));
            out_of_order.erase(it);
            moved = true;
            break;
          }
        }
      }
      cv_consume.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// One-shot decoders (also the unit-test surface).
int tsdf_decode_depth(const char* path, float* out, int* w, int* h,
                      int max_elems) {
  std::vector<uint8_t> buf;
  Image img;
  if (!read_file(path, buf) || !decode_png(buf, img)) return -1;
  *w = img.width;
  *h = img.height;
  // size_t math: int multiply would overflow for large (valid) dims
  if (size_t(img.width) * size_t(img.height) > size_t(max_elems)) return -2;
  return depth_to_float(img, out) ? 0 : -3;
}

int tsdf_decode_rgb(const char* path, float* out, int* w, int* h,
                    int max_elems) {
  std::vector<uint8_t> buf;
  Image img;
  if (!read_file(path, buf) || !decode_png(buf, img)) return -1;
  *w = img.width;
  *h = img.height;
  if (size_t(img.width) * size_t(img.height) * 3 > size_t(max_elems)) return -2;
  return rgb_to_float(img, out) ? 0 : -3;
}

static void* loader_open_impl(const char** depth_paths,
                              const char** rgb_paths, int n, int prefetch,
                              int threads, bool raw) {
  auto* ld = new Loader();
  // `raw` MUST be set before any worker starts: the old open_raw wrapper
  // flipped it after tsdf_loader_open had already spawned the pool, and
  // workers that won that race decoded in FLOAT mode — the raw consumer
  // then memcpy'd from the empty u16/u8 vectors, handing Python
  // uninitialized np.empty buffers (observed as rare garbage-depth /
  // missing-rgb frames under load; the root cause of the flaky
  // raw-vs-float chunk equivalence test).
  ld->raw = raw;
  ld->depth_paths.reserve(n);
  ld->rgb_paths.reserve(n);
  for (int i = 0; i < n; ++i) {
    ld->depth_paths.emplace_back(depth_paths[i]);
    ld->rgb_paths.emplace_back(rgb_paths && rgb_paths[i] ? rgb_paths[i] : "");
  }
  ld->prefetch = prefetch > 0 ? prefetch : 8;
  // probe dims from the first decodable frame
  std::vector<uint8_t> buf;
  Image img;
  if (n == 0 || !read_file(ld->depth_paths[0].c_str(), buf) ||
      !decode_png(buf, img)) {
    delete ld;
    return nullptr;
  }
  ld->width = img.width;
  ld->height = img.height;
  int nt = threads > 0 ? threads : int(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > 16) nt = 16;
  for (int i = 0; i < nt; ++i)
    ld->workers.emplace_back(&Loader::worker, ld);
  return ld;
}

void* tsdf_loader_open(const char** depth_paths, const char** rgb_paths,
                       int n, int prefetch, int threads) {
  return loader_open_impl(depth_paths, rgb_paths, n, prefetch, threads,
                          false);
}

// Raw-mode open: identical to tsdf_loader_open but frames emit u16 depth /
// u8 rgb wire buffers (consume with tsdf_loader_next_raw).
void* tsdf_loader_open_raw(const char** depth_paths, const char** rgb_paths,
                           int n, int prefetch, int threads) {
  return loader_open_impl(depth_paths, rgb_paths, n, prefetch, threads,
                          true);
}

void tsdf_loader_dims(void* handle, int* w, int* h) {
  auto* ld = static_cast<Loader*>(handle);
  *w = ld->width;
  *h = ld->height;
}

// Blocks until the next frame (in order) is ready. Returns the frame index,
// -1 at end of stream, -2 on a decode failure for that frame (stream
// continues). rgb_out receives -1.0f fill when the frame has no color.
int tsdf_loader_next(void* handle, float* depth_out, float* rgb_out) {
  auto* ld = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(ld->mu);
  if (ld->next_to_emit >= int(ld->depth_paths.size())) return -1;
  ld->cv_consume.wait(lk, [&] { return !ld->ready.empty() || ld->stop; });
  if (ld->stop) return -1;
  Frame fr = std::move(ld->ready.front());
  ld->ready.pop_front();
  ld->next_to_emit++;
  ld->cv_produce.notify_all();
  lk.unlock();

  if (!fr.ok) return -2;
  std::memcpy(depth_out, fr.depth.data(), fr.depth.size() * sizeof(float));
  if (rgb_out) {
    if (!fr.rgb.empty()) {
      std::memcpy(rgb_out, fr.rgb.data(), fr.rgb.size() * sizeof(float));
    } else {
      size_t n = size_t(ld->width) * ld->height * 3;
      for (size_t i = 0; i < n; ++i) rgb_out[i] = -1.0f;
    }
  }
  return fr.index;
}

// Raw-mode consume: depth_out w*h uint16 (0 = hole), rgb_out 3*w*h uint8
// (0xFF fill + return-code semantics identical to tsdf_loader_next; a
// frame with no color writes 0 to *has_rgb and leaves rgb_out untouched).
int tsdf_loader_next_raw(void* handle, uint16_t* depth_out, uint8_t* rgb_out,
                         int* has_rgb) {
  auto* ld = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(ld->mu);
  if (ld->next_to_emit >= int(ld->depth_paths.size())) return -1;
  ld->cv_consume.wait(lk, [&] { return !ld->ready.empty() || ld->stop; });
  if (ld->stop) return -1;
  Frame fr = std::move(ld->ready.front());
  ld->ready.pop_front();
  ld->next_to_emit++;
  ld->cv_produce.notify_all();
  lk.unlock();

  if (!fr.ok) return -2;
  std::memcpy(depth_out, fr.depth16.data(),
              fr.depth16.size() * sizeof(uint16_t));
  if (has_rgb) *has_rgb = fr.rgb8.empty() ? 0 : 1;
  if (rgb_out && !fr.rgb8.empty())
    std::memcpy(rgb_out, fr.rgb8.data(), fr.rgb8.size());
  return fr.index;
}

void tsdf_loader_close(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stop = true;
  }
  ld->cv_produce.notify_all();
  ld->cv_consume.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"

// Host-side data loader: PNG decode + resize + threaded batch loading
// (the port's copy of native/decode.cc; host code, not a CUDA kernel).
//
// The trainers feed uint8 batches to the device, so the host's share of
// the input pipeline is image decode + resize; this library does that in
// C++ with a pthread pool, behind a minimal C ABI consumed via ctypes
// (mingraph_unet_tpu_torch/data/native_loader.py).
//
// Scope: 8-bit non-interlaced PNG, color types 0 (gray), 2 (RGB), 3
// (palette), 4 (gray+alpha), 6 (RGBA). Other files take the OpenCV path
// on the Python side.
//
// Build: ops/kernels/build.py::host_library("decode")
// (g++ -O3 -shared -fPIC, links zlib + pthread).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <string>
#include <thread>
#include <atomic>
#include <zlib.h>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;  // c = channels in decoded output (1 or 3)
  std::vector<uint8_t> px;  // h * w * c
};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit non-interlaced PNG into RGB (3ch) or gray (1ch).
bool decode_png(const uint8_t* data, size_t len, Image* out, bool want_gray) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || memcmp(data, magic, 8) != 0) return false;

  size_t pos = 8;
  int width = 0, height = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // rgb triples

  while (pos + 8 <= len) {
    uint32_t chunk_len = be32(data + pos);
    const char* type = reinterpret_cast<const char*>(data + pos + 4);
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + chunk_len > len) return false;
    if (!memcmp(type, "IHDR", 4)) {
      width = be32(body);
      height = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
      if (bit_depth != 8 || interlace != 0) return false;
      if (color_type != 0 && color_type != 2 && color_type != 3 && color_type != 4 && color_type != 6)
        return false;
    } else if (!memcmp(type, "PLTE", 4)) {
      palette.assign(body, body + chunk_len);
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + chunk_len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + chunk_len;
  }
  if (width <= 0 || height <= 0 || idat.empty()) return false;

  int src_c = color_type == 2 ? 3 : color_type == 6 ? 4 : color_type == 4 ? 2 : 1;
  size_t stride = size_t(width) * src_c;
  std::vector<uint8_t> raw((stride + 1) * height);

  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  int zret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zret != Z_STREAM_END && zret != Z_OK) return false;

  // Unfilter scanlines in place into a contiguous pixel buffer.
  std::vector<uint8_t> img(stride * height);
  const int bpp = src_c;  // bytes per pixel (8-bit depth)
  for (int y = 0; y < height; ++y) {
    uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = raw.data() + (stride + 1) * y + 1;
    uint8_t* dst = img.data() + stride * y;
    const uint8_t* up = y > 0 ? img.data() + stride * (y - 1) : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(bpp)) ? up[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
  }

  // Convert to requested channel count.
  int out_c = want_gray ? 1 : 3;
  out->w = width;
  out->h = height;
  out->c = out_c;
  out->px.resize(size_t(width) * height * out_c);
  for (size_t i = 0; i < size_t(width) * height; ++i) {
    uint8_t r, g, b;
    const uint8_t* s = img.data() + i * src_c;
    switch (color_type) {
      case 0: r = g = b = s[0]; break;
      case 2: r = s[0]; g = s[1]; b = s[2]; break;
      case 3: {
        size_t pi = size_t(s[0]) * 3;
        if (pi + 2 >= palette.size()) return false;
        r = palette[pi]; g = palette[pi + 1]; b = palette[pi + 2];
        break;
      }
      case 4: r = g = b = s[0]; break;
      default: r = s[0]; g = s[1]; b = s[2]; break;  // 6 = RGBA, drop alpha
    }
    if (want_gray) {
      // OpenCV grayscale weights, rounded.
      out->px[i] = uint8_t(0.299 * r + 0.587 * g + 0.114 * b + 0.5);
    } else {
      out->px[i * 3] = r;
      out->px[i * 3 + 1] = g;
      out->px[i * 3 + 2] = b;
    }
  }
  return true;
}

// cv2 INTER_LINEAR-compatible bilinear resize (half-pixel centers).
void resize_bilinear(const Image& in, int oh, int ow, uint8_t* out) {
  const int c = in.c;
  const float sy = float(in.h) / oh, sx = float(in.w) / ow;
  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(floorf(fy));
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= in.h ? in.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= in.h ? in.h - 1 : y0 + 1);
    for (int x = 0; x < ow; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = int(floorf(fx));
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= in.w ? in.w - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= in.w ? in.w - 1 : x0 + 1);
      for (int ch = 0; ch < c; ++ch) {
        float v00 = in.px[(size_t(y0c) * in.w + x0c) * c + ch];
        float v01 = in.px[(size_t(y0c) * in.w + x1c) * c + ch];
        float v10 = in.px[(size_t(y1c) * in.w + x0c) * c + ch];
        float v11 = in.px[(size_t(y1c) * in.w + x1c) * c + ch];
        float top = v00 * (1 - wx) + v01 * wx;
        float bot = v10 * (1 - wx) + v11 * wx;
        out[(size_t(y) * ow + x) * c + ch] = uint8_t(top * (1 - wy) + bot * wy + 0.5f);
      }
    }
  }
}

// cv2 INTER_NEAREST-compatible resize: sx = floor(dx * src / dst).
void resize_nearest(const Image& in, int oh, int ow, uint8_t* out) {
  const int c = in.c;
  for (int y = 0; y < oh; ++y) {
    int sy = int((int64_t(y) * in.h) / oh);
    if (sy >= in.h) sy = in.h - 1;
    for (int x = 0; x < ow; ++x) {
      int sx = int((int64_t(x) * in.w) / ow);
      if (sx >= in.w) sx = in.w - 1;
      memcpy(out + (size_t(y) * ow + x) * c, in.px.data() + (size_t(sy) * in.w + sx) * c, c);
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    fclose(f);
    return false;
  }
  buf->resize(size_t(n));
  size_t got = fread(buf->data(), 1, size_t(n), f);
  fclose(f);
  return got == size_t(n);
}

}  // namespace

extern "C" {

// Decode one PNG file and resize into out (oh*ow*3 RGB, bilinear) or
// (oh*ow gray, nearest — for masks). Returns 0 on success, nonzero on error.
int mgu_load_image(const char* path, int oh, int ow, uint8_t* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return 1;
  Image img;
  if (!decode_png(buf.data(), buf.size(), &img, /*want_gray=*/false)) return 2;
  if (img.h == oh && img.w == ow) {
    memcpy(out, img.px.data(), img.px.size());
  } else {
    resize_bilinear(img, oh, ow, out);
  }
  return 0;
}

int mgu_load_mask(const char* path, int oh, int ow, uint8_t* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return 1;
  Image img;
  if (!decode_png(buf.data(), buf.size(), &img, /*want_gray=*/true)) return 2;
  if (img.h == oh && img.w == ow) {
    memcpy(out, img.px.data(), img.px.size());
  } else {
    resize_nearest(img, oh, ow, out);
  }
  return 0;
}

// Threaded batch loader: decode+resize n images (and masks when mask_paths
// is non-null) with `threads` workers. paths are NUL-separated. Returns the
// number of failures (failed slots are zero-filled).
int mgu_load_batch(const char* const* img_paths, const char* const* mask_paths, int n,
                   int oh, int ow, uint8_t* out_imgs, uint8_t* out_masks, int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      uint8_t* img_dst = out_imgs + size_t(i) * oh * ow * 3;
      if (mgu_load_image(img_paths[i], oh, ow, img_dst) != 0) {
        memset(img_dst, 0, size_t(oh) * ow * 3);
        failures.fetch_add(1);
      }
      if (mask_paths && out_masks) {
        uint8_t* mask_dst = out_masks + size_t(i) * oh * ow;
        if (mgu_load_mask(mask_paths[i], oh, ow, mask_dst) != 0) {
          memset(mask_dst, 0, size_t(oh) * ow);
          failures.fetch_add(1);
        }
      }
    }
  };
  std::vector<std::thread> pool;
  int n_threads = threads < n ? threads : (n > 0 ? n : 1);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

int mgu_version() { return 1; }

}  // extern "C"

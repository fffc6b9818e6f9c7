// Native host-side runtime of the PyTorch port.
//
// The repository's native/host_ops.cpp with a PNG decoder of its own: the
// same C interface (decode_gray, remap_bilinear, feeder_create, feeder_next,
// feeder_destroy), the same PGM branch, bilinear remap and prefetching stereo
// feeder, and in place of libpng a decoder built on zlib's inflate alone, so
// the library links with -lz -lpthread only. Its gray values are bit-equal to
// the libpng build's (the same float expressions in the same order) on every
// non-interlaced PNG, except gray+alpha: there it takes the gray channel, as
// PIL's convert("L") does, where the libpng build reads three channels at
// the wrong stride and one byte past each row. Interlaced and damaged files
// return a nonzero code, and the Python loaders then decode them with PIL.
//
// Exposed as a plain C ABI for ctypes.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>


// ---------------------------------------------------------------------------
// PNG decode on zlib alone
// ---------------------------------------------------------------------------

namespace {

const unsigned char kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const unsigned char* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo one row's filter in place; prev is the previous unfiltered row (zeros
// above the first row). False for an unknown filter type.
bool unfilter_row(int type, unsigned char* row, const unsigned char* prev,
                  size_t rowbytes, size_t bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < rowbytes; ++i) row[i] += row[i - bpp];
      return true;
    case 2:
      for (size_t i = 0; i < rowbytes; ++i) row[i] += prev[i];
      return true;
    case 3:
      for (size_t i = 0; i < rowbytes; ++i)
        row[i] += (unsigned char)(((i >= bpp ? row[i - bpp] : 0) + prev[i]) >> 1);
      return true;
    case 4:
      for (size_t i = 0; i < rowbytes; ++i)
        row[i] += (unsigned char)paeth(i >= bpp ? row[i - bpp] : 0, prev[i],
                                       i >= bpp ? prev[i - bpp] : 0);
      return true;
    default:
      return false;
  }
}

// Channels of a PNG colour type at a bit depth the format allows; 0 for a
// combination it does not.
int png_channels(int color, int depth) {
  switch (color) {
    case 0:  // gray
      return (depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
              depth == 16) ? 1 : 0;
    case 3:  // palette
      return (depth == 1 || depth == 2 || depth == 4 || depth == 8) ? 1 : 0;
    case 2:  // RGB
      return (depth == 8 || depth == 16) ? 3 : 0;
    case 4:  // gray + alpha
      return (depth == 8 || depth == 16) ? 2 : 0;
    case 6:  // RGBA
      return (depth == 8 || depth == 16) ? 4 : 0;
    default:
      return 0;
  }
}

// A whole PNG file in memory, signature already checked, to float32 gray.
// The transforms are the libpng build's: a palette expands to RGB, 1/2/4-bit
// gray to 8 bits (x255, x85, x17), 16-bit samples stay 16-bit; then the gray
// conversion of that build, expression for expression. Returns 0; 4 when the
// image exceeds the buffer; 7 when the file is damaged or truncated; 8 when it
// is interlaced.
int decode_png(const unsigned char* data, size_t size, float* out, int cap_h,
               int cap_w, int* out_h, int* out_w) {
  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  bool have_ihdr = false;
  unsigned char palette[256][3] = {};  // indices past the PLTE read black
  std::vector<std::pair<const unsigned char*, uint32_t>> idat;
  while (size - pos >= 12) {
    const uint32_t len = be32(data + pos);
    if (len > size - pos - 12) break;  // truncated: keep what is whole
    const unsigned char* type = data + pos + 4;
    const unsigned char* body = data + pos + 8;
    const bool is_ihdr = std::memcmp(type, "IHDR", 4) == 0;
    const bool is_plte = std::memcmp(type, "PLTE", 4) == 0;
    const bool is_idat = std::memcmp(type, "IDAT", 4) == 0;
    if (is_ihdr || is_plte || is_idat) {  // critical chunks: check the CRC
      if (crc32(0L, type, 4 + len) != be32(body + len)) return 7;
    }
    if (is_ihdr) {
      if (len != 13 || have_ihdr) return 7;
      w = be32(body);
      h = be32(body + 4);
      depth = body[8];
      color = body[9];
      if (body[10] != 0 || body[11] != 0) return 7;  // compression, filter
      interlace = body[12];
      have_ihdr = true;
    } else if (!have_ihdr) {
      return 7;  // IHDR comes first
    } else if (is_plte) {
      if (len % 3 != 0 || len / 3 > 256) return 7;
      std::memcpy(palette, body, len);
    } else if (is_idat) {
      idat.emplace_back(body, len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + (size_t)len;
  }
  const int file_channels = png_channels(color, depth);
  if (!have_ihdr || file_channels == 0 || w == 0 || h == 0 ||
      w > 0x7fffffffu || h > 0x7fffffffu || idat.empty())
    return 7;
  if (interlace != 0) return interlace == 1 ? 8 : 7;
  if ((int64_t)h > cap_h || (int64_t)w > cap_w) return 4;

  const size_t rowbytes = ((size_t)w * file_channels * depth + 7) / 8;
  const size_t bpp = std::max<size_t>(1, (size_t)file_channels * depth / 8);
  std::vector<unsigned char> raw((rowbytes + 1) * h);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return 7;
  zs.next_out = raw.data();
  zs.avail_out = (uInt)raw.size();
  int zrc = Z_OK;
  for (size_t k = 0; k < idat.size() && zrc == Z_OK && zs.avail_out > 0; ++k) {
    zs.next_in = const_cast<unsigned char*>(idat[k].first);
    zs.avail_in = idat[k].second;
    while (zs.avail_in > 0 && zs.avail_out > 0) {
      zrc = inflate(&zs, Z_NO_FLUSH);
      if (zrc != Z_OK) break;
    }
  }
  inflateEnd(&zs);
  if (zs.avail_out != 0 || (zrc != Z_OK && zrc != Z_STREAM_END)) return 7;

  // the expanded row: 8-bit gray, 8-bit RGB from a palette, or the file's
  // own samples at 8 or 16 bits
  const bool pal = color == 3;
  const int channels = pal ? 3 : file_channels;
  const int out_depth = depth < 8 ? 8 : depth;
  const std::vector<unsigned char> zeros(rowbytes, 0);
  std::vector<unsigned char> exp((size_t)w * channels * (out_depth / 8));
  const float bgr[3] = {0.299f, 0.587f, 0.114f};  // cvtColor RGB2GRAY weights
  for (uint32_t y = 0; y < h; ++y) {
    unsigned char* line = raw.data() + (size_t)y * (rowbytes + 1);
    unsigned char* cur = line + 1;
    const unsigned char* prev = y ? cur - (rowbytes + 1) : zeros.data();
    if (!unfilter_row(line[0], cur, prev, rowbytes, bpp)) return 7;
    const unsigned char* row = cur;
    if (depth < 8 || pal) {
      const int mask = (1 << depth) - 1;
      const int gain = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
      for (uint32_t x = 0; x < w; ++x) {
        const size_t bit = (size_t)x * depth;
        const int v = (cur[bit >> 3] >> (8 - depth - (int)(bit & 7))) & mask;
        if (pal) {
          std::memcpy(&exp[(size_t)x * 3], palette[v], 3);
        } else {
          exp[x] = (unsigned char)(v * gain);
        }
      }
      row = exp.data();
    }
    float* dst = out + (size_t)y * cap_w;
    if (out_depth == 16) {
      for (uint32_t x = 0; x < w; ++x) {
        if (channels <= 2) {  // gray, or gray + alpha: the gray sample
          uint16_t v = (row[2 * x * channels] << 8) | row[2 * x * channels + 1];
          dst[x] = (float)v / 257.0f;  // 16-bit gray -> [0,255]
        } else {
          float acc = 0.f;
          for (int c = 0; c < 3; ++c) {
            uint16_t v = (row[2 * (x * channels + c)] << 8) |
                         row[2 * (x * channels + c) + 1];
            acc += bgr[c] * (float)v / 257.0f;
          }
          dst[x] = acc;
        }
      }
    } else {
      for (uint32_t x = 0; x < w; ++x) {
        if (channels <= 2) {
          dst[x] = (float)row[(size_t)x * channels];
        } else {
          const unsigned char* p = row + (size_t)x * channels;
          dst[x] = bgr[0] * p[0] + bgr[1] * p[1] + bgr[2] * p[2];
        }
      }
    }
  }
  *out_h = (int)h;
  *out_w = (int)w;
  return 0;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// PNG / PGM decode to float32 grayscale [0,255]
// ---------------------------------------------------------------------------

// Returns 0 on success. Caller passes a buffer of capacity cap_h*cap_w;
// actual dims written to out_h/out_w.
int decode_gray(const char* path, float* out, int cap_h, int cap_w,
                int* out_h, int* out_w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  unsigned char sig[8];
  if (std::fread(sig, 1, 8, fp) != 8) {
    std::fclose(fp);
    return 2;
  }
  // PGM (P5) path: KITTI grayscale and many SLAM datasets
  if (sig[0] == 'P' && (sig[1] == '5' || sig[1] == '2')) {
    std::fseek(fp, 0, SEEK_SET);
    char magic[3] = {0};
    int w = 0, h = 0, maxv = 0;
    if (std::fscanf(fp, "%2s", magic) != 1) { std::fclose(fp); return 3; }
    auto skip_ws_comments = [&]() {
      int c;
      while ((c = std::fgetc(fp)) != EOF) {
        if (c == '#') {
          while ((c = std::fgetc(fp)) != EOF && c != '\n') {}
        } else if (!isspace(c)) {
          std::ungetc(c, fp);
          break;
        }
      }
    };
    skip_ws_comments();
    if (std::fscanf(fp, "%d", &w) != 1) { std::fclose(fp); return 3; }
    skip_ws_comments();
    if (std::fscanf(fp, "%d", &h) != 1) { std::fclose(fp); return 3; }
    skip_ws_comments();
    if (std::fscanf(fp, "%d", &maxv) != 1) { std::fclose(fp); return 3; }
    std::fgetc(fp);  // single whitespace after maxval
    if (h > cap_h || w > cap_w) { std::fclose(fp); return 4; }
    std::vector<unsigned char> row(w * (maxv > 255 ? 2 : 1));
    for (int y = 0; y < h; ++y) {
      if (std::fread(row.data(), 1, row.size(), fp) != row.size()) {
        std::fclose(fp);
        return 5;
      }
      float* dst = out + (size_t)y * cap_w;
      if (maxv > 255) {
        for (int x = 0; x < w; ++x) {
          dst[x] = (float)((row[2 * x] << 8) | row[2 * x + 1]) * 255.0f /
                   (float)maxv;
        }
      } else {
        for (int x = 0; x < w; ++x) dst[x] = (float)row[x];
      }
    }
    std::fclose(fp);
    *out_h = h;
    *out_w = w;
    return 0;
  }
  if (std::memcmp(sig, kPngSig, 8) != 0) {
    std::fclose(fp);
    return 6;  // not PNG either
  }
  std::vector<unsigned char> file(sig, sig + 8);
  unsigned char buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), fp)) > 0)
    file.insert(file.end(), buf, buf + n);
  std::fclose(fp);
  return decode_png(file.data(), file.size(), out, cap_h, cap_w, out_h, out_w);
}

// ---------------------------------------------------------------------------
// Bilinear remap (cv::remap equivalent)
// ---------------------------------------------------------------------------

void remap_bilinear(const float* img, int h, int w, const float* map_x,
                    const float* map_y, float* out) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t i = (size_t)y * w + x;
      const float mx = map_x[i], my = map_y[i];
      if (mx < 0.f || my < 0.f || mx > (float)(w - 1) ||
          my > (float)(h - 1)) {
        out[i] = 0.f;
        continue;
      }
      const int x0 = (int)mx, y0 = (int)my;
      const int x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      const int y1 = y0 + 1 < h ? y0 + 1 : h - 1;
      const float fx = mx - (float)x0, fy = my - (float)y0;
      const float a = img[(size_t)y0 * w + x0];
      const float b = img[(size_t)y0 * w + x1];
      const float c = img[(size_t)y1 * w + x0];
      const float d = img[(size_t)y1 * w + x1];
      out[i] = a * (1.f - fx) * (1.f - fy) + b * fx * (1.f - fy) +
               c * (1.f - fx) * fy + d * fx * fy;
    }
  }
}

// ---------------------------------------------------------------------------
// Prefetching stereo feeder
// ---------------------------------------------------------------------------
//
// The reference's example program does imread+remap inline at sensor rate
// (stereo_inertial_euroc.cc:176-234). Here a worker pool decodes + rectifies
// frames ahead into a bounded queue, so the Python tracking loop only ever
// memcpy's a ready frame.

// Worker threads race to claim the next frame index and write into an
// indexed ring of slots; the consumer takes frames strictly in order.
struct Feeder2 {
  std::vector<std::string> left, right;
  std::vector<float> map_lx, map_ly, map_rx, map_ry;
  int h = 0, w = 0;
  int depth = 6;
  std::atomic<size_t> claim{0};
  std::atomic<bool> stop{false};
  std::atomic<size_t> consumed{0};
  struct Slot {
    std::vector<float> l, r;
    std::atomic<int> state{0};  // 0 empty, 1 writing, 2 ready
    int status = 0;
  };
  std::vector<Slot> ring;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;

  void worker() {
    std::vector<float> tmp((size_t)h * w);
    while (!stop.load()) {
      size_t idx = claim.fetch_add(1);
      if (idx >= left.size()) break;
      // wait until the slot for idx is free (consumer caught up)
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || idx < consumed.load() + ring.size();
        });
        if (stop.load()) break;
      }
      Slot& s = ring[idx % ring.size()];
      int st = 0;
      int hh, ww;
      if (map_lx.empty()) {
        st |= decode_gray(left[idx].c_str(), s.l.data(), h, w, &hh, &ww);
      } else {
        st |= decode_gray(left[idx].c_str(), tmp.data(), h, w, &hh, &ww);
        remap_bilinear(tmp.data(), h, w, map_lx.data(), map_ly.data(),
                       s.l.data());
      }
      if (!right.empty()) {
        if (map_rx.empty()) {
          st |= decode_gray(right[idx].c_str(), s.r.data(), h, w, &hh, &ww);
        } else {
          st |= decode_gray(right[idx].c_str(), tmp.data(), h, w, &hh, &ww);
          remap_bilinear(tmp.data(), h, w, map_rx.data(), map_ry.data(),
                         s.r.data());
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        s.status = st;
        s.state.store(2);
      }
      cv_ready.notify_all();
    }
  }
};

void* feeder_create(const char** left_paths, const char** right_paths,
                    int n_frames, int h, int w, const float* map_lx,
                    const float* map_ly, const float* map_rx,
                    const float* map_ry, int depth, int n_workers) {
  auto* f = new Feeder2();
  f->h = h;
  f->w = w;
  f->depth = depth;
  for (int i = 0; i < n_frames; ++i) {
    f->left.emplace_back(left_paths[i]);
    if (right_paths) f->right.emplace_back(right_paths[i]);
  }
  const size_t npx = (size_t)h * w;
  if (map_lx) {
    f->map_lx.assign(map_lx, map_lx + npx);
    f->map_ly.assign(map_ly, map_ly + npx);
  }
  if (map_rx) {
    f->map_rx.assign(map_rx, map_rx + npx);
    f->map_ry.assign(map_ry, map_ry + npx);
  }
  f->ring = std::vector<Feeder2::Slot>(depth);
  for (auto& s : f->ring) {
    s.l.resize(npx);
    if (right_paths) s.r.resize(npx);
  }
  for (int i = 0; i < n_workers; ++i)
    f->workers.emplace_back(&Feeder2::worker, f);
  return f;
}

// Blocks until frame idx (must be consumed in order) is decoded; copies into
// out_l/out_r. Returns decode status (0 ok).
int feeder_next(void* handle, float* out_l, float* out_r) {
  auto* f = static_cast<Feeder2*>(handle);
  size_t idx = f->consumed.load();
  if (idx >= f->left.size()) return -1;
  Feeder2::Slot& s = f->ring[idx % f->ring.size()];
  {
    std::unique_lock<std::mutex> lk(f->mu);
    f->cv_ready.wait(lk, [&] { return s.state.load() == 2; });
  }
  const size_t npx = (size_t)f->h * f->w;
  std::memcpy(out_l, s.l.data(), npx * sizeof(float));
  if (out_r && !s.r.empty())
    std::memcpy(out_r, s.r.data(), npx * sizeof(float));
  int st = s.status;
  {
    std::lock_guard<std::mutex> lk(f->mu);
    s.state.store(0);
    f->consumed.fetch_add(1);
  }
  f->cv_space.notify_all();
  return st;
}

void feeder_destroy(void* handle) {
  auto* f = static_cast<Feeder2*>(handle);
  f->stop.store(true);
  f->cv_space.notify_all();
  f->cv_ready.notify_all();
  for (auto& t : f->workers) t.join();
  delete f;
}

}  // extern "C"

// FAST-9 at two thresholds + level-interior mask + 3x3 NMS over a padded
// pyramid stack [BN, H, W] (both views x all levels), in one pass.
//
// Replaces the Pallas kernel `_fast_nms_pallas` / `_kernel_factory`
// (orb_slam3_detailed_comments_kor_tpu/ops/pallas_fast.py:42,149). Scores
// follow ops/fast.py (the high map is scored with the high-threshold
// margins), not the Pallas shortcut.
//
// Bound: memory. Per pixel it reads 4 bytes and writes 12, and does ~150
// integer/float ops on data that sits in shared memory, far below the
// card's compute. So each block stages its output tile plus a 4-px halo
// (3 px circle + 1 px NMS) in shared memory once, computes both score maps
// for the tile plus 1 px into shared memory, and runs NMS from there: one
// global read and three writes per pixel, no intermediate in device memory.
//
// Pixels outside the image read as 0. Every pixel the level mask keeps
// reads only pixels of its own level, so this equals the reference's
// circular roll on every kept pixel.
#include <math_constants.h>

#include "osk.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 4;
constexpr int kMaxLevels = 32;
constexpr int kSW = kTileW + 2 * kHalo;  // staged image tile
constexpr int kSH = kTileH + 2 * kHalo;
constexpr int kRW = kTileW + 2;          // score tile (output +-1 px)
constexpr int kRH = kTileH + 2;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// True iff the 16-bit circular mask has a run of >= 9 set bits.
__device__ __forceinline__ bool run9(unsigned m) {
  unsigned mm = m | (m << 16);
  unsigned r = mm & (mm >> 1);
  r &= r >> 2;
  r &= r >> 4;
  r &= mm >> 8;
  return (r & 0xFFFFu) != 0;
}

__global__ void fast_nms_kernel(const float* __restrict__ img,
                                float* __restrict__ shi,
                                float* __restrict__ slo,
                                float* __restrict__ raw, int H, int W, int NL,
                                Levels lv, float th_hi, float th_lo) {
  // Bresenham circle of radius 3, clockwise from 12 o'clock (ops/fast.py);
  // indexed only in unrolled loops, so the offsets fold into addresses.
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                           3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                           0, -1, -2, -3, -3, -3, -2, -1};
  __shared__ float tile[kSH][kSW];
  __shared__ float s_hi[kRH][kRW];
  __shared__ float s_lo[kRH][kRW];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int level = b % NL;
  const int hl = lv.h[level];
  const int wl = lv.w[level];
  const size_t plane = static_cast<size_t>(H) * W;
  const float* src = img + b * plane;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  for (int i = tid; i < kSH * kSW; i += nthr) {
    const int ty = i / kSW, tx = i % kSW;
    const int y = y0 - kHalo + ty, x = x0 - kHalo + tx;
    tile[ty][tx] = (y >= 0 && y < H && x >= 0 && x < W)
                       ? src[static_cast<size_t>(y) * W + x]
                       : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < kRH * kRW; i += nthr) {
    const int sy = i / kRW, sx = i % kRW;
    const int y = y0 - 1 + sy, x = x0 - 1 + sx;
    const int ty = sy + kHalo - 1, tx = sx + kHalo - 1;
    const float c = tile[ty][tx];
    unsigned bh = 0, dh = 0, bl = 0, dl = 0;
    float mbh = 0.f, mdh = 0.f, mbl = 0.f, mdl = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float d = tile[ty + kDy[k]][tx + kDx[k]] - c;
      bh |= static_cast<unsigned>(d > th_hi) << k;
      dh |= static_cast<unsigned>(d < -th_hi) << k;
      bl |= static_cast<unsigned>(d > th_lo) << k;
      dl |= static_cast<unsigned>(d < -th_lo) << k;
      mbh += fmaxf(d - th_hi, 0.f);
      mdh += fmaxf(-d - th_hi, 0.f);
      mbl += fmaxf(d - th_lo, 0.f);
      mdl += fmaxf(-d - th_lo, 0.f);
    }
    const bool inb = y >= 3 && y < hl - 3 && x >= 3 && x < wl - 3;
    s_hi[sy][sx] = (inb && (run9(bh) || run9(dh))) ? fmaxf(mbh, mdh) : 0.f;
    s_lo[sy][sx] = (inb && (run9(bl) || run9(dl))) ? fmaxf(mbl, mdl) : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < kTileH * kTileW; i += nthr) {
    const int oy = i / kTileW, ox = i % kTileW;
    const int y = y0 + oy, x = x0 + ox;
    if (y >= H || x >= W) continue;
    const float ch = s_hi[oy + 1][ox + 1];
    const float cl = s_lo[oy + 1][ox + 1];
    float mh = -CUDART_INF_F, ml = -CUDART_INF_F;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (dy == 1 && dx == 1) continue;
        mh = fmaxf(mh, s_hi[oy + dy][ox + dx]);
        ml = fmaxf(ml, s_lo[oy + dy][ox + dx]);
      }
    }
    const size_t o = b * plane + static_cast<size_t>(y) * W + x;
    shi[o] = (ch > 0.f && ch >= mh) ? ch : 0.f;
    slo[o] = (cl > 0.f && cl >= ml) ? cl : 0.f;
    raw[o] = cl;
  }
}

}  // namespace

// img, shi, slo, raw: device float32 [BN, H, W]; hs, ws: HOST int32 [NL]
// true level extents (passed by value into the kernel).
OSK_API int osk_fast_nms(const void* img, void* shi, void* slo, void* raw,
                         int BN, int H, int W, int NL, const void* hs,
                         const void* ws, float th_hi, float th_lo,
                         void* stream) {
  if (NL < 1 || NL > kMaxLevels || BN % NL != 0) return cudaErrorInvalidValue;
  if (BN == 0 || H == 0 || W == 0) return cudaSuccess;
  Levels lv;
  for (int l = 0; l < NL; ++l) {
    lv.h[l] = static_cast<const int*>(hs)[l];
    lv.w[l] = static_cast<const int*>(ws)[l];
  }
  const dim3 block(32, 8);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, BN);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(shi),
      static_cast<float*>(slo), static_cast<float*>(raw), H, W, NL, lv, th_hi,
      th_lo);
  return cudaGetLastError();
}

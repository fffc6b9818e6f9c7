// FAST-9 at two thresholds + level-interior mask + 3x3 NMS over a padded
// pyramid stack [BN, H, W] (both views x all levels), in one pass.
//
// Replaces the Pallas kernel `_fast_nms_pallas` / `_kernel_factory`
// (orb_slam3_detailed_comments_kor_tpu/ops/pallas_fast.py:42,149). Scores
// follow ops/fast.py (the high map is scored with the high-threshold
// margins), not the Pallas shortcut.
//
// Bound: bytes, on paper. The three f32 outputs are written in full (12 B
// a pixel of the padded stack) and the level pixels are read once: 0.024 ms
// at 3.35 TB/s for the bench stack, above what its operations take at the
// CUDA cores' peak. In practice its work limits it on textured images,
// and the design cuts that work:
//  - 62 % of the stack is padding: summed over 8 levels at scale 1.2 the
//    level areas are 3.10 of the 8.17 padded planes. A block whose tile has
//    no pixel inside its level's interior (y >= hl-3 or x >= wl-3) only
//    writes zeros, with 16-byte stores, and stages and computes nothing.
//    (The tile alone decides it: every output is 0 at a pixel outside the
//    interior, whatever its neighbours hold.)
//  - The full test (4 bit masks and 4 margin sums over 16 points) is
//    needed only at corners, and a corner at th_hi or th_lo is a corner at
//    min(th). Two exact filters at min(th) come first:
//    the compass pre-test (any run of 9 on the 16-circle covers at least 2
//    of the points k = 0, 4, 8, 12, so a pixel with fewer than 2 of them
//    beyond +min(th) and fewer than 2 beyond -min(th) scores 0 at both
//    thresholds), then the run-of-9 test on the bright and dark bits alone.
//    The pixels left are compacted into a list in shared memory, so the
//    full test runs without idle lanes, with the margins summed in circle
//    order k = 0..15 as the plain version sums them. On the bench's
//    synthetic texture 79 % of interior pixels pass the compass test and
//    31 % reach the full test.
//  - Tiles are 128x16 (halo 1.6x the tile's pixels, against 1.9x at
//    32x16), staged with float4 loads, and each thread writes 4 neighbouring
//    pixels of every output as one float4 (the caller pads W to a multiple
//    of 128, ops/orb.py; W % 4 == 0 is required).
//
// Pixels outside the image read as 0. Every pixel the level mask keeps
// reads only pixels of its own level, so this equals the reference's
// circular roll on every kept pixel.
#include <math_constants.h>

#include "osk.cuh"

namespace {

constexpr int kTileW = 128;
constexpr int kTileH = 16;
constexpr int kHalo = 4;                 // 3 px circle + 1 px NMS
constexpr int kThreads = 512;            // 4 blocks of 16 warps fill an SM
constexpr int kMaxLevels = 32;
constexpr int kSW = kTileW + 2 * kHalo;  // staged image tile
constexpr int kSH = kTileH + 2 * kHalo;
constexpr int kRW = kTileW + 2;          // score tile (output +-1 px)
constexpr int kRH = kTileH + 2;
constexpr int kQuads = kTileH * kTileW / 4;  // 4-pixel output groups

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

// Writes pixels o..o+3 of one output row (W % 4 == 0, so all four lie in it).
__device__ __forceinline__ void store4(float* __restrict__ dst, size_t o,
                                       float4 v) {
  *reinterpret_cast<float4*>(dst + o) = v;
}

__global__ void __launch_bounds__(kThreads)
    fast_nms_kernel(const float* __restrict__ img, float* __restrict__ shi,
                    float* __restrict__ slo, float* __restrict__ raw, int H,
                    int W, int NL, Levels lv, float th_hi, float th_lo) {
  // Bresenham circle of radius 3, clockwise from 12 o'clock (ops/fast.py);
  // indexed only in unrolled loops, so the offsets fold into addresses.
  constexpr int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                           3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                           0, -1, -2, -3, -3, -3, -2, -1};
  __shared__ __align__(16) float tile[kSH][kSW];
  __shared__ float s_hi[kRH][kRW];
  __shared__ float s_lo[kRH][kRW];
  __shared__ unsigned short cand[kRH * kRW];  // score positions left for the full test
  __shared__ int n_cand;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int level = b % NL;
  const int iy1 = lv.h[level] - 3;  // interior: 3 <= y < iy1, 3 <= x < ix1
  const int ix1 = lv.w[level] - 3;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t obase = b * plane;
  const int tid = threadIdx.x;

  if (y0 >= iy1 || x0 >= ix1 || iy1 <= 3 || ix1 <= 3) {  // all zeros
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < kQuads; i += kThreads) {
      const int y = y0 + i / (kTileW / 4), x = x0 + 4 * (i % (kTileW / 4));
      if (y >= H || x >= W) continue;
      const size_t o = obase + static_cast<size_t>(y) * W + x;
      store4(shi, o, z);
      store4(slo, o, z);
      store4(raw, o, z);
    }
    return;
  }

  if (tid == 0) n_cand = 0;
  const float* src = img + obase;
  for (int i = tid; i < kSH * (kSW / 4); i += kThreads) {
    const int ty = i / (kSW / 4), tx = 4 * (i % (kSW / 4));
    const int y = y0 - kHalo + ty, x = x0 - kHalo + tx;
    // W % 4 == 0 and x % 4 == 0: a quad lies wholly inside or outside
    const float4 v =
        (y >= 0 && y < H && x >= 0 && x < W)
            ? __ldg(reinterpret_cast<const float4*>(
                  src + static_cast<size_t>(y) * W + x))
            : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(&tile[ty][tx]) = v;
  }
  __syncthreads();

  // every score position: 0 unless both filters at min(th) pass, in which
  // case it joins `cand` (warp-aggregated append)
  const float th_min = fminf(th_hi, th_lo);
  const int lane = tid & 31;
  for (int i0 = 0; i0 < kRH * kRW; i0 += kThreads) {  // uniform trip count
    const int i = i0 + tid;
    bool corner = false;
    if (i < kRH * kRW) {
      const int sy = i / kRW, sx = i % kRW;
      const int y = y0 - 1 + sy, x = x0 - 1 + sx;
      s_hi[sy][sx] = 0.f;
      s_lo[sy][sx] = 0.f;
      if (y >= 3 && y < iy1 && x >= 3 && x < ix1) {
        const int ty = sy + kHalo - 1, tx = sx + kHalo - 1;
        const float c = tile[ty][tx];
        const float d0 = tile[ty - 3][tx] - c, d4 = tile[ty][tx + 3] - c;
        const float d8 = tile[ty + 3][tx] - c, d12 = tile[ty][tx - 3] - c;
        const int n_bright =
            (d0 > th_min) + (d4 > th_min) + (d8 > th_min) + (d12 > th_min);
        const int n_dark = (d0 < -th_min) + (d4 < -th_min) + (d8 < -th_min) +
                           (d12 < -th_min);
        if (n_bright >= 2 || n_dark >= 2) {
          unsigned bm = 0, dm = 0;
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const float d = tile[ty + kDy[k]][tx + kDx[k]] - c;
            bm |= static_cast<unsigned>(d > th_min) << k;
            dm |= static_cast<unsigned>(d < -th_min) << k;
          }
          corner = run9(bm) || run9(dm);
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, corner);
    if (ballot) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&n_cand, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (corner) {
        cand[base + __popc(ballot & ((1u << lane) - 1u))] =
            static_cast<unsigned short>(i);
      }
    }
  }
  __syncthreads();

  // the candidates: both thresholds' bits and margin sums
  const int nc = n_cand;
  for (int j = tid; j < nc; j += kThreads) {
    const int i = cand[j];
    const int sy = i / kRW, sx = i % kRW;
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
    s_hi[sy][sx] = (run9(bh) || run9(dh)) ? fmaxf(mbh, mdh) : 0.f;
    s_lo[sy][sx] = (run9(bl) || run9(dl)) ? fmaxf(mbl, mdl) : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < kQuads; i += kThreads) {
    const int oy = i / (kTileW / 4), ox = 4 * (i % (kTileW / 4));
    const int y = y0 + oy, x = x0 + ox;
    if (y >= H || x >= W) continue;
    float oh[4], ol[4], orw[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float ch = s_hi[oy + 1][ox + q + 1];
      const float cl = s_lo[oy + 1][ox + q + 1];
      float mh = -CUDART_INF_F, ml = -CUDART_INF_F;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          if (dy == 1 && dx == 1) continue;
          mh = fmaxf(mh, s_hi[oy + dy][ox + q + dx]);
          ml = fmaxf(ml, s_lo[oy + dy][ox + q + dx]);
        }
      }
      oh[q] = (ch > 0.f && ch >= mh) ? ch : 0.f;
      ol[q] = (cl > 0.f && cl >= ml) ? cl : 0.f;
      orw[q] = cl;
    }
    const size_t o = obase + static_cast<size_t>(y) * W + x;
    store4(shi, o, make_float4(oh[0], oh[1], oh[2], oh[3]));
    store4(slo, o, make_float4(ol[0], ol[1], ol[2], ol[3]));
    store4(raw, o, make_float4(orw[0], orw[1], orw[2], orw[3]));
  }
}

}  // namespace

// img, shi, slo, raw: device float32 [BN, H, W]; hs, ws: HOST int32 [NL]
// true level extents, each within [H, W] (passed by value into the kernel).
// Rows are read and written as float4: W % 4 == 0 and 16-byte aligned
// pointers, or cudaErrorInvalidValue.
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
    if (lv.h[l] > H || lv.w[l] > W) return cudaErrorInvalidValue;
  }
  if (W % 4 != 0 || ((reinterpret_cast<uintptr_t>(img) |
                      reinterpret_cast<uintptr_t>(shi) |
                      reinterpret_cast<uintptr_t>(slo) |
                      reinterpret_cast<uintptr_t>(raw)) & 15) != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, BN);
  fast_nms_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(shi),
      static_cast<float*>(slo), static_cast<float*>(raw), H, W, NL, lv, th_hi,
      th_lo);
  return cudaGetLastError();
}

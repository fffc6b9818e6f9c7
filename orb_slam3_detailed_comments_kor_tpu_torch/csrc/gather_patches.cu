// One [ph, pw] window per keypoint, copied from a 2-D image at a top-left
// corner that the kernel clamps into the image.
//
// Replaces the Pallas kernel `_gather_patches_pallas` / `_kernel_factory`
// (orb_slam3_detailed_comments_kor_tpu/ops/pallas_gather.py:29,91) together
// with the corner clamp of the reference's public `gather_patches` (:116-117),
// so that one call is one launch. The TPU version DMAs an 8/128-aligned
// superblock per keypoint and rolls the patch into place; none of that
// alignment logic is needed here.
//
// Bound: bytes. It moves K*ph*pw*8 bytes (41 MB for the 2400 ORB patches
// of a 480x752 stereo frame) with no arithmetic; the small SAD call
// (1200 x 11x21) is near the floor of a launch plus two dependent memory
// latencies (the corner, then the pixels).
//
// Design: one warp per keypoint, kWarps keypoints per block, a grid of
// ceil(K / kWarps) blocks (600 and 300 on the main path's two calls, well
// inside one wave). Lane 0 loads and clamps the corner and broadcasts it.
// The lanes walk the patch in row-major order, so a warp reads neighbouring pixels of a row and writes
// neighbouring output words; each lane's column and source offset advance by
// fixed amounts per step with at most one wrap, so no lane divides per
// element. Where ph*pw % 4 == 0 and the output is 16-byte aligned (the
// [48,45] ORB patches), each lane stores a float4 of four consecutive
// outputs; the loads stay scalar, since a corner's column has any alignment.
#include "osk.cuh"

namespace {

constexpr int kWarps = 4;  // keypoints per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;

// jnp.clip(v, 0, hi) in the corner's own type, then the int it fits in.
template <typename T>
__device__ __forceinline__ int clamp_corner(T v, int hi) {
  return static_cast<int>(v < T(0) ? T(0) : (v > T(hi) ? T(hi) : v));
}

// V: outputs per lane and step (4 = float4 stores, 1 = scalar).
template <typename RowT, typename ColT, int V>
__global__ void __launch_bounds__(kThreads)
    gather_patches_kernel(const float* __restrict__ img,
                          const RowT* __restrict__ rows,
                          const ColT* __restrict__ cols,
                          float* __restrict__ out, int R, int W, int K, int ph,
                          int pw) {
  const int lane = threadIdx.x & 31;
  const int n = ph * pw;
  // A lane starts at output V*lane of each patch and steps 32*V outputs;
  // per step its row advances by step_r and its column by step_c (< pw),
  // plus one row when the column passes pw.
  const int step = 32 * V;
  const int step_r = step / pw, step_c = step - step_r * pw;
  const int lane_r = (V * lane) / pw, lane_c = V * lane - lane_r * pw;
  // offsets into the image are 64-bit: a lane's runs on past the patch
  // through its last batch of steps
  const long long step_off = static_cast<long long>(step_r) * W + step_c;
  const long long wrap = W - pw;  // from past the end of a patch row to the next row's start
  // Steps per lane whose loads are in flight together: 8 scalar steps take
  // a 231-float SAD strip in one round; 4 float4 steps (16 floats a lane)
  // keep the 2160-float ORB patch's loads and stores interleaved.
  constexpr int kBatch = V == 4 ? 4 : 8;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= K) return;  // whole warps leave: the shuffles below see full warps
  int r0 = 0, c0 = 0;
  if (lane == 0) {
    r0 = clamp_corner(rows[k], R - ph);
    c0 = clamp_corner(cols[k], W - pw);
  }
  r0 = __shfl_sync(kFullMask, r0, 0);
  c0 = __shfl_sync(kFullMask, c0, 0);
  const float* src = img + static_cast<size_t>(r0) * W + c0;
  float* dst = out + static_cast<size_t>(k) * n;
  int c = lane_c;
  long long off = static_cast<long long>(lane_r) * W + lane_c;
  // kBatch steps at a time, the same count for every lane: all their
  // loads are in flight before the first store waits on one
  for (int base = 0; base < n; base += kBatch * step) {
    float v[kBatch][V];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (base + u * step + V * lane < n) {
        int cq = c;
        long long oq = off;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          v[u][q] = src[oq];
          ++oq;
          if (++cq == pw) {  // pw < 4 may wrap more than once
            cq = 0;
            oq += wrap;
          }
        }
      }
      off += step_off;
      c += step_c;
      if (c >= pw) {
        c -= pw;
        off += wrap;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * step + V * lane;
      if (i < n) {
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(dst + i) = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
        } else {
          dst[i] = v[u][0];
        }
      }
    }
  }
}

template <typename RowT, typename ColT>
cudaError_t launch_gather(const void* img, const void* rows, const void* cols,
                          void* out, int R, int W, int K, int ph, int pw,
                          cudaStream_t stream) {
  const int blocks = (K + kWarps - 1) / kWarps;
  const bool vec = (ph * pw) % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto* i = static_cast<const float*>(img);
  auto* r = static_cast<const RowT*>(rows);
  auto* c = static_cast<const ColT*>(cols);
  auto* o = static_cast<float*>(out);
  if (vec) {
    gather_patches_kernel<RowT, ColT, 4><<<blocks, kThreads, 0, stream>>>(i, r, c, o, R, W, K, ph, pw);
  } else {
    gather_patches_kernel<RowT, ColT, 1><<<blocks, kThreads, 0, stream>>>(i, r, c, o, R, W, K, ph, pw);
  }
  return cudaGetLastError();
}

}  // namespace

// img: device float32 [R, W]; rows, cols: device [K] raw top-left corners,
// each int32 or int64 (row_bytes, col_bytes: 4 or 8), clamped here to
// [0, R-ph] x [0, W-pw]; out: device float32 [K, ph, pw]. K = 0 launches
// nothing. A patch holds fewer than 2^30 pixels.
OSK_API int osk_gather_patches(const void* img, const void* rows,
                               const void* cols, void* out, int R, int W,
                               int K, int ph, int pw, int row_bytes,
                               int col_bytes, void* stream) {
  if (ph < 1 || pw < 1 || ph > R || pw > W || K < 0) return cudaErrorInvalidValue;
  if ((row_bytes != 4 && row_bytes != 8) || (col_bytes != 4 && col_bytes != 8))
    return cudaErrorInvalidValue;
  if (static_cast<long long>(ph) * pw >= (1LL << 30)) return cudaErrorInvalidValue;
  if (K == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (row_bytes == 4) {
    return col_bytes == 4
               ? launch_gather<int32_t, int32_t>(img, rows, cols, out, R, W, K, ph, pw, s)
               : launch_gather<int32_t, int64_t>(img, rows, cols, out, R, W, K, ph, pw, s);
  }
  return col_bytes == 4
             ? launch_gather<int64_t, int32_t>(img, rows, cols, out, R, W, K, ph, pw, s)
             : launch_gather<int64_t, int64_t>(img, rows, cols, out, R, W, K, ph, pw, s);
}

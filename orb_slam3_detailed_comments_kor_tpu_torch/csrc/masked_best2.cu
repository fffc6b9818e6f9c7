// Masked Hamming best-2: for each row i of A, the best distance, the
// second best and the argbest over the columns j of B with mask[i, j] set,
// without storing the [N, M] distance matrix.
//
// Replaces the Pallas kernel `fused_masked_best2` / `_kernel`
// (orb_slam3_detailed_comments_kor_tpu/ops/pallas_matching.py:34,123).
// The TPU computes distances as a 0/1 matmul on the MXU; here they are
// __popc of the XOR of packed 256-bit descriptors (8 x 32-bit words).
//
// Bound: memory. At the tracking shape (N=4096, M=1200) the uint8 mask is
// 4.9 MB and dominates the bytes; B (38 KB) stays in L1/L2. One warp per
// A-row: its lanes stride over M (so mask reads coalesce), each lane keeps
// its own (best, second, argbest), and a shuffle merge combines them.
// Ties go to the lower column index, as jnp.argmin does; `second` is the
// minimum over the allowed columns other than argbest, so it equals best
// when two columns tie.
#include <limits.h>

#include "osk.cuh"

namespace {

constexpr int kNone = 1 << 30;     // "no allowed column" distance sentinel
constexpr float kBig = 1e9f;        // ops/matching.py BIG

__device__ __forceinline__ int hamming(uint4 a0, uint4 a1, uint4 b0,
                                       uint4 b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__global__ void masked_best2_kernel(const uint4* __restrict__ a,
                                    const uint4* __restrict__ b,
                                    const uint8_t* __restrict__ mask,
                                    int* __restrict__ idx_out,
                                    float* __restrict__ best_out,
                                    float* __restrict__ second_out, int N,
                                    int M) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // uniform across the warp
  const uint4 a0 = a[2 * row], a1 = a[2 * row + 1];
  const uint8_t* mrow = mask + static_cast<size_t>(row) * M;
  int best = kNone, second = kNone, arg = INT_MAX;
  for (int j = lane; j < M; j += 32) {  // j ascends: strict < keeps the first
    if (!mrow[j]) continue;
    const int d = hamming(a0, a1, b[2 * j], b[2 * j + 1]);
    if (d < best) {
      second = best;
      best = d;
      arg = j;
    } else if (d < second) {
      second = d;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int os = __shfl_xor_sync(0xffffffffu, second, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    // second of the union: the smaller of both seconds and the losing best
    second = min(min(second, os), max(best, ob));
    if (ob < best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  if (lane == 0) {
    const bool none = best >= kNone;
    idx_out[row] = none ? 0 : arg;
    best_out[row] = none ? kBig : static_cast<float>(best);
    second_out[row] = second >= kNone ? kBig : static_cast<float>(second);
  }
}

}  // namespace

// a: device int32 [N, 8], b: device int32 [M, 8] packed descriptors (16-byte
// aligned rows); mask: device uint8 [N, M]; idx: int32 [N]; best, second:
// float32 [N].
OSK_API int osk_masked_best2(const void* a, const void* b, const void* mask,
                             void* idx, void* best, void* second, int N, int M,
                             void* stream) {
  if (N == 0) return cudaSuccess;
  constexpr int kThreads = 256;  // 8 rows per block
  const int blocks = (N + kThreads / 32 - 1) / (kThreads / 32);
  masked_best2_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<const uint8_t*>(mask), static_cast<int*>(idx),
      static_cast<float*>(best), static_cast<float*>(second), N, M);
  return cudaGetLastError();
}

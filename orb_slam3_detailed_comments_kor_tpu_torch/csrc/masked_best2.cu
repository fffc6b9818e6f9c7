// Masked Hamming best-2: for each row i of A, the best distance, the
// second best and the argbest over the columns j of B with mask[i, j] set,
// without storing the [N, M] distance matrix.
//
// Replaces the Pallas kernel `fused_masked_best2` / `_kernel`
// (orb_slam3_detailed_comments_kor_tpu/ops/pallas_matching.py:34,123).
// The TPU computes distances as a 0/1 matmul on the MXU; here they are
// __popc of the XOR of packed 256-bit descriptors (8 x 32-bit words).
//
// Bound: bytes. At the tracking shape (N=4096, M=1200) the uint8 mask is
// 4.9 MB of the 5.1 MB moved, and the geometric masks are sparse (a search
// window of r*1.2^level px, +-1 level), so nearly all of the work is
// reading zero bytes. The kernel therefore reads the mask as a memory scan:
// one warp per row, each lane loading 16 mask bytes at a time with its
// row's 2-4 loads in flight together (512 columns per warp per load), one
// compare skipping a zero word, and __popc distances only for set bytes.
// B (38 KB) is not staged per block, which would move more bytes than the
// mask: it is read through L1/L2 for allowed columns only. Rows whose
// start is not 16-byte aligned (M % 16 != 0, or an offset mask) take a
// scalar head of up to 15 columns and a scalar tail.
//
// Ties go to the lower column index, as jnp.argmin does: every lane visits
// its columns in ascending order (head, 16-byte words, tail), keeps its
// first best under a strict <, and the warp merge takes the lower index on
// equal distance. `second` is the minimum over the allowed columns other
// than argbest, so it equals best when two columns tie.
#include <limits.h>

#include "osk.cuh"

namespace {

constexpr int kNone = 1 << 30;     // "no allowed column" distance sentinel
constexpr float kBig = 1e9f;        // ops/matching.py BIG
constexpr int kRowsPerBlock = 4;    // one warp per row
constexpr int kLoads = 4;           // 16-byte mask words a lane has in flight

struct Best2 {
  int best, second, arg;
};

__device__ __forceinline__ void visit(Best2& s, int d, int j) {
  if (d < s.best) {
    s.second = s.best;
    s.best = d;
    s.arg = j;
  } else if (d < s.second) {
    s.second = d;
  }
}

__device__ __forceinline__ int hamming(uint4 a0, uint4 a1,
                                       const uint4* __restrict__ b, int j) {
  const uint4 b0 = __ldg(b + 2 * j), b1 = __ldg(b + 2 * j + 1);
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// Visits the columns col..col+7 whose byte of `w` is non-zero, in
// ascending order (byte 0 is column col: the words are little-endian).
__device__ __forceinline__ void visit8(Best2& s, unsigned long long w,
                                       int col, uint4 a0, uint4 a1,
                                       const uint4* __restrict__ b) {
  while (w) {
    const int byte = (__ffsll(static_cast<long long>(w)) - 1) >> 3;
    visit(s, hamming(a0, a1, b, col + byte), col + byte);
    w &= ~(0xFFull << (8 * byte));
  }
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
    masked_best2_kernel(const uint4* __restrict__ a,
                        const uint4* __restrict__ b,
                        const uint8_t* __restrict__ mask,
                        int* __restrict__ idx_out,
                        float* __restrict__ best_out,
                        float* __restrict__ second_out, int N, int M) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;  // uniform across the warp
  const uint4 a0 = __ldg(a + 2 * row), a1 = __ldg(a + 2 * row + 1);
  const uint8_t* mrow = mask + static_cast<size_t>(row) * M;
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(mrow) & 15);
  const int head = min(M, (16 - misalign) & 15);  // columns before the first word
  const int words = (M - head) >> 4;
  const int tail0 = head + (words << 4);           // columns after the last word
  const uint4* mw = reinterpret_cast<const uint4*>(mrow + head);

  Best2 s{kNone, kNone, INT_MAX};
  if (lane < head && mrow[lane]) visit(s, hamming(a0, a1, b, lane), lane);
  for (int w0 = lane; w0 < words; w0 += 32 * kLoads) {
    uint4 v[kLoads];
#pragma unroll
    for (int g = 0; g < kLoads; ++g) {  // all loads first, then the scan
      const int w = w0 + 32 * g;
      v[g] = w < words ? __ldg(mw + w) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int g = 0; g < kLoads; ++g) {
      if ((v[g].x | v[g].y | v[g].z | v[g].w) == 0u) continue;
      const int col = head + ((w0 + 32 * g) << 4);
      visit8(s, v[g].x | (static_cast<unsigned long long>(v[g].y) << 32), col,
             a0, a1, b);
      visit8(s, v[g].z | (static_cast<unsigned long long>(v[g].w) << 32),
             col + 8, a0, a1, b);
    }
  }
  if (tail0 + lane < M && mrow[tail0 + lane]) {
    visit(s, hamming(a0, a1, b, tail0 + lane), tail0 + lane);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, s.best, off);
    const int os = __shfl_xor_sync(0xffffffffu, s.second, off);
    const int oa = __shfl_xor_sync(0xffffffffu, s.arg, off);
    // second of the union: the smaller of both seconds and the losing best
    s.second = min(min(s.second, os), max(s.best, ob));
    if (ob < s.best || (ob == s.best && oa < s.arg)) {
      s.best = ob;
      s.arg = oa;
    }
  }
  if (lane == 0) {
    const bool none = s.best >= kNone;
    idx_out[row] = none ? 0 : s.arg;
    best_out[row] = none ? kBig : static_cast<float>(s.best);
    second_out[row] = s.second >= kNone ? kBig : static_cast<float>(s.second);
  }
}

}  // namespace

// a: device int32 [N, 8], b: device int32 [M, 8] packed descriptors (16-byte
// aligned rows); mask: device uint8 [N, M], any alignment; idx: int32 [N];
// best, second: float32 [N].
OSK_API int osk_masked_best2(const void* a, const void* b, const void* mask,
                             void* idx, void* best, void* second, int N, int M,
                             void* stream) {
  if (N == 0) return cudaSuccess;
  const int blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  masked_best2_kernel<<<blocks, 32 * kRowsPerBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<const uint8_t*>(mask), static_cast<int*>(idx),
      static_cast<float*>(best), static_cast<float*>(second), N, M);
  return cudaGetLastError();
}

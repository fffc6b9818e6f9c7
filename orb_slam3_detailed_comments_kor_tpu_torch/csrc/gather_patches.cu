// One [ph, pw] window per keypoint, copied from a 2-D image at a top-left
// corner that the wrapper has already clamped into the image.
//
// Replaces the Pallas kernel `_gather_patches_pallas` / `_kernel_factory`
// (orb_slam3_detailed_comments_kor_tpu/ops/pallas_gather.py:29,91). The
// TPU version DMAs an 8/128-aligned superblock per keypoint and rolls the
// patch into place; none of that alignment logic is needed here.
//
// Bound: memory latency. It moves ~K*ph*pw*8 bytes (≈41 MB for the 2400
// ORB patches of a 480x752 stereo frame) with no arithmetic. One block per
// keypoint walks the patch in row-major order, so neighbouring threads read
// neighbouring pixels of a row and write neighbouring output words.
#include "osk.cuh"

namespace {

__global__ void gather_patches_kernel(const float* __restrict__ img,
                                      const int* __restrict__ rows,
                                      const int* __restrict__ cols,
                                      float* __restrict__ out, int W, int ph,
                                      int pw) {
  const int k = blockIdx.x;
  const int r0 = rows[k];
  const int c0 = cols[k];
  const int n = ph * pw;
  float* dst = out + static_cast<size_t>(k) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / pw;
    const int c = i - r * pw;
    dst[i] = img[static_cast<size_t>(r0 + r) * W + (c0 + c)];
  }
}

}  // namespace

// img: device float32 [R, W]; rows, cols: device int32 [K] corners already
// clamped to [0, R-ph] x [0, W-pw]; out: device float32 [K, ph, pw].
OSK_API int osk_gather_patches(const void* img, const void* rows,
                               const void* cols, void* out, int R, int W,
                               int K, int ph, int pw, void* stream) {
  if (ph < 1 || pw < 1 || ph > R || pw > W) return cudaErrorInvalidValue;
  if (K == 0) return cudaSuccess;
  gather_patches_kernel<<<K, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<float*>(out), W, ph, pw);
  return cudaGetLastError();
}

#include "osk.cuh"

namespace {

__global__ void noop_kernel() {}

}  // namespace

OSK_API const char* osk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// An empty kernel of one warp on the caller's stream. Its device time,
// launched back to back, is the floor under every kernel's time.
OSK_API int osk_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

#include "osk.cuh"

OSK_API const char* osk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

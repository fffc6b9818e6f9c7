// Shared declarations for the package's CUDA kernels.
//
// Every kernel has a plain C entry point `osk_<name>` that launches on the
// caller's stream and returns cudaGetLastError() (0 = launched). The Python
// wrappers in ops/cuda_*.py allocate all outputs; no entry allocates or
// synchronises.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define OSK_API extern "C" __attribute__((visibility("default")))

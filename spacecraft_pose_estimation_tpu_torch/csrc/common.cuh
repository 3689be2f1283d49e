// Shared by every kernel source. Each .cu file is built alone into its own
// shared library (see _cuda.py), so this header is compiled once per
// library and its extern "C" helper is exported by each of them.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

extern "C" const char* spe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launchers return the launch status as an int: 0 is cudaSuccess.
#define SPE_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

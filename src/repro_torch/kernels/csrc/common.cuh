// Shared helpers of the attention kernels: element conversion, dtype codes
// and the dispatch over (query dtype, cache dtype, head_dim).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// dtype codes passed from the Python wrappers (kernels/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// masked scores: finite, so exp(NEG_INF - NEG_INF) never makes a NaN
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro

// Expands LAUNCH(TQ, TKV, DH) for the supported instantiations and returns
// cudaErrorInvalidValue for anything else (the wrappers check first).
#define REPRO_DISPATCH(dtype_q, dtype_kv, head_dim, LAUNCH)                  \
  do {                                                                       \
    const bool q32 = (dtype_q) == repro::kFloat32;                           \
    const bool kv32 = (dtype_kv) == repro::kFloat32;                         \
    if ((dtype_q) != repro::kFloat32 && (dtype_q) != repro::kBFloat16)       \
      return cudaErrorInvalidValue;                                          \
    if ((dtype_kv) != repro::kFloat32 && (dtype_kv) != repro::kBFloat16)     \
      return cudaErrorInvalidValue;                                          \
    switch (head_dim) {                                                      \
      REPRO_DISPATCH_DH(16, q32, kv32, LAUNCH)                               \
      REPRO_DISPATCH_DH(32, q32, kv32, LAUNCH)                               \
      REPRO_DISPATCH_DH(64, q32, kv32, LAUNCH)                               \
      REPRO_DISPATCH_DH(128, q32, kv32, LAUNCH)                              \
      REPRO_DISPATCH_DH(256, q32, kv32, LAUNCH)                              \
      default:                                                               \
        return cudaErrorInvalidValue;                                        \
    }                                                                        \
  } while (0)

#define REPRO_DISPATCH_DH(DH, q32, kv32, LAUNCH)                             \
  case DH:                                                                   \
    if (q32 && kv32) return LAUNCH(float, float, DH);                        \
    if (q32) return LAUNCH(float, __nv_bfloat16, DH);                        \
    if (kv32) return LAUNCH(__nv_bfloat16, float, DH);                       \
    return LAUNCH(__nv_bfloat16, __nv_bfloat16, DH);

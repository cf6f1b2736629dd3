// Shared device helpers for the port's hand-written Hopper kernels.
//
// Built with nvcc into one shared library with a plain C interface
// (tempo_tpu_torch/ops/_build.py) and called through ctypes. Every C entry
// point launches on the caller's stream and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tempo {

// Element types the wrappers pass as `dtype`.
enum DType { DT_F32 = 0, DT_BF16 = 1 };

// Activation codes the wrappers pass as `act`.
enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_RELU = 2, ACT_SILU = 3 };

// Exact (erf) GELU, ReLU and SiLU in fp32, as torch.nn.functional computes
// them. The TPU kernel approximated erf (Mosaic has none); CUDA has erff.
__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case ACT_GELU:
      return 0.5f * y * (1.0f + erff(y * 0.70710678118654752f));
    case ACT_RELU:
      return fmaxf(y, 0.0f);
    case ACT_SILU:
      return y / (1.0f + expf(-y));
    default:
      return y;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace tempo

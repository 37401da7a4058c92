// Shared helpers for the port's Hopper kernels (plain C interface, no
// PyTorch headers).  Every entry point is `extern "C" int kft_*(...)`: it
// launches on the caller's stream (PyTorch's current stream, passed as a
// void*), allocates nothing, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kft {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Two floats -> one packed bf16x2 register (low half = a).
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(h);
}

// c += a * b on the tensor cores: m16n8k16, bf16 inputs, f32 accumulate.
// Fragments (g = lane / 4, t = lane % 4): a[0..3] hold A rows g, g+8 at
// columns 2t, 2t+1 (a[0], a[1]) and 2t+8, 2t+9 (a[2], a[3]); b0/b1 hold
// B column g at rows 2t, 2t+1 and 2t+8, 2t+9; c[0..1] is row g and
// c[2..3] row g+8, both at columns 2t, 2t+1.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace kft

// RMSNorm forward for Hopper: y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces: kubeflow_tpu/ops/pallas/rms_norm.py `_kernel` (via `_forward`,
// `rms_norm`), which tiles rows into (block_rows, d) VMEM blocks and pads
// the row count up to the block.
//
// What bounds it on the H100: bytes.  Each element is read once and
// written once (bf16: rows*d*(2+2) bytes plus the f32 scale); the work is
// ~3 flops per element, far below the 295 flop/byte ridge.  At decode the
// call sees only `b` rows (4 rows of 8 KB for llama3_8b), so there the
// launch latency, not the bytes, sets its time.
//
// Design: one block per row (no row padding, no cross-block reduction).
// Threads read 16-byte vectors (8 bf16 or 2x4 f32), neighbouring threads
// on neighbouring addresses, and sum squares in f32; a warp-shuffle then
// shared-memory reduction gives the row's mean square.  The second pass
// re-reads the row (an L1/L2 hit: a row is at most a few tens of KB) and
// writes y once in x's dtype.  d must be a multiple of 8; there is no
// other shape limit, and the last vector of a row needs no mask.
#include "kft_common.cuh"

namespace {

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  float2 a = kft::unpack_bf16x2(u.x), b = kft::unpack_bf16x2(u.y);
  float2 c = kft::unpack_bf16x2(u.z), d = kft::unpack_bf16x2(u.w);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  u.x = kft::pack_bf16x2(v[0], v[1]);
  u.y = kft::pack_bf16x2(v[2], v[3]);
  u.z = kft::pack_bf16x2(v[4], v[5]);
  u.w = kft::pack_bf16x2(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const float* __restrict__ scale,
                                T* __restrict__ y, int d, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int nvec = d / 8;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[8];
    load8(xr + i * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += v[j] * v[j];
  }

  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = kft::warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float t = lane < nwarps ? red[lane] : 0.f;
    t = kft::warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(red[0] / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[8], s[8];
    load8(xr + i * 8, v);
    load8(scale + i * 8, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] * r) * s[j];
    store8(yr + i * 8, v);
  }
}

}  // namespace

extern "C" int kft_rms_norm(const void* x, const void* scale, void* y,
                            int rows, int d, float eps, int x_is_bf16,
                            void* stream) {
  const int nvec = d / 8;
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    rms_norm_kernel<__nv_bfloat16><<<rows, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), d,
        eps);
  } else {
    rms_norm_kernel<float><<<rows, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(y), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Single-token decode attention (split-S flash decoding) for Hopper, bf16.
//
// Replaces: kubeflow_tpu/ops/pallas/flash_decode.py `_decode_kernel` (via
// `flash_decode_ds`, `flash_decode`).  Same function: one query token per
// row, the q "tile" is the GQA group of g = h / kv_h heads that share a kv
// head (q head j <-> kv head j / g), one additive f32 bias row [b, S]
// shared by every head, softmax over the S cache slots, l == 0 -> 1.
//
// What bounds it on the H100: bytes.  Every cache byte is read once,
// 2*b*S*kv_h*d*2 bytes for K and V, against ~4 flops per cache element.
//
// Design, and what it does about that:
// * The TPU kernel walks S sequentially inside one grid cell per
//   (b, kv head): b*kv_h = 32 cells for llama3_8b at b = 4, which would
//   leave 100 of the H100's 132 SMs idle.  Here S is split into chunks of
//   64 slots, one block per (chunk, kv head, b) — flash-decoding — and a
//   second, small launch merges the per-chunk (max, sum, acc) partials.
// * A block serves the whole GQA group, so each K/V byte is read from
//   device memory once, not once per query head.
// * The cache stays sequence-major [b, S, kv_h, d] (the model's layout):
//   a key row is d contiguous bf16, read as 16-byte vectors, 8 lanes per
//   key (4 keys per warp at a time); V rows are read 8 bytes per lane.
// * Ragged S: any S >= 1; the last chunk is masked, no padding copy.
// * The probabilities stay f32 in the P V sum (the TPU kernel rounds them
//   to the cache dtype first).
#include "kft_common.cuh"

namespace {

constexpr int kChunk = 64;  // = CHUNK in ops/cuda/flash_decode.py
constexpr int kWarps = 4;

template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* f) {
  static_assert(N % 8 == 0, "16-byte vectors");
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    uint4 u = reinterpret_cast<const uint4*>(p)[i];
    float2 a = kft::unpack_bf16x2(u.x), b = kft::unpack_bf16x2(u.y);
    float2 c = kft::unpack_bf16x2(u.z), d = kft::unpack_bf16x2(u.w);
    f[8 * i + 0] = a.x; f[8 * i + 1] = a.y; f[8 * i + 2] = b.x;
    f[8 * i + 3] = b.y; f[8 * i + 4] = c.x; f[8 * i + 5] = c.y;
    f[8 * i + 6] = d.x; f[8 * i + 7] = d.y;
  }
}

// Pass 1: one block per (chunk, kv head, batch row).  Writes the chunk's
// unnormalised acc [G, D] and its (max, sum) per head.
template <int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ bias,
                    float* __restrict__ part_o, float* __restrict__ part_ml,
                    int S, int kvh, float scale) {
  constexpr int E = D / 8;    // q/k elements per lane in the score pass
  constexpr int E2 = D / 32;  // v elements per lane in the P V pass
  __shared__ float sc[G][kChunk];
  __shared__ float red[kWarps][G][D];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y, bi = blockIdx.z;
  const int nsplit = gridDim.x;
  const int c0 = split * kChunk;
  const int n = min(kChunk, S - c0);
  const int h = kvh * G;

  // Scores: lanes 8*sub .. 8*sub+7 share one key, each holding E dims.
  const int sub = lane >> 3, part = lane & 7;
  float qf[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    load_bf16<E>(q + ((size_t)bi * h + kh * G + gi) * D + part * E, qf[gi]);

  for (int base = warp * 4; base < n; base += kWarps * 4) {
    const int j = base + sub;
    const bool ok = j < n;
    float kf[E];
    if (ok) {
      load_bf16<E>(k + ((size_t)(bi * S + c0 + j) * kvh + kh) * D + part * E,
                   kf);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kf[e] = 0.f;
    }
    float dot[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc += qf[gi][e] * kf[e];
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      dot[gi] = acc;
    }
    if (ok && part == 0) {
      const float bj = bias[(size_t)bi * S + c0 + j];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) sc[gi][j] = dot[gi] * scale + bj;
    }
  }
  __syncthreads();

  // Per-head max and sum over the chunk; sc becomes exp(s - max).
  for (int gi = warp; gi < G; gi += kWarps) {
    float mx = KFT_NEG_INF;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sc[gi][j]);
    mx = kft::warp_max(mx);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = __expf(sc[gi][j] - mx);
      sc[gi][j] = p;
      l += p;
    }
    l = kft::warp_sum(l);
    if (lane == 0) {
      float* ml = part_ml + (((size_t)bi * kvh + kh) * nsplit + split) * G * 2;
      ml[2 * gi] = mx;
      ml[2 * gi + 1] = l;
    }
  }
  __syncthreads();

  // acc[g][d] = sum_j p[g][j] v[j][d]: warp w takes keys w, w+4, ...
  float acc[G][E2];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < E2; ++e) acc[gi][e] = 0.f;
  for (int j = warp; j < n; j += kWarps) {
    const __nv_bfloat16* vr =
        v + ((size_t)(bi * S + c0 + j) * kvh + kh) * D + lane * E2;
    float vf[E2];
    if constexpr (E2 == 4) {
      uint2 u = *reinterpret_cast<const uint2*>(vr);
      float2 a = kft::unpack_bf16x2(u.x), b = kft::unpack_bf16x2(u.y);
      vf[0] = a.x; vf[1] = a.y; vf[2] = b.x; vf[3] = b.y;
    } else {
      float2 a = kft::unpack_bf16x2(*reinterpret_cast<const uint32_t*>(vr));
      vf[0] = a.x; vf[1] = a.y;
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float p = sc[gi][j];
#pragma unroll
      for (int e = 0; e < E2; ++e) acc[gi][e] += p * vf[e];
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < E2; ++e) red[warp][gi][lane * E2 + e] = acc[gi][e];
  __syncthreads();

  float* po = part_o + (((size_t)bi * kvh + kh) * nsplit + split) * G * D;
  for (int i = tid; i < G * D; i += kWarps * 32) {
    const int gi = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][gi][d];
    po[i] = s;
  }
}

// Pass 2: one block per (head, batch row), one thread per head dim.
template <int D, int G>
__global__ void decode_merge_kernel(const float* __restrict__ part_o,
                                    const float* __restrict__ part_ml,
                                    __nv_bfloat16* __restrict__ o, int kvh,
                                    int nsplit) {
  const int head = blockIdx.x, bi = blockIdx.y, d = threadIdx.x;
  const int kh = head / G, gi = head % G;
  const size_t base = ((size_t)bi * kvh + kh) * nsplit;
  float mx = KFT_NEG_INF;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, part_ml[((base + s) * G + gi) * 2]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float* ml = part_ml + ((base + s) * G + gi) * 2;
    const float w = __expf(ml[0] - mx);
    l += ml[1] * w;
    acc += part_o[((base + s) * G + gi) * D + d] * w;
  }
  if (l == 0.f) l = 1.f;
  o[((size_t)bi * kvh * G + head) * D + d] = __float2bfloat16_rn(acc / l);
}

template <int D, int G>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, void* part_o, void* part_ml, int b, int S, int kvh,
           float scale, cudaStream_t s) {
  const int nsplit = (S + kChunk - 1) / kChunk;
  decode_split_kernel<D, G><<<dim3(nsplit, kvh, b), kWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), S, kvh,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<D, G><<<dim3(kvh * G, b), D, 0, s>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(o), kvh, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_g(int g, const void* q, const void* k, const void* v,
             const void* bias, void* o, void* part_o, void* part_ml, int b,
             int S, int kvh, float scale, cudaStream_t s) {
  switch (g) {
    case 1: return launch<D, 1>(q, k, v, bias, o, part_o, part_ml, b, S, kvh, scale, s);
    case 2: return launch<D, 2>(q, k, v, bias, o, part_o, part_ml, b, S, kvh, scale, s);
    case 4: return launch<D, 4>(q, k, v, bias, o, part_o, part_ml, b, S, kvh, scale, s);
    case 8: return launch<D, 8>(q, k, v, bias, o, part_o, part_ml, b, S, kvh, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int kft_flash_decode(const void* q, const void* k, const void* v,
                                const void* bias, void* o, void* part_o,
                                void* part_ml, int b, int S, int h, int kvh,
                                int d, float scale, void* stream) {
  if (h % kvh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = h / kvh;
  if (d == 128)
    return launch_g<128>(g, q, k, v, bias, o, part_o, part_ml, b, S, kvh,
                         scale, s);
  if (d == 64)
    return launch_g<64>(g, q, k, v, bias, o, part_o, part_ml, b, S, kvh,
                        scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// RMSNorm forward and backward for Hopper.
//
// Forward, y = x * rsqrt(mean(x^2) + eps) * scale, replaces
// kubeflow_tpu/ops/pallas/rms_norm.py `_kernel` (via `_forward`,
// `rms_norm`), which tiles rows into (block_rows, d) VMEM blocks and pads
// the row count up to the block.  Backward, the VJP of that function,
// replaces the same file's `_bwd`: plain XLA, which the TPU's compiler
// fuses into a pass or two over x and g.  PyTorch has no such fusion, so
// the port's counterpart is a kernel:
//   r = rsqrt(mean(x^2) + eps)
//   dx = r * g * scale - x * r^3 * mean(g * scale * x)     (x's dtype)
//   dscale = sum over rows of g * x * r                    (scale's dtype)
// all in f32, as `_bwd` computes it.  x (and g) are bf16 or f32, the scale
// f32 or bf16, cast to f32 inside as `_kernel` does.
//
// What bounds both on the H100: bytes.  The forward reads x once and
// writes y once (~3 flops an element); the backward reads x and g once
// and writes dx once (~11 flops an element), plus an f32 row of dscale
// sums per block (below).  Both are far below the 295 flop/byte ridge.
// At decode the forward sees 4 rows of 8 KB: a launch's latency, not its
// bytes, sets its time there.
//
// What both kernels do about the bytes:
// * One read of each row.  A row spreads over W warps and each lane loads
//   its 16-byte vectors (8 bf16 or 4 f32; lane l takes vectors l,
//   l + 32W, ..., so neighbouring lanes read neighbouring addresses) into
//   registers once, all of a row's loads issued before the first is used,
//   with non-allocating `ld.global.nc.L1::no_allocate` (x and g are read
//   once; the scale stays in L1, read there at use).  The row sums reduce
//   by warp shuffles, then through shared memory when W > 1, and the
//   output is computed from the registers and written once.  A lane holds
//   at most kVecsPerLane vectors and W <= kWarpsPerBlock, so d is at most
//   16384 bf16 or 8192 f32 columns, and a multiple of 8; the wrapper
//   raises beyond.
// * Forward: one row a block, W = as many warps (up to kWarpsPerBlock) as
//   the row has 32-vector runs, so a lane loads one or two vectors at the
//   serving and training widths, and the hardware's block scheduler
//   spreads the rows over the SMs.  (A persistent grid looping over rows,
//   each block prefetching its next row, was slower on the [8192, 2048]
//   training rows and faster on the [2048, 4096] prefill rows: this grid
//   is no slower than the first design's on any of the three shapes,
//   where that one was not.)
// * Backward: a persistent grid, at most kBwdBlocksPerSm blocks an SM
//   (the wrapper passes that cap, from the card's SM count), each holding
//   R rows at once (R row groups of W warps, W the fewest that give a lane
//   at most kBwdVecs vectors) and looping over rows with a stride; a group
//   loads its next row's x and g before it reduces the current one, so
//   each warp keeps two rows of loads in flight.  Every block makes the
//   same number of passes.
// * dscale with no atomics: a thread's columns are the same for every row
//   it visits, so it keeps its g*x*r sums in f32 registers across rows.
//   At the end the block's row groups add theirs into shared memory in
//   group order and the block writes one f32 row of a [blocks, d]
//   workspace; a second, small launch sums the workspace over blocks in a
//   fixed order and rounds to scale's dtype.  dx and dscale are bit-equal
//   on relaunch.
#include "kft_common.cuh"

#include <type_traits>

namespace {

// Launch shape.  ops/cuda/rms_norm.py mirrors the first three (d's limit
// and the backward's grid cap, hence its workspace rows); the tests hold
// the two equal.
constexpr int kWarpsPerBlock = 8;    // warps a block; W's limit
constexpr int kVecsPerLane = 8;      // 16-byte vectors a lane holds a row
constexpr int kBwdBlocksPerSm = 2;   // the backward's grid cap an SM
constexpr int kBwdVecs = 2;          // vectors a lane the backward aims at
constexpr int kReduceWarps = 16;     // warps of the workspace-sum block

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;  // elements a 16-byte vector
  __device__ static void unpack(const uint4& u, float* v) {
    float2 a = kft::unpack_bf16x2(u.x), b = kft::unpack_bf16x2(u.y);
    float2 c = kft::unpack_bf16x2(u.z), d = kft::unpack_bf16x2(u.w);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(kft::pack_bf16x2(v[0], v[1]),
                      kft::pack_bf16x2(v[2], v[3]),
                      kft::pack_bf16x2(v[4], v[5]),
                      kft::pack_bf16x2(v[6], v[7]));
  }
};

template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

// A 16-byte load that does not allocate in L1.  Volatile, so a row's
// loads keep their order: all issued before the first is used.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 u;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
               : "l"(p));
  return u;
}

// E scale values from p, as f32.
template <typename S, int E>
__device__ __forceinline__ void load_scale(const S* p, float* out) {
  if constexpr (std::is_same<S, float>::value) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + k);
      out[4 * k] = f.x; out[4 * k + 1] = f.y;
      out[4 * k + 2] = f.z; out[4 * k + 3] = f.w;
    }
  } else if constexpr (E == 8) {
    Vec<__nv_bfloat16>::unpack(__ldg(reinterpret_cast<const uint4*>(p)), out);
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = kft::unpack_bf16x2(u.x), b = kft::unpack_bf16x2(u.y);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
}

__device__ __forceinline__ void store_scalar(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_scalar(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A lane's vectors in its row: lane + j * stride for j < VPT.  Those at or
// past nvec are clamped to the last vector (loaded, never used), so every
// load is unconditional.
struct RowVecs {
  int nvec, lane, stride;
  __device__ int operator()(int j) const {
    const int v = lane + j * stride;
    return v < nvec ? v : nvec - 1;
  }
  __device__ bool in(int j) const { return lane + j * stride < nvec; }
};

// One row a block, blockDim.x = 32 W threads.
template <typename T, typename S, int VPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    rms_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    T* __restrict__ y, int d, float eps) {
  using V = Vec<T>;
  constexpr int E = V::E;
  const RowVecs vec{d / E, static_cast<int>(threadIdx.x),
                    static_cast<int>(blockDim.x)};
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  uint4 u[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
    u[j] = ld_stream(x + off + static_cast<size_t>(vec(j)) * E);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (!vec.in(j)) continue;
    float f[E];
    V::unpack(u[j], f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss += f[e] * f[e];
  }
  ss = kft::warp_sum(ss);
  if (blockDim.x > 32) {
    __shared__ float red[kWarpsPerBlock];
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) ss += red[w];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (!vec.in(j)) continue;
    const size_t o = static_cast<size_t>(vec(j)) * E;
    float f[E], fs[E];
    V::unpack(u[j], f);
    load_scale<S, E>(scale + o, fs);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = (f[e] * r) * fs[e];
    *reinterpret_cast<uint4*>(y + off + o) = V::pack(f);
  }
}

// R row groups of W warps a block (blockDim.x = 32 W R), each group
// visiting rows group + R * blockIdx.x + k * R * gridDim.x; partial gets
// the block's row of dscale sums.  A group past the last row loads the
// last row again and stores nothing, so every loop pass, and every
// barrier in it, is uniform over the block.  Eight vectors a lane (only
// the widest rows: 16384 bf16 or 8192 f32 columns) need more than the
// 128 registers kBwdBlocksPerSm = 2 leaves a thread (ptxas spilled), so
// that width gets one block an SM and its grid runs in two waves.
template <typename T, typename S, int VPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  VPT > 4 ? 1 : kBwdBlocksPerSm)
    rms_norm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ partial, int rows, int d,
                        float eps, int warps_per_row) {
  using V = Vec<T>;
  constexpr int E = V::E;
  const int row_threads = warps_per_row * 32;
  const int group = threadIdx.x / row_threads;
  const int groups = blockDim.x / row_threads;
  const int warp = threadIdx.x >> 5;
  const RowVecs vec{d / E, static_cast<int>(threadIdx.x) % row_threads,
                    row_threads};
  extern __shared__ float acc[];  // d floats: the block's dscale row
  __shared__ float2 red[2][kWarpsPerBlock];

  float ds[VPT][E];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) ds[j][e] = 0.f;

  const int stride = gridDim.x * groups;
  auto row_off = [&](int base) {
    const int row = base + group;
    return static_cast<size_t>(row < rows ? row : rows - 1) * d;
  };
  auto load_row = [&](int base, uint4* ux, uint4* ug) {
    const size_t off = row_off(base);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const size_t o = off + static_cast<size_t>(vec(j)) * E;
      ux[j] = ld_stream(x + o);
      ug[j] = ld_stream(g + o);
    }
  };
  uint4 ux[VPT], ug[VPT];
  int parity = 0;
  int base = blockIdx.x * groups;
  if (base < rows) load_row(base, ux, ug);
  for (; base < rows; base += stride, parity ^= 1) {
    uint4 nx[VPT], ng[VPT];
    if (base + stride < rows) load_row(base + stride, nx, ng);
    // Sums of x^2 and of g * scale * x over the row.
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (!vec.in(j)) continue;
      float fx[E], fg[E], fs[E];
      V::unpack(ux[j], fx);
      V::unpack(ug[j], fg);
      load_scale<S, E>(scale + static_cast<size_t>(vec(j)) * E, fs);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        ss += fx[e] * fx[e];
        dot += (fg[e] * fs[e]) * fx[e];
      }
    }
    ss = kft::warp_sum(ss);
    dot = kft::warp_sum(dot);
    if (warps_per_row > 1) {  // uniform over the block
      // Two buffers by pass parity: one barrier a pass suffices.
      if ((threadIdx.x & 31) == 0) red[parity][warp] = make_float2(ss, dot);
      __syncthreads();
      ss = 0.f;
      dot = 0.f;
      for (int w = 0; w < warps_per_row; ++w) {
        const float2 p = red[parity][group * warps_per_row + w];
        ss += p.x;
        dot += p.y;
      }
    }
    const bool live = base + group < rows;
    const size_t off = row_off(base);
    const float inv_d = 1.f / static_cast<float>(d);
    const float r = rsqrtf(ss * inv_d + eps);
    const float c = (r * r * r) * (dot * inv_d);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (!live || !vec.in(j)) continue;
      const size_t o = static_cast<size_t>(vec(j)) * E;
      float fx[E], fg[E], fs[E], out[E];
      V::unpack(ux[j], fx);
      V::unpack(ug[j], fg);
      load_scale<S, E>(scale + o, fs);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        out[e] = r * (fg[e] * fs[e]) - fx[e] * c;
        ds[j][e] += (fg[e] * fx[e]) * r;
      }
      *reinterpret_cast<uint4*>(dx + off + o) = V::pack(out);
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      ux[j] = nx[j];
      ug[j] = ng[j];
    }
  }

  // The row groups' dscale sums, added in group order, then this block's
  // workspace row.
  for (int k = 0; k < groups; ++k) {
    if (group == k) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (!vec.in(j)) continue;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float& a = acc[vec(j) * E + e];
          a = (k == 0 ? 0.f : a) + ds[j][e];
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) out[i] = acc[i];
}

// dscale[c] = sum over b of partial[b, c], cast to S.  A block takes 32
// columns: warp w sums workspace rows w, w + kReduceWarps, ... in order,
// then warp 0 adds the warps' sums in warp order.
template <typename S>
__global__ void __launch_bounds__(kReduceWarps * 32)
    rms_norm_bwd_reduce_kernel(const float* __restrict__ partial,
                               S* __restrict__ dscale, int n_parts, int d) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int b = warp; b < n_parts; b += kReduceWarps)
      s += partial[static_cast<size_t>(b) * d + c];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) t += sums[w][lane];
    store_scalar(dscale + c, t);
  }
}

// The fewest warps (a power of two up to kWarpsPerBlock) that give a lane
// of a d-column row at most `target` vectors of `elems` elements, and the
// vectors a lane then holds, rounded up to a power of two.  False when d
// is not a multiple of 8 or a lane would need more than kVecsPerLane.
bool row_split(int d, int elems, int target, int* warps, int* vpt) {
  if (d % 8 != 0 || d < 8) return false;
  const int nvec = d / elems;
  int w = 1;
  while (w < kWarpsPerBlock && w * 32 * target < nvec) w *= 2;
  const int per_lane = (nvec + 32 * w - 1) / (32 * w);
  if (per_lane > kVecsPerLane) return false;
  int v = 1;
  while (v < per_lane) v *= 2;
  *warps = w;
  *vpt = v;
  return true;
}

template <typename T, typename S, int VPT>
void launch_fwd(int rows, int w, const void* x, const void* scale, void* y,
                int d, float eps, cudaStream_t st) {
  rms_norm_kernel<T, S, VPT><<<rows, 32 * w, 0, st>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), d, eps);
}

template <typename T, typename S>
void launch_fwd(int rows, int w, int vpt, const void* x, const void* scale,
                void* y, int d, float eps, cudaStream_t st) {
  switch (vpt) {
    case 1: return launch_fwd<T, S, 1>(rows, w, x, scale, y, d, eps, st);
    case 2: return launch_fwd<T, S, 2>(rows, w, x, scale, y, d, eps, st);
    case 4: return launch_fwd<T, S, 4>(rows, w, x, scale, y, d, eps, st);
    default: return launch_fwd<T, S, 8>(rows, w, x, scale, y, d, eps, st);
  }
}

// The backward's grid: R = rows a block at once (more when the rows
// outnumber the cap, up to what kWarpsPerBlock warps hold), then as many
// passes as the cap needs and the fewest blocks that cover the rows in
// that many (8192 rows, 2 a block, cap 264: 256 blocks of 16 passes).
struct BwdShape {
  int warps_per_row, vpt, rows_per_block, blocks;
};

bool bwd_shape(int rows, int d, int elems, int max_blocks, BwdShape* out) {
  if (rows < 1 || max_blocks < 1) return false;
  // With no more rows than blocks, a row is one block, spread wide.
  const int target = rows <= max_blocks ? 1 : kBwdVecs;
  int w, vpt;
  if (!row_split(d, elems, target, &w, &vpt)) return false;
  int r = rows / max_blocks;
  r = r < 1 ? 1 : (r > kWarpsPerBlock / w ? kWarpsPerBlock / w : r);
  const int groups = (rows + r - 1) / r;
  const int passes = (groups + max_blocks - 1) / max_blocks;
  *out = {w, vpt, r, (groups + passes - 1) / passes};
  return true;
}

template <typename T, typename S, int VPT>
cudaError_t launch_bwd(const BwdShape& sh, const void* x, const void* scale,
                       const void* g, void* dx, void* partial, int rows,
                       int d, float eps, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto kernel = rms_norm_bwd_kernel<T, S, VPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<sh.blocks, sh.rows_per_block * sh.warps_per_row * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, d, eps, sh.warps_per_row);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_bwd(const BwdShape& sh, const void* x, const void* scale,
                       const void* g, void* dx, void* dscale, void* partial,
                       int rows, int d, float eps, cudaStream_t st) {
  cudaError_t e;
  switch (sh.vpt) {
    case 1:
      e = launch_bwd<T, S, 1>(sh, x, scale, g, dx, partial, rows, d, eps, st);
      break;
    case 2:
      e = launch_bwd<T, S, 2>(sh, x, scale, g, dx, partial, rows, d, eps, st);
      break;
    case 4:
      e = launch_bwd<T, S, 4>(sh, x, scale, g, dx, partial, rows, d, eps, st);
      break;
    default:
      e = launch_bwd<T, S, 8>(sh, x, scale, g, dx, partial, rows, d, eps, st);
  }
  if (e != cudaSuccess) return e;
  rms_norm_bwd_reduce_kernel<S><<<(d + 31) / 32, kReduceWarps * 32, 0, st>>>(
      static_cast<const float*>(partial), static_cast<S*>(dscale), sh.blocks,
      d);
  return cudaGetLastError();
}

}  // namespace

// y = rms_norm(x, scale): x and y [rows, d] bf16 (x_is_bf16) or f32, the
// scale [d] bf16 (scale_is_bf16) or f32.
extern "C" int kft_rms_norm(const void* x, const void* scale, void* y,
                            int rows, int d, float eps, int x_is_bf16,
                            int scale_is_bf16, void* stream) {
  int w, vpt;
  if (rows < 1 || !row_split(d, x_is_bf16 ? 8 : 4, 1, &w, &vpt))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (x_is_bf16 && scale_is_bf16)
    launch_fwd<B, B>(rows, w, vpt, x, scale, y, d, eps, s);
  else if (x_is_bf16)
    launch_fwd<B, float>(rows, w, vpt, x, scale, y, d, eps, s);
  else if (scale_is_bf16)
    launch_fwd<float, B>(rows, w, vpt, x, scale, y, d, eps, s);
  else
    launch_fwd<float, float>(rows, w, vpt, x, scale, y, d, eps, s);
  return static_cast<int>(cudaGetLastError());
}

// (dx, dscale) of rms_norm for the cotangent g: x, g and dx [rows, d] of
// one dtype, scale and dscale [d] of one dtype, partial an f32 workspace of
// at least [min(rows, max_blocks), d].  Two launches: the row kernel, then
// the workspace sum.
extern "C" int kft_rms_norm_bwd(const void* x, const void* scale,
                                const void* g, void* dx, void* dscale,
                                void* partial, int rows, int d, float eps,
                                int x_is_bf16, int scale_is_bf16,
                                int max_blocks, void* stream) {
  BwdShape sh;
  if (!bwd_shape(rows, d, x_is_bf16 ? 8 : 4, max_blocks, &sh))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  cudaError_t e;
  if (x_is_bf16 && scale_is_bf16)
    e = launch_bwd<B, B>(sh, x, scale, g, dx, dscale, partial, rows, d, eps,
                         s);
  else if (x_is_bf16)
    e = launch_bwd<B, float>(sh, x, scale, g, dx, dscale, partial, rows, d,
                             eps, s);
  else if (scale_is_bf16)
    e = launch_bwd<float, B>(sh, x, scale, g, dx, dscale, partial, rows, d,
                             eps, s);
  else
    e = launch_bwd<float, float>(sh, x, scale, g, dx, dscale, partial, rows,
                                 d, eps, s);
  return static_cast<int>(e);
}

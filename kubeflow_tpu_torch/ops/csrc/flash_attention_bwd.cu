// Flash attention backward for Hopper, BSHD layout, bf16: two kernels,
// dq and dk/dv (FlashAttention-2), deterministic, no atomics.
//
// Replaces: kubeflow_tpu/ops/pallas/flash_attention.py `_flash_bwd`, its
// dq pass `_dq_kernel` and its dk/dv pass `_dkv_kernel` (tile math
// `_bwd_tile`).  Same semantics per (query row i, key j):
//   P   = exp(S * scale - lse_i), zero where masked,
//   dP  = dO V^T,  delta_i = rowsum(dO_i * O_i) - g_lse_i,
//   dS  = P * (dP - delta_i) * scale,
//   dQ  = dS K,  dK = dS^T Q,  dV = P^T dO,
// with the forward's masks: end-aligned causal (i + sk - sq >= j), dead
// tiles skipped, `segment_ids` equality.  GQA: dK and dV of a kv head sum
// over the q heads of its group inside one block (the reference writes a
// [b, hq, sk, d] intermediate and sums it afterwards).
//
// What bounds it on the H100: the tensor-core work.  dq does 3 products
// per visible (i, j) pair (S, dP, dQ) and dk/dv 4 (S, dP, dV, dK), each
// 2*d flops, against q, k, v, o, dO read once and dq, dk, dv written once:
// at b1 s8192 h16 d128 causal that is ~412 and ~550 GFLOP against
// ~0.26 GB, three orders of magnitude past the 295 flop/byte ridge.
//
// Design, and what it does about that:
// * dq kernel: one block of 4 warps per (64 query rows, head, batch); each
//   warp owns 16 rows and keeps their Q and dO fragments and the dQ
//   accumulator in registers; K and V tiles of 64 keys are staged in shared
//   memory.  It also computes delta for its rows (O read once, beside dO
//   already in registers), subtracts g_lse, and writes delta [b, hq, sq]
//   f32 for the dk/dv kernel, which the wrapper launches after it on the
//   same stream.
// * dk/dv kernel: one block per (64 keys, kv head, batch); each warp owns
//   16 keys and their dK and dV accumulators (2 x D/2 f32 registers a
//   thread).  K and V stay in shared memory and are read as A fragments
//   (in registers they would not fit beside the accumulators); the block
//   loops over the q heads of the group and over 64-row tiles of Q and dO
//   staged in shared memory (dynamic, 70 KB at d = 128).
// * Register pressure: neither kernel holds a whole S or dP tile.  Both
//   walk 16-key (dq) or 16-query (dk/dv) slabs: S and dP for one slab are
//   2 x 8 f32 registers, re-packed in registers as the bf16 A operand of
//   the next product.  P and dS are rounded to bf16 there, which the
//   reference's f32 products do not do.
// * Ragged lengths: rows past sq and keys past sk are zero-filled, masked
//   and not written.  Dead causal slabs are skipped per warp.
// * mma.sync m16n8k16 bf16 -> f32; B operands taken along the key or
//   query axis are built from 16-bit shared loads.  wgmma, TMA and a
//   pipeline are later work: this is the simple, correct first version.
#include "kft_common.cuh"

namespace {

using kft::ld32;
using kft::mma16816;
using kft::pack2;
using kft::pack_bf16x2;

constexpr int kWarps = 4;
constexpr int kRows = 64;   // rows a block owns: q rows (dq), keys (dk/dv)
constexpr int kTile = 64;   // rows staged a step: keys (dq), q rows (dk/dv)
constexpr int kPad = 8;     // bf16 elements of padding per shared-memory row

// A fragment of rows [r, r + 16) x columns [c, c + 16) of a shared tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a,
                                       const __nv_bfloat16 (*tile)[LD],
                                       int r, int c, int g, int t) {
  a[0] = ld32(&tile[r + g][c + 2 * t]);
  a[1] = ld32(&tile[r + g + 8][c + 2 * t]);
  a[2] = ld32(&tile[r + g][c + 2 * t + 8]);
  a[3] = ld32(&tile[r + g + 8][c + 2 * t + 8]);
}

// Two m16n8 accumulators (16 x 16) re-packed as one bf16 A fragment.
__device__ __forceinline__ void pack_a(uint32_t* a, const float (*c)[4]) {
  a[0] = pack_bf16x2(c[0][0], c[0][1]);
  a[1] = pack_bf16x2(c[0][2], c[0][3]);
  a[2] = pack_bf16x2(c[1][0], c[1][1]);
  a[3] = pack_bf16x2(c[1][2], c[1][3]);
}

// acc[j] += A (16 x 16) * tile[r0 .. r0 + 16)[j * 8 .. j * 8 + 8): the B
// operand runs down the tile's rows, so it is built from 16-bit loads.
template <int D, int LD>
__device__ __forceinline__ void mma_rows(float (*acc)[4], const uint32_t* a,
                                         const __nv_bfloat16 (*tile)[LD],
                                         int r0, int g, int t) {
  const int r = r0 + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + g;
    const uint32_t b0 = pack2(tile[r][col], tile[r + 1][col]);
    const uint32_t b1 = pack2(tile[r + 8][col], tile[r + 9][col]);
    mma16816(acc[j], a, b0, b1);
  }
}

// Stage rows [start, start + 64) of head `head` of a [b, s, heads, D]
// tensor into a shared tile of 64 rows (kRows = kTile), zeros past s.
template <int D, int LD>
__device__ __forceinline__ void stage(__nv_bfloat16 (*tile)[LD],
                                      const __nv_bfloat16* __restrict__ x,
                                      int bi, int start, int s, int heads,
                                      int head, int tid) {
  static_assert(kRows == kTile, "stage() fills 64-row tiles of both kinds");
  for (int idx = tid; idx < kTile * (D / 8); idx += kWarps * 32) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int row = start + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < s)
      val = *reinterpret_cast<const uint4*>(
          x + ((size_t)(bi * s + row) * heads + head) * D + c);
    *reinterpret_cast<uint4*>(&tile[r][c]) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ o,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ glse,
                    const int* __restrict__ seg,
                    __nv_bfloat16* __restrict__ dq,
                    float* __restrict__ delta, int sq, int sk, int hq, int hk,
                    int causal, float scale) {
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int LD = D + kPad;

  __shared__ __align__(16) __nv_bfloat16 ks[kTile][LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile][LD];
  __shared__ int kseg[kTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kh = h / (hq / hk);
  const int q_start = blockIdx.x * kRows;
  const int warp_row = q_start + warp * 16;
  const int r0 = warp_row + g;  // this thread's two rows
  const int r1 = r0 + 8;
  const int offset = causal ? sk - sq : 0;

  // Q and dO fragments (A operands), zero past sq; delta partials from
  // the same dO values and O at the same positions.
  uint32_t qa[KD][4], da[KD][4];
  float dl0 = 0.f, dl1 = 0.f;
  {
    const size_t o0 = ((size_t)(bi * sq + r0) * hq + h) * D;
    const size_t o1 = ((size_t)(bi * sq + r1) * hq + h) * D;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = r0 < sq ? ld32(q + o0 + c) : 0u;
      qa[kk][1] = r1 < sq ? ld32(q + o1 + c) : 0u;
      qa[kk][2] = r0 < sq ? ld32(q + o0 + c + 8) : 0u;
      qa[kk][3] = r1 < sq ? ld32(q + o1 + c + 8) : 0u;
      da[kk][0] = r0 < sq ? ld32(dout + o0 + c) : 0u;
      da[kk][1] = r1 < sq ? ld32(dout + o1 + c) : 0u;
      da[kk][2] = r0 < sq ? ld32(dout + o0 + c + 8) : 0u;
      da[kk][3] = r1 < sq ? ld32(dout + o1 + c + 8) : 0u;
      if (r0 < sq) {
        const float2 a = kft::unpack_bf16x2(da[kk][0]);
        const float2 b = kft::unpack_bf16x2(ld32(o + o0 + c));
        const float2 a8 = kft::unpack_bf16x2(da[kk][2]);
        const float2 b8 = kft::unpack_bf16x2(ld32(o + o0 + c + 8));
        dl0 += a.x * b.x + a.y * b.y + a8.x * b8.x + a8.y * b8.y;
      }
      if (r1 < sq) {
        const float2 a = kft::unpack_bf16x2(da[kk][1]);
        const float2 b = kft::unpack_bf16x2(ld32(o + o1 + c));
        const float2 a8 = kft::unpack_bf16x2(da[kk][3]);
        const float2 b8 = kft::unpack_bf16x2(ld32(o + o1 + c + 8));
        dl1 += a.x * b.x + a.y * b.y + a8.x * b8.x + a8.y * b8.y;
      }
    }
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, o_);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, o_);
  }
  const size_t lrow = ((size_t)bi * hq + h) * sq;
  const float lse0 = r0 < sq ? lse[lrow + r0] : 0.f;
  const float lse1 = r1 < sq ? lse[lrow + r1] : 0.f;
  if (glse != nullptr) {
    dl0 -= r0 < sq ? glse[lrow + r0] : 0.f;
    dl1 -= r1 < sq ? glse[lrow + r1] : 0.f;
  }
  if (t == 0) {
    if (r0 < sq) delta[lrow + r0] = dl0;
    if (r1 < sq) delta[lrow + r1] = dl1;
  }
  int qs0 = 0, qs1 = 0;
  if (seg != nullptr) {
    qs0 = r0 < sq ? seg[bi * sq + r0] : 0;
    qs1 = r1 < sq ? seg[bi * sq + r1] : 0;
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int kv_end = sk;
  if (causal) kv_end = min(sk, min(q_start + kRows, sq) - 1 + offset + 1);
  const bool warp_live = warp_row < sq;
  const int warp_last = min(warp_row + 15, sq - 1) + offset;  // causal reach

  for (int k_start = 0; k_start < kv_end; k_start += kTile) {
    stage<D, LD>(ks, k, bi, k_start, sk, hk, kh, tid);
    stage<D, LD>(vs, v, bi, k_start, sk, hk, kh, tid);
    if (seg != nullptr) {
      for (int r = tid; r < kTile; r += kWarps * 32) {
        const int key = k_start + r;
        kseg[r] = key < sk ? seg[bi * sk + key] : 0;
      }
    }
    __syncthreads();
    if (warp_live) {
#pragma unroll 1
      for (int sl = 0; sl < kTile / 16; ++sl) {
        if (causal && k_start + sl * 16 > warp_last) break;
        float s[2][4], dp[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int r = sl * 16 + n * 8 + g, c = kk * 16 + t * 2;
            const __nv_bfloat16* kr = &ks[r][c];
            const __nv_bfloat16* vr = &vs[r][c];
            mma16816(s[n], qa[kk], ld32(kr), ld32(kr + 8));
            mma16816(dp[n], da[kk], ld32(vr), ld32(vr + 8));
          }
        }
        // dS = P * (dP - delta) * scale, P recomputed from the lse.
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = sl * 16 + n * 8 + t * 2 + (e & 1);
            const int key = k_start + col;
            const int row = e < 2 ? r0 : r1;
            bool ok = key < sk && row < sq;
            if (causal) ok = ok && (row + offset >= key);
            if (seg != nullptr) ok = ok && ((e < 2 ? qs0 : qs1) == kseg[col]);
            const float p =
                ok ? __expf(s[n][e] * scale - (e < 2 ? lse0 : lse1)) : 0.f;
            s[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1)) * scale;
          }
        }
        uint32_t dsa[4];
        pack_a(dsa, s);
        mma_rows<D, LD>(acc, dsa, ks, sl * 16, g, t);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* d0 = dq + ((size_t)(bi * sq + r0) * hq + h) * D;
  __nv_bfloat16* d1 = dq + ((size_t)(bi * sq + r1) * hq + h) * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + t * 2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(d0 + c) = pack_bf16x2(acc[j][0], acc[j][1]);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(d1 + c) = pack_bf16x2(acc[j][2], acc[j][3]);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * kRows + 2 * kTile) * (D + kPad) * 2 +
         (size_t)3 * kTile * 4;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int sq, int sk, int hq,
                     int hk, int causal, float scale) {
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int LD = D + kPad;

  extern __shared__ __align__(16) unsigned char smem[];
  auto ks = reinterpret_cast<__nv_bfloat16(*)[LD]>(smem);
  auto vs = ks + kRows;
  auto qs = vs + kRows;
  auto dos = qs + kTile;
  float* lse_s = reinterpret_cast<float*>(dos + kTile);
  float* del_s = lse_s + kTile;
  int* qseg_s = reinterpret_cast<int*>(del_s + kTile);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kh = blockIdx.y, bi = blockIdx.z;
  const int n_rep = hq / hk;
  const int k_start = blockIdx.x * kRows;
  const int warp_key = k_start + warp * 16;
  const int key0 = warp_key + g;  // this thread's two keys
  const int key1 = key0 + 8;
  const int offset = causal ? sk - sq : 0;

  stage<D, LD>(ks, k, bi, k_start, sk, hk, kh, tid);
  stage<D, LD>(vs, v, bi, k_start, sk, hk, kh, tid);
  int kseg0 = 0, kseg1 = 0;
  if (seg != nullptr) {
    kseg0 = key0 < sk ? seg[bi * sk + key0] : 0;
    kseg1 = key1 < sk ? seg[bi * sk + key1] : 0;
  }

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  // Causal: query rows below k_start - offset see none of these keys.
  const int q_begin =
      causal ? (max(0, k_start - offset) / kTile) * kTile : 0;
  const bool warp_live = warp_key < sk;

  for (int hr = 0; hr < n_rep; ++hr) {
    const int h = kh * n_rep + hr;
    const size_t lrow = ((size_t)bi * hq + h) * sq;
    for (int q_start = q_begin; q_start < sq; q_start += kTile) {
      __syncthreads();  // the previous tile's readers are done
      stage<D, LD>(qs, q, bi, q_start, sq, hq, h, tid);
      stage<D, LD>(dos, dout, bi, q_start, sq, hq, h, tid);
      for (int r = tid; r < kTile; r += kWarps * 32) {
        const int row = q_start + r;
        const bool in = row < sq;
        lse_s[r] = in ? lse[lrow + row] : 0.f;
        del_s[r] = in ? delta[lrow + row] : 0.f;
        qseg_s[r] = (in && seg != nullptr) ? seg[bi * sq + row] : 0;
      }
      __syncthreads();
      if (!warp_live) continue;
#pragma unroll 1
      for (int sl = 0; sl < kTile / 16; ++sl) {
        const int qb = q_start + sl * 16;
        if (qb >= sq) break;
        if (causal && qb + 15 + offset < warp_key) continue;
        // S^T and dP^T for this warp's 16 keys x 16 query rows.
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t ak[4], av[4];
          load_a<LD>(ak, ks, warp * 16, kk * 16, g, t);
          load_a<LD>(av, vs, warp * 16, kk * 16, g, t);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int r = sl * 16 + n * 8 + g, c = kk * 16 + t * 2;
            const __nv_bfloat16* qr = &qs[r][c];
            const __nv_bfloat16* dr = &dos[r][c];
            mma16816(st[n], ak, ld32(qr), ld32(qr + 8));
            mma16816(dpt[n], av, ld32(dr), ld32(dr + 8));
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = sl * 16 + n * 8 + t * 2 + (e & 1);
            const int row = q_start + qc;
            const int key = e < 2 ? key0 : key1;
            bool ok = row < sq && key < sk;
            if (causal) ok = ok && (row + offset >= key);
            if (seg != nullptr)
              ok = ok && (qseg_s[qc] == (e < 2 ? kseg0 : kseg1));
            const float p = ok ? __expf(st[n][e] * scale - lse_s[qc]) : 0.f;
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - del_s[qc]) * scale;
          }
        }
        uint32_t pa[4], dsa[4];
        pack_a(pa, st);
        pack_a(dsa, dpt);
        mma_rows<D, LD>(dva, pa, dos, sl * 16, g, t);
        mma_rows<D, LD>(dka, dsa, qs, sl * 16, g, t);
      }
    }
  }

  __nv_bfloat16* k0 = dk + ((size_t)(bi * sk + key0) * hk + kh) * D;
  __nv_bfloat16* k1 = dk + ((size_t)(bi * sk + key1) * hk + kh) * D;
  __nv_bfloat16* v0 = dv + ((size_t)(bi * sk + key0) * hk + kh) * D;
  __nv_bfloat16* v1 = dv + ((size_t)(bi * sk + key1) * hk + kh) * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + t * 2;
    if (key0 < sk) {
      *reinterpret_cast<uint32_t*>(k0 + c) = pack_bf16x2(dka[j][0], dka[j][1]);
      *reinterpret_cast<uint32_t*>(v0 + c) = pack_bf16x2(dva[j][0], dva[j][1]);
    }
    if (key1 < sk) {
      *reinterpret_cast<uint32_t*>(k1 + c) = pack_bf16x2(dka[j][2], dka[j][3]);
      *reinterpret_cast<uint32_t*>(v1 + c) = pack_bf16x2(dva[j][2], dva[j][3]);
    }
  }
}

template <int D>
int launch_dkv(dim3 grid, cudaStream_t s, const __nv_bfloat16* q,
               const __nv_bfloat16* k, const __nv_bfloat16* v,
               const __nv_bfloat16* dout, const float* lse,
               const float* delta, const int* seg, __nv_bfloat16* dk,
               __nv_bfloat16* dv, int sq, int sk, int hq, int hk, int causal,
               float scale) {
  constexpr size_t bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D><<<grid, kWarps * 32, bytes, s>>>(
      q, k, v, dout, lse, delta, seg, dk, dv, sq, sk, hq, hk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dQ and delta = rowsum(dO * O) - g_lse ([b, hq, sq] f32; g_lse may be
// null).  Launch before kft_flash_attention_bwd_dkv, which reads delta.
extern "C" int kft_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* glse, const void* seg,
    void* dq, void* delta, int b, int sq, int sk, int hq, int hk, int d,
    int causal, float scale, void* stream) {
  dim3 grid((sq + kRows - 1) / kRows, hq, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const auto* q_ = static_cast<const bf*>(q);
  const auto* k_ = static_cast<const bf*>(k);
  const auto* v_ = static_cast<const bf*>(v);
  const auto* o_ = static_cast<const bf*>(o);
  const auto* do_ = static_cast<const bf*>(dout);
  const auto* lse_ = static_cast<const float*>(lse);
  const auto* glse_ = static_cast<const float*>(glse);
  const auto* seg_ = static_cast<const int*>(seg);
  auto* dq_ = static_cast<bf*>(dq);
  auto* delta_ = static_cast<float*>(delta);
  if (d == 128) {
    flash_bwd_dq_kernel<128><<<grid, kWarps * 32, 0, s>>>(
        q_, k_, v_, o_, do_, lse_, glse_, seg_, dq_, delta_, sq, sk, hq, hk,
        causal, scale);
  } else if (d == 64) {
    flash_bwd_dq_kernel<64><<<grid, kWarps * 32, 0, s>>>(
        q_, k_, v_, o_, do_, lse_, glse_, seg_, dq_, delta_, sq, sk, hq, hk,
        causal, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dK and dV [b, sk, hk, d], each the sum over the q heads of its group.
extern "C" int kft_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg, void* dk, void* dv,
    int b, int sq, int sk, int hq, int hk, int d, int causal, float scale,
    void* stream) {
  dim3 grid((sk + kRows - 1) / kRows, hk, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const auto* q_ = static_cast<const bf*>(q);
  const auto* k_ = static_cast<const bf*>(k);
  const auto* v_ = static_cast<const bf*>(v);
  const auto* do_ = static_cast<const bf*>(dout);
  const auto* lse_ = static_cast<const float*>(lse);
  const auto* delta_ = static_cast<const float*>(delta);
  const auto* seg_ = static_cast<const int*>(seg);
  auto* dk_ = static_cast<bf*>(dk);
  auto* dv_ = static_cast<bf*>(dv);
  if (d == 128)
    return launch_dkv<128>(grid, s, q_, k_, v_, do_, lse_, delta_, seg_, dk_,
                           dv_, sq, sk, hq, hk, causal, scale);
  if (d == 64)
    return launch_dkv<64>(grid, s, q_, k_, v_, do_, lse_, delta_, seg_, dk_,
                          dv_, sq, sk, hq, hk, causal, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

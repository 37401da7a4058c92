// Flash attention backward for Hopper, BSHD layout, bf16: two kernels,
// dq and dk/dv (FlashAttention-2's split), deterministic, no atomics.
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
// dq kernel (K3): one block of 4 warps per (64 query rows, head, batch);
// each warp owns 16 rows and keeps their Q and dO fragments and the dQ
// accumulator in registers; K and V tiles of 64 keys are staged in shared
// memory by the block's threads, and the products run on mma.sync
// m16n8k16 (B operands along the key axis from 16-bit shared loads).  It
// also computes delta for its rows (O read once, beside dO already in
// registers), subtracts g_lse, and writes delta [b, hq, sq] f32 for the
// dk/dv kernel, which the wrapper launches after it on the same stream.
//
// dk/dv kernel (K4), on wgmma with a TMA pipeline:
// * One block of 288 threads per (128 keys, kv head, batch): two consumer
//   warpgroups of 64 keys each and one producer warp that issues every
//   load.  K and V for the block's keys are loaded once by TMA and stay
//   in shared memory.
// * The producer walks the q heads of the GQA group and, from the first
//   causally live one, the 64-row tiles of Q and dO, through a ring of
//   kDkvStages stages with full/empty mbarriers; the tile's lse and delta
//   rows and q segment ids go beside them in the stage.  It walks them
//   twice, once for each pass of the consumers.
// * Two passes: dV += P^T dO over every tile, then dK += dS^T Q.  One
//   64 keys x d f32 accumulator at a time (d / 2 registers a thread)
//   fits beside the S^T and dP^T slabs.  A block of more than 8 warps
//   puts 3 warps on one of the SM's 4 schedulers, whose share of the
//   register file (16384) then allows 168 registers a thread; dK and dV
//   together (d registers at d = 128) with the slabs spilled and made
//   ptxas serialise the wgmmas.  The price is S^T computed twice: 5
//   products per tile, not 4.
// * Per tile, every product is wgmma, in slabs of 32 q rows: S^T = K Q^T
//   and dP^T = V dO^T (m64n32k16, both operands in shared memory, Q and
//   dO K-major), then dV += P^T dO or dK += dS^T Q (m64n{d}k16, P^T or
//   dS^T re-packed as bf16 from the accumulators in registers, dO or Q
//   from shared memory with the transpose bit).  One slab's product into
//   dV or dK runs while the next slab's S^T and dP^T are issued.
// * dK and dV sum over the q heads of the group in f32 registers, inside
//   the block, in a fixed order, so the result is deterministic.
// * The per-element mask runs only on tiles that cross the causal
//   diagonal, reach past sq, or carry segment ids; with segment ids a q
//   tile that shares no id with the block's keys is neither loaded nor
//   computed (every pair in it is masked).  The
//   producer tests 32 q tiles at a time (`hw::IdSet`, as the forward
//   does), with all 32 tiles' id loads in flight; a consumer warpgroup
//   also passes over a live tile that shares no id with its own 64 keys.
//   Blocks are ordered longest first (lowest keys) across all heads.
// * P and dS are rounded to bf16 to feed the tensor cores, which the
//   reference's f32 products do not do.
#include <limits.h>

#include "kft_common.cuh"
#include "kft_hopper.cuh"

namespace {

using kft::ld32;
using kft::mma16816;
using kft::pack2;
using kft::pack_bf16x2;
namespace hw = kft::hopper;

// dq kernel.
constexpr int kWarps = 4;
constexpr int kRows = 64;   // q rows a block owns
constexpr int kTile = 64;   // keys staged a step
constexpr int kPad = 8;     // bf16 elements of padding per shared-memory row

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


// dk/dv kernel.
constexpr int kDkvKeys = 128;  // keys per block (64 per consumer)
constexpr int kDkvRows = 64;   // q rows per streamed tile
constexpr int kHalf = 32;      // q rows per S^T / dP^T product
constexpr int kDkvStages = 2;  // q/dO ring depth (3 measured slower)
constexpr int kConsumers = 2;  // consumer warpgroups
// Two consumer warpgroups and one producer warp: 288 threads.
constexpr int kDkvThreads = kConsumers * 128 + 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct DkvSmem {
  static constexpr int NCB = D / 64;  // 64-column blocks of a row
  alignas(1024) __nv_bfloat16 k[NCB][kDkvKeys * 64];
  alignas(1024) __nv_bfloat16 v[NCB][kDkvKeys * 64];
  alignas(1024) __nv_bfloat16 q[kDkvStages][NCB][kDkvRows * 64];
  alignas(1024) __nv_bfloat16 dout[kDkvStages][NCB][kDkvRows * 64];
  float lse[kDkvStages][kDkvRows];
  float delta[kDkvStages][kDkvRows];
  int qseg[kDkvStages][kDkvRows];
  hw::IdSet qset[kDkvStages];       // the ids of the stage's q rows
  hw::IdSet wgset[kConsumers][4];   // scratch: each consumer's key ids
  int tile[kDkvStages];  // first q row of the stage, -1 after the last
  uint64_t kv_full;
  uint64_t full[kDkvStages];
  uint64_t empty[kDkvStages];
};

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(DkvSmem<D>) + 1024;  // +1024 to align the base
}

// acc (64 keys x D) += A (64 keys x 16 q rows, registers) * B (16 q rows
// x D, shared, MN-major).
template <int D>
__device__ __forceinline__ void wgmma_acc(float* acc, const uint32_t* a,
                                          uint64_t b) {
  if constexpr (D == 128) hw::wgmma_m64n128k16_rs(acc, a, b, 1);
  else hw::wgmma_m64n64k16_rs(acc, a, b, 1);
}

// An m64n32 accumulator (n-tile pairs) -> bf16 A fragments of 16 q rows.
__device__ __forceinline__ void pack_rows(uint32_t (*a)[4], const float* c) {
#pragma unroll
  for (int kk = 0; kk < kHalf / 16; ++kk) {
    a[kk][0] = pack_bf16x2(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// The producer warp: the K and V loads once, then the Q and dO loads of
// every live q tile of every q head of the group, with their lse, delta
// and segment ids.  With segment ids it tests 32 q tiles at a time
// (`hw::live_tiles`: their ids against the block's keys') and loads the
// live ones for each head.
template <int D>
__device__ __forceinline__ void dkv_producer(
    DkvSmem<D>& sm, const CUtensorMap* tq, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, int bi, int kh, int k0, int sq, int sk,
    int hq, int hk, int causal, int lane) {
  constexpr int NCB = DkvSmem<D>::NCB;
  const int n_rep = hq / hk;
  const int offset = causal ? sk - sq : 0;
  int stage = 0;
  uint32_t phase = 0;
  // One q tile of head h into the ring.
  auto load = [&](int h, int q0) {
    const size_t lrow = ((size_t)bi * hq + h) * sq;
    float l_[kDkvRows / 32], d_[kDkvRows / 32];
    int ids[kDkvRows / 32];
#pragma unroll
    for (int i = 0; i < kDkvRows / 32; ++i) {
      const int row = q0 + lane + 32 * i;
      const bool in = row < sq;
      l_[i] = in ? lse[lrow + row] * kLog2e : 0.f;
      d_[i] = in ? delta[lrow + row] : 0.f;
      ids[i] = (in && seg != nullptr) ? seg[bi * sq + row] : 0;
    }
    hw::mbar_wait(&sm.empty[stage], phase ^ 1);
    hw::IdSet set = hw::IdSet::empty();
#pragma unroll
    for (int i = 0; i < kDkvRows / 32; ++i) {
      sm.lse[stage][lane + 32 * i] = l_[i];
      sm.delta[stage][lane + 32 * i] = d_[i];
      sm.qseg[stage][lane + 32 * i] = ids[i];
      if (q0 + lane + 32 * i < sq) set.add(ids[i]);
    }
    if (seg != nullptr) {
      set.warp_reduce();
      if (lane == 0) sm.qset[stage] = set;
    }
    __syncwarp();
    if (lane == 0) {
      sm.tile[stage] = q0;
      hw::mbar_arrive_expect_tx(&sm.full[stage], 2 * NCB * kDkvRows * 128);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        hw::tma_load_4d(sm.q[stage][cb], tq, &sm.full[stage], cb * 64, h, q0,
                        bi);
        hw::tma_load_4d(sm.dout[stage][cb], tdo, &sm.full[stage], cb * 64, h,
                        q0, bi);
      }
    }
    if (++stage == kDkvStages) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (lane == 0) {
    hw::tma_prefetch_map(tq);
    hw::tma_prefetch_map(tdo);
    hw::mbar_arrive_expect_tx(&sm.kv_full, 2 * NCB * kDkvKeys * 128);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      hw::tma_load_4d(sm.k[cb], tk, &sm.kv_full, cb * 64, kh, k0, bi);
      hw::tma_load_4d(sm.v[cb], tv, &sm.kv_full, cb * 64, kh, k0, bi);
    }
  }
  // Causal: query rows below k0 - offset see none of these keys.
  const int t_begin = causal ? max(0, k0 - offset) / kDkvRows : 0;
  const int n_qt = (sq + kDkvRows - 1) / kDkvRows;
  const hw::IdSet kset =
      seg != nullptr
          ? hw::warp_id_set<kDkvKeys / 32>(seg + bi * sk, sk, k0, lane)
          : hw::IdSet::empty();
  // The same tiles twice: the consumers' dV pass, then their dK pass,
  // each closed by an end mark (tile -1).
  for (int pass = 0; pass < 2; ++pass) {
    if (seg == nullptr) {
      for (int hr = 0; hr < n_rep; ++hr)
        for (int qt = t_begin; qt < n_qt; ++qt)
          load(kh * n_rep + hr, qt * kDkvRows);
    } else {
      for (int first = t_begin; first < n_qt; first += 32) {
        const uint32_t bits = hw::live_tiles<kDkvRows, 32>(
            seg + bi * sq, sq, first, min(32, n_qt - first), kset, lane);
        for (int hr = 0; hr < n_rep; ++hr)
          for (uint32_t b = bits; b != 0u; b &= b - 1)
            load(kh * n_rep + hr, (first + __ffs(b) - 1) * kDkvRows);
      }
    }
    hw::mbar_wait(&sm.empty[stage], phase ^ 1);
    if (lane == 0) {
      sm.tile[stage] = -1;
      hw::mbar_arrive(&sm.full[stage]);
    }
    if (++stage == kDkvStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// What a consumer warpgroup keeps across the tiles of a pass.
struct DkvRows {
  int key0, key1;    // this thread's two keys
  int key_base;      // the warpgroup's first key
  int kseg0, kseg1;  // their segment ids
  hw::IdSet keys;    // the warpgroup's key ids
  bool live;         // the warpgroup has a key below sk
};

// One pass of a consumer warpgroup over the producer's tiles, up to the
// end mark: acc (64 keys x D) += P^T dO (DK false) or dS^T Q (DK true).
// The pass is a template argument so no wgmma sits on a runtime branch.
template <int D, bool DK>
__device__ __forceinline__ void dkv_pass(
    DkvSmem<D>& sm, float* acc, const DkvRows& r, const int* __restrict__ seg,
    uint32_t k_base, uint32_t v_base, int sq, int causal, int offset,
    float scale, int t, int lane, int& stage, uint32_t& phase) {
  constexpr int KD = D / 16;          // k-steps of K Q^T and V dO^T
  constexpr int NT = kHalf / 2;       // S^T / dP^T registers a thread
  constexpr int NA = D / 2;           // acc registers a thread
  constexpr uint32_t kKeyBlock = kDkvKeys * 128;  // bytes, one column block
  constexpr uint32_t kRowBlock = kDkvRows * 128;
  const float sl2 = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  while (true) {
    hw::mbar_wait(&sm.full[stage], phase);
    const int q0 = sm.tile[stage];
    if (q0 < 0) break;
    const bool dead =
        !r.live || (causal && q0 + kDkvRows - 1 + offset < r.key_base) ||
        (seg != nullptr && !r.keys.meets(sm.qset[stage]));
    const bool need_mask = seg != nullptr || q0 + kDkvRows > sq ||
                           (causal && q0 + offset < r.key_base + 63);
    if (!dead) {
      const uint32_t q_addr = hw::opaque(hw::smem_u32(sm.q[stage][0]));
      const uint32_t do_addr = hw::opaque(hw::smem_u32(sm.dout[stage][0]));
      const uint32_t k_addr = hw::opaque(k_base);
      const uint32_t v_addr = hw::opaque(v_base);
      const uint32_t b_addr = DK ? q_addr : do_addr;
      const float* lse_s = sm.lse[stage];
      const float* del_s = sm.delta[stage];
      // Slabs of kHalf q rows; a slab's product into acc runs while the
      // next slab's S^T (and dP^T) are issued.
      uint32_t pa[kHalf / 16][4];
#pragma unroll
      for (int half = 0; half < kDkvRows / kHalf; ++half) {
        const uint32_t hoff = half * kHalf * 128;  // bytes: kHalf q rows
        // S^T = K Q^T (and for dK, dP^T = V dO^T): 64 keys x kHalf rows.
        float st[NT], dpt[NT];
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const uint32_t ka = (kk / 4) * kKeyBlock + (kk % 4) * 32;
          const uint32_t qa = (kk / 4) * kRowBlock + (kk % 4) * 32 + hoff;
          hw::wgmma_m64n32k16_ss(st, hw::desc_sw128(k_addr + ka, 16, 1024),
                                 hw::desc_sw128(q_addr + qa, 16, 1024),
                                 kk > 0);
        }
        hw::wgmma_commit();
        if constexpr (DK) {
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            const uint32_t ka = (kk / 4) * kKeyBlock + (kk % 4) * 32;
            const uint32_t qa = (kk / 4) * kRowBlock + (kk % 4) * 32 + hoff;
            hw::wgmma_m64n32k16_ss(dpt,
                                   hw::desc_sw128(v_addr + ka, 16, 1024),
                                   hw::desc_sw128(do_addr + qa, 16, 1024),
                                   kk > 0);
          }
          hw::wgmma_commit();
          // S^T has landed (and the previous slab's product, which read
          // pa); dP^T may still be in flight.
          hw::wgmma_wait<1>();
        } else {
          hw::wgmma_wait<0>();
        }
        hw::fence_regs<NT>(st);
        hw::fence_regs<kHalf / 16 * 4>(&pa[0][0]);

        // P^T = exp2(S^T * sl2 - lse * log2 e), zero where masked.
#pragma unroll
        for (int n = 0; n < kHalf / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = half * kHalf + n * 8 + t * 2 + (e & 1);
            float p = hw::ex2(fmaf(st[4 * n + e], sl2, -lse_s[qc]));
            if (need_mask) {
              const int row = q0 + qc;
              const int key = e < 2 ? r.key0 : r.key1;
              bool ok = row < sq;
              if (causal) ok = ok && (row + offset >= key);
              if (seg != nullptr)
                ok = ok && (sm.qseg[stage][qc] == (e < 2 ? r.kseg0 : r.kseg1));
              if (!ok) p = 0.f;
            }
            st[4 * n + e] = p;
          }
        }
        if constexpr (DK) {
          // dS^T = P^T * (dP^T - delta) * scale.
          hw::wgmma_wait<0>();
          hw::fence_regs<NT>(dpt);
#pragma unroll
          for (int n = 0; n < kHalf / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = half * kHalf + n * 8 + t * 2 + (e & 1);
              st[4 * n + e] *= (dpt[4 * n + e] - del_s[qc]) * scale;
            }
          }
        }
        pack_rows(pa, st);
        // acc += P^T dO or dS^T Q over the slab's rows (dO, Q MN-major).
        hw::fence_regs<NA>(acc);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHalf / 16; ++kk)
          wgmma_acc<D>(acc, pa[kk],
                       hw::desc_sw128(b_addr + hoff + kk * 16 * 128,
                                      kRowBlock, 1024));
        hw::wgmma_commit();
      }
      hw::wgmma_wait<0>();
      hw::fence_regs<NA>(acc);
      hw::fence_regs<kHalf / 16 * 4>(&pa[0][0]);  // read until the wait
    }
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&sm.empty[stage]);
    if (++stage == kDkvStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // The end mark's stage goes back to the producer like a tile's.
  __syncwarp();
  if (lane == 0) hw::mbar_arrive(&sm.empty[stage]);
  if (++stage == kDkvStages) {
    stage = 0;
    phase ^= 1;
  }
}

// acc (64 keys x D) as bf16 rows of out [b, sk, hk, D].
template <int D>
__device__ __forceinline__ void dkv_store(__nv_bfloat16* __restrict__ out,
                                          const float* acc, const DkvRows& r,
                                          int bi, int kh, int sk, int hk,
                                          int t) {
  __nv_bfloat16* r0 = out + ((size_t)(bi * sk + r.key0) * hk + kh) * D;
  __nv_bfloat16* r1 = out + ((size_t)(bi * sk + r.key1) * hk + kh) * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t * 2;
    if (r.key0 < sk)
      *reinterpret_cast<uint32_t*>(r0 + c) =
          pack_bf16x2(acc[4 * n], acc[4 * n + 1]);
    if (r.key1 < sk)
      *reinterpret_cast<uint32_t*>(r1 + c) =
          pack_bf16x2(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// A consumer warpgroup: 64 keys (`wg` 0 or 1 of the block's 128), in two
// passes over the same q tiles: dV += P^T dO, written, then
// dK += dS^T Q.  One accumulator of 64 keys x d at a time (d / 2
// registers a thread) leaves room for S^T and dP^T without spilling;
// the price is S^T computed twice (5 products per tile, not 4).
template <int D>
__device__ __forceinline__ void dkv_consumer(
    DkvSmem<D>& sm, const int* __restrict__ seg,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int bi,
    int kh, int k0, int sq, int sk, int hk, int causal, float scale, int wg,
    int ctid) {
  const int warp = ctid / 32, lane = ctid % 32;
  const int g = lane / 4, t = lane % 4;
  const int offset = causal ? sk - sq : 0;
  DkvRows r;
  r.key_base = k0 + wg * 64;
  r.key0 = r.key_base + warp * 16 + g;
  r.key1 = r.key0 + 8;
  r.live = r.key_base < sk;
  r.kseg0 = r.kseg1 = 0;
  r.keys = hw::IdSet::empty();
  if (seg != nullptr) {
    r.kseg0 = r.key0 < sk ? seg[bi * sk + r.key0] : 0;
    r.kseg1 = r.key1 < sk ? seg[bi * sk + r.key1] : 0;
    if (r.key0 < sk) r.keys.add(r.kseg0);
    if (r.key1 < sk) r.keys.add(r.kseg1);
    r.keys = hw::warpgroup_union(r.keys, sm.wgset[wg], wg, warp, lane);
  }
  const uint32_t k_base = hw::smem_u32(sm.k[0]) + wg * 64 * 128;
  const uint32_t v_base = hw::smem_u32(sm.v[0]) + wg * 64 * 128;
  hw::mbar_wait(&sm.kv_full, 0);

  int stage = 0;
  uint32_t phase = 0;
  float acc[D / 2];
  dkv_pass<D, false>(sm, acc, r, seg, k_base, v_base, sq, causal, offset,
                     scale, t, lane, stage, phase);
  if (r.live) dkv_store<D>(dv, acc, r, bi, kh, sk, hk, t);
  dkv_pass<D, true>(sm, acc, r, seg, k_base, v_base, sq, causal, offset,
                    scale, t, lane, stage, phase);
  if (r.live) dkv_store<D>(dk, acc, r, bi, kh, sk, hk, t);
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int b, int sq, int sk,
                     int hq, int hk, int causal, float scale) {
  using Smem = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  // Lowest keys (the longest causal walk) first, across every (head,
  // batch).
  const int hb = hk * b;
  const int kt = static_cast<int>(blockIdx.x) / hb;
  const int kh = static_cast<int>(blockIdx.x) % hb % hk;
  const int bi = static_cast<int>(blockIdx.x) % hb / hk;
  const int k0 = kt * kDkvKeys;

  if (threadIdx.x == 0) {
    hw::mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      hw::mbar_init(&sm.full[s], 1);
      hw::mbar_init(&sm.empty[s], kConsumers * 4);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    dkv_producer<D>(sm, &tq, &tk, &tv, &tdo, lse, delta, seg, bi, kh, k0, sq,
                    sk, hq, hk, causal, threadIdx.x % 32);
  } else {
    dkv_consumer<D>(sm, seg, dk, dv, bi, kh, k0, sq, sk, hk, causal, scale,
                    wg, threadIdx.x - wg * 128);
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* seg,
               __nv_bfloat16* dk, __nv_bfloat16* dv, int b, int sq, int sk,
               int hq, int hk, int causal, float scale, cudaStream_t stream) {
  namespace hh = kft::hopper_host;
  CUtensorMap tq, tk, tv, tdo;
  int err = hh::encode_bshd(&tq, q, b, sq, hq, D, kDkvRows);
  if (err == 0) err = hh::encode_bshd(&tdo, dout, b, sq, hq, D, kDkvRows);
  if (err == 0) err = hh::encode_bshd(&tk, k, b, sk, hk, D, kDkvKeys);
  if (err == 0) err = hh::encode_bshd(&tv, v, b, sk, hk, D, kDkvKeys);
  if (err != 0) return err;
  constexpr size_t bytes = dkv_smem_bytes<D>();
  static const int attr = hh::allow_smem(flash_bwd_dkv_kernel<D>, bytes);
  if (attr != 0) return attr;
  const int n_ktiles = (sk + kDkvKeys - 1) / kDkvKeys;
  flash_bwd_dkv_kernel<D><<<n_ktiles * hk * b, kDkvThreads, bytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, seg, dk, dv, b, sq, sk, hq, hk, causal,
      scale);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const auto* lse_ = static_cast<const float*>(lse);
  const auto* delta_ = static_cast<const float*>(delta);
  const auto* seg_ = static_cast<const int*>(seg);
  auto* dk_ = static_cast<bf*>(dk);
  auto* dv_ = static_cast<bf*>(dv);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse_, delta_, seg_, dk_, dv_, b,
                           sq, sk, hq, hk, causal, scale, s);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse_, delta_, seg_, dk_, dv_, b, sq,
                          sk, hq, hk, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

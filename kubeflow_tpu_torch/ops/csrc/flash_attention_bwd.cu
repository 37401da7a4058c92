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
// With a packed row's segment ids most pairs are masked and the visible
// ones are few: there the bytes bound it, and only a kernel that skips
// the masked tiles comes near.
//
// dq kernel (K3), on wgmma with a TMA pipeline, the structure of the
// forward's:
// * One block of 288 threads per (128 query rows, q head, batch): two
//   consumer warpgroups of 64 rows each and one producer warp that
//   issues every load.  Q and dO for the block's rows are loaded once by
//   TMA and stay in shared memory.
// * The producer streams K and V tiles of kDqKeys keys, with their
//   segment ids, through a ring of kDqStages stages with full/empty
//   mbarriers, up to the block's causal diagonal.  One TMA load of K
//   serves two products: S = Q K^T reads it K-major, dQ += dS K reads the
//   same tile MN-major (the transpose bit), as the forward reads V.
// * With segment ids the producer loads the always-live diagonal tile
//   first, then tests the others 32 at a time (`hw::live_tiles`: their
//   ids against the block's rows'), from the diagonal down; a tile that
//   shares no id is neither loaded nor computed.  A consumer warpgroup
//   also passes over a live tile that shares no id with its own rows.
// * Per tile, in slabs of kDqSlab keys: S = Q K^T and dP = dO V^T as SS
//   wgmma (all four operands K-major), P and dS in registers, then
//   dQ += dS K as an RS wgmma with dS re-packed as bf16 from the
//   accumulators.  One slab's dQ product runs while the next slab's S
//   and dP are issued; register fences keep the dS fragments live until
//   the wgmma that reads them has completed.  The per-element mask runs
//   only on tiles that cross the diagonal, reach past sq or sk, or carry
//   segment ids.
// * Registers: the dQ accumulator is d / 2 f32 a thread (64 at d = 128),
//   S and dP kDqSlab / 2 each, the packed dS kDqSlab / 4: under the 168
//   a thread of a 9-warp block may hold.  `-Xptxas -v`: 168 registers at
//   d = 128 and 166 at d = 64, no spill, no wgmma-serialisation note.
//   Slabs of 64 keys (32 registers each for S and dP) spilled 540 bytes
//   and made ptxas serialise the wgmmas (C7512) at d = 128.  Dynamic
//   shared memory: 195 KiB at d = 128 (Q and dO 64 KiB, two K/V stages
//   128 KiB), 99 KiB at d = 64.
// * delta = rowsum(dO * O) - g_lse is computed by the consumers before
//   the key loop, from dO in shared memory (read through the swizzle)
//   and O read once with 16-byte loads; it is written to delta [b, hq,
//   sq] f32 for the dk/dv kernel, which the wrapper launches after this
//   one on the same stream.
// * One block owns its rows' dQ and sums the key tiles in a fixed order:
//   deterministic.  Blocks are ordered longest causal tile first, across
//   all heads.
// * P and dS are rounded to bf16 to feed the tensor cores, which the
//   reference's f32 products do not do.
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

using kft::pack_bf16x2;
namespace hw = kft::hopper;

constexpr int kConsumers = 2;  // consumer warpgroups of either kernel
// Two consumer warpgroups and one producer warp: 288 threads.
constexpr int kThreads = kConsumers * 128 + 32;
constexpr float kLog2e = 1.4426950408889634f;

// dq kernel.
constexpr int kDqRows = 128;   // q rows per block (64 per consumer)
constexpr int kDqKeys = 128;   // keys per streamed K/V tile
constexpr int kDqSlab = 32;    // keys per S / dP product (m64n32)
constexpr int kDqStages = 2;   // K/V ring depth

template <int D>
struct DqSmem {
  static constexpr int NCB = D / 64;  // 64-column blocks of a row
  alignas(1024) __nv_bfloat16 q[NCB][kDqRows * 64];
  alignas(1024) __nv_bfloat16 dout[NCB][kDqRows * 64];
  alignas(1024) __nv_bfloat16 k[kDqStages][NCB][kDqKeys * 64];
  alignas(1024) __nv_bfloat16 v[kDqStages][NCB][kDqKeys * 64];
  float delta[kDqRows];
  int kseg[kDqStages][kDqKeys];
  hw::IdSet kset[kDqStages];       // the ids of the stage's keys
  hw::IdSet wgset[kConsumers][4];  // scratch: each consumer's row ids
  hw::IdSet rows[kConsumers];      // each consumer warpgroup's row ids
  int tile[kDqStages];  // kv tile index of the stage, -1 after the last
  uint64_t q_full;
  uint64_t full[kDqStages];
  uint64_t empty[kDqStages];
};

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(DqSmem<D>) + 1024;  // +1024 to align the base
}

// acc (64 x D) += A (64 x 16, registers) * B (16 x D, shared, MN-major):
// dQ += dS K in the dq kernel, dV += P^T dO and dK += dS^T Q in dk/dv.
template <int D>
__device__ __forceinline__ void wgmma_acc(float* acc, const uint32_t* a,
                                          uint64_t b) {
  if constexpr (D == 128) hw::wgmma_m64n128k16_rs(acc, a, b, 1);
  else hw::wgmma_m64n64k16_rs(acc, a, b, 1);
}

// The dot product of two rows of 8 bf16 in f32.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = kft::unpack_bf16x2(x[i]), q = kft::unpack_bf16x2(y[i]);
    s = fmaf(p.x, q.x, fmaf(p.y, q.y, s));
  }
  return s;
}

// The producer warp: the Q and dO loads, then the K and V loads of every
// live kv tile through the ring.  With segment ids it loads the diagonal
// tile, then tests the others 32 at a time (`hw::live_tiles`: their ids
// against the block's rows'), from the diagonal down, and loads the live
// ones.
template <int D>
__device__ __forceinline__ void dq_producer(
    DqSmem<D>& sm, const CUtensorMap* tq, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tdo,
    const int* __restrict__ seg, int bi, int h, int kh, int q0, int sq,
    int sk, int n_kv, int lane) {
  constexpr int NCB = DqSmem<D>::NCB;
  constexpr uint32_t kTileBytes = 2 * NCB * kDqKeys * 128;  // K and V
  int stage = 0;
  uint32_t phase = 0;
  // One kv tile into the ring.
  auto load = [&](int j) {
    const int k0 = j * kDqKeys;
    int ids[kDqKeys / 32];
    if (seg != nullptr) {
#pragma unroll
      for (int i = 0; i < kDqKeys / 32; ++i) {
        const int key = k0 + lane + 32 * i;
        ids[i] = key < sk ? seg[bi * sk + key] : 0;
      }
    }
    hw::mbar_wait(&sm.empty[stage], phase ^ 1);
    if (seg != nullptr) {
      hw::IdSet set = hw::IdSet::empty();
#pragma unroll
      for (int i = 0; i < kDqKeys / 32; ++i) {
        sm.kseg[stage][lane + 32 * i] = ids[i];
        if (k0 + lane + 32 * i < sk) set.add(ids[i]);
      }
      set.warp_reduce();
      if (lane == 0) sm.kset[stage] = set;
    }
    __syncwarp();
    if (lane == 0) {
      sm.tile[stage] = j;
      hw::mbar_arrive_expect_tx(&sm.full[stage], kTileBytes);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        hw::tma_load_4d(sm.k[stage][cb], tk, &sm.full[stage], cb * 64, kh,
                        k0, bi);
        hw::tma_load_4d(sm.v[stage][cb], tv, &sm.full[stage], cb * 64, kh,
                        k0, bi);
      }
    }
    if (++stage == kDqStages) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (lane == 0) {
    hw::tma_prefetch_map(tk);
    hw::tma_prefetch_map(tv);
    hw::mbar_arrive_expect_tx(&sm.q_full, 2 * NCB * kDqRows * 128);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      hw::tma_load_4d(sm.q[cb], tq, &sm.q_full, cb * 64, h, q0, bi);
      hw::tma_load_4d(sm.dout[cb], tdo, &sm.q_full, cb * 64, h, q0, bi);
    }
  }
  if (seg == nullptr) {
    for (int j = 0; j < n_kv; ++j) load(j);
  } else {
    // The diagonal tile holds each row's own key (segment ids need
    // sq == sk), so it is live: load it before testing the rest.
    const int diag = q0 / kDqKeys;
    load(diag);
    const hw::IdSet qset =
        hw::warp_id_set<kDqRows / 32>(seg + bi * sq, sq, q0, lane);
    for (int last = n_kv; last > 0; last -= 32) {
      const int first = max(0, last - 32);
      uint32_t bits = hw::live_tiles<kDqKeys, 8>(seg + bi * sk, sk, first,
                                                 last - first, qset, lane);
      if (diag >= first && diag < last) bits &= ~(1u << (diag - first));
      for (; bits != 0u; bits &= ~(1u << (31 - __clz(bits))))
        load(first + 31 - __clz(bits));
    }
  }
  hw::mbar_wait(&sm.empty[stage], phase ^ 1);
  if (lane == 0) {
    sm.tile[stage] = -1;
    hw::mbar_arrive(&sm.full[stage]);
  }
}

// A consumer warpgroup: 64 query rows (`wg` 0 or 1 of the block's 128).
template <int D>
__device__ __forceinline__ void dq_consumer(
    DqSmem<D>& sm, const __nv_bfloat16* __restrict__ o,
    const float* __restrict__ lse, const float* __restrict__ glse,
    const int* __restrict__ seg, __nv_bfloat16* __restrict__ dq,
    float* __restrict__ delta, int bi, int h, int q0, int sq, int sk,
    int hq, int causal, int offset, float scale, int wg, int ctid) {
  constexpr int KD = D / 16;          // k-steps of Q K^T and dO V^T
  constexpr int NS = kDqSlab / 2;     // S / dP registers a thread
  constexpr int NA = D / 2;           // dQ registers a thread
  constexpr int NP = kDqSlab / 16;    // dS fragments (16 keys each)
  constexpr uint32_t kRowBlock = kDqRows * 128;  // bytes, a column block
  constexpr uint32_t kKeyBlock = kDqKeys * 128;
  const int warp = ctid / 32, lane = ctid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_base = q0 + wg * 64;
  const int r0 = row_base + warp * 16 + g;  // this thread's two rows
  const int r1 = r0 + 8;
  const bool wg_live = row_base < sq;
  const int wg_last = min(row_base + 63, sq - 1);
  const size_t lrow = ((size_t)bi * hq + h) * sq;
  int qs0 = 0, qs1 = 0;
  if (seg != nullptr) {
    qs0 = r0 < sq ? seg[bi * sq + r0] : 0;
    qs1 = r1 < sq ? seg[bi * sq + r1] : 0;
    hw::IdSet rows = hw::IdSet::empty();
    if (r0 < sq) rows.add(qs0);
    if (r1 < sq) rows.add(qs1);
    rows = hw::warpgroup_union(rows, sm.wgset[wg], wg, warp, lane);
    if (ctid == 0) sm.rows[wg] = rows;
    hw::named_barrier(1 + wg, 128);
  }
  const float l2_0 = r0 < sq ? lse[lrow + r0] * kLog2e : 0.f;
  const float l2_1 = r1 < sq ? lse[lrow + r1] * kLog2e : 0.f;

  // delta = rowsum(dO * O) - g_lse: two threads a row, each half of its
  // 16-byte chunks; dO from shared memory, where chunk c of row r sits at
  // chunk c ^ (r % 8) of its 128-byte line (the TMA swizzle).
  hw::mbar_wait(&sm.q_full, 0);
  {
    const int rb = wg * 64 + ctid / 2;  // row in the block
    const int row = q0 + rb;
    const int half = ctid % 2;
    float dl = 0.f;
    if (row < sq) {
      const __nv_bfloat16* orow = o + ((size_t)(bi * sq + row) * hq + h) * D;
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const int c = half * (D / 16) + i;
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const uint4 dv = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const char*>(sm.dout[c / 8]) + rb * 128 +
            (((c % 8) ^ (rb % 8)) << 4));
        dl += dot8(ov, dv);
      }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    if (row < sq && glse != nullptr) dl -= glse[lrow + row];
    if (half == 0) {
      if (row < sq) delta[lrow + row] = dl;
      sm.delta[rb] = row < sq ? dl : 0.f;
    }
    hw::named_barrier(1 + wg, 128);
  }
  const float dl0 = sm.delta[wg * 64 + warp * 16 + g];
  const float dl1 = sm.delta[wg * 64 + warp * 16 + g + 8];
  const float sl2 = scale * kLog2e;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  const uint32_t q_base = hw::smem_u32(sm.q[0]) + wg * 64 * 128;
  const uint32_t do_base = hw::smem_u32(sm.dout[0]) + wg * 64 * 128;

  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    hw::mbar_wait(&sm.full[stage], phase);
    const int j = sm.tile[stage];
    if (j < 0) break;
    const int k0 = j * kDqKeys;
    const bool dead = !wg_live || (causal && k0 > wg_last + offset) ||
                      (seg != nullptr && !sm.rows[wg].meets(sm.kset[stage]));
    const bool need_mask = seg != nullptr || k0 + kDqKeys > sk ||
                           row_base + 64 > sq ||
                           (causal && k0 + kDqKeys - 1 > row_base + offset);
    if (!dead) {
      const uint32_t q_addr = hw::opaque(q_base);
      const uint32_t do_addr = hw::opaque(do_base);
      const uint32_t k_addr = hw::opaque(hw::smem_u32(sm.k[stage][0]));
      const uint32_t v_addr = hw::opaque(hw::smem_u32(sm.v[stage][0]));
      uint32_t pa[NP][4];
#pragma unroll
      for (int slab = 0; slab < kDqKeys / kDqSlab; ++slab) {
        const uint32_t soff = slab * kDqSlab * 128;  // bytes: the slab's keys
        // S = Q K^T and dP = dO V^T: 64 rows x kDqSlab keys.
        float s[NS], dp[NS];
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const uint32_t qo = (kk / 4) * kRowBlock + (kk % 4) * 32;
          const uint32_t ko = (kk / 4) * kKeyBlock + (kk % 4) * 32 + soff;
          hw::wgmma_m64n32k16_ss(s, hw::desc_sw128(q_addr + qo, 16, 1024),
                                 hw::desc_sw128(k_addr + ko, 16, 1024),
                                 kk > 0);
        }
        hw::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const uint32_t qo = (kk / 4) * kRowBlock + (kk % 4) * 32;
          const uint32_t ko = (kk / 4) * kKeyBlock + (kk % 4) * 32 + soff;
          hw::wgmma_m64n32k16_ss(dp,
                                 hw::desc_sw128(do_addr + qo, 16, 1024),
                                 hw::desc_sw128(v_addr + ko, 16, 1024),
                                 kk > 0);
        }
        hw::wgmma_commit();
        // S has landed (and the previous slab's dQ product, which read
        // pa); dP may still be in flight.
        hw::wgmma_wait<1>();
        hw::fence_regs<NS>(s);
        hw::fence_regs<NP * 4>(&pa[0][0]);

        // P = exp2(S * sl2 - lse * log2 e), zero where masked.
#pragma unroll
        for (int n = 0; n < kDqSlab / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = hw::ex2(fmaf(s[4 * n + e], sl2, e < 2 ? -l2_0 : -l2_1));
            if (need_mask) {
              const int col = slab * kDqSlab + n * 8 + t * 2 + (e & 1);
              const int key = k0 + col;
              const int row = e < 2 ? r0 : r1;
              bool ok = key < sk && row < sq;
              if (causal) ok = ok && (row + offset >= key);
              if (seg != nullptr)
                ok = ok && ((e < 2 ? qs0 : qs1) == sm.kseg[stage][col]);
              if (!ok) p = 0.f;
            }
            s[4 * n + e] = p;
          }
        }
        // dS = P * (dP - delta) * scale, as bf16 A fragments of 16 keys.
        hw::wgmma_wait<0>();
        hw::fence_regs<NS>(dp);
#pragma unroll
        for (int i = 0; i < NS; ++i)
          s[i] *= (dp[i] - ((i & 3) < 2 ? dl0 : dl1)) * scale;
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
          pa[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
          pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
          pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
          pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
        }
        // dQ += dS K over the slab's keys (K MN-major).
        hw::fence_regs<NA>(acc);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NP; ++kk)
          wgmma_acc<D>(acc, pa[kk],
                       hw::desc_sw128(k_addr + soff + kk * 16 * 128,
                                      kKeyBlock, 1024));
        hw::wgmma_commit();
      }
      hw::wgmma_wait<0>();
      hw::fence_regs<NA>(acc);
      hw::fence_regs<NP * 4>(&pa[0][0]);  // read until the wait
    }
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&sm.empty[stage]);
    if (++stage == kDqStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (wg_live) {
    __nv_bfloat16* d0 = dq + ((size_t)(bi * sq + r0) * hq + h) * D;
    __nv_bfloat16* d1 = dq + ((size_t)(bi * sq + r1) * hq + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + t * 2;
      if (r0 < sq)
        *reinterpret_cast<uint32_t*>(d0 + c) =
            pack_bf16x2(acc[4 * n], acc[4 * n + 1]);
      if (r1 < sq)
        *reinterpret_cast<uint32_t*>(d1 + c) =
            pack_bf16x2(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __nv_bfloat16* __restrict__ o,
                    const float* __restrict__ lse,
                    const float* __restrict__ glse,
                    const int* __restrict__ seg,
                    __nv_bfloat16* __restrict__ dq,
                    float* __restrict__ delta, int b, int sq, int sk, int hq,
                    int hk, int causal, float scale, int n_qtiles) {
  using Smem = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  // Longest causal q tiles first, across every (head, batch).
  const int hb = hq * b;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = static_cast<int>(blockIdx.x) % hb % hq;
  const int bi = static_cast<int>(blockIdx.x) % hb / hq;
  const int kh = h / (hq / hk);
  const int q0 = qt * kDqRows;
  const int offset = causal ? sk - sq : 0;
  int kv_end = sk;
  if (causal) kv_end = min(sk, min(q0 + kDqRows, sq) - 1 + offset + 1);
  const int n_kv = (kv_end + kDqKeys - 1) / kDqKeys;

  if (threadIdx.x == 0) {
    hw::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hw::mbar_init(&sm.full[s], 1);
      hw::mbar_init(&sm.empty[s], kConsumers * 4);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    dq_producer<D>(sm, &tq, &tk, &tv, &tdo, seg, bi, h, kh, q0, sq, sk, n_kv,
                   threadIdx.x % 32);
  } else {
    dq_consumer<D>(sm, o, lse, glse, seg, dq, delta, bi, h, q0, sq, sk, hq,
                   causal, offset, scale, wg, threadIdx.x - wg * 128);
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, const float* glse,
              const int* seg, __nv_bfloat16* dq, float* delta, int b, int sq,
              int sk, int hq, int hk, int causal, float scale,
              cudaStream_t stream) {
  namespace hh = kft::hopper_host;
  CUtensorMap tq, tk, tv, tdo;
  int err = hh::encode_bshd(&tq, q, b, sq, hq, D, kDqRows);
  if (err == 0) err = hh::encode_bshd(&tdo, dout, b, sq, hq, D, kDqRows);
  if (err == 0) err = hh::encode_bshd(&tk, k, b, sk, hk, D, kDqKeys);
  if (err == 0) err = hh::encode_bshd(&tv, v, b, sk, hk, D, kDqKeys);
  if (err != 0) return err;
  constexpr size_t bytes = dq_smem_bytes<D>();
  static const int attr = hh::allow_smem(flash_bwd_dq_kernel<D>, bytes);
  if (attr != 0) return attr;
  const int n_qtiles = (sq + kDqRows - 1) / kDqRows;
  flash_bwd_dq_kernel<D><<<n_qtiles * hq * b, kThreads, bytes, stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(o), lse, glse, seg,
      dq, delta, b, sq, sk, hq, hk, causal, scale, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

// dk/dv kernel.
constexpr int kDkvKeys = 128;  // keys per block (64 per consumer)
constexpr int kDkvRows = 64;   // q rows per streamed tile
constexpr int kHalf = 32;      // q rows per S^T / dP^T product
constexpr int kDkvStages = 2;  // q/dO ring depth (3 measured slower)

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
__global__ void __launch_bounds__(kThreads, 1)
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
  flash_bwd_dkv_kernel<D><<<n_ktiles * hk * b, kThreads, bytes, stream>>>(
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lse_ = static_cast<const float*>(lse);
  const auto* glse_ = static_cast<const float*>(glse);
  const auto* seg_ = static_cast<const int*>(seg);
  auto* dq_ = static_cast<__nv_bfloat16*>(dq);
  auto* delta_ = static_cast<float*>(delta);
  if (d == 128)
    return launch_dq<128>(q, k, v, o, dout, lse_, glse_, seg_, dq_, delta_,
                          b, sq, sk, hq, hk, causal, scale, s);
  if (d == 64)
    return launch_dq<64>(q, k, v, o, dout, lse_, glse_, seg_, dq_, delta_, b,
                         sq, sk, hq, hk, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
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

// Flash attention forward (online softmax) for Hopper, BSHD layout, bf16.
//
// Replaces: kubeflow_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (via
// `_flash_fwd`, `flash_attention`), with and without the logsumexp output
// (`return_residuals`, the forward of `flash_attention_with_lse` and of
// training).  Given an `lse` pointer ([b, hq, sq] f32; the reference
// lane-replicates it as [b, hq, sq, 128]) the kernel also writes
// m + log(l) per row from the registers that normalise O; serving passes
// null.  Same semantics: end-aligned causal mask (query row i sees keys
// j <= i + sk - sq), dead kv tiles skipped, `segment_ids` equality mask,
// GQA with kv head = h / (hq / hk), probabilities of masked slots zeroed
// (so a row with no visible key in a tile adds nothing), and l == 0 -> 1.
//
// What bounds it on the H100: the bf16 tensor-core work, 4*sq*sk*d flops
// per (b, h) halved by the causal mask, against q/k/v/o read and written
// once.  At llama_1b4's training shape (s8192, d128) that is thousands of
// flops per byte, far past the 295 flop/byte ridge: the operations bound
// it.  At the prefill shape of llama3_8b (sq = sk = 512, 4 q heads per kv
// head) it is about 205 flops per byte, so the bytes do.
//
// Design (FlashAttention-3's structure), and what it does about that:
// * One block of 288 threads per (128 query rows, q head, batch): two
//   consumer warpgroups of 64 rows each and one producer warp that
//   issues every load.  Nine warps put three on one of the SM's four
//   schedulers, so each thread may hold 168 registers: the consumers'
//   S (64), O (64) and P (32) fit, which the ptxas build line shows.
// * The producer loads the block's Q tile once by TMA, then streams K and
//   V tiles of 128 keys through a ring of kStages stages: a "full"
//   mbarrier per stage and operand (completed by the TMA's byte count)
//   and an "empty" one per operand (completed by the 8 consumer warps).
//   The tensor maps are 4-D (d, heads, seq, batch) with a 128-byte
//   swizzle, so each d = 128 row is two 64-column boxes; boxes past sq or
//   sk are zero-filled and the masks hide them.
// * S = Q K^T is wgmma m64n128k16 with both operands in shared memory (K
//   in its natural [keys, d] layout is the K-major B operand); O += P V
//   takes P from registers, re-packed from the S accumulator as bf16, and
//   V from shared memory with the transpose bit (V's rows are MN-major).
//   The online softmax stays in registers (exp2 with the scale folded in;
//   the row max and sum reduced over the 4 threads of a row).
// * The per-element mask runs only on tiles that cross the causal
//   diagonal, reach past sk, or carry segment ids.  With segment ids the
//   producer reads each kv tile's ids, and a tile that shares no id with
//   the q tile (`hw::IdSet`: disjoint [min, max] ranges, or disjoint
//   masks of id mod 64) is neither loaded nor computed: every pair in it
//   is masked, so it would add P = 0 and leave m and l as they are.
//   Exact for any ids, sorted or not (the packed loader's are not
//   sorted, so a range alone skips little).  The producer loads the
//   diagonal tile first (always live), then tests the others 32 at a
//   time with 8 tiles' id loads in flight (16 made ptxas spill), from
//   the diagonal down, so the tiles next to it (a packed row's live
//   ones) are computed while farther ones are tested.  A consumer
//   warpgroup also passes over a live tile that shares no id with its
//   own 64 rows.
// * Blocks are ordered longest causal q tile first, across all heads, so
//   the short tiles fill the tail of the grid.
// * d = 64 and 128 are two instances of the same template.
#include <limits.h>
#include <math.h>

#include "kft_common.cuh"
#include "kft_hopper.cuh"

namespace {

namespace hw = kft::hopper;

constexpr int kBM = 128;      // query rows per block (64 per consumer)
constexpr int kBN = 128;      // keys per kv tile
constexpr int kStages = 2;    // kv ring depth (3 measured slower)
constexpr int kConsumers = 2; // consumer warpgroups
// Two consumer warpgroups and one producer warp: 288 threads.
constexpr int kThreads = kConsumers * 128 + 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct FwdSmem {
  static constexpr int NCB = D / 64;  // 64-column blocks of a row
  alignas(1024) __nv_bfloat16 q[NCB][kBM * 64];
  alignas(1024) __nv_bfloat16 k[kStages][NCB][kBN * 64];
  alignas(1024) __nv_bfloat16 v[kStages][NCB][kBN * 64];
  int kseg[kStages][kBN];
  hw::IdSet kset[kStages];  // the ids of the stage's keys
  hw::IdSet wgset[kConsumers][4];  // scratch: each consumer's row ids
  hw::IdSet rows[kConsumers];      // each consumer warpgroup's row ids
  int tile[kStages];  // kv tile index of the stage, -1 after the last
  uint64_t q_full;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];
  uint64_t v_empty[kStages];
};

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(FwdSmem<D>) + 1024;  // +1024 to align the base
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (D == 128) hw::wgmma_m64n128k16_rs(o, a, b, 1);
  else hw::wgmma_m64n64k16_rs(o, a, b, 1);
}

// The producer warp: the Q load, then the K and V loads of every live kv
// tile through the ring, in key order.  With segment ids it loads the
// diagonal tile, then tests the others 32 at a time (`hw::live_tiles`:
// their ids against the q tile's), from the diagonal down, and loads the
// live ones.
template <int D>
__device__ __forceinline__ void fwd_producer(
    FwdSmem<D>& sm, const CUtensorMap* tq, const CUtensorMap* tk,
    const CUtensorMap* tv, const int* __restrict__ seg, int bi, int h,
    int kh, int q0, int sq, int sk, int n_kv, int lane) {
  constexpr int NCB = FwdSmem<D>::NCB;
  constexpr uint32_t kTileBytes = NCB * kBN * 128;
  int stage = 0;
  uint32_t phase = 0;
  // One kv tile into the ring.
  auto load = [&](int j) {
    const int k0 = j * kBN;
    int ids[kBN / 32];
    if (seg != nullptr) {
#pragma unroll
      for (int i = 0; i < kBN / 32; ++i) {
        const int key = k0 + lane + 32 * i;
        ids[i] = key < sk ? seg[bi * sk + key] : 0;
      }
    }
    hw::mbar_wait(&sm.k_empty[stage], phase ^ 1);
    if (seg != nullptr) {
      hw::IdSet set = hw::IdSet::empty();
#pragma unroll
      for (int i = 0; i < kBN / 32; ++i) {
        sm.kseg[stage][lane + 32 * i] = ids[i];
        if (k0 + lane + 32 * i < sk) set.add(ids[i]);
      }
      set.warp_reduce();
      if (lane == 0) sm.kset[stage] = set;
    }
    __syncwarp();
    if (lane == 0) {
      sm.tile[stage] = j;
      hw::mbar_arrive_expect_tx(&sm.k_full[stage], kTileBytes);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        hw::tma_load_4d(sm.k[stage][cb], tk, &sm.k_full[stage], cb * 64, kh,
                        k0, bi);
    }
    hw::mbar_wait(&sm.v_empty[stage], phase ^ 1);
    if (lane == 0) {
      hw::mbar_arrive_expect_tx(&sm.v_full[stage], kTileBytes);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        hw::tma_load_4d(sm.v[stage][cb], tv, &sm.v_full[stage], cb * 64, kh,
                        k0, bi);
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (lane == 0) {
    hw::tma_prefetch_map(tq);
    hw::tma_prefetch_map(tk);
    hw::tma_prefetch_map(tv);
    hw::mbar_arrive_expect_tx(&sm.q_full, NCB * kBM * 128);
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
      hw::tma_load_4d(sm.q[cb], tq, &sm.q_full, cb * 64, h, q0, bi);
  }
  if (seg == nullptr) {
    for (int j = 0; j < n_kv; ++j) load(j);
  } else {
    // The diagonal tile holds each row's own key (segment ids need
    // sq == sk), so it is live: load it before testing the rest, then go
    // from the diagonal down.  A packed row's live tiles sit next to it,
    // so they are loaded and computed while farther tiles are tested.
    const int diag = q0 / kBN;
    load(diag);
    const hw::IdSet qset =
        hw::warp_id_set<kBM / 32>(seg + bi * sq, sq, q0, lane);
    for (int last = n_kv; last > 0; last -= 32) {
      const int first = max(0, last - 32);
      uint32_t bits = hw::live_tiles<kBN, 8>(seg + bi * sk, sk, first,
                                            last - first, qset, lane);
      if (diag >= first && diag < last) bits &= ~(1u << (diag - first));
      for (; bits != 0u; bits &= ~(1u << (31 - __clz(bits))))
        load(first + 31 - __clz(bits));
    }
  }
  hw::mbar_wait(&sm.k_empty[stage], phase ^ 1);
  if (lane == 0) {
    sm.tile[stage] = -1;
    hw::mbar_arrive(&sm.k_full[stage]);
  }
}

// A consumer warpgroup: 64 query rows (`wg` 0 or 1 of the block's 128).
template <int D>
__device__ __forceinline__ void fwd_consumer(
    FwdSmem<D>& sm, const int* __restrict__ seg, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int bi, int h, int q0, int sq, int sk, int hq,
    int causal, int offset, float scale, int wg, int ctid) {
  constexpr int KD = D / 16;     // k-steps of Q K^T
  constexpr int NS = kBN / 2;    // S accumulator registers a thread
  constexpr int NO = D / 2;      // O accumulator registers a thread
  constexpr uint32_t kColBlock = kBN * 128;  // bytes of one column block
  const int warp = ctid / 32, lane = ctid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_base = q0 + wg * 64;
  const int r0 = row_base + warp * 16 + g;  // this thread's two rows
  const int r1 = r0 + 8;
  const bool wg_live = row_base < sq;
  const int wg_last = min(row_base + 63, sq - 1);
  int qs0 = 0, qs1 = 0;
  if (seg != nullptr) {
    // The warpgroup's row ids, kept in shared memory (registers are
    // short here) for the per-tile test below.
    qs0 = r0 < sq ? seg[bi * sq + r0] : 0;
    qs1 = r1 < sq ? seg[bi * sq + r1] : 0;
    hw::IdSet rows = hw::IdSet::empty();
    if (r0 < sq) rows.add(qs0);
    if (r1 < sq) rows.add(qs1);
    rows = hw::warpgroup_union(rows, sm.wgset[wg], wg, warp, lane);
    if (ctid == 0) sm.rows[wg] = rows;
    hw::named_barrier(1 + wg, 128);
  }
  const float sl2 = scale * kLog2e;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const uint32_t q_base = hw::smem_u32(sm.q[0]) + wg * 64 * 128;
  hw::mbar_wait(&sm.q_full, 0);

  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    hw::mbar_wait(&sm.k_full[stage], phase);
    const int j = sm.tile[stage];
    if (j < 0) break;
    const int k0 = j * kBN;
    const bool dead = !wg_live || (causal && k0 > wg_last + offset) ||
                      (seg != nullptr && !sm.rows[wg].meets(sm.kset[stage]));
    const bool need_mask = seg != nullptr || k0 + kBN > sk ||
                           (causal && k0 + kBN - 1 > row_base + offset);
    if (!dead) {
      // S = Q K^T, 64 rows x 128 keys.
      float s[NS];
      const uint32_t k_addr = hw::opaque(hw::smem_u32(sm.k[stage][0]));
      const uint32_t q_addr = hw::opaque(q_base);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint32_t off = (kk / 4) * kColBlock + (kk % 4) * 32;
        hw::wgmma_m64n128k16_ss(s, hw::desc_sw128(q_addr + off, 16, 1024),
                                hw::desc_sw128(k_addr + off, 16, 1024),
                                kk > 0);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs<NS>(s);

      if (need_mask) {
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + t * 2 + (e & 1);
            const int key = k0 + col;
            const int row = e < 2 ? r0 : r1;
            bool ok = key < sk;
            if (causal) ok = ok && (row + offset >= key);
            if (seg != nullptr)
              ok = ok && ((e < 2 ? qs0 : qs1) == sm.kseg[stage][col]);
            if (!ok) s[4 * n + e] = -INFINITY;
          }
        }
      }
      // Running max (raw logits), then P = exp2(S * sl2 - max * sl2).
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      // A row with no visible key so far keeps max -inf: subtract 0, so
      // its masked entries give exp2(-inf) = 0 and not NaN.
      const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * sl2;
      const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * sl2;
      const float al0 = hw::ex2(m0 * sl2 - ms0);
      const float al1 = hw::ex2(m1 * sl2 - ms1);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        s[4 * n] = hw::ex2(fmaf(s[4 * n], sl2, -ms0));
        s[4 * n + 1] = hw::ex2(fmaf(s[4 * n + 1], sl2, -ms0));
        s[4 * n + 2] = hw::ex2(fmaf(s[4 * n + 2], sl2, -ms1));
        s[4 * n + 3] = hw::ex2(fmaf(s[4 * n + 3], sl2, -ms1));
        ps0 += s[4 * n] + s[4 * n + 1];
        ps1 += s[4 * n + 2] + s[4 * n + 3];
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= al0;
        acc[4 * n + 1] *= al0;
        acc[4 * n + 2] *= al1;
        acc[4 * n + 3] *= al1;
      }
      // P as bf16 A fragments, one per 16 keys.
      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        pa[kk][0] = kft::pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = kft::pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = kft::pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = kft::pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V: V rows 16kk .. 16kk + 15, all D columns (MN-major).
      hw::mbar_wait(&sm.v_full[stage], phase);
      const uint32_t v_addr = hw::opaque(hw::smem_u32(sm.v[stage][0]));
      hw::fence_regs<NO>(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv<D>(acc, pa[kk],
                    hw::desc_sw128(v_addr + kk * 16 * 128, kColBlock, 1024));
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs<NO>(acc);
      hw::fence_regs<kBN / 16 * 4>(&pa[0][0]);  // read until the wait
    } else {
      // The stage is released only once its V load has landed.
      hw::mbar_wait(&sm.v_full[stage], phase);
    }
    __syncwarp();
    if (lane == 0) {
      hw::mbar_arrive(&sm.k_empty[stage]);
      hw::mbar_arrive(&sm.v_empty[stage]);
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (wg_live) {
    // Row sums across the quad; l == 0 (no visible key) -> 1.
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
    }
    // The logsumexp of each row's scaled logits, from the m and l that
    // normalise O (unguarded, as the reference writes it: every row the
    // wrapper admits sees at least one key).
    if (lse != nullptr && t == 0) {
      float* row_lse = lse + ((size_t)bi * hq + h) * sq;
      if (r0 < sq) row_lse[r0] = m0 * scale + logf(l0);
      if (r1 < sq) row_lse[r1] = m1 * scale + logf(l1);
    }
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    __nv_bfloat16* o0 = o + ((size_t)(bi * sq + r0) * hq + h) * D;
    __nv_bfloat16* o1 = o + ((size_t)(bi * sq + r1) * hq + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + t * 2;
      if (r0 < sq)
        *reinterpret_cast<uint32_t*>(o0 + c) =
            kft::pack_bf16x2(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      if (r1 < sq)
        *reinterpret_cast<uint32_t*>(o1 + c) =
            kft::pack_bf16x2(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const int* __restrict__ seg,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int b, int sq, int sk, int hq, int hk, int causal,
                 float scale, int n_qtiles) {
  using Smem = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  // Longest causal q tiles first, across every (head, batch).
  const int hb = hq * b;
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = static_cast<int>(blockIdx.x) % hb % hq;
  const int bi = static_cast<int>(blockIdx.x) % hb / hq;
  const int kh = h / (hq / hk);
  const int q0 = qt * kBM;
  const int offset = causal ? sk - sq : 0;
  int kv_end = sk;
  if (causal) kv_end = min(sk, min(q0 + kBM, sq) - 1 + offset + 1);
  const int n_kv = (kv_end + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    hw::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(&sm.k_full[s], 1);
      hw::mbar_init(&sm.v_full[s], 1);
      hw::mbar_init(&sm.k_empty[s], kConsumers * 4);
      hw::mbar_init(&sm.v_empty[s], kConsumers * 4);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    fwd_producer<D>(sm, &tq, &tk, &tv, seg, bi, h, kh, q0, sq, sk, n_kv,
                    threadIdx.x % 32);
  } else {
    fwd_consumer<D>(sm, seg, o, lse, bi, h, q0, sq, sk, hq, causal, offset,
                    scale, wg, threadIdx.x - wg * 128);
  }
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg,
               __nv_bfloat16* o, float* lse, int b, int sq, int sk, int hq,
               int hk, int causal, float scale, cudaStream_t stream) {
  namespace hh = kft::hopper_host;
  CUtensorMap tq, tk, tv;
  int err = hh::encode_bshd(&tq, q, b, sq, hq, D, kBM);
  if (err == 0) err = hh::encode_bshd(&tk, k, b, sk, hk, D, kBN);
  if (err == 0) err = hh::encode_bshd(&tv, v, b, sk, hk, D, kBN);
  if (err != 0) return err;
  constexpr size_t bytes = fwd_smem_bytes<D>();
  static const int attr = hh::allow_smem(flash_fwd_kernel<D>, bytes);
  if (attr != 0) return attr;
  const int n_qtiles = (sq + kBM - 1) / kBM;
  flash_fwd_kernel<D><<<n_qtiles * hq * b, kThreads, bytes, stream>>>(
      tq, tk, tv, seg, o, lse, b, sq, sk, hq, hk, causal, scale, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int kft_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* seg,
                                       void* o, void* lse, int b, int sq,
                                       int sk, int hq,
                                       int hk, int d, int causal, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* seg_ = static_cast<const int*>(seg);
  auto* o_ = static_cast<__nv_bfloat16*>(o);
  auto* lse_ = static_cast<float*>(lse);
  if (d == 128)
    return launch_fwd<128>(q, k, v, seg_, o_, lse_, b, sq, sk, hq, hk,
                           causal, scale, s);
  if (d == 64)
    return launch_fwd<64>(q, k, v, seg_, o_, lse_, b, sq, sk, hq, hk,
                          causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

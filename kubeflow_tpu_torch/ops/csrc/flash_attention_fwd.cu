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
// once.  At the prefill shape of llama3_8b (sq = sk = 512, d = 128, 4 q
// heads per kv head) that is about 205 flops per byte, below the 295
// flop/byte ridge, so the bytes bound it; past sq ~ 740 the operations
// do.
//
// Design, and what it does about that:
// * One block of 4 warps per (q tile of 64 rows, head, batch): blocks run
//   in parallel and in no order, so the kv loop lives inside the block and
//   nothing is carried across blocks.  A TPU grid axis marked "arbitrary"
//   has no counterpart here.
// * Each warp owns 16 query rows.  Its q fragment is loaded once from
//   global memory straight into mma.sync registers; K and V tiles of 64
//   keys are staged in shared memory (rows padded by 16 bytes so the
//   fragment loads hit 32 distinct banks).
// * S = Q K^T and O += P V run on `mma.sync.m16n8k16` bf16 -> f32.  The S
//   accumulator fragment is re-packed in registers as the A operand of
//   the P V product (P never touches shared memory).  The running row max
//   and sum live in registers; the sum stays per-thread and is reduced
//   across the 4 threads of a row only at the end.
// * Ragged lengths: any sq >= 1, sk >= 1.  Rows past sq are computed on
//   zeros and not written; keys past sk are zero-filled and masked.
// * wgmma, TMA and a multi-stage pipeline are later work: this kernel is
//   the simple, correct first version.
#include "kft_common.cuh"

namespace {

constexpr int kBQ = 64;    // query rows per block (16 per warp)
constexpr int kBK = 64;    // keys per staged tile
constexpr int kWarps = 4;
constexpr int kPad = 8;    // bf16 elements of padding per shared-memory row

using kft::ld32;
using kft::mma16816;
using kft::pack2;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ seg,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int hq, int hk, int causal, float scale) {
  constexpr int KD = D / 16;   // k-steps of the QK^T product
  constexpr int NS = kBK / 8;  // n-tiles of S per warp
  constexpr int ND = D / 8;    // n-tiles of O per warp
  constexpr int LD = D + kPad;

  __shared__ __align__(16) __nv_bfloat16 ks[kBK][LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK][LD];
  __shared__ int kseg[kBK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kh = h / (hq / hk);
  const int q_start = blockIdx.x * kBQ;
  const int r0 = q_start + warp * 16 + g;  // this thread's two rows
  const int r1 = r0 + 8;
  const int offset = causal ? sk - sq : 0;

  // q fragments (A operand, row-major 16 x D per warp), zero past sq.
  uint32_t qa[KD][4];
  {
    const __nv_bfloat16* q0 = q + ((size_t)(bi * sq + r0) * hq + h) * D;
    const __nv_bfloat16* q1 = q + ((size_t)(bi * sq + r1) * hq + h) * D;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = r0 < sq ? ld32(q0 + c) : 0u;
      qa[kk][1] = r1 < sq ? ld32(q1 + c) : 0u;
      qa[kk][2] = r0 < sq ? ld32(q0 + c + 8) : 0u;
      qa[kk][3] = r1 < sq ? ld32(q1 + c + 8) : 0u;
    }
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
  float m0 = KFT_NEG_INF, m1 = KFT_NEG_INF, l0 = 0.f, l1 = 0.f;

  // Causal: keys past the block's last live row (+ offset) are dead.
  int kv_end = sk;
  if (causal) {
    const int last_row = min(q_start + kBQ, sq) - 1;
    kv_end = min(sk, last_row + offset + 1);
  }

  for (int k_start = 0; k_start < kv_end; k_start += kBK) {
    // Stage the K and V tiles: 16-byte vectors, zeros past sk.
    for (int idx = tid; idx < kBK * (D / 8); idx += kWarps * 32) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      const int key = k_start + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < sk) {
        const size_t off = ((size_t)(bi * sk + key) * hk + kh) * D + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vv;
    }
    if (seg != nullptr) {
      for (int r = tid; r < kBK; r += kWarps * 32) {
        const int key = k_start + r;
        kseg[r] = key < sk ? seg[bi * sk + key] : 0;
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* kr = &ks[j * 8 + g][kk * 16 + t * 2];
        mma16816(s[j], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // Scale, mask, and the tile's row max.
    float mx0 = KFT_NEG_INF, mx1 = KFT_NEG_INF;
    unsigned live = 0;  // bit (4j + e): element e of n-tile j is visible
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const int key = k_start + col;
        const int row = e < 2 ? r0 : r1;
        bool ok = key < sk;
        if (causal) ok = ok && (row + offset >= key);
        if (seg != nullptr) ok = ok && ((e < 2 ? qs0 : qs1) == kseg[col]);
        const float val = ok ? s[j][e] * scale : KFT_NEG_INF;
        s[j][e] = val;
        if (ok) live |= 1u << (4 * j + e);
        if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp(S - m), zero where masked; per-thread partial row sums.
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (live >> (4 * j + e)) & 1u
                            ? __expf(s[j][e] - (e < 2 ? mn0 : mn1))
                            : 0.f;
        s[j][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= al0; acc[j][1] *= al0;
      acc[j][2] *= al1; acc[j][3] *= al1;
    }

    // O += P V: the S fragments re-packed as bf16 A operands.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = kft::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = kft::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = kft::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = kft::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key0 = kk * 16 + t * 2;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int col = j * 8 + g;
        const uint32_t b0 = pack2(vs[key0][col], vs[key0 + 1][col]);
        const uint32_t b1 = pack2(vs[key0 + 8][col], vs[key0 + 9][col]);
        mma16816(acc[j], pa, b0, b1);
      }
    }
    __syncthreads();
  }

  // Row sums across the quad; l == 0 (no visible key) -> 1.
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  // The logsumexp of each row's scaled logits, from the m and l that
  // normalise O (unguarded, as the reference writes it: every row the
  // kernel admits sees at least one key).
  if (lse != nullptr && t == 0) {
    float* row_lse = lse + ((size_t)bi * hq + h) * sq;
    if (r0 < sq) row_lse[r0] = m0 + logf(l0);
    if (r1 < sq) row_lse[r1] = m1 + logf(l1);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* o0 = o + ((size_t)(bi * sq + r0) * hq + h) * D;
  __nv_bfloat16* o1 = o + ((size_t)(bi * sq + r1) * hq + h) * D;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int c = j * 8 + t * 2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(o0 + c) =
          kft::pack_bf16x2(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(o1 + c) =
          kft::pack_bf16x2(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

}  // namespace

extern "C" int kft_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const void* seg,
                                       void* o, void* lse, int b, int sq,
                                       int sk, int hq,
                                       int hk, int d, int causal, float scale,
                                       void* stream) {
  dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q_ = static_cast<const __nv_bfloat16*>(q);
  const auto* k_ = static_cast<const __nv_bfloat16*>(k);
  const auto* v_ = static_cast<const __nv_bfloat16*>(v);
  const auto* seg_ = static_cast<const int*>(seg);
  auto* o_ = static_cast<__nv_bfloat16*>(o);
  auto* lse_ = static_cast<float*>(lse);
  if (d == 128) {
    flash_fwd_kernel<128><<<grid, kWarps * 32, 0, s>>>(
        q_, k_, v_, seg_, o_, lse_, sq, sk, hq, hk, causal, scale);
  } else if (d == 64) {
    flash_fwd_kernel<64><<<grid, kWarps * 32, 0, s>>>(
        q_, k_, v_, seg_, o_, lse_, sq, sk, hq, hk, causal, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

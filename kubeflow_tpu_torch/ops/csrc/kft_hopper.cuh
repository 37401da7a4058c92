// Hopper building blocks for the port's kernels, as raw PTX (sm_90a):
// mbarriers, TMA tile loads and their tensor maps, thread block cluster
// barriers and stores, wgmma with its shared memory descriptors, and the
// producer's segment-id tile test.  No CUTLASS, no -lcuda: the tensor map
// encoder, cuTensorMapEncodeTiled, is looked up at run time with the
// runtime's cudaGetDriverEntryPoint.
//
// Layout every user of this header shares: a bf16 tile in shared memory
// is stored as column blocks of 64 elements (128 bytes) per row, the
// rows of one block consecutive, with the 128-byte swizzle that a TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B writes (16-byte chunk c of row r
// lands at chunk c ^ (r % 8)).  Each block starts on a 1024-byte
// boundary.  The same tile serves wgmma as a K-major operand (the 64
// contiguous elements are the reduction axis) or, with the transpose
// bit, as an MN-major one (they are the output axis).
#pragma once

#include <cuda.h>
#include <limits.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kft {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); call
// once after the inits, before the block-wide __syncthreads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Arrive and announce `bytes` that TMA loads will deliver to this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0: waiting on parity 1 returns at once.  A wait that never
// ends (a pipeline fault) traps after 2^28 polls, seconds at the least,
// so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// ---- TMA -----------------------------------------------------------------

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- thread block clusters --------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: the shared-memory writes
// before it are visible to the reads of any block after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two halves of a cluster barrier, split so that work runs between
// them: arrive (no ordering), later wait.  A block may touch another's
// shared memory only after a barrier both have passed: every block of the
// cluster has then started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Store `v` in the shared memory of block `rank` of the cluster, at the
// offset `p` has in this block's.
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

// ---- barriers -------------------------------------------------------------

// Barrier `id` (1.., not 0, which __syncthreads uses) over `threads`.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- segment-id tile skipping ---------------------------------------------

// A summary of a set of segment ids: their [lo, hi] range and a 64-bit
// mask of (id mod 64).  Two sets whose ranges or masks are disjoint share
// no id, so every (query, key) pair between their tiles is masked.  The
// converse need not hold: the test may keep a tile with no visible pair,
// never drop one that has one.  The range decides for sorted ids, the
// mask for up to 64 distinct ids in any order (a packed row's documents).
struct IdSet {
  int lo, hi;
  uint32_t m0, m1;

  __device__ __forceinline__ static IdSet empty() {
    return IdSet{INT_MAX, INT_MIN, 0u, 0u};
  }
  __device__ __forceinline__ void add(int id) {
    lo = min(lo, id);
    hi = max(hi, id);
    const uint32_t bit = 1u << (id & 31);
    if (id & 32) m1 |= bit;
    else m0 |= bit;
  }
  __device__ __forceinline__ void merge(const IdSet& o) {
    lo = min(lo, o.lo);
    hi = max(hi, o.hi);
    m0 |= o.m0;
    m1 |= o.m1;
  }
  // The union over the 32 lanes of a warp, in every lane.
  __device__ __forceinline__ void warp_reduce() {
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    m0 = __reduce_or_sync(0xffffffffu, m0);
    m1 = __reduce_or_sync(0xffffffffu, m1);
  }
  __device__ __forceinline__ bool meets(const IdSet& o) const {
    return lo <= o.hi && o.lo <= hi && ((m0 & o.m0) | (m1 & o.m1)) != 0u;
  }
};

// The union of one set per thread over a warpgroup (`wg` of the block,
// `warp` 0..3 in it), in every thread of it.  `scratch` holds 4 sets;
// uses named barrier 1 + wg.
__device__ __forceinline__ IdSet warpgroup_union(IdSet set, IdSet* scratch,
                                                 int wg, int warp,
                                                 int lane) {
  set.warp_reduce();
  if (lane == 0) scratch[warp] = set;
  named_barrier(1 + wg, 128);
  set = scratch[0];
  for (int w = 1; w < 4; ++w) set.merge(scratch[w]);
  return set;
}

// The ids at positions [start, start + 32 * PER) clipped to [0, n), as
// one set in every lane of the calling warp.
template <int PER>
__device__ __forceinline__ IdSet warp_id_set(const int* __restrict__ ids,
                                             int n, int start, int lane) {
  IdSet set = IdSet::empty();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int p = start + lane + 32 * i;
    if (p < n) set.add(ids[p]);
  }
  set.warp_reduce();
  return set;
}

// Called by one whole warp: bit j of the result (the same in every lane)
// says whether tile first + j, j < count <= 32, whose positions are
// [(first + j) * ROWS, (first + j + 1) * ROWS) clipped to [0, n), holds
// an id of `other`.  UNROLL tiles' loads are in flight at once.
template <int ROWS, int UNROLL>
__device__ __forceinline__ uint32_t live_tiles(const int* __restrict__ ids,
                                               int n, int first, int count,
                                               const IdSet& other,
                                               int lane) {
  constexpr int PER = ROWS / 32;
  uint32_t bits = 0u;
  for (int j0 = 0; j0 < count; j0 += UNROLL) {
    int v[UNROLL][PER];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int p = (first + j0 + u) * ROWS + lane + 32 * i;
        v[u][i] = (j0 + u < count && p < n) ? ids[p] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      IdSet set = IdSet::empty();
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (j0 + u < count && (first + j0 + u) * ROWS + lane + 32 * i < n)
          set.add(v[u][i]);
      set.warp_reduce();
      if (set.meets(other)) bits |= 1u << (j0 + u);
    }
  }
  return bits;
}

// ---- math --------------------------------------------------------------

// 2^x on the SFU (ex2.approx.ftz); 2^-inf = +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- compiler hints ------------------------------------------------------

// The same value, opaque to the compiler: a descriptor built from it is
// rebuilt where it is used instead of being hoisted out of the loop and
// held in registers across it.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  uint32_t y;
  asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.  Address and byte
// offsets in 16-byte units.  K-major operand: `sbo` = 1024 (the stride of
// 8-row groups), `lbo` unused (one k-step of 32 bytes stays inside the
// 128-byte row; advance along K by adding 32 bytes to the address).
// MN-major operand: `lbo` = the stride between 64-element column blocks
// along MN, `sbo` = 1024 (8 rows of K).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an in-flight wgmma writes or reads, so the compiler
// moves no access to them across the issue or the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Accumulator layout of m64nN (f32, N / 2 registers a thread): warp w of
// the warpgroup holds rows 16w .. 16w + 15; with g = lane / 4 and
// t = lane % 4, registers 4j .. 4j + 3 hold (row g, cols 8j + 2t, +1) and
// (row g + 8, the same cols), as m16n8k16's C fragment does n-tile by
// n-tile.  The register A operand is m16n8k16's A fragment per warp.

// d[0..64) += A (64 x 16, shared, K-major) * B (16 x 128, shared,
// K-major): wgmma.m64n128k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[0..16) += A (64 x 16, shared, K-major) * B (16 x 32, shared,
// K-major): wgmma.m64n32k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float* d, uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[0..64) += A (64 x 16, registers, the m16n8k16 A fragment per warp)
// * B (16 x 128, shared, MN-major: the transpose bit): wgmma.m64n128k16.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[0..32) += A (64 x 16, registers, the m16n8k16 A fragment per warp)
// * B (16 x 64, shared, MN-major: the transpose bit): wgmma.m64n64k16.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

}  // namespace hopper

// ---- host: tensor maps -----------------------------------------------------

namespace hopper_host {

// cuTensorMapEncodeTiled's type, as cuda.h declares it.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a contiguous [b, s, heads, d] bf16 tensor whose box
// is 64 elements of d (128 bytes, 128-byte swizzle) x one head x `rows`
// positions x one batch row.  Boxes reaching past s are zero-filled.
// Returns a cudaError_t code (0 on success).
inline int encode_bshd(CUtensorMap* map, const void* base, int b, int s,
                       int heads, int d, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, estride,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Raise a kernel's dynamic shared memory limit to `bytes`.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

}  // namespace hopper_host
}  // namespace kft

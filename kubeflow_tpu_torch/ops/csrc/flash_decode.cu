// Single-token decode attention for Hopper, bf16: one launch, a thread
// block cluster per (kv head, batch row).
//
// Replaces: kubeflow_tpu/ops/pallas/flash_decode.py `_decode_kernel` (via
// `flash_decode_ds`, `flash_decode`).  Same function: one query token per
// row, the q "tile" is the GQA group of g = h / kv_h heads that share a kv
// head (q head j <-> kv head j / g), one additive f32 bias row [b, S]
// shared by every head, softmax over the S cache slots, l == 0 -> 1.  A
// row whose bias masks every slot with -1e30 (as the reference pads)
// averages V uniformly, as the reference does.
//
// What bounds it on the H100: bytes.  Every cache byte is read once,
// 2*b*S*kv_h*d*2 bytes for K and V, against ~4 flops per cache element.
// At the serving shapes (b4, S of a few hundred) that is a few MB, a few
// microseconds of the card's bandwidth, so the latency of one launch, its
// loads and its merge decides the time.
//
// Design, and what it does about that:
// * One launch, no partial buffers in device memory.  A cluster of N
//   blocks works on each (kv head, batch row).  N <= kDecodeCluster (the
//   portable cluster size) is chosen on the host so that a block holds at
//   least kDecodeSlice keys (N = 1 for short S: a cluster of one) and
//   every cluster of the grid is resident at once (the largest N for
//   which cudaOccupancyMaxActiveClusters admits b * kv_h clusters): a
//   second wave cost ~10 us at b4 S544.  Each block computes the (max,
//   sum, unnormalised output) of every head of the group over its slice
//   of S and stores it into rank 0's shared memory (`mapa` +
//   `st.shared::cluster`: stores, so no block waits on a remote read);
//   after a cluster barrier rank 0 merges the N partials and writes the
//   bf16 output.  (The barrier's first phase, which every block must pass
//   before touching another's shared memory, is arrived at on entry and
//   waited for only before the stores.)
// * Loads in flight: a producer warp issues the slice's K and V as TMA
//   boxes of up to kDecodeChunk keys (two 64-column boxes a tensor at
//   d = 128, 128-byte swizzle; a first design's one bulk copy per
//   256-byte row ran the copy engine at 6 GB/s an SM) into a ring of
//   kDecodeStages stages with full/empty mbarriers.  Small chunks let the
//   first scores start while the rest of the slice is still arriving.
// * Each of the 8 consumer warps owns 8 keys of every chunk and runs its
//   own online softmax, so the chunk loop has no block-wide barrier (a
//   second design's score, softmax and P V passes, two __syncthreads a
//   chunk apart, took ~2900 cycles a 64-key chunk).  16 consumer warps in
//   two groups taking alternate chunks were faster only on long slices
//   (b1 S8192) and slower at the serving shapes: 17 warps leave a thread
//   96 registers, and ptxas spilled.  Scores on the
//   tensor cores: mma.sync m16n8k16 with the group's q rows as the A
//   operand (zero past g) and K from the swizzled tile, 32-bit loads that
//   meet no bank twice; bf16 products are exact in the f32 accumulator,
//   as in an f32 dot product.  P V in f32 on the FMA units: each lane
//   holds d / 32 output columns of every head and takes the heads'
//   probabilities from the lanes that computed them (shuffles).  The 8
//   warps' (max, sum, output) are merged once, at the end.
// * A block serves the whole GQA group, so each K/V byte is read from
//   device memory once, not once per query head.
// * The cache stays sequence-major [b, S, kv_h, d] (the model's layout).
//   Any S >= 1; the last chunk of a slice is partial, no padding copy.
// * The probabilities stay f32 in the P V sum (the TPU kernel rounds them
//   to the cache dtype first).
// * `-Xptxas -v`: 124 registers at d = 128 with a group of 4 (the
//   serving shape), 80-154 over every (d, group), no spill.  Dynamic
//   shared memory: 146 KiB at d = 128, group 4 (the ring 128 KiB, rank
//   0's partials 16 KiB); 163 KiB at group 8.
#include "kft_common.cuh"
#include "kft_hopper.cuh"

namespace {

namespace hw = kft::hopper;

constexpr int kDecodeSlice = 64;    // fewest keys a block of a cluster holds
constexpr int kDecodeCluster = 8;   // most blocks a cluster (portable size)
constexpr int kDecodeChunk = 64;    // most keys a ring stage holds
constexpr int kDecodeStages = 4;    // ring depth
constexpr int kConsumers = kDecodeChunk / 8;  // warps, 8 keys a chunk each
// The consumer warps and one producer warp: 288 threads.
constexpr int kThreads = (kConsumers + 1) * 32;

template <int D, int G>
struct DecodeSmem {
  static constexpr int NCB = D / 64;  // 64-column blocks of a row
  alignas(1024) __nv_bfloat16 k[kDecodeStages][NCB][kDecodeChunk * 64];
  alignas(1024) __nv_bfloat16 v[kDecodeStages][NCB][kDecodeChunk * 64];
  float wm[kConsumers][G], wl[kConsumers][G];  // each warp's max and sum
  float we[kConsumers][G];  // each warp's weight in the block's merge
  float bm[G], bl[G];       // the block's max and sum
  // Rank 0: each block's unnormalised output, max and sum per head.
  float part[kDecodeCluster][G][D];
  float pm[kDecodeCluster][G], pl[kDecodeCluster][G];
  uint64_t full[kDecodeStages];
  uint64_t empty[kDecodeStages];
};

template <int D, int G>
constexpr size_t decode_smem_bytes() {
  return sizeof(DecodeSmem<D, G>) + 1024;  // +1024 to align the base
}

// Byte offset of column `col` (even, below 64) of row j in a swizzled
// column block.
__device__ __forceinline__ int swz(int j, int col) {
  return j * 128 + (((col >> 3) ^ (j & 7)) << 4) + (col & 7) * 2;
}

// One block of the cluster of gridDim.x blocks that serves (kv head
// blockIdx.y, batch row blockIdx.z); TMA boxes of `chunk` keys.
template <int D, int G>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_kernel(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __nv_bfloat16* __restrict__ q,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ o, int S, int kvh,
                    float scale, int chunk) {
  using Smem = DecodeSmem<D, G>;
  constexpr int NCB = Smem::NCB;
  constexpr int KD = D / 16;   // k-steps of the score product
  constexpr int CPL = D / 32;  // output columns a lane, P V pass
  static_assert(G <= 8, "the group fills at most the 8 mma rows");
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kh = blockIdx.y, bi = blockIdx.z;
  const int n_blocks = gridDim.x;  // the cluster spans the grid's x
  const uint32_t rank = hw::cluster_rank();
  const int per = (S + n_blocks - 1) / n_blocks;
  const int c_begin = min(S, static_cast<int>(rank) * per);
  const int c_end = min(S, c_begin + per);
  const int n_chunks = (c_end - c_begin + chunk - 1) / chunk;

  if (tid == 0) {
    for (int s = 0; s < kDecodeStages; ++s) {
      hw::mbar_init(&sm.full[s], 1);
      hw::mbar_init(&sm.empty[s], kConsumers);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();
  hw::cluster_arrive();  // waited for before the first remote store

  float m_run = -INFINITY, l_run = 0.f;  // head g's, in lanes of row g
  float acc[G][CPL];                     // head h, columns of this lane
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int x = 0; x < CPL; ++x) acc[h][x] = 0.f;

  if (warp == kConsumers) {
    // The producer: chunk c's K and V boxes into stage c % kDecodeStages
    // once the consumers are past the chunk it held before.
    if (lane == 0) {
      hw::tma_prefetch_map(&tk);
      hw::tma_prefetch_map(&tv);
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % kDecodeStages;
        if (c >= kDecodeStages)
          hw::mbar_wait(&sm.empty[s], ((c / kDecodeStages) - 1) & 1);
        const int c0 = c_begin + c * chunk;
        hw::mbar_arrive_expect_tx(&sm.full[s], 2 * NCB * chunk * 128);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          hw::tma_load_4d(sm.k[s][cb], &tk, &sm.full[s], cb * 64, kh, c0,
                          bi);
          hw::tma_load_4d(sm.v[s][cb], &tv, &sm.full[s], cb * 64, kh, c0,
                          bi);
        }
      }
    }
  } else {
    // A consumer warp: keys 8 warp .. 8 warp + 7 of every chunk, with its
    // own online softmax.  The group's q rows are the mma A fragments:
    // row g (head g, zero past G) at columns 16 kk + 2t, +1 and
    // 16 kk + 8 + 2t, +1; rows g + 8 are zero.
    uint32_t qa[KD][4];
    const __nv_bfloat16* qrow = q + ((size_t)(bi * kvh + kh) * G + g) * D;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + c) : 0u;
      qa[kk][1] = 0u;
      qa[kk][2] =
          g < G ? *reinterpret_cast<const uint32_t*>(qrow + c + 8) : 0u;
      qa[kk][3] = 0u;
    }
    const float* brow = bias + (size_t)bi * S;
    const int key = warp * 8 + 2 * t;  // this lane's two score columns
    // The next chunk's bias, loaded a chunk ahead.
    auto bias_of = [&](int c, int i) {
      const int c0 = c_begin + c * chunk;
      return c < n_chunks && key + i < min(chunk, c_end - c0)
                 ? brow[c0 + key + i] : 0.f;
    };
    float nb0 = bias_of(0, 0), nb1 = bias_of(0, 1);
    const int col = (D == 128 ? 4 : 2) * lane;  // first output column
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % kDecodeStages;
      const int n = min(chunk, c_end - (c_begin + c * chunk));
      const float b0 = nb0, b1 = nb1;
      nb0 = bias_of(c + 1, 0);
      nb1 = bias_of(c + 1, 1);
      hw::mbar_wait(&sm.full[s], (c / kDecodeStages) & 1);
      if (warp * 8 < n) {
        // Scores (B column g is key 8 warp + g), the k-steps in two
        // independent chains.
        float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
        const int j = warp * 8 + g;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const char* blk = reinterpret_cast<const char*>(sm.k[s][kk / 4]);
          const int kc = (kk % 4) * 16 + 2 * t;
          kft::mma16816(kk % 2 ? sb : sa, qa[kk],
                        *reinterpret_cast<const uint32_t*>(blk + swz(j, kc)),
                        *reinterpret_cast<const uint32_t*>(
                            blk + swz(j, kc + 8)));
        }
        const float s0 = key < n ? (sa[0] + sb[0]) * scale + b0 : -INFINITY;
        const float s1 =
            key + 1 < n ? (sa[1] + sb[1]) * scale + b1 : -INFINITY;
        // Head g's max over the warp's keys (the 4 lanes of row g), its
        // rescale and probabilities; key 8 warp < n is finite.
        float cm = fmaxf(s0, s1);
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 1));
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 2));
        const float m_new = fmaxf(m_run, cm);
        const float al = __expf(m_run - m_new);  // 0 at the first chunk
        const float p0 = __expf(s0 - m_new), p1 = __expf(s1 - m_new);
        m_run = m_new;
        l_run = l_run * al + p0 + p1;
        // acc = acc * alpha + P V: every lane takes each head's alpha
        // and probabilities from the lanes of its row.
        const char* vb = reinterpret_cast<const char*>(sm.v[s][col / 64]);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float a = __shfl_sync(0xffffffffu, al, 4 * h);
#pragma unroll
          for (int x = 0; x < CPL; ++x) acc[h][x] *= a;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int row = warp * 8 + jj;
          float vf[CPL];
          if constexpr (CPL == 4) {
            const uint2 u = *reinterpret_cast<const uint2*>(
                vb + swz(row, col % 64));
            const float2 lo = kft::unpack_bf16x2(u.x);
            const float2 hi = kft::unpack_bf16x2(u.y);
            vf[0] = lo.x; vf[1] = lo.y; vf[2] = hi.x; vf[3] = hi.y;
          } else {
            const float2 lo = kft::unpack_bf16x2(
                *reinterpret_cast<const uint32_t*>(vb + swz(row, col % 64)));
            vf[0] = lo.x; vf[1] = lo.y;
          }
#pragma unroll
          for (int h = 0; h < G; ++h) {
            const float p = __shfl_sync(0xffffffffu, (jj & 1) ? p1 : p0,
                                        4 * h + jj / 2);
#pragma unroll
            for (int x = 0; x < CPL; ++x) acc[h][x] = fmaf(p, vf[x], acc[h][x]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&sm.empty[s]);
    }
    // The warp's sum per head over the 4 lanes of its row.
    l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
    l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  }

  // The block's partial: the consumer warps' (max, sum, acc) merged
  // through the ring (free once every chunk has been consumed), then
  // stored into rank 0.
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(&sm.k[0][0][0]);  // [warp][G][D]
  if (warp < kConsumers) {
    const int col = (D == 128 ? 4 : 2) * lane;
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int x = 0; x < CPL; ++x)
        wacc[(warp * G + h) * D + col + x] = acc[h][x];
    if (t == 0 && g < G) {
      sm.wm[warp][g] = m_run;
      sm.wl[warp][g] = l_run;
    }
  }
  __syncthreads();
  // Thread h < G: head h's block max and sum, and each warp's weight.
  if (tid < G) {
    float mx = -INFINITY, l = 0.f;
    for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, sm.wm[w][tid]);
    for (int w = 0; w < kConsumers; ++w) {
      const float e = __expf(sm.wm[w][tid] - mx);  // 0 for a warp of no key
      sm.we[w][tid] = e;
      l = fmaf(sm.wl[w][tid], e, l);
    }
    sm.bm[tid] = mx;
    sm.bl[tid] = l;
  }
  hw::cluster_wait();  // every block of the cluster has started
  __syncthreads();
  if (tid < G) {
    hw::st_cluster(&sm.pm[rank][tid], 0, sm.bm[tid]);
    hw::st_cluster(&sm.pl[rank][tid], 0, sm.bl[tid]);
  }
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w)
      a = fmaf(wacc[w * G * D + i], sm.we[w][h], a);
    hw::st_cluster(&sm.part[rank][h][i % D], 0, a);
  }

  // Rank 0 merges the cluster's partials and writes the output.
  hw::cluster_sync();
  if (rank == 0) {
    for (int i = tid; i < G * D; i += kThreads) {
      const int h = i / D, d = i % D;
      float mx = -INFINITY;
      for (int r = 0; r < n_blocks; ++r) mx = fmaxf(mx, sm.pm[r][h]);
      float l = 0.f, a = 0.f;
      for (int r = 0; r < n_blocks; ++r) {
        const float w = __expf(sm.pm[r][h] - mx);
        l = fmaf(sm.pl[r][h], w, l);
        a = fmaf(sm.part[r][h][d], w, a);
      }
      if (l == 0.f) l = 1.f;
      o[((size_t)(bi * kvh + kh) * G + h) * D + d] = __float2bfloat16_rn(a / l);
    }
  }
}

template <int D, int G>
cudaLaunchConfig_t launch_config(int n, int b, int kvh, cudaStream_t s,
                                 cudaLaunchAttribute* cluster) {
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n, kvh, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = decode_smem_bytes<D, G>();
  cfg.stream = s;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

// The most clusters of n blocks the card holds at once, asked once per n.
template <int D, int G>
int max_clusters(int n) {
  static int known[kDecodeCluster + 1] = {};
  if (known[n] == 0) {
    cudaLaunchAttribute cluster[1];
    cudaLaunchConfig_t cfg = launch_config<D, G>(n, 1, 1, nullptr, cluster);
    int count = 0;
    if (cudaOccupancyMaxActiveClusters(&count, flash_decode_kernel<D, G>,
                                       &cfg) != cudaSuccess)
      count = 1;
    known[n] = max(1, count);
  }
  return known[n];
}

template <int D, int G>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* o, int b, int S, int kvh, float scale, cudaStream_t s) {
  namespace hh = kft::hopper_host;
  static const int attr =
      hh::allow_smem(flash_decode_kernel<D, G>, decode_smem_bytes<D, G>());
  if (attr != 0) return attr;
  // Blocks of >= kDecodeSlice keys, at most kDecodeCluster a cluster, and
  // every cluster of the grid resident at once.
  int n = max(1, min(kDecodeCluster, S / kDecodeSlice));
  while (n > 1 && b * kvh > max_clusters<D, G>(n)) --n;
  const int per = (S + n - 1) / n;
  const int chunk = min(kDecodeChunk, (per + 7) / 8 * 8);
  CUtensorMap tk, tv;
  int err = hh::encode_bshd(&tk, k, b, S, kvh, D, chunk);
  if (err == 0) err = hh::encode_bshd(&tv, v, b, S, kvh, D, chunk);
  if (err != 0) return err;
  cudaLaunchAttribute cluster[1];
  const cudaLaunchConfig_t cfg = launch_config<D, G>(n, b, kvh, s, cluster);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<D, G>, tk, tv,
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(o), S, kvh, scale, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_g(int g, const void* q, const void* k, const void* v,
             const void* bias, void* o, int b, int S, int kvh, float scale,
             cudaStream_t s) {
  switch (g) {
    case 1: return launch<D, 1>(q, k, v, bias, o, b, S, kvh, scale, s);
    case 2: return launch<D, 2>(q, k, v, bias, o, b, S, kvh, scale, s);
    case 4: return launch<D, 4>(q, k, v, bias, o, b, S, kvh, scale, s);
    case 8: return launch<D, 8>(q, k, v, bias, o, b, S, kvh, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int kft_flash_decode(const void* q, const void* k, const void* v,
                                const void* bias, void* o, int b, int S,
                                int h, int kvh, int d, float scale,
                                void* stream) {
  if (h % kvh != 0 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = h / kvh;
  if (d == 128) return launch_g<128>(g, q, k, v, bias, o, b, S, kvh, scale, s);
  if (d == 64) return launch_g<64>(g, q, k, v, bias, o, b, S, kvh, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

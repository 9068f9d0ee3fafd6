// dw_phase2: phase 2 of every backward of the port, shared by
// mlp_chain_bwd.cu (K1b, K2b, K8b, K9s, K9m) and fused_block.cu (K4 and K5,
// pre and post).  Phase 1 (one block per 64-row tile) writes, per weight
// gradient, the bf16 output cotangent D of the product and, per row tile,
// fp32 column sums (bias, LayerNorm, head and loss partials).  Phase 2 turns
// them into dW = D^T H over all rows and the column sums over all row tiles.
// In the TPU kernels these sums are the VMEM accumulators the sequential grid
// carries across row tiles: cusrl_tpu/nn/kernels/fused_mlp.py `_run_bwd`,
// `_pair_run_bwd` and `_pair_heads_run_bwd`, fused_ppo_step.py
// `_run_loss_bwd` and `_run_ppo_step`, fused_block.py `_pre_run_bwd`,
// `_post_run_bwd` and their pair forms.
//
// What bounds it on the H100: bytes.  Each product reads its D and H once
// (bf16, or fp32 for some H) and does 2 * n_out * n_in FLOP per row, 64-512
// FLOP per byte at the port's widths, below the card's ~295 only for the
// narrow products and close to it for the rest; at TL's 65,536 rows the post
// backward's three products read ~218 MB (0.065 ms at 3.35 TB/s).  The design,
// one launch:
//   * the grid is (row splits, dW tiles, chains): each block accumulates one
//     dW tile of 128 outputs (two consumer warpgroups of 64, fp32
//     accumulators in registers) by 256 inputs (wgmma m64n256k16), or by 128
//     where it converts H, over one contiguous range of 64-row tiles.  The
//     rows are the products' K, so D [rows, n_out] and H [rows, n_in] are
//     both MN-major operands: TMA loads 64 x 64 boxes with the 128-byte
//     swizzle straight into the layout a transposed wgmma operand reads, and
//     no thread moves them;
//   * a producer thread keeps a ring of up to 224 KB in flight (3 to 8
//     stages by the tile's width); an fp32 H is loaded as it is and a saved
//     gelu pre-activation in place, and the consumers turn stage k into the
//     bf16 operand while stage k - 1's products run;
//   * the other three producer warps sum the column partials of the block's
//     share of the columns over its rows;
//   * the row splits of a tile form clusters of up to 8 blocks: each block
//     leaves its fp32 partial tile (and column sums) in shared memory, and
//     block r of the cluster adds slice r of the cluster's partials through
//     distributed shared memory, in rank order.  Where a tile has more
//     splits than a cluster, each cluster writes its reduced slices to a
//     scratch and the last cluster to finish a slice (an integer semaphore
//     per slice, reset by that block) adds the clusters' slices in cluster
//     order.  The plan is a pure function of the shapes, chosen in Python
//     (nn/kernels/dw_phase2.py: one wave of blocks; each job's kind of H too), so a shape always sums
//     in the same order: no float atomics, two calls give the same bits.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "hopper_wg.cuh"
#include "mlp_chain.cuh"

#define DW_MAX_JOBS 8
#define DW_MAX_SUMS 12

// Phase 2's plan and scratch for one launch, from Python (mirrored by ctypes
// in cusrl_tpu_torch/nn/kernels/dw_phase2.py, DwScratch).
struct DwScratch {
  void* partials;  // fp32 [chains][tiles][splits / cluster][vec]: each cluster's reduced partial (unused for one cluster)
  void* counters;  // int32 [chains][tiles][cluster]: 0 between launches (each semaphore's last block resets it)
  int splits;      // row splits per tile, a multiple of cluster
  int cluster;     // blocks per cluster (1, 2, 4 or 8)
  int tiles;       // dW tiles per chain
  int col_chunk;   // column sums per tile (a multiple of 32); vec = 128 * 256 + col_chunk
  int kinds[DW_MAX_JOBS];  // each job's dw::HKind: what its H is, and so its tile width
};

namespace dw {

using mlp::bf16;

enum HKind { H_BF16 = 0, H_F32 = 1, H_SAVED = 2 };  // H_SAVED: bf16 saved gelu pre-activation -> bf16(gelu(z))

// One weight gradient dW[n_out, n_in] = D[:, d_col : d_col + n_out]^T H.
struct Job {
  const void* d;  // bf16 [N, d_ld]
  const void* h;  // [N, n_in]: bf16 (H_BF16, H_SAVED) or fp32 (H_F32)
  float* dw;      // out [n_out, n_in]
  int d_ld, d_col, n_out, n_in;
  int h_kind;     // DwScratch::kinds[job], set by launch
};

// One column sum over the row tiles: out[j * out_stride] = sum_t part[t * part_ld + col0 + j], j < width.
struct Sum {
  const float* part;  // [row_tiles, part_ld] per-row-tile partials from phase 1
  float* out;
  int part_ld, col0, width, out_stride;
};

// What a call site fills in: the jobs and sums of each chain.
struct Phase2 {
  Job job[2][DW_MAX_JOBS];  // per chain; the chains' jobs have the same shapes
  Sum sum[2][DW_MAX_SUMS];
  int num_jobs, num_sums[2];
  int num_rows;
};

// The kernel's parameter: the jobs, their tensor maps (D and H per chain and
// job) and the plan.
struct alignas(64) Params {
  CUtensorMap map[2][DW_MAX_JOBS][2];
  Phase2 P;
  float* partials;
  int* counters;
  int row_tiles, splits, cluster, groups, tiles, col_chunk, vec, ring_bytes;
  int col_floats[2];
};

constexpr int RT = 64;                       // rows per stage: one phase-1 row tile (mlp::BM)
constexpr int TILE_M = 128;                  // dW tile outputs: two consumer warpgroups of 64
constexpr int HALF = 64;                     // outputs per consumer warpgroup
constexpr int TILE_N = 256;                  // dW tile inputs with a bf16 H (wgmma's widest N)
constexpr int TILE_N_CONVERTED = 128;        // with an H the block converts: twice the tiles to share the work
constexpr int THREADS = 384;                 // warpgroup 0: producer and column sums; 1, 2: consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int BOX = RT * 64 * 2;             // 8 KB: a 64-row x 64-column bf16 box, 128-byte swizzle
constexpr int BOX_F32 = RT * 64 * 4;         // 16 KB: the same box of fp32, unswizzled
constexpr int MAX_STAGES = 8;
constexpr int MAX_RING = 224 * 1024;         // seven 32 KB stages where the column sums leave room
constexpr int MIN_RING = TILE_M * TILE_N * 4;  // 128 KB: the widest partial tile, left in the ring
constexpr int MAX_CLUSTER = 8;
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8 + 16;  // and the last-cluster flag
constexpr int ALIGN_SLACK = 1024;            // the dynamic base aligned up to 1,024 bytes
static_assert(RT == mlp::BM, "a stage is one phase-1 row tile");

__host__ __device__ inline int tile_n(int kind) { return kind == H_BF16 ? TILE_N : TILE_N_CONVERTED; }

__host__ __device__ inline int job_tiles(const Job& j) {
  return ((j.n_out + TILE_M - 1) / TILE_M) * ((j.n_in + tile_n(j.h_kind) - 1) / tile_n(j.h_kind));
}

// A stage of a tile whose H takes `hb` 64-column blocks: D's two output
// halves, H's blocks as the products read them, and for an fp32 H the
// blocks as loaded.
__host__ __device__ inline int stage_bytes(int kind, int hb) {
  return 2 * BOX + hb * BOX + (kind == H_F32 ? hb * BOX_F32 : 0);
}

__host__ __device__ inline int ring_stages(int kind, int hb, int ring_bytes) {
  const int fit = ring_bytes / stage_bytes(kind, hb);
  return fit < MAX_STAGES ? fit : MAX_STAGES;
}

// ---- TMA, clusters --------------------------------------------------------

// A 2-D box of `map` at column x, row y into shared memory; completion counts
// against `bar`'s transactions.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
          wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(wg::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every block of the cluster: writes before it are visible
// to reads after it, shared memory of the whole cluster included.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float4 ld_peer(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// ---- the block's work -----------------------------------------------------

struct Tile {
  int job, o0, i0, kind, n_out, n_in;
  int halves;  // output halves with rows (1 or 2)
  int blocks;  // 64-column input blocks with columns (1 to 4)
  int hb;      // H blocks a stage holds and the products take: 1, 2 or 4 (NA = 32 hb)
  int sb;      // bytes of a stage
};

__device__ __forceinline__ Tile find_tile(const Params& p, int chain, int t) {
  int j = 0;
  while (t >= job_tiles(p.P.job[chain][j])) t -= job_tiles(p.P.job[chain][j++]);
  const Job& jb = p.P.job[chain][j];
  const int tn = tile_n(jb.h_kind), i_tiles = (jb.n_in + tn - 1) / tn;
  Tile T;
  T.job = j;
  T.o0 = (t / i_tiles) * TILE_M;
  T.i0 = (t % i_tiles) * tn;
  T.kind = jb.h_kind;
  T.n_out = jb.n_out;
  T.n_in = jb.n_in;
  T.halves = jb.n_out - T.o0 > HALF ? 2 : 1;
  T.blocks = min((jb.n_in - T.i0 + 63) / 64, tn / 64);
  T.hb = T.blocks > 2 ? 4 : T.blocks;
  T.sb = stage_bytes(T.kind, T.hb);
  return T;
}

// The producer thread: stage k holds row tile r0 + k, D's output halves at
// [0, 16 KB), H's input blocks from 16 KB on (bf16), and for an fp32 H the
// blocks as loaded after them.
__device__ __forceinline__ void produce(const Params& p, int chain, const Tile& T, int r0, int stages, int ns,
                                        unsigned char* ring, uint64_t* full, uint64_t* empty) {
  const CUtensorMap* md = &p.map[chain][T.job][0];
  const CUtensorMap* mh = &p.map[chain][T.job][1];
  const bool f32 = T.kind == H_F32;
  const uint32_t bytes = T.halves * BOX + T.blocks * (f32 ? BOX_F32 : BOX);
  for (int k = 0; k < stages; ++k) {
    const int slot = k % ns;
    if (k >= ns) wg::mbar_wait(&empty[slot], ((k / ns) - 1) & 1);
    unsigned char* s = ring + slot * T.sb;
    const int row = (r0 + k) * RT;
    wg::mbar_expect_tx(&full[slot], bytes);
    for (int h = 0; h < T.halves; ++h) tma_load(s + h * BOX, md, T.o0 + h * HALF, row, &full[slot]);
    for (int b = 0; b < T.blocks; ++b)
      tma_load(s + (f32 ? (2 + T.hb) * BOX + b * BOX_F32 : (2 + b) * BOX), mh, T.i0 + b * 64, row, &full[slot]);
  }
}

// bf16(gelu(z)) of the tanh form, written as z sigmoid(2u) = z / (1 + e^-2u)
// with u = sqrt(2/pi) (z + 0.044715 z^3): 0.5 z (1 + tanh u) in a few fp32
// ulps of the forward's tanhf at a fraction of its instructions, so that the
// recomputation keeps up with the loads (the bf16 value differs from the
// forward's where the fp32 one lies within those ulps of a rounding edge).
__device__ __forceinline__ bf16 gelu_bf16(bf16 s) {
  const float z = __bfloat162float(s);
  const float u = mlp::GELU_C * (z + 0.044715f * z * z * z);
  return __float2bfloat16(__fdividef(z, 1.f + __expf(-2.f * u)));
}

// H of one stage into the bf16 operand the products read, by the 256
// consumer threads (`ct`): an fp32 H converted from its unswizzled boxes
// into the swizzled layout, a saved gelu pre-activation z replaced by
// bf16(gelu(z)) in place.
__device__ __forceinline__ void convert_h(unsigned char* s, const Tile& T, int ct) {
  unsigned char* h = s + 2 * BOX;
  const int units = T.blocks * (BOX / 16);  // 16-byte chunks of bf16
  if (T.kind == H_F32) {
    for (int u = ct; u < units; u += 256) {
      const int b = u >> 9, m = (u >> 3) & 63, c = u & 7;
      const float4* src = reinterpret_cast<const float4*>(s + (2 + T.hb) * BOX + b * BOX_F32 + m * 256 + c * 32);
      const float4 a = src[0], e = src[1];
      *reinterpret_cast<uint4*>(h + b * BOX + m * 128 + ((c ^ (m & 7)) << 4)) =
          make_uint4(wg::pack2(a.x, a.y), wg::pack2(a.z, a.w), wg::pack2(e.x, e.y), wg::pack2(e.z, e.w));
    }
  } else {
    for (int u = ct; u < units; u += 256) {
      uint4 v = *reinterpret_cast<const uint4*>(h + u * 16);
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = gelu_bf16(e[i]);
      *reinterpret_cast<uint4*>(h + u * 16) = v;
    }
  }
  wg::fence_async_smem();
}

// Descriptor of an MN-major operand at shared address `addr`: 64-element
// rows of the MN dimension, 128 bytes apart along K, with the 128-byte
// swizzle; 8-row groups 1,024 bytes apart, the next 64 MN elements `lbo`
// bytes on.  Stepping 16 rows of K adds 2,048 bytes.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// The consumer warpgroup `half`: acc[64 outputs x (2 NA) inputs] += D^T H
// over the block's stages, handing each slot back once its products are done.
template <int NA>
__device__ __forceinline__ void consume(float (&acc)[NA], const Tile& T, int half, int stages, int ns,
                                        unsigned char* ring, uint64_t* full, uint64_t* empty) {
  const bool active = half < T.halves;
  const bool convert = T.kind != H_BF16;
  const int ct = threadIdx.x - 128;
  wg::zero(acc);
  wg::fence_regs(acc);
  for (int k = 0; k < stages; ++k) {
    const int slot = k % ns;
    unsigned char* s = ring + slot * T.sb;
    wg::mbar_wait(&full[slot], (k / ns) & 1);
    if (convert) {
      convert_h(s, T, ct);
      wg::group_sync(1, 256);
    }
    if (active) {
      wg::wgmma_fence();
      const uint32_t a = wg::smem_u32(s + half * BOX), b = wg::smem_u32(s + 2 * BOX);
#pragma unroll
      for (int kk = 0; kk < RT / 16; ++kk) wg::wgmma_mn(acc, desc_mn(a + kk * 2048, BOX), desc_mn(b + kk * 2048, BOX));
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
    }
    if (k > 0) wg::mbar_arrive_if(&empty[(k - 1) % ns], (threadIdx.x & 31) == 0);
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);
}

// The warpgroup's accumulators into rows [64 half, 64 half + 64) of the
// block's fp32 partial tile ([128][2 NA] at `part`).
template <int NA>
__device__ __forceinline__ void store_partial(const float (&acc)[NA], int half, float* part) {
  const wg::Frag f(threadIdx.x & 127);
  const int row = half * HALF + f.row;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int col = 8 * j + f.col;
    *reinterpret_cast<float2*>(part + row * (2 * NA) + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(part + (row + 8) * (2 * NA) + col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Column sum q of `chain` over row tiles [r0, r1): four running sums over
// the row tiles by their index mod 4, added in a fixed order.
__device__ __forceinline__ float column_sum(const Params& p, int chain, int q, int r0, int r1) {
  int s = 0, j = q;
  while (j >= p.P.sum[chain][s].width) j -= p.P.sum[chain][s++].width;
  const Sum& sm = p.P.sum[chain][s];
  const float* part = sm.part + sm.col0 + j;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  int r = r0;
  for (; r + 4 <= r1; r += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) a[u] += part[size_t(r + u) * sm.part_ld];
  }
#pragma unroll
  for (int u = 0; u < 3; ++u)
    if (r + u < r1) a[u] += part[size_t(r + u) * sm.part_ld];
  return (a[0] + a[1]) + (a[2] + a[3]);
}

__device__ __forceinline__ void write_column(const Params& p, int chain, int q, float v) {
  int s = 0, j = q;
  while (j >= p.P.sum[chain][s].width) j -= p.P.sum[chain][s++].width;
  const Sum& sm = p.P.sum[chain][s];
  sm.out[size_t(j) * sm.out_stride] = v;
}

// Four floats of the tile's reduced vector from element e (a multiple of 4):
// the partial tile's dW entries below 128 x 64 hb, then the tile's share of
// the column sums.
__device__ __forceinline__ void write_out(const Params& p, int chain, int tile, const Tile& T, int e, float4 v) {
  const int width = 64 * T.hb, partial = TILE_M * width;
  if (e < partial) {
    const int o = T.o0 + e / width, i = T.i0 + e % width;
    if (o < T.n_out && i < T.n_in)
      *reinterpret_cast<float4*>(p.P.job[chain][T.job].dw + size_t(o) * T.n_in + i) = v;
    return;
  }
  const int q = tile * p.col_chunk + (e - partial);
  const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (q + u < p.col_floats[chain]) write_column(p, chain, q + u, w[u]);
}

// A consumer warpgroup's part: the products, then (after every role's
// work, named barrier 2) its accumulators into the partial tile at the
// ring's start.
template <int NA>
__device__ __forceinline__ void consumer(const Tile& T, int half, int stages, int ns, unsigned char* ring,
                                         uint64_t* full, uint64_t* empty) {
  float acc[NA];
  consume(acc, T, half, stages, ns, ring, full, empty);
  wg::group_sync(2, THREADS);
  store_partial(acc, half, reinterpret_cast<float*>(ring));
}

// Grid (splits, tiles, chains) in clusters of `cluster` splits; THREADS
// threads and block_smem(p.ring_bytes, p.col_chunk) bytes of shared memory.
__global__ void __launch_bounds__(THREADS, 1) phase2_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char raw_smem[];
  unsigned char* ring = wg::aligned_base(raw_smem);
  float* cols = reinterpret_cast<float*>(ring + p.ring_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(cols + p.col_chunk);
  uint64_t* empty = full + MAX_STAGES;
  int* last = reinterpret_cast<int*>(empty + MAX_STAGES);

  const int split = blockIdx.x, tile = blockIdx.y, chain = blockIdx.z;
  const Tile T = find_tile(p, chain, tile);
  const int r0 = int(int64_t(split) * p.row_tiles / p.splits);
  const int r1 = int(int64_t(split + 1) * p.row_tiles / p.splits);
  const int stages = r1 - r0;
  const int ns = ring_stages(T.kind, T.hb, p.ring_bytes);
  const int warp = wg::warp_index();

  if (threadIdx.x == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  // Roles by warp; each ends at named barrier 2, after which the ring holds
  // the partial tile (every product is done).
  if (warp >= 4) {
    if (T.hb == 4) {
      consumer<128>(T, warp / 4 - 1, stages, ns, ring, full, empty);
    } else if (T.hb == 2) {
      consumer<64>(T, warp / 4 - 1, stages, ns, ring, full, empty);
    } else {
      consumer<32>(T, warp / 4 - 1, stages, ns, ring, full, empty);
    }
  } else {
    if (warp == 0) {
      if (threadIdx.x == 0) produce(p, chain, T, r0, stages, ns, ring, full, empty);
      __syncwarp();
    } else {
      const int q0 = tile * p.col_chunk;
      for (int q = threadIdx.x - 32; q < p.col_chunk; q += 96)
        cols[q] = q0 + q < p.col_floats[chain] ? column_sum(p, chain, q0 + q, r0, r1) : 0.f;
    }
    wg::group_sync(2, THREADS);
  }
  float* part = reinterpret_cast<float*>(ring);
  cluster_sync();  // every block of the cluster holds its partial

  // Block r of the cluster adds slice r of the cluster's partials in rank
  // order: the tile's vector, its partial tile then its column sums.
  const int rank = cluster_rank(), group = split / p.cluster;
  const int partial = TILE_M * 64 * T.hb, slice = (partial + p.col_chunk) / p.cluster, e0 = rank * slice;
  float* out = p.groups > 1 ? p.partials + ((size_t(chain) * p.tiles + tile) * p.groups + group) * p.vec : nullptr;
  constexpr int U = 2;  // float4s of a thread in flight from every block of the cluster
  for (int e = e0 + 4 * threadIdx.x; e < e0 + slice; e += 4 * THREADS * U) {
    float4 v[U][MAX_CLUSTER];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int eu = e + 4 * THREADS * u;
      const uint32_t addr = eu < partial ? wg::smem_u32(part + eu) : wg::smem_u32(cols + (eu - partial));
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < p.cluster && eu < e0 + slice) v[u][q] = ld_peer(addr, q);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int eu = e + 4 * THREADS * u;
      if (eu >= e0 + slice) break;
#pragma unroll
      for (int q = 1; q < MAX_CLUSTER; ++q)
        if (q < p.cluster) add4(v[u][0], v[u][q]);
      if (out) {
        *reinterpret_cast<float4*>(out + eu) = v[u][0];
      } else {
        write_out(p, chain, tile, T, eu, v[u][0]);
      }
    }
  }
  cluster_sync();  // no block leaves while another reads its shared memory
  if (p.groups == 1) return;

  // Several clusters: the last to finish slice r adds the clusters' slices in cluster order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = p.counters + (size_t(chain) * p.tiles + tile) * p.cluster + rank;
    *last = atomicAdd(counter, 1) == p.groups - 1;
    if (*last) *counter = 0;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* src = p.partials + (size_t(chain) * p.tiles + tile) * p.groups * p.vec;
  constexpr int V = 4, G = 4;  // float4s of a thread from each cluster's slice, clusters at once
  for (int e = e0 + 4 * threadIdx.x; e < e0 + slice; e += 4 * THREADS * V) {
    float4 total[V];
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (e + 4 * THREADS * u < e0 + slice) total[u] = __ldcg(reinterpret_cast<const float4*>(src + e + 4 * THREADS * u));
    for (int g0 = 1; g0 < p.groups; g0 += G) {  // G clusters' slices in flight, added in cluster order
      float4 v[G][V];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < V; ++u)
          if (g0 + g < p.groups && e + 4 * THREADS * u < e0 + slice)
            v[g][u] = __ldcg(reinterpret_cast<const float4*>(src + size_t(g0 + g) * p.vec + e + 4 * THREADS * u));
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < V; ++u)
          if (g0 + g < p.groups && e + 4 * THREADS * u < e0 + slice) add4(total[u], v[g][u]);
    }
#pragma unroll
    for (int u = 0; u < V; ++u)
      if (e + 4 * THREADS * u < e0 + slice) write_out(p, chain, tile, T, e + 4 * THREADS * u, total[u]);
  }
}

// ---- the launch -------------------------------------------------------------

inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// The map of a row-major [rows, cols] matrix at `base` (rows `ld` elements
// apart) in 64-column x 64-row boxes: bf16 with the 128-byte swizzle, or
// fp32 unswizzled.
inline bool encode_map(CUtensorMap* map, const void* base, bool f32, int cols, int rows, int ld) {
  const auto fn = encode_tiled();
  if (fn == nullptr) return false;
  const int es = f32 ? 4 : 2;
  cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  cuuint64_t strides[1] = {cuuint64_t(ld) * es};
  cuuint32_t box[2] = {64, RT};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            f32 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Shared memory of a block: the ring, the column sums, the barriers.
inline int block_smem(int ring_bytes, int col_chunk) {
  return ALIGN_SLACK + ring_bytes + col_chunk * 4 + BAR_BYTES;
}

// The ring: what the column sums and barriers leave of a block's shared
// memory, in 8 KB steps, at most MAX_RING.  Read, with ring_stages, through dw_phase2_stages.
inline int ring_bytes(int col_chunk) {
  return std::min(MAX_RING, (wg::BLOCK_SMEM - block_smem(0, col_chunk)) / BOX * BOX);
}

// Checks the jobs, sums and plan `S` against each other and launches phase 2
// for `chains` chains on `stream`; returns a cudaError_t.  P's jobs (but
// their kinds, which S gives), sums, num_jobs, num_sums and num_rows are set.
inline int launch(Phase2& P, int chains, const DwScratch* S, cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (S == nullptr || chains < 1 || chains > 2 || P.num_jobs < 1 || P.num_jobs > DW_MAX_JOBS || P.num_rows < 1)
    return invalid;
  Params p{};
  p.P = P;
  p.row_tiles = (P.num_rows + RT - 1) / RT;
  p.splits = S->splits;
  p.cluster = S->cluster;
  p.col_chunk = S->col_chunk;
  p.vec = MIN_RING / 4 + S->col_chunk;  // the scratch's stride: the widest tile's vector
  if (p.cluster < 1 || p.cluster > MAX_CLUSTER || (p.cluster & (p.cluster - 1)) || p.splits < p.cluster ||
      p.splits % p.cluster || p.splits > p.row_tiles || p.col_chunk < 0 || p.col_chunk % 32)
    return invalid;  // every split holds a row tile; slices of whole float4s
  p.groups = p.splits / p.cluster;
  for (int j = 0; j < P.num_jobs; ++j) {
    if (S->kinds[j] < H_BF16 || S->kinds[j] > H_SAVED) return invalid;
    for (int c = 0; c < chains; ++c) p.P.job[c][j].h_kind = S->kinds[j];
  }
  p.tiles = 0;
  for (int j = 0; j < P.num_jobs; ++j) p.tiles += job_tiles(p.P.job[0][j]);
  if (p.tiles != S->tiles || (p.groups > 1 && (S->partials == nullptr || S->counters == nullptr))) return invalid;
  p.partials = static_cast<float*>(S->partials);
  p.counters = static_cast<int*>(S->counters);
  for (int c = 0; c < chains; ++c) {
    if (P.num_sums[c] < 0 || P.num_sums[c] > DW_MAX_SUMS) return invalid;
    int cols = 0;
    for (int s = 0; s < P.num_sums[c]; ++s) cols += P.sum[c][s].width;
    if (cols > p.tiles * p.col_chunk) return invalid;
    p.col_floats[c] = cols;
    for (int j = 0; j < P.num_jobs; ++j) {
      const Job& jb = p.P.job[c][j];
      if (jb.n_out != P.job[0][j].n_out || jb.n_in != P.job[0][j].n_in || jb.n_out % 16 || jb.n_in % 16 ||
          jb.d_ld % 8 || jb.d_col % 8 || !aligned16(jb.d) || !aligned16(jb.h) || !aligned16(jb.dw))
        return invalid;  // TMA's 16-byte rows and addresses, the float4 stores
      const void* d = static_cast<const bf16*>(jb.d) + jb.d_col;
      if (!encode_map(&p.map[c][j][0], d, false, jb.n_out, P.num_rows, jb.d_ld) ||
          !encode_map(&p.map[c][j][1], jb.h, jb.h_kind == H_F32, jb.n_in, P.num_rows, jb.n_in))
        return invalid;
    }
  }
  p.ring_bytes = ring_bytes(p.col_chunk);
  if (p.ring_bytes < MIN_RING || ring_stages(H_F32, 2, p.ring_bytes) < 2) return invalid;
  const int smem = block_smem(p.ring_bytes, p.col_chunk);
  cudaError_t err = cudaFuncSetAttribute(phase2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.tiles, chains);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, phase2_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of clusters of `cluster` that the card runs at once (0 where the
// query fails): the plan's one wave, printed beside its time.
inline int max_active_blocks(int cluster, int col_chunk) {
  const int smem = block_smem(ring_bytes(col_chunk), col_chunk);
  if (cudaFuncSetAttribute(phase2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, phase2_kernel, &cfg) != cudaSuccess) return 0;
  return clusters * cluster;
}

}  // namespace dw

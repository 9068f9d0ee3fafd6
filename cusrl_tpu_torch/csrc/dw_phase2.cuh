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
// backward's three products read ~218 MB (0.065 ms at 3.35 TB/s).  The design:
//   * the rows are split over blocks: the grid is (dW tiles, row splits,
//     chains), each block accumulating its 64 x 64 dW tile over one
//     contiguous range of row tiles in fp32 WMMA fragments.  The split count
//     is a pure function of the shapes, chosen in Python
//     (nn/kernels/dw_phase2.py: about four blocks per SM, at least four row
//     tiles per split), so a shape always sums in the same order;
//   * row tiles stream through a two-stage ring in shared memory: bf16
//     operands by 16-byte cp.async, fp32 or recomputed (gelu) operands by
//     16-byte loads into registers, converted there and stored after the
//     current tile's products, so the next tile's loads overlap them;
//   * each block writes its fp32 partial tile to a scratch [splits, dW] and
//     the same launch sums each split's rows of the column partials; a
//     second launch adds the splits in order and writes dW and the sums.
//     No atomics: two calls give the same bits.
#pragma once

#include <mma.h>
#include <stdint.h>

#include "mlp_chain.cuh"

#define DW_MAX_JOBS 8
#define DW_MAX_SUMS 12

// The scratch and the split of one phase-2 launch, from Python (mirrored by
// ctypes in cusrl_tpu_torch/nn/kernels/dw_phase2.py, DwScratch).
struct DwScratch {
  void* tiles[2];     // per chain: fp32 [splits, dw_floats], each split's partial dW of every job, back to back
  void* cols[2];      // per chain: fp32 [splits, col_floats[c]], each split's column sums
  int splits;         // row splits
  int per_split;      // row tiles per split (the last split may hold fewer)
  int dw_floats;      // sum of n_out * n_in over the jobs
  int col_floats[2];  // per chain: sum of the column sums' widths
};

namespace dw {

using mlp::bf16;
namespace wmma = nvcuda::wmma;

enum HKind { H_BF16 = 0, H_F32 = 1, H_SAVED = 2 };  // H_SAVED: bf16 saved gelu pre-activation -> bf16(gelu(z))

// One weight gradient dW[n_out, n_in] = D[:, d_col : d_col + n_out]^T H.
struct Job {
  const void* d;  // bf16 [N, d_ld]
  const void* h;  // [N, n_in]: bf16 (H_BF16, H_SAVED) or fp32 (H_F32)
  float* dw;      // out [n_out, n_in]
  int d_ld, d_col, h_kind, n_out, n_in;
};

// One column sum over the row tiles: out[j * out_stride] = sum_t part[t * part_ld + col0 + j], j < width.
struct Sum {
  const float* part;  // [row_tiles, part_ld] per-row-tile partials from phase 1
  float* out;
  int part_ld, col0, width, out_stride;
};

struct Phase2 {
  Job job[2][DW_MAX_JOBS];  // per chain; the chains' jobs have the same shapes
  Sum sum[2][DW_MAX_SUMS];
  float* tiles[2];
  float* cols[2];
  int num_jobs, num_sums[2], col_floats[2];
  int num_rows, row_tiles, splits, per_split, activation, dw_floats, dw_tiles;
};

constexpr int TILE = 64;           // dW tile edge
constexpr int RT = 64;             // rows per stage: one row tile (mlp::BM)
constexpr int LD = TILE + 8;       // bf16 staging leading dim: 144-byte rows, 16-byte aligned
constexpr int SLD = TILE + 4;      // fp32 epilogue staging leading dim
constexpr int THREADS = 128;       // 4 warps, 2 x 2, each a 32 x 32 piece of the tile
constexpr int STAGE = RT * LD;     // bf16 values per operand per stage
constexpr int REDUCE_THREADS = 256;
static_assert(RT == mlp::BM, "a stage is one phase-1 row tile");
static_assert(size_t(TILE) * SLD * sizeof(float) <= 4 * size_t(STAGE) * sizeof(bf16),
              "the epilogue tile must fit the ring");

__host__ __device__ inline int job_tiles(const Job& j) {
  return ((j.n_out + TILE - 1) / TILE) * ((j.n_in + TILE - 1) / TILE);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Copies a 64-row x 64-column bf16 block, rows [r0, r0 + 64) and columns
// [c0, c0 + 64) of src ([N, ld], columns < limit valid), into dst ([RT][LD]);
// what lies outside is zero.  512 chunks of 16 bytes, 4 per thread.
__device__ __forceinline__ void async_block(bf16* dst, const bf16* src, int ld, int r0, int c0, int limit,
                                            int num_rows) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int row = c >> 3, col = (c & 7) * 8;
    const bool valid = r0 + row < num_rows && c0 + col < limit;
    const bf16* g = valid ? src + size_t(r0 + row) * ld + c0 + col : src;
    cp_async16(dst + row * LD + col, g, valid);
  }
}

// H blocks that need converting go through registers: 16-byte loads now,
// conversion and the shared store after the current tile's products.
template <int KIND>
struct HRegs {
  static constexpr int N = KIND == H_F32 ? 8 : 4;  // fp32: 1,024 float4 chunks; bf16: 512 chunks of 8
  uint4 v[N];

  __device__ __forceinline__ void load(const void* src, int ld, int r0, int c0, int limit, int num_rows) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int row = KIND == H_F32 ? c >> 4 : c >> 3;
      const int col = KIND == H_F32 ? (c & 15) * 4 : (c & 7) * 8;
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + row < num_rows && c0 + col < limit) {
        const size_t idx = size_t(r0 + row) * ld + c0 + col;
        if constexpr (KIND == H_F32) v[i] = __ldg(reinterpret_cast<const uint4*>(static_cast<const float*>(src) + idx));
        else v[i] = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(src) + idx));
      }
    }
  }

  __device__ __forceinline__ void store(bf16* dst, int activation) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * THREADS;
      if constexpr (KIND == H_F32) {
        const int row = c >> 4, col = (c & 15) * 4;
        const float4 f = *reinterpret_cast<const float4*>(&v[i]);
        __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y), hi = __floats2bfloat162_rn(f.z, f.w);
        uint2 packed;
        packed.x = *reinterpret_cast<unsigned*>(&lo);
        packed.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(dst + row * LD + col) = packed;
      } else {
        const int row = c >> 3, col = (c & 7) * 8;
        uint4 out = v[i];
        bf16* e = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int k = 0; k < 8; ++k) e[k] = mlp::layer_input_from_saved(activation, e[k]);
        *reinterpret_cast<uint4*>(dst + row * LD + col) = out;
      }
    }
  }
};

struct Acc {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2][2];
};

// acc += D_tile^T H_tile over one stage: warp w owns outputs o in
// [(w / 2) * 32, +32) and inputs k in [(w % 2) * 32, +32).
__device__ __forceinline__ void stage_products(const bf16* ds, const bf16* hs, Acc& acc) {
  const int warp = threadIdx.x >> 5;
  const int wo = (warp >> 1) * 32, wk = (warp & 1) * 32;
#pragma unroll
  for (int kk = 0; kk < RT; kk += 16) {
    // A(m = o, k = row) = D[row][o]: a column-major view of the row-major block.
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], ds + kk * LD + wo + i * 16, LD);
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], hs + kk * LD + wk + j * 16, LD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc.f[i][j], a[i], b[j], acc.f[i][j]);
  }
}

// The products of row tiles [t0, t1) for the tile (o0, k0) of job `jb`,
// through the two-stage ring `ring` ([stage][D, H][STAGE]).
template <int KIND>
__device__ void accumulate(const Phase2& P, const Job& jb, int o0, int k0, int t0, int t1, bf16* ring, Acc& acc) {
  const bf16* D = static_cast<const bf16*>(jb.d);
  auto d_buf = [&](int s) { return ring + (2 * s) * STAGE; };
  auto h_buf = [&](int s) { return ring + (2 * s + 1) * STAGE; };
  HRegs<KIND == H_BF16 ? H_SAVED : KIND> regs;  // unused for bf16 H

  async_block(d_buf(0), D, jb.d_ld, t0 * RT, jb.d_col + o0, jb.d_col + jb.n_out, P.num_rows);
  if constexpr (KIND == H_BF16) {
    async_block(h_buf(0), static_cast<const bf16*>(jb.h), jb.n_in, t0 * RT, k0, jb.n_in, P.num_rows);
  } else {
    regs.load(jb.h, jb.n_in, t0 * RT, k0, jb.n_in, P.num_rows);
  }
  cp_async_commit();
  if constexpr (KIND != H_BF16) regs.store(h_buf(0), P.activation);

  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t is in stage s for every thread; stage s ^ 1 is free
    const bool next = t + 1 < t1;
    if (next) {
      const int r0 = (t + 1) * RT;
      async_block(d_buf(s ^ 1), D, jb.d_ld, r0, jb.d_col + o0, jb.d_col + jb.n_out, P.num_rows);
      if constexpr (KIND == H_BF16) {
        async_block(h_buf(s ^ 1), static_cast<const bf16*>(jb.h), jb.n_in, r0, k0, jb.n_in, P.num_rows);
      } else {
        regs.load(jb.h, jb.n_in, r0, k0, jb.n_in, P.num_rows);
      }
    }
    cp_async_commit();
    stage_products(d_buf(s), h_buf(s), acc);
    if constexpr (KIND != H_BF16) {
      if (next) regs.store(h_buf(s ^ 1), P.activation);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every product is done: the ring may be reused
}

// Phase 2a, grid (dw_tiles + sum blocks, splits, chains): a block below
// dw_tiles accumulates one dW tile over its split's row tiles and writes the
// fp32 partial tile to the scratch; the blocks past them sum the column
// partials of the split's row tiles, in row order.
__global__ void __launch_bounds__(THREADS) split_kernel(const Phase2 P) {
  __shared__ __align__(128) bf16 ring[4 * STAGE];
  const int chain = blockIdx.z, split = blockIdx.y;
  const int t0 = split * P.per_split, t1 = min(t0 + P.per_split, P.row_tiles);

  if (int(blockIdx.x) >= P.dw_tiles) {  // uniform over the block
    const int q = (blockIdx.x - P.dw_tiles) * THREADS + threadIdx.x;
    if (q >= P.col_floats[chain]) return;
    int s = 0, j = q;
    while (j >= P.sum[chain][s].width) j -= P.sum[chain][s++].width;
    const Sum& sm = P.sum[chain][s];
    const float* part = sm.part + sm.col0 + j;
    float acc = 0.f;
    for (int t = t0; t < t1; ++t) acc += part[size_t(t) * sm.part_ld];
    P.cols[chain][size_t(split) * P.col_floats[chain] + q] = acc;
    return;
  }

  int t = blockIdx.x, j = 0, offset = 0;
  while (t >= job_tiles(P.job[chain][j])) {
    t -= job_tiles(P.job[chain][j]);
    offset += P.job[chain][j].n_out * P.job[chain][j].n_in;
    ++j;
  }
  const Job& jb = P.job[chain][j];
  const int k_tiles = (jb.n_in + TILE - 1) / TILE;
  const int o0 = (t / k_tiles) * TILE, k0 = (t % k_tiles) * TILE;

  Acc acc;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k) wmma::fill_fragment(acc.f[i][k], 0.f);
  switch (jb.h_kind) {  // uniform over the block
    case H_F32: accumulate<H_F32>(P, jb, o0, k0, t0, t1, ring, acc); break;
    case H_SAVED: accumulate<H_SAVED>(P, jb, o0, k0, t0, t1, ring, acc); break;
    default: accumulate<H_BF16>(P, jb, o0, k0, t0, t1, ring, acc); break;
  }

  float* stg = reinterpret_cast<float*>(ring);
  const int warp = threadIdx.x >> 5;
  const int wo = (warp >> 1) * 32, wk = (warp & 1) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      wmma::store_matrix_sync(stg + (wo + i * 16) * SLD + wk + k * 16, acc.f[i][k], SLD, wmma::mem_row_major);
  __syncthreads();
  float* out = P.tiles[chain] + size_t(split) * P.dw_floats + offset;
  for (int c = threadIdx.x; c < TILE * TILE / 4; c += THREADS) {  // float4 stores along a dW row
    const int m = c / (TILE / 4), n = (c % (TILE / 4)) * 4;
    if (o0 + m < jb.n_out && k0 + n < jb.n_in)
      *reinterpret_cast<float4*>(out + size_t(o0 + m) * jb.n_in + k0 + n) =
          *reinterpret_cast<const float4*>(stg + m * SLD + n);
  }
}

// Phase 2b, grid (elements / REDUCE_THREADS, chains): each thread adds one dW
// element or one column sum over the splits, in split order.
__global__ void __launch_bounds__(REDUCE_THREADS) reduce_kernel(const Phase2 P) {
  const int chain = blockIdx.y;
  const int e = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (e < P.dw_floats) {
    const float* src = P.tiles[chain] + e;
    float acc = 0.f;
    for (int s = 0; s < P.splits; ++s) acc += src[size_t(s) * P.dw_floats];
    int j = 0, local = e;
    for (int size = P.job[chain][0].n_out * P.job[chain][0].n_in; local >= size;
         ++j, size = P.job[chain][j].n_out * P.job[chain][j].n_in)
      local -= size;
    P.job[chain][j].dw[local] = acc;
    return;
  }
  const int q = e - P.dw_floats;
  if (q >= P.col_floats[chain]) return;
  const float* src = P.cols[chain] + q;
  float acc = 0.f;
  for (int s = 0; s < P.splits; ++s) acc += src[size_t(s) * P.col_floats[chain]];
  int s = 0, j = q;
  while (j >= P.sum[chain][s].width) j -= P.sum[chain][s++].width;
  P.sum[chain][s].out[size_t(j) * P.sum[chain][s].out_stride] = acc;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Checks the jobs, sums and scratch `S` against each other and launches both
// kernels of phase 2 for `chains` chains on `stream`; returns a cudaError_t.
// P's jobs, sums, num_jobs, num_sums, num_rows and activation are set.
inline int launch(Phase2& P, int chains, const DwScratch* S, cudaStream_t stream) {
  if (S == nullptr || chains < 1 || chains > 2 || P.num_jobs < 1 || P.num_jobs > DW_MAX_JOBS)
    return static_cast<int>(cudaErrorInvalidValue);
  P.row_tiles = (P.num_rows + RT - 1) / RT;
  P.splits = S->splits;
  P.per_split = S->per_split;
  if (P.splits < 1 || P.per_split < 1 || (P.splits - 1) * P.per_split >= P.row_tiles ||
      P.splits * P.per_split < P.row_tiles)
    return static_cast<int>(cudaErrorInvalidValue);  // every split holds at least one row tile
  long dw_floats = 0;
  P.dw_tiles = 0;
  for (int j = 0; j < P.num_jobs; ++j) {
    dw_floats += long(P.job[0][j].n_out) * P.job[0][j].n_in;
    P.dw_tiles += job_tiles(P.job[0][j]);
  }
  if (dw_floats != S->dw_floats) return static_cast<int>(cudaErrorInvalidValue);
  P.dw_floats = S->dw_floats;
  int sum_blocks = 0;
  for (int c = 0; c < chains; ++c) {
    if (P.num_sums[c] < 0 || P.num_sums[c] > DW_MAX_SUMS) return static_cast<int>(cudaErrorInvalidValue);
    int cols = 0;
    for (int s = 0; s < P.num_sums[c]; ++s) cols += P.sum[c][s].width;
    if (cols != S->col_floats[c]) return static_cast<int>(cudaErrorInvalidValue);
    P.col_floats[c] = cols;
    sum_blocks = max(sum_blocks, (cols + THREADS - 1) / THREADS);
    for (int j = 0; j < P.num_jobs; ++j) {
      Job& jb = P.job[c][j];
      if (jb.h_kind == H_SAVED && P.activation != mlp::ACT_GELU) jb.h_kind = H_BF16;  // the saved value is h
      if (jb.n_out != P.job[0][j].n_out || jb.n_in != P.job[0][j].n_in || jb.n_out % 16 || jb.n_in % 16 ||
          jb.d_ld % 8 || jb.d_col % 8 || !aligned16(jb.d) || !aligned16(jb.h))
        return static_cast<int>(cudaErrorInvalidValue);  // the 16-byte loads' alignment
    }
    P.tiles[c] = static_cast<float*>(S->tiles[c]);
    P.cols[c] = static_cast<float*>(S->cols[c]);
  }
  split_kernel<<<dim3(P.dw_tiles + sum_blocks, P.splits, chains), THREADS, 0, stream>>>(P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_cols = max(P.col_floats[0], chains > 1 ? P.col_floats[1] : 0);
  const int elements = P.dw_floats + max_cols;
  reduce_kernel<<<dim3((elements + REDUCE_THREADS - 1) / REDUCE_THREADS, chains), REDUCE_THREADS, 0, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dw

// mlp_chain_bwd: gradient of the Linear+activation chain from the saved
// post-activations, for one chain (K1b) or two chains selected by blockIdx.y
// (K2b).
//
// Replaces the Pallas kernels cusrl_tpu/nn/kernels/fused_mlp.py:_bwd_kernel
// (via _run_bwd) and _pair_bwd_kernel (via _pair_run_bwd).  Numerics as
// there: d stays fp32 and is multiplied by the activation derivative taken
// from the saved h (elu' = min(h + 1, 1)); d_bf = bf16(d) feeds both
// dW += h_in^T d_bf and d <- d_bf W^T (fp32 accumulation); db sums the fp32 d;
// skip_input_grad drops layer 0's dX product.  dW is written in the [out, in]
// layout of the port's parameters.
//
// Summing dW/db over row tiles.  The TPU grid runs in order and accumulates in
// VMEM; blocks on the card run in parallel.  This kernel is deterministic and
// uses no atomics, in two phases:
//   phase 1 (one block per 64-row tile): the gradient chain, top layer down,
//     with d kept in shared memory; writes every layer's d_bf to device memory
//     (D_l, [N, out_l] bf16) and the tile's fp32 column sums of d (db
//     partials, [tiles, out_l]), and dX unless skipped;
//   phase 2 (one block per 64x64 tile of each dW): dW_l = D_l^T h_l over all
//     rows with bf16 WMMA and fp32 accumulators; blocks holding column tile 0
//     also sum the db partials in tile order.
// The price is bytes: D_l is written once and read again by the dW blocks
// (2 * 2 * sum(out_l) bytes per row, 3,584 B/row/chain at 512-256-128), and
// each dW block reads its 64 columns of D_l and h_l for every row.
//
// What bounds it on the H100: ~4 * 188,416 FLOP per row per chain (dX products
// and dW products) against ~2.2 KB per row per chain read (saved hiddens, x,
// the cotangent) plus the D_l round trip: compute bound by the roofline.
// Not yet done (later work): wgmma/TMA, splitting phase 2's row loop over more
// blocks (it launches only as many blocks as there are 64x64 dW tiles).
#include "mlp_chain.cuh"

namespace mlp {

constexpr int TW = 64;              // dW tile edge (phase 2)
constexpr int DLD = TW + 8;         // bf16 staging leading dim (phase 2)
constexpr int DSLD = TW + 4;        // fp32 staging leading dim (phase 2)

// Finishes one NC-column chunk of layer l's output gradient held (fp32) in
// `stg`: multiplies by the activation derivative from the saved h_l output,
// writes bf16(d) to the next GEMM's A tile and to D_l, and the tile's fp32
// column sums to the db partials.
__device__ void finish_d_chunk(const MlpParams& p, const MlpChain& c, int l, int n0, int ncols, int row0,
                               float* stg, bf16* dnext) {
  const int n_out = p.dims[l + 1];
  const bool has_act = (l < p.num_layers - 1) || p.trailing;
  const bf16* saved = reinterpret_cast<const bf16*>(c.h[l]);
  bf16* dg = reinterpret_cast<bf16*>(c.d[l]);
  for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
    const int r = i / ncols, j = i % ncols;
    const int gr = row0 + r;
    float d = 0.f;
    if (gr < p.num_rows) {
      d = stg[r * SLD + j];
      if (has_act) d *= act_grad_from_h(p.activation, __bfloat162float(saved[size_t(gr) * n_out + n0 + j]));
    }
    stg[r * SLD + j] = d;
    const bf16 db = __float2bfloat16(d);
    dnext[r * HLD + n0 + j] = db;
    if (gr < p.num_rows) dg[size_t(gr) * n_out + n0 + j] = db;
  }
  __syncthreads();
  float* dbp = reinterpret_cast<float*>(c.dbp[l]);
  for (int j = threadIdx.x; j < ncols; j += THREADS) {
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s += stg[r * SLD + j];
    dbp[size_t(blockIdx.x) * n_out + n0 + j] = s;
  }
}

__global__ void __launch_bounds__(THREADS) mlp_chain_bwd_rows_kernel(const MlpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* dbuf[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + ACT_BYTES)};
  bf16* ws = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES);
  float* stg = reinterpret_cast<float*>(smem + 2 * ACT_BYTES + WS_BYTES);

  const MlpChain& c = p.chain[blockIdx.y];
  const int row0 = blockIdx.x * BM;
  const int num_layers = p.num_layers;

  // Cotangent of the chain output (bf16, upcast per tile) -> d of layer L-1.
  {
    const int n_out = p.dims[num_layers];
    const bf16* g = reinterpret_cast<const bf16*>(c.g);
    for (int n0 = 0; n0 < n_out; n0 += NC) {
      const int ncols = min(NC, n_out - n0);
      __syncthreads();  // previous readers of stg are done
      for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
        const int r = i / ncols, j = i % ncols;
        const int gr = row0 + r;
        stg[r * SLD + j] = gr < p.num_rows ? __bfloat162float(g[size_t(gr) * n_out + n0 + j]) : 0.f;
      }
      __syncthreads();
      finish_d_chunk(p, c, num_layers - 1, n0, ncols, row0, stg, dbuf[0]);
    }
  }

  int cur = 0;
  for (int l = num_layers - 1; l >= 0; --l) {
    if (l == 0 && p.skip_input_grad) break;
    const int K = p.dims[l + 1], n_in = p.dims[l];
    const float* W = reinterpret_cast<const float*>(c.w[l]);
    for (int n0 = 0; n0 < n_in; n0 += NC) {
      gemm_chunk<false>(dbuf[cur], K, W, n_in, n0, n_in, ws, stg);
      const int ncols = min(NC, n_in - n0);
      if (l > 0) {
        finish_d_chunk(p, c, l - 1, n0, ncols, row0, stg, dbuf[cur ^ 1]);
      } else {
        float* dx = reinterpret_cast<float*>(c.dx);
        for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
          const int r = i / ncols, j = i % ncols;
          const int gr = row0 + r;
          if (gr < p.num_rows) dx[size_t(gr) * n_in + n0 + j] = stg[r * SLD + j];
        }
      }
    }
    cur ^= 1;
  }
}

__global__ void __launch_bounds__(THREADS) mlp_chain_bwd_dw_kernel(const MlpParams p, int row_tiles) {
  __shared__ __align__(128) bf16 ds[TW * DLD];   // D_l rows x 64 output columns
  __shared__ __align__(128) bf16 hs[TW * DLD];   // h_l rows x 64 input columns
  __shared__ __align__(128) float out[TW * DSLD];

  const MlpChain& c = p.chain[blockIdx.y];
  // Locate this block's (layer, o-tile, k-tile).
  int t = blockIdx.x, l = 0;
  for (; l < p.num_layers; ++l) {
    const int tiles = ((p.dims[l + 1] + TW - 1) / TW) * ((p.dims[l] + TW - 1) / TW);
    if (t < tiles) break;
    t -= tiles;
  }
  if (l >= p.num_layers) return;  // uniform over the block
  const int n_out = p.dims[l + 1], n_in = p.dims[l];
  const int k_tiles = (n_in + TW - 1) / TW;
  const int o0 = (t / k_tiles) * TW, k0 = (t % k_tiles) * TW;
  const bf16* D = reinterpret_cast<const bf16*>(c.d[l]);
  const bool in_is_x = (l == 0);
  const bool x_bf16 = p.x_is_bf16;
  const void* hin = in_is_x ? c.x : c.h[l - 1];

  const int warp = threadIdx.x / 32;
  const int wr = warp & 3;          // 16-row (output o) fragment
  const int wc = (warp >> 2) * 2;   // first of two 16-column (input k) fragments
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int r0 = 0; r0 < p.num_rows; r0 += TW) {
    __syncthreads();
    for (int i = threadIdx.x; i < TW * TW; i += THREADS) {
      const int rr = i / TW, j = i % TW;
      const int gr = r0 + rr;
      bf16 dv = __float2bfloat16(0.f), hv = __float2bfloat16(0.f);
      if (gr < p.num_rows) {
        if (o0 + j < n_out) dv = D[size_t(gr) * n_out + o0 + j];
        if (k0 + j < n_in) {
          const size_t idx = size_t(gr) * n_in + k0 + j;
          if (!in_is_x) hv = reinterpret_cast<const bf16*>(hin)[idx];
          else if (x_bf16) hv = reinterpret_cast<const bf16*>(hin)[idx];
          else hv = __float2bfloat16(reinterpret_cast<const float*>(hin)[idx]);
        }
      }
      ds[rr * DLD + j] = dv;
      hs[rr * DLD + j] = hv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TW; kk += 16) {
      // A(m = o, k = row) = D[row][o]: column-major view of the row-major tile.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, ds + kk * DLD + wr * 16, DLD);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, hs + kk * DLD + (wc + f) * 16, DLD);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(out + wr * 16 * DSLD + (wc + f) * 16, acc[f], DSLD, wmma::mem_row_major);
  __syncthreads();
  float* dw = reinterpret_cast<float*>(c.dw[l]);
  for (int i = threadIdx.x; i < TW * TW; i += THREADS) {
    const int m = i / TW, n = i % TW;
    if (o0 + m < n_out && k0 + n < n_in) dw[size_t(o0 + m) * n_in + k0 + n] = out[m * DSLD + n];
  }
  if (k0 == 0) {
    const float* dbp = reinterpret_cast<const float*>(c.dbp[l]);
    float* db = reinterpret_cast<float*>(c.db[l]);
    for (int m = threadIdx.x; m < TW; m += THREADS) {
      if (o0 + m >= n_out) continue;
      float s = 0.f;
      for (int tile = 0; tile < row_tiles; ++tile) s += dbp[size_t(tile) * n_out + o0 + m];
      db[o0 + m] = s;
    }
  }
}

}  // namespace mlp

extern "C" const char* mlp_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches both phases for `num_chains` (1 or 2) chains on `stream`; returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int mlp_chain_bwd(const MlpParams* p, int num_chains, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(mlp::mlp_chain_bwd_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(mlp::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (p->num_rows + mlp::BM - 1) / mlp::BM;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mlp::mlp_chain_bwd_rows_kernel<<<dim3(row_tiles, num_chains), mlp::THREADS, mlp::SMEM_BYTES, s>>>(*p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int dw_tiles = 0;
  for (int l = 0; l < p->num_layers; ++l)
    dw_tiles += ((p->dims[l + 1] + mlp::TW - 1) / mlp::TW) * ((p->dims[l] + mlp::TW - 1) / mlp::TW);
  mlp::mlp_chain_bwd_dw_kernel<<<dim3(dw_tiles, num_chains), mlp::THREADS, 0, s>>>(*p, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

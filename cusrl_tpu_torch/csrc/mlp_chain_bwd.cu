// mlp_chain_bwd: gradient of the Linear+activation chain from the saved
// post-activations, for one chain (K1b) or two chains selected by blockIdx.y
// (K2b); with fp32 heads on the two chains' outputs (K8b); or with the heads
// and the PPO + value loss computed from the saved activations (K9s); or the
// whole PPO step, forward included, per row tile in one launch (K9m).
//
// Replaces the Pallas kernels cusrl_tpu/nn/kernels/fused_mlp.py:_bwd_kernel
// (via _run_bwd), _pair_bwd_kernel (via _pair_run_bwd) and
// _pair_heads_bwd_kernel (via _pair_heads_run_bwd), and
// cusrl_tpu/nn/kernels/fused_ppo_step.py:_loss_bwd_kernel (via _run_loss_bwd,
// the split mode of fused_ppo_step) and _ppo_step_kernel (via _run_ppo_step,
// the mono mode, CUSRL_TPU_PPO_MODE=mono).
//
// K9m (mlp_ppo_step): the losses are separable per row and per chain (the
// surrogate needs only the actor's mean, the value loss only the critic's
// value), so one phase-1 block per (row tile, chain) runs that chain's whole
// forward on its 64-row tile (chain_forward_tile, mlp_chain.cuh: the
// activation tile never leaves shared memory between layers), then after a
// block barrier the heads, the loss and the backward of the same tile (K9s's
// phase 1).  The forward writes each layer's bf16 activation to device memory
// on the way, since the backward's activation derivatives and phase 2's dW
// products read them; nothing is read from an earlier launch.  Phase 2 is K9s's, as the
// second kernel of the same call.  Mono and split (K2f + K9s) give the same
// numbers up to the forward's summation order (K2f takes its products with
// wgmma, chain_forward_tile with WMMA).
//
// K8b and K9s add a prologue to phase 1 (head_prologue): per 64-row tile the
// latent is staged in shared memory; K9s first runs the heads' forward, the
// Normal logp, ratio, clipped surrogate and (clipped) value loss, and their
// analytic per-row gradients (loss_rows), where K8b reads the heads'
// cotangents.  The heads' backward is fp32 (dW_head partials = f32(latent)^T
// g_head; d = g_head W_head (+ gl)); d stays fp32 through the activation
// derivative and joins the chain backward below.  The chains of one PPO
// update are independent until the loss sums: the surrogate needs only the
// actor's mean, the value loss only the critic's value, so blockIdx.y still
// selects one chain and its half of the loss.  K9s always skips layer 0's dX
// (the inputs are rollout data).  Numerics of the chains as
// there: d stays fp32 and is multiplied by the activation derivative taken
// from the saved h (elu' = min(h + 1, 1)); d_bf = bf16(d) feeds both
// dW += h_in^T d_bf and d <- d_bf W^T (fp32 accumulation); db sums the fp32 d;
// skip_input_grad drops layer 0's dX product.  dW is written in the [out, in]
// layout of the port's parameters.  gelu saves pre-activations: the derivative
// comes from z (act_grad_from_saved), and phase 2 recomputes h = bf16(gelu(z))
// as it stages a layer's input (layer_input_from_saved), as the TPU kernel
// does (fused_mlp.py:236-237).
//
// Summing dW/db over row tiles.  The TPU grid runs in order and accumulates in
// VMEM; blocks on the card run in parallel.  This kernel is deterministic and
// uses no atomics, in two phases:
//   phase 1 (one block per 64-row tile): the gradient chain, top layer down,
//     with d kept in shared memory; writes every layer's d_bf to device memory
//     (D_l, [N, out_l] bf16) and the tile's fp32 column sums of d (db
//     partials, [tiles, out_l]), and dX unless skipped;
//   phase 2 (dw_phase2.cuh, shared with fused_block.cu): dW_l = D_l^T h_l
//     over row ranges split across blocks, and the db partials, summed in a
//     fixed order.  It serves all five TPU kernels above (_run_bwd,
//     _pair_run_bwd, _pair_heads_run_bwd, _run_loss_bwd, _run_ppo_step).
//     Bytes bound it (D_l and h_l read once, 2 * out_l * in_l FLOP per
//     row); splitting the rows over about four blocks per SM, a cp.async
//     ring and 16-byte loads are what the design does about it.
// The price is bytes: D_l is written once and read again by phase 2
// (2 * 2 * sum(out_l) bytes per row, 3,584 B/row/chain at 512-256-128).
// The heads (K8b, K9s) use the same two phases: each phase-1 block writes its
// tile's partial dW_head, db_head (and, for K9s, dstd and the four loss sums)
// as one row of a [row_tiles, stride] fp32 array, which phase 2 sums as
// columns.  At 24,576 rows (384 tiles) with A = 12, Dv = 1 and a 128-wide
// latent that is 384 * (1,562 + 131) * 4 B = 2.6 MB written and read once
// (K8b: 384 * (1,548 + 129) * 4 B), against ~100 MB the kernel must move
// anyway.
//
// What bounds it on the H100: ~4 * 188,416 FLOP per row per chain (dX products
// and dW products) against ~2.2 KB per row per chain read (saved hiddens, x,
// the cotangent) plus the D_l round trip: compute bound by the roofline.
// K8b and K9s add 2 * 2 * (A + Dv) * 128 FLOP per row for the heads (and, for
// K9s, a few dozen per action for the loss), so at the main-path shape they
// are bound as K2b is: ~34.6 GFLOP, 0.035 ms at 24,576 rows.  K9m adds the
// forward's 2 * 188,416 FLOP per row per chain (~53 GFLOP, 0.054 ms at 24,576
// rows).  Its bound counts only the bytes the function must move (x, the loss
// rows and the outputs); the kernel itself still writes each layer's bf16
// activation and reads it back, as split does.
// Not yet done (later work): wgmma/TMA, and for K9m keeping the tile's
// activations in shared memory from the forward to the backward instead of
// the device-memory round trip.
#include "dw_phase2.cuh"
#include "mlp_chain.cuh"

namespace mlp {

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
      if (has_act) d *= act_grad_from_saved(p.activation, __bfloat162float(saved[size_t(gr) * n_out + n0 + j]));
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

// K9s: the heads' forward and the PPO + value loss of one row tile, with the
// analytic per-row gradient of loss_core = w_surr * surrogate + w_value *
// value_loss (fused_ppo_step.py:_loss_tail, :196-266).  `lat` holds the
// tile's latent (bf16, pad rows 0).  Writes the head cotangent into `gh`
// ([BM][dim] fp32, 0 on pad rows) and the tile's loss sums, in row order, into
// `part` past the head's dW and db partials:
//   chain 0: [sum min(t1, t2), sum |dlt|, dstd partial (A)]
//   chain 1: [sum of value-loss terms, sum vhat]
// Conventions kept from the TPU kernel: dlt is 0 on pad rows before the exp;
// pick_t1 = t1 <= t2; the clip passes the gradient for lo <= r <= hi;
// pick_u = u2 >= w2; w_inside = |delta| <= loss_clip; inv_n counts real rows.
__device__ void loss_rows(const MlpParams& p, const MlpHead& hd, int chain, int row0, const bf16* lat, float* gh,
                          float* stg, float* part) {
  const MlpLoss& ls = p.loss;
  const int latent = p.dims[p.num_layers], dim = hd.dim;
  const float* W = reinterpret_cast<const float*>(hd.w);
  const float* bias = reinterpret_cast<const float*>(hd.b);
  for (int i = threadIdx.x; i < BM * dim; i += THREADS) {
    const int r = i / dim, o = i % dim;
    stg[r * SLD + o] = head_dot(lat + r * HLD, W + size_t(o) * latent, latent, bias[o]);
  }
  __syncthreads();
  if (chain == 0) {
    const float* action = reinterpret_cast<const float*>(ls.action);
    const float* old_logp = reinterpret_cast<const float*>(ls.old_logp);
    const float* advantage = reinterpret_cast<const float*>(ls.advantage);
    const float* std = reinterpret_cast<const float*>(ls.std);
    const float lo = 1.f - ls.clip_ratio, hi = 1.f + ls.clip_ratio;
    const float g_row = -ls.w_surr * ls.inv_n;
    for (int r = threadIdx.x; r < BM; r += THREADS) {
      const int gr = row0 + r;
      const bool valid = gr < p.num_rows;
      float logp = 0.f;
      for (int o = 0; o < dim; ++o) {
        const float a = valid ? action[size_t(gr) * dim + o] : 0.f;
        const float z = (a - stg[r * SLD + o]) / std[o];
        logp += -0.5f * z * z - logf(std[o]) - LOG_SQRT_2PI;
      }
      const float dlt = valid ? logp - old_logp[gr] : 0.f;
      const float ratio = expf(dlt);
      const float adv = valid ? advantage[gr] : 0.f;
      const float clipped = fminf(fmaxf(ratio, lo), hi);
      const float t1 = adv * ratio, t2 = adv * clipped;
      const bool inside = ratio >= lo && ratio <= hi;
      const float dsurr_dr = t1 <= t2 ? adv : (inside ? adv : 0.f);
      const float dlogp = (g_row * dsurr_dr) * ratio;
      for (int o = 0; o < dim; ++o) {
        const float a = valid ? action[size_t(gr) * dim + o] : 0.f;
        const float z = (a - stg[r * SLD + o]) / std[o];
        gh[r * dim + o] = dlogp * (z / std[o]);
        stg[r * SLD + LOSS_COL + 4 + o] = dlogp * ((z * z - 1.f) / std[o]);
      }
      stg[r * SLD + LOSS_COL] = fminf(t1, t2);
      stg[r * SLD + LOSS_COL + 1] = fabsf(dlt);
    }
  } else {
    const float* returns = reinterpret_cast<const float*>(ls.returns);
    const float* old_value = reinterpret_cast<const float*>(ls.old_value);
    const float coef = ls.w_value * ls.inv_nv;
    for (int r = threadIdx.x; r < BM; r += THREADS) {
      const int gr = row0 + r;
      const bool valid = gr < p.num_rows;
      float loss_sum = 0.f, vhat_sum = 0.f;
      for (int o = 0; o < dim; ++o) {
        const float vhat = stg[r * SLD + o];
        const float ret = valid ? returns[size_t(gr) * dim + o] : 0.f;
        const float u = vhat - ret;
        float term, dv;
        if (ls.use_old_value) {
          const float ov = valid ? old_value[size_t(gr) * dim + o] : 0.f;
          const float delta = vhat - ov;
          const float w = ov + fminf(fmaxf(delta, -ls.loss_clip), ls.loss_clip) - ret;
          const float u2 = u * u, w2 = w * w;
          term = fmaxf(u2, w2);
          dv = coef * (u2 >= w2 ? 2.f * u : (fabsf(delta) <= ls.loss_clip ? 2.f * w : 0.f));
        } else {
          term = u * u;
          dv = coef * (2.f * u);
        }
        gh[r * dim + o] = valid ? dv : 0.f;
        if (valid) {
          loss_sum += term;
          vhat_sum += vhat;
        }
      }
      stg[r * SLD + LOSS_COL] = loss_sum;
      stg[r * SLD + LOSS_COL + 1] = vhat_sum;
    }
  }
  __syncthreads();
  const int base = dim * latent + dim;
  const int extra = chain == 0 ? 2 + dim : 2;
  for (int q = threadIdx.x; q < extra; q += THREADS) {
    const int col = q < 2 ? LOSS_COL + q : LOSS_COL + 4 + (q - 2);
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s += stg[r * SLD + col];
    part[base + q] = s;
  }
}

// K8b / K9s prologue of one row tile: the head backward in fp32, then the
// chain's top-layer d.  Per tile it writes the head's dW and db partials
// (sums over the tile's rows, in row order) to `part`; d = gh W (+ gl) stays
// fp32 through the activation derivative taken from the saved latent, and
// only bf16(d) feeds the products (fused_mlp.py:930-952).
__device__ void head_prologue(const MlpParams& p, const MlpChain& c, int chain, int row0, bf16* lat, float* gh,
                              float* stg, bf16* dtop) {
  const MlpHead& hd = p.head[chain];
  const int num_layers = p.num_layers, latent = p.dims[num_layers], dim = hd.dim;
  const bf16* saved = reinterpret_cast<const bf16*>(c.h[num_layers - 1]);
  float* part = reinterpret_cast<float*>(hd.part) + size_t(blockIdx.x) * hd.stride;
  for (int i = threadIdx.x; i < BM * latent; i += THREADS) {
    const int r = i / latent, k = i % latent;
    const int gr = row0 + r;
    lat[r * HLD + k] = gr < p.num_rows ? saved[size_t(gr) * latent + k] : __float2bfloat16(0.f);
  }
  if (p.head_mode == 2) {
    __syncthreads();
    loss_rows(p, hd, chain, row0, lat, gh, stg, part);
  } else {
    const float* g = reinterpret_cast<const float*>(hd.g);
    for (int i = threadIdx.x; i < BM * dim; i += THREADS) {
      const int r = i / dim, o = i % dim;
      const int gr = row0 + r;
      gh[r * dim + o] = gr < p.num_rows ? g[size_t(gr) * dim + o] : 0.f;
    }
  }
  __syncthreads();
  // Per-tile partials of the head's dW = f32(latent)^T gh and db = sum gh.
  for (int q = threadIdx.x; q < dim * latent; q += THREADS) {
    const int o = q / latent, k = q % latent;
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s = fmaf(__bfloat162float(lat[r * HLD + k]), gh[r * dim + o], s);
    part[q] = s;
  }
  for (int o = threadIdx.x; o < dim; o += THREADS) {
    float s = 0.f;
    for (int r = 0; r < BM; ++r) s += gh[r * dim + o];
    part[dim * latent + o] = s;
  }
  // Top-layer d = gh W (+ gl), fp32, per NC-column chunk of the latent.
  const float* W = reinterpret_cast<const float*>(hd.w);
  const float* gl = reinterpret_cast<const float*>(hd.gl);
  for (int n0 = 0; n0 < latent; n0 += NC) {
    const int ncols = min(NC, latent - n0);
    __syncthreads();  // previous readers of stg are done
    for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
      const int r = i / ncols, j = i % ncols;
      const int gr = row0 + r;
      float d = 0.f;
      if (gr < p.num_rows) {
        for (int o = 0; o < dim; ++o) d = fmaf(gh[r * dim + o], W[size_t(o) * latent + n0 + j], d);
        if (gl != nullptr) d += gl[size_t(gr) * latent + n0 + j];
      }
      stg[r * SLD + j] = d;
    }
    __syncthreads();
    finish_d_chunk(p, c, num_layers - 1, n0, ncols, row0, stg, dtop);
  }
}

// Phase 1 of one row tile of chain `c` (blockIdx.y): the head prologue or the
// upcast cotangent, then the gradient chain top layer down (module comment).
__device__ void chain_backward_tile(const MlpParams& p, const MlpChain& c, int row0, unsigned char* smem) {
  bf16* dbuf[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + ACT_BYTES)};
  bf16* ws = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES);
  float* stg = reinterpret_cast<float*>(smem + 2 * ACT_BYTES + WS_BYTES);

  const int num_layers = p.num_layers;

  if (p.head_mode != 0) {
    // Heads: the latent tile goes to dbuf[1] and the head cotangent to the
    // weight-slice region, both free until the first layer's product.
    head_prologue(p, c, blockIdx.y, row0, dbuf[1], reinterpret_cast<float*>(ws), stg, dbuf[0]);
  } else {
    // Cotangent of the chain output (bf16, upcast per tile) -> d of layer L-1.
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

__global__ void __launch_bounds__(THREADS) mlp_chain_bwd_rows_kernel(const MlpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  chain_backward_tile(p, p.chain[blockIdx.y], blockIdx.x * BM, smem);
}

// K9m phase 1: the chain's forward on the row tile, writing every layer's
// bf16 activation (save_hiddens), then, after a block barrier that makes
// those writes visible to the whole block, the heads, the loss and the
// backward of the same tile from them (K9s's phase 1).  Only this block
// writes and reads its tile's rows.
__global__ void __launch_bounds__(THREADS) mlp_ppo_step_rows_kernel(const MlpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpChain& c = p.chain[blockIdx.y];
  const int row0 = blockIdx.x * BM;
  chain_forward_tile(p, c, row0, smem);
  __syncthreads();
  chain_backward_tile(p, c, row0, smem);
}

}  // namespace mlp

extern "C" const char* mlp_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {

// Phase 2 of `num_chains` chains (dw_phase2.cuh): per layer dW_l = D_l^T h_l
// (layer 0 reads x, the others the saved value of the layer below) and db_l
// from the per-tile partials; with heads, each head's per-tile partials
// summed into its dW, db, the loss sums (sums[2 * q + chain]) and dstd.
int launch_dw(const MlpParams* p, int num_chains, const DwScratch* s, cudaStream_t stream) {
  dw::Phase2 P{};
  const int L = p->num_layers;
  for (int c = 0; c < num_chains; ++c) {
    const MlpChain& ch = p->chain[c];
    int n = 0;
    for (int l = 0; l < L; ++l) {
      const int n_out = p->dims[l + 1], n_in = p->dims[l];
      const int kind = l > 0 ? dw::H_SAVED : (p->x_is_bf16 ? dw::H_BF16 : dw::H_F32);
      P.job[c][l] = {ch.d[l], l > 0 ? ch.h[l - 1] : ch.x, static_cast<float*>(ch.dw[l]), n_out, 0, kind, n_out,
                     n_in};
      P.sum[c][n++] = {static_cast<const float*>(ch.dbp[l]), static_cast<float*>(ch.db[l]), n_out, 0, n_out, 1};
    }
    if (p->head_mode != 0) {
      const MlpHead& hd = p->head[c];
      const float* part = static_cast<const float*>(hd.part);
      const int wsize = hd.dim * p->dims[L], base = wsize + hd.dim;
      P.sum[c][n++] = {part, static_cast<float*>(hd.dw), hd.stride, 0, wsize, 1};
      P.sum[c][n++] = {part, static_cast<float*>(hd.db), hd.stride, wsize, hd.dim, 1};
      if (p->head_mode == 2) {
        P.sum[c][n++] = {part, static_cast<float*>(p->loss.sums) + c, hd.stride, base, 2, 2};
        if (c == 0) P.sum[c][n++] = {part, static_cast<float*>(p->loss.dstd), hd.stride, base + 2, hd.dim, 1};
      }
    }
    P.num_sums[c] = n;
  }
  P.num_jobs = L;
  P.num_rows = p->num_rows;
  P.activation = p->activation;
  return dw::launch(P, num_chains, s, stream);
}

// Launches phase 1 (`rows_kernel`) and phase 2 for `num_chains` (1 or 2)
// chains on `stream`; returns cudaGetLastError() after the launches.
int launch_phases(void (*rows_kernel)(const MlpParams), const MlpParams* p, int num_chains, const DwScratch* s,
                  void* stream) {
  cudaError_t err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(mlp::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (p->num_rows + mlp::BM - 1) / mlp::BM;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  rows_kernel<<<dim3(row_tiles, num_chains), mlp::THREADS, mlp::SMEM_BYTES, st>>>(*p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_dw(p, num_chains, s, st);
}

}  // namespace

// K1b, K2b, K8b, K9s: both phases from saved activations (0 on success).
// `s`: phase 2's split and scratch.
extern "C" int mlp_chain_bwd(const MlpParams* p, int num_chains, const DwScratch* s, void* stream) {
  return launch_phases(mlp::mlp_chain_bwd_rows_kernel, p, num_chains, s, stream);
}

// K9m: both chains' forward, heads, loss and backward per row tile in one
// phase-1 launch (head_mode 2, save_hiddens, the biases and every h[l] set),
// then phase 2 (0 on success).
extern "C" int mlp_ppo_step(const MlpParams* p, const DwScratch* s, void* stream) {
  if (p->head_mode != 2 || !p->save_hiddens || !p->skip_input_grad) return static_cast<int>(cudaErrorInvalidValue);
  return launch_phases(mlp::mlp_ppo_step_rows_kernel, p, 2, s, stream);
}

// Shared definitions of the fused Linear+activation chain kernels for Hopper
// (sm_90a): the parameter block passed from Python through ctypes (chains,
// their fp32 heads and the PPO loss), the tile constants, the activations, and
// the block-level bf16 tensor-core GEMM of K9m's row kernel (16x16x16 WMMA on
// fp32 weights restaged per 64-row tile; K1f/K2f/K8f and phase 1 of
// K1b/K2b/K8b/K9s are the wgmma designs of mlp_chain_fwd.cu and
// mlp_chain_bwd.cu).
//
// Numerics follow the TPU kernels in cusrl_tpu/nn/kernels/fused_mlp.py:
// bf16 operands, fp32 accumulation, fp32 bias, round to bf16, activation in
// fp32 on that bf16 value, round to bf16 again.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

#define MLP_MAX_LAYERS 8
#define MLP_MAX_WIDTH 512

// Mirrored field by field by ctypes in cusrl_tpu_torch/nn/kernels/fused_mlp.py
// (_Chain / _Params): every pointer is a void*, every scalar an int.
struct MlpChain {
  void* x;                       // [N, dims[0]] fp32 or bf16 (x_is_bf16)
  void* w[MLP_MAX_LAYERS];       // [dims[l+1], dims[l]] fp32 ([out, in] layout)
  void* b[MLP_MAX_LAYERS];       // [dims[l+1]] fp32
  void* h[MLP_MAX_LAYERS];       // [N, dims[l+1]] bf16: layer l output, for gelu its pre-activation (l = L-1: the chain output)
  void* g;                       // bwd: [N, dims[L]] bf16 cotangent of the chain output
  void* d[MLP_MAX_LAYERS];       // bwd scratch: [N, dims[l+1]] bf16(d_l)
  void* dbp[MLP_MAX_LAYERS];     // bwd scratch: [row_tiles, dims[l+1]] fp32 per-tile db partials
  void* dw[MLP_MAX_LAYERS];      // bwd out: [dims[l+1], dims[l]] fp32
  void* db[MLP_MAX_LAYERS];      // bwd out: [dims[l+1]] fp32
  void* dx;                      // bwd out: [N, dims[0]] fp32 (unused with skip_input_grad)
  void* wpack;                   // fwd, bwd scratch: [num_stages][128][64] bf16, the weights' images (wg::Pack)
};

// An fp32 head on a chain's output h_L (K8f, K8b, K9s): out = f32(h_L) W^T + b,
// computed with fp32 FMAs (the TPU kernels' fp32 island, LinearFp32).
struct MlpHead {
  void* w;     // [dim, dims[L]] fp32 ([out, in])
  void* b;     // [dim] fp32
  void* out;   // fwd: [N, dim] fp32
  void* g;     // bwd, head_mode 1: [N, dim] fp32 cotangent of out
  void* gl;    // bwd, head_mode 1: [N, dims[L]] fp32 extra cotangent of h_L, or null
  void* part;  // bwd scratch: [row_tiles, stride] fp32 per-tile partials (see mlp_chain_bwd.cu)
  void* dw;    // bwd out: [dim, dims[L]] fp32
  void* db;    // bwd out: [dim] fp32
  int dim;     // 0: no head on this chain
  int stride;  // floats per row of `part`
};

// The PPO + value loss of K9s (cusrl_tpu/nn/kernels/fused_ppo_step.py:_loss_tail)
// on the heads' outputs: chain 0's head is the Normal mean, chain 1's the value.
struct MlpLoss {
  void* action;     // [N, A] fp32
  void* old_logp;   // [N] fp32
  void* advantage;  // [N] fp32
  void* old_value;  // [N, Dv] fp32, read only with use_old_value
  void* returns;    // [N, Dv] fp32
  void* std;        // [A] fp32
  void* dstd;       // out: [A] fp32
  void* sums;       // out: [4] fp32: sum min(t1, t2), sum of value-loss terms, sum |dlt|, sum vhat
  float clip_ratio;
  float w_surr;
  float w_value;
  float loss_clip;
  float inv_n;      // 1 / real rows
  float inv_nv;     // 1 / (real rows * Dv)
  int use_old_value;
};

struct MlpParams {
  MlpChain chain[2];
  MlpHead head[2];
  MlpLoss loss;
  int dims[MLP_MAX_LAYERS + 1];
  int num_layers;
  int num_rows;
  int activation;       // 0 identity, 1 elu, 2 relu, 3 tanh, 4 gelu (tanh form)
  int trailing;         // activation after the last layer
  int save_hiddens;     // fwd: write h_1..h_{L-1} (the chain output is written where h[L-1] is set)
  int x_is_bf16;
  int skip_input_grad;  // bwd: no dX for layer 0
  int head_mode;        // 0: no heads; 1: heads (K8f writes out, K8b reads g); 2: heads + loss (K9s)
  int num_stages;       // weight images per chain the caller allocated in wpack (0: none)
};

namespace mlp {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;                    // rows per block (row tile)
constexpr int NC = 128;                   // output columns per GEMM chunk
constexpr int KS = 64;                    // reduction depth staged per step
constexpr int THREADS = 256;              // 8 warps: 4 (16-row) x 2 (64-col)
constexpr int HLD = MLP_MAX_WIDTH + 8;    // bf16 activation tile leading dim
constexpr int WLD_COL = KS + 8;           // staged W slice [NC][KS] (fwd)
constexpr int WLD_ROW = NC + 8;           // staged W slice [KS][NC] (bwd data)
constexpr int SLD = NC + 4;               // fp32 accumulator staging leading dim

constexpr int MAX_HEAD_DIM = 64;          // head tile [BM][dim] fp32 fits the weight-slice region
constexpr int LOSS_COL = 64;              // stg columns past the widest head: per-row loss terms
constexpr float LOG_SQRT_2PI = 0.9189385332046727f;

constexpr size_t ACT_BYTES = size_t(BM) * HLD * sizeof(bf16);
constexpr size_t WS_BYTES =
    (size_t(NC) * WLD_COL > size_t(KS) * WLD_ROW ? size_t(NC) * WLD_COL : size_t(KS) * WLD_ROW) * sizeof(bf16);
constexpr size_t STG_BYTES = size_t(BM) * SLD * sizeof(float);
// Two activation tiles (ping-pong), one staged weight slice, one fp32 staging tile.
constexpr size_t SMEM_BYTES = 2 * ACT_BYTES + WS_BYTES + STG_BYTES;
static_assert(ACT_BYTES % 128 == 0 && WS_BYTES % 128 == 0, "smem regions must stay 128-byte aligned");
static_assert(SMEM_BYTES <= 232448, "exceeds the 227 KB a block may use");
static_assert(size_t(BM) * MAX_HEAD_DIM * sizeof(float) <= WS_BYTES, "head tile must fit the weight-slice region");
static_assert(LOSS_COL + 2 + MAX_HEAD_DIM <= SLD, "per-row loss terms must fit the staging tile");

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

constexpr int ACT_GELU = 4;               // saves pre-activations (see act_grad_from_saved)
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2/pi), the tanh form of jax.nn.gelu

// Activation on the bf16-rounded pre-activation, in fp32 (fused_mlp.py:_act_kernel).
// elu is written without a select, z > 0 ? z : exp(z) - 1 bit for bit
// (exp(0) - 1 = 0): the select compiled to a branch per element.
__device__ __forceinline__ float act_fwd(int activation, float z) {
  switch (activation) {
    case 1: return fmaxf(z, 0.f) + (expf(fminf(z, 0.f)) - 1.f);
    case 2: return fmaxf(z, 0.f);
    case 3: return tanhf(z);
    case ACT_GELU: return 0.5f * z * (1.f + tanhf(GELU_C * (z + 0.044715f * z * z * z)));
    default: return z;
  }
}

// d = bf16(act(d)) on the NA accumulators of a warpgroup product
// (mlp_chain_fwd.cu, fused_block.cu), the activation fixed at compile time so
// that the elements' chains interleave.
template <int A, int NA>
__device__ __forceinline__ void activate(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; i += 2) {  // rounded in pairs: one packed conversion
    const float2 h = __bfloat1622float2(__floats2bfloat162_rn(act_fwd(A, d[i]), act_fwd(A, d[i + 1])));
    d[i] = h.x;
    d[i + 1] = h.y;
  }
}

template <int NA>
__device__ __forceinline__ void activate(float (&d)[NA], int act) {
  switch (act) {
    case 1: activate<1>(d); break;
    case 2: activate<2>(d); break;
    case 3: activate<3>(d); break;
    case ACT_GELU: activate<ACT_GELU>(d); break;
    default: activate<0>(d);
  }
}

// What the forward saves for the backward of an activated layer: the
// post-activation h, or for gelu (whose derivative is not a function of its
// output) the bf16 pre-activation z (fused_mlp.py:206-209).
__device__ __forceinline__ bf16 saved_value(int activation, bf16 zb, bf16 hb) {
  return activation == ACT_GELU ? zb : hb;
}

// Derivative from the saved value: from the POST-activation h
// (fused_mlp.py:_dact_from_h), or for gelu from z (_dact_from_z).
__device__ __forceinline__ float act_grad_from_saved(int activation, float s) {
  switch (activation) {
    case 1: return fminf(s + 1.f, 1.f);
    case 2: return s > 0.f ? 1.f : 0.f;
    case 3: return 1.f - s * s;
    case ACT_GELU: {
      const float t = tanhf(GELU_C * (s + 0.044715f * s * s * s));
      const float du = GELU_C * (1.f + 3.f * 0.044715f * s * s);
      return 0.5f * (1.f + t) + 0.5f * s * (1.f - t * t) * du;
    }
    default: return 1.f;
  }
}

// d[i] *= act'(saved(i)) on the NA accumulators of a warpgroup product
// (mlp_chain_bwd.cu, fused_block.cu), the activation fixed at compile time so
// that the elements' chains interleave.
template <int NA, class Saved>
__device__ __forceinline__ void mul_act_grad(float (&d)[NA], const Saved& saved, int act) {
  switch (act) {
#define MLP_ACT_GRAD_CASE(A)                                                     \
  case A:                                                                        \
    _Pragma("unroll") for (int i = 0; i < NA; ++i) d[i] *= act_grad_from_saved(A, saved(i)); \
    break;
    MLP_ACT_GRAD_CASE(1)
    MLP_ACT_GRAD_CASE(2)
    MLP_ACT_GRAD_CASE(3)
    MLP_ACT_GRAD_CASE(ACT_GELU)
#undef MLP_ACT_GRAD_CASE
    default: break;  // identity
  }
}

// The layer input a weight gradient needs, from the saved value of the layer
// below: h itself, or bf16(gelu(z)) recomputed as the forward rounded it.
__device__ __forceinline__ bf16 layer_input_from_saved(int activation, bf16 s) {
  return activation == ACT_GELU ? __float2bfloat16(act_fwd(ACT_GELU, __bfloat162float(s))) : s;
}

// One output of an fp32 head: f32(lat_row) . w_row + bias, fp32 FMAs in
// column order (lat_row: one bf16 row of the latent tile; w_row: one row of
// the head's [out, in] weight).
__device__ __forceinline__ float head_dot(const bf16* lat_row, const float* __restrict__ w_row, int n, float bias) {
  float s = 0.f;
  for (int k = 0; k < n; ++k) s = fmaf(__bfloat162float(lat_row[k]), w_row[k], s);
  return s + bias;
}

// One NC-column chunk of C[BM, n_total] = A[BM, K] * B[K, n_total], columns
// [n0, n0 + NC), into the fp32 staging tile `stg` ([BM][SLD]).
//   A: bf16 in shared memory, row-major, leading dim HLD.
//   B comes from the fp32 weight W ([out, in] row-major, row length w_ld):
//     W_IS_NK = true : B(k, n) = W[n][k]  (forward: y = h W^T)
//     W_IS_NK = false: B(k, n) = W[k][n]  (backward data: d_in = d_out W)
//   Each KS-deep slice of B is converted to bf16 into `ws` and consumed by
//   16x16x16 bf16 WMMA products with fp32 accumulators.
// K and n_total must be multiples of 16.  Ends with a block barrier, after
// which `stg` holds the chunk for every thread.
template <bool W_IS_NK>
__device__ void gemm_chunk(const bf16* A, int K, const float* __restrict__ W, int w_ld, int n0, int n_total,
                           bf16* ws, float* stg) {
  const int warp = threadIdx.x / 32;
  const int wr = warp & 3;   // 16-row fragment row
  const int wc = warp >> 2;  // 64-column half
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int k0 = 0; k0 < K; k0 += KS) {
    __syncthreads();  // previous readers of ws / stg are done
    if (W_IS_NK) {
      for (int i = threadIdx.x; i < NC * KS; i += THREADS) {
        const int n = i / KS, k = i % KS;
        const int gn = n0 + n, gk = k0 + k;
        const float v = (gn < n_total && gk < K) ? W[size_t(gn) * w_ld + gk] : 0.f;
        ws[n * WLD_COL + k] = __float2bfloat16(v);
      }
    } else {
      for (int i = threadIdx.x; i < KS * NC; i += THREADS) {
        const int k = i / NC, n = i % NC;
        const int gn = n0 + n, gk = k0 + k;
        const float v = (gn < n_total && gk < K) ? W[size_t(gk) * w_ld + gn] : 0.f;
        ws[k * WLD_ROW + n] = __float2bfloat16(v);
      }
    }
    __syncthreads();
    const int kmax = min(KS, K - k0);
    for (int kk = 0; kk < kmax; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + wr * 16 * HLD + k0 + kk, HLD);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int nl = wc * 64 + f * 16;
        if (n0 + nl < n_total) {  // warp-uniform
          if (W_IS_NK) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
            wmma::load_matrix_sync(b, ws + nl * WLD_COL + kk, WLD_COL);
            wmma::mma_sync(acc[f], a, b, acc[f]);
          } else {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(b, ws + kk * WLD_ROW + nl, WLD_ROW);
            wmma::mma_sync(acc[f], a, b, acc[f]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int nl = wc * 64 + f * 16;
    if (n0 + nl < n_total) wmma::store_matrix_sync(stg + wr * 16 * SLD + nl, acc[f], SLD, wmma::mem_row_major);
  }
  __syncthreads();
}

// The whole chain `c` on the 64-row tile at row0 (K9m's forward).  `smem`
// holds two activation tiles (ping-pong), a staged weight slice and an fp32
// staging tile (SMEM_BYTES).  Writes the chain output
// where c.h[L-1] is set, and with save_hiddens every layer's saved value
// (post-activation, for gelu the pre-activation).  Returns the index of the
// activation tile that holds the chain output, complete for every thread only
// after a block barrier.
__device__ __forceinline__ int chain_forward_tile(const MlpParams& p, const MlpChain& c, int row0,
                                                   unsigned char* smem) {
  bf16* act[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + ACT_BYTES)};
  bf16* ws = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES);
  float* stg = reinterpret_cast<float*>(smem + 2 * ACT_BYTES + WS_BYTES);
  const int n_rows = p.num_rows;
  const int num_layers = p.num_layers;

  // x tile -> bf16 activation tile (rows past the end are zero).
  const int in0 = p.dims[0];
  for (int i = threadIdx.x; i < BM * in0; i += THREADS) {
    const int r = i / in0, k = i % in0;
    const int gr = row0 + r;
    float v = 0.f;
    if (gr < n_rows) {
      v = p.x_is_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(c.x)[size_t(gr) * in0 + k])
                      : reinterpret_cast<const float*>(c.x)[size_t(gr) * in0 + k];
    }
    act[0][r * HLD + k] = __float2bfloat16(v);
  }

  int cur = 0;
  for (int l = 0; l < num_layers; ++l) {
    const int K = p.dims[l], n_out = p.dims[l + 1];
    const bool apply_act = (l < num_layers - 1) || p.trailing;
    bf16* out = reinterpret_cast<bf16*>(c.h[l]);
    const bool write_global = out != nullptr && ((l == num_layers - 1) || p.save_hiddens);
    const float* W = reinterpret_cast<const float*>(c.w[l]);
    const float* bias = reinterpret_cast<const float*>(c.b[l]);
    for (int n0 = 0; n0 < n_out; n0 += NC) {
      gemm_chunk<true>(act[cur], K, W, K, n0, n_out, ws, stg);
      const int ncols = min(NC, n_out - n0);
      for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
        const int r = i / ncols, j = i % ncols;
        const float zb = bf16_round(stg[r * SLD + j] + bias[n0 + j]);
        const bf16 hb = __float2bfloat16(apply_act ? act_fwd(p.activation, zb) : zb);
        act[cur ^ 1][r * HLD + n0 + j] = hb;
        const int gr = row0 + r;
        if (write_global && gr < n_rows)
          out[size_t(gr) * n_out + n0 + j] = apply_act ? saved_value(p.activation, __float2bfloat16(zb), hb) : hb;
      }
    }
    cur ^= 1;
  }
  return cur;
}

}  // namespace mlp

extern "C" const char* mlp_chain_error_string(int code);

// Shared definitions of the fused Linear+activation chain kernels for Hopper
// (sm_90a): the parameter block passed from Python through ctypes (chains,
// their fp32 heads and the PPO loss), the activations and their derivatives,
// and the chain forward's weight images and 64-row tile (namespace mlpf: the
// forward of K1f/K2f/K8f in mlp_chain_fwd.cu, and of K9m's single-launch PPO
// step in mlp_chain_bwd.cu).
//
// Numerics follow the TPU kernels in cusrl_tpu/nn/kernels/fused_mlp.py:
// bf16 operands, fp32 accumulation, fp32 bias, round to bf16, activation in
// fp32 on that bf16 value, round to bf16 again.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

#include "hopper_wg.cuh"

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

constexpr int BM = wg::TILE_M;            // rows of a row tile: phase 1's per-tile partials, phase 2's stages
constexpr int MAX_HEAD_DIM = 64;          // the heads' scratch of a tile ([64][dim] fp32)
constexpr float LOG_SQRT_2PI = 0.9189385332046727f;

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

}  // namespace mlp

namespace mlpf {

using wg::bf16;

// Layer l's images: per 128-row chunk of its output, per 64-column K block.
// Mirrored by chain_stages in nn/kernels/weight_images.py.
inline wg::Pack chain_pack(const MlpParams& p) {
  wg::Pack P{};
  for (int l = 0; l < p.num_layers; ++l) {
    const int K = p.dims[l], N = p.dims[l + 1];
    wg::pack_matrix(P, l, l, N, N, K);
    for (int c = 0; c < wg::nchunks(N); ++c)
      for (int kb = 0; kb < wg::kblocks(K); ++kb) wg::pack_add(P, l, 128 * c, 64 * kb);
  }
  return P;
}

// Bytes of the tile that holds the inputs of the layers of this parity (the
// chain output counts as layer L's input: the heads read it there).
inline int tile_bytes(const MlpParams& p, int parity) {
  int widest = 0;
  for (int i = parity; i <= p.num_layers; i += 2) widest = std::max(widest, wg::kblocks(p.dims[i]));
  return widest * wg::ABLOCK_BYTES;
}

// The chain forward of chain c on the 64-row tile at row0, by the WGS
// consumer warpgroups of a block (t: the thread among them): x's rows into
// buf[0], then per layer and per 128-column chunk of its output the products
// from the ring's images (warpgroup w taking the columns [w * NW, (w + 1) *
// NW) of the chunk, NW / 2 accumulators per thread), the epilogue on the
// accumulators (bias, bf16 rounding, the activation; gelu's hidden layers
// save z) and the bf16 result into the next layer's tile (even and odd
// layers' inputs in buf[0] and buf[1]) and, where c.h[l] is set (the chain
// output; the hidden layers with save_hiddens), to device memory.  With
// keep_out the chain output also stays in buf[L & 1], complete for every
// consumer thread on return (K8f's heads and K9m's loss read it there).
template <int WGS>
__device__ __forceinline__ void forward_tile(const MlpParams& p, const MlpChain& c, wg::Ring& ring,
                                             unsigned char* const (&buf)[2], int row0, bool keep_out, int t) {
  constexpr int NT = WGS * 128, NW = wg::STAGE_N / WGS;
  const int w = wg::warp_index() / 4, num_layers = p.num_layers, n_rows = p.num_rows, act = p.activation;
  const uint32_t b_off = w * NW * wg::KBLOCK * 2;  // this warpgroup's rows of each image
  const wg::Frag f(t & 127);
  float d[NW / 2];
  if (p.x_is_bf16) {
    wg::load_x<true, 8 / WGS, NT>(c.x, p.dims[0], row0, n_rows, buf[0], t);
  } else {
    wg::load_x<false, 4 / WGS, NT>(c.x, p.dims[0], row0, n_rows, buf[0], t);
  }
  wg::fence_async_smem();
  wg::group_sync(1, NT);
  for (int l = 0; l < num_layers; ++l) {
    const int K = p.dims[l], N = p.dims[l + 1];
    const bool last = l == num_layers - 1, apply_act = !last || p.trailing;
    const bool keep_z = !last && act == mlp::ACT_GELU;  // gelu's hidden layers save z
    const bool to_smem = !last || keep_out;
    bf16* dst = (last || p.save_hiddens) ? static_cast<bf16*>(c.h[l]) : nullptr;
    const float* bias = static_cast<const float*>(c.b[l]);
    const uint32_t a_in = wg::smem_u32(buf[l & 1]);
    unsigned char* next = buf[(l + 1) & 1];
    for (int n0 = 0; n0 < N; n0 += wg::STAGE_N) {
      const int c0 = n0 + w * NW, cols = max(0, min(NW, N - c0));  // this warpgroup's columns
      wg::zero(d);
      wg::issue(d, a_in, K, ring, b_off);
      wg::finish(d, ring);
      wg::add_bias_round(d, bias + c0, cols, f);
      if (dst != nullptr && keep_z) wg::store_bf16(d, cols, dst, N, c0, row0, n_rows, f);
      if (apply_act) mlp::activate(d, act);
      if (dst != nullptr && !keep_z) wg::store_bf16(d, cols, dst, N, c0, row0, n_rows, f);
      // Past `cols` the accumulators and act(0) are 0: the next layer's K
      // padding, up to the next multiple of 64, in each warpgroup's columns.
      if (to_smem) wg::to_tile(d, max(0, min(NW, wg::pad64(N) - c0)), next, f, c0);
    }
    if (to_smem) {
      wg::fence_async_smem();
      wg::group_sync(1, NT);
    }
  }
}

}  // namespace mlpf

extern "C" const char* mlp_chain_error_string(int code);

// mlp_chain_fwd: the whole Linear+activation chain per 64-row tile, for one
// chain (K1f) or two same-shape chains selected by blockIdx.y (K2f), or two
// chains each followed by an fp32 head (K8f: the Normal mean on the actor, the
// value on the critic).
//
// Replaces the Pallas kernels cusrl_tpu/nn/kernels/fused_mlp.py:_fwd_kernel
// (via _run_fwd, fused_mlp), _pair_fwd_kernel (via _pair_run_fwd,
// fused_mlp_pair) and _pair_heads_fwd_kernel (via _pair_heads_run_fwd,
// fused_mlp_pair_heads).
//
// K8f: after the last layer the latent tile is still in shared memory, so the
// heads read it there (fp32 FMAs on the fp32 head weights, never rounded to
// bf16: the TPU kernel's fp32 island).  Without `save` only the heads'
// [N, A] and [N, Dv] fp32 outputs leave the block; with it the latents and
// hiddens are written as K2f writes them.  The heads add 2 * (A + Dv) * 128
// FLOP per row to the chains' 2 * 2 * 188,416 at the main-path shape, so
// K8f is bound as K2f is.
//
// What bounds it on the H100: at the main-path widths 48->512->256->128 the
// chain does 2 * 188,416 FLOP per row against ~96 bytes of x in and 256 bytes
// of output out (plus 1,792 bytes of saved hiddens per row on the grad path),
// so by the roofline it is compute bound (~1,000 FLOP/byte without saved
// hiddens).  Design:
//   * the activation tile (64 rows x up to 512 bf16) stays in shared memory
//     through the whole chain (ping-pong between two tiles), so hidden
//     activations never touch device memory unless the backward needs them;
//   * one chain's bf16 weights (368 KB) exceed the 227 KB a block may use, so
//     each layer's fp32 weights stream from L2 in 128x64 slices, converted to
//     bf16 as they are staged;
//   * products are 16x16x16 bf16 WMMA tensor-core operations with fp32
//     accumulators; the epilogue (bias, bf16 rounding, activation) runs on an
//     fp32 staging tile in shared memory.
// gelu (the transformer FFN, 128->512->128): the epilogue computes the tanh
// form in fp32 on the bf16 pre-activation, as the other activations, and
// with save_hiddens writes that bf16 pre-activation instead of the output
// (its derivative is not a function of the output); the FFN's 1,024-row step
// and 6,144- and 24,576-row passes are compute bound as the rest.
// Not yet done (later work): wgmma/TMA, keeping bf16 weights resident across
// tiles (persistent blocks), double-buffered weight staging.
#include "mlp_chain.cuh"

namespace mlp {

__global__ void __launch_bounds__(THREADS) mlp_chain_fwd_kernel(const MlpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row0 = blockIdx.x * BM;
  const int n_rows = p.num_rows;
  const int cur = chain_forward_tile(p, p.chain[blockIdx.y], row0, smem);
  const bf16* latent_tile = reinterpret_cast<const bf16*>(smem + cur * ACT_BYTES);

  // K8f epilogue: the fp32 head on the latent tile, still in shared memory.
  const MlpHead& hd = p.head[blockIdx.y];
  if (p.head_mode == 1 && hd.dim > 0) {
    __syncthreads();  // the last layer's epilogue wrote the latent tile
    const int latent = p.dims[p.num_layers], dim = hd.dim;
    const float* W = reinterpret_cast<const float*>(hd.w);
    const float* bias = reinterpret_cast<const float*>(hd.b);
    float* out = reinterpret_cast<float*>(hd.out);
    for (int i = threadIdx.x; i < BM * dim; i += THREADS) {
      const int r = i / dim, o = i % dim;
      const int gr = row0 + r;
      if (gr < n_rows) out[size_t(gr) * dim + o] = head_dot(latent_tile + r * HLD, W + size_t(o) * latent, latent, bias[o]);
    }
  }
}

}  // namespace mlp

extern "C" const char* mlp_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the forward for `num_chains` (1 or 2) chains on `stream`; returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mlp_chain_fwd(const MlpParams* p, int num_chains, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(mlp::mlp_chain_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(mlp::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p->num_rows + mlp::BM - 1) / mlp::BM, num_chains);
  mlp::mlp_chain_fwd_kernel<<<grid, mlp::THREADS, mlp::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

// fused_block: every matmul and LayerNorm of one pre-norm causal transformer
// encoder layer with residual gates, as two programs on either side of its
// attention, for one layer (K4) or the actor's and the critic's same-shape
// layers selected by blockIdx.y (K5):
//   pre  forward:  h = bf16(x W_in^T + b_in); y = bf16(LN1(h));
//                  qkv = bf16(y [W_q; W_k; W_v]^T + [b_q; b_k; b_v])
//   post forward:  r1 = bf16(h + bf16(attn W_o^T + b_o)); y2 = bf16(LN2(r1));
//                  z1 = bf16(y2 W_up^T + b_up); hid = bf16(act(z1));
//                  out = bf16(r1 + bf16(hid W_down^T + b_down))
//   and the backward of each.
//
// Replaces the Pallas kernels cusrl_tpu/nn/kernels/fused_block.py:
// _pre_fwd_kernel (_pre_run_fwd), _pre_bwd_kernel (_pre_run_bwd),
// _post_fwd_kernel (_post_run_fwd), _post_bwd_kernel (_post_run_bwd) and the
// pair variants _pair_pre_fwd_kernel, _pair_pre_bwd_kernel,
// _pair_post_fwd_kernel and _pair_post_bwd_kernel (each the single kernel's
// body once per chain).
//
// Numerics are the TPU kernels': bf16 operands with fp32 accumulation and fp32
// bias, LayerNorm in fp32 (population variance, eps 1e-6) rounded to bf16,
// residual adds of two bf16 values rounded to bf16, the FFN activation in fp32
// on the bf16 pre-activation (act_fwd of mlp_chain.cuh).  The residual h
// leaves the pre kernel as fp32 holding the bf16 value, so that its cotangent
// from the post backward (fp32 dr1) reaches the pre backward unrounded, as in
// the TPU kernels, where PyTorch's autograd would round it to a bf16 h's type.
// The backwards recompute the LayerNorm statistics from the saved h / r1 and
// the FFN hidden from the saved bf16 pre-activation (gelu) or post-activation
// (the ELU family), as the TPU kernels do.
//
// What bounds them on the H100: at the transformer's widths (48 -> 128,
// 128 -> 384; 128 -> 128 -> 512 -> 128) the forwards do 2 * 67,584 (pre) and
// 2 * 147,456 (post) FLOP per row against ~0.9 KB and ~1.0-1.8 KB per row in
// and out, ~75-160 FLOP per byte: below the card's ~295, so bytes bound them
// (7.5 MB for the pre forward at 6,144 rows, ~2 us at 3.35 TB/s).  Design:
//   * one block per 64-row tile keeps the tile's activations in shared memory
//     through the whole program (x, h, y; attn, r1, y2, the 512-wide hidden),
//     so only the outputs (and, for the backward, the saved tensors) touch
//     device memory;
//   * the weights (288 KB of bf16 for the post chain, more than the 227 KB a
//     block may use) stream from L2 in 128 x 64 slices, converted from the
//     port's fp32 [out, in] parameters as they are staged; q, k and v are read
//     from their three matrices (no concatenated copy per call);
//   * products are 16x16x16 bf16 WMMA with fp32 accumulators; LayerNorm runs
//     as one warp per row on the tile in shared memory;
//   * weight gradients without atomics, as mlp_chain_bwd.cu: the row kernel
//     (phase 1) writes bf16(d) of each product and per-tile fp32 column sums
//     (biases, LayerNorm scale and shift); phase 2 (dw_phase2.cuh, shared
//     with mlp_chain_bwd.cu) forms each dW over row ranges split across
//     blocks and adds the partials and the per-tile sums in a fixed order.
//     It serves _pre_run_bwd, _post_run_bwd and their pair forms.  Bytes
//     bound it (d and the layer input read once: ~218 MB for the post
//     backward at 65,536 rows, 0.065 ms); the split over about four blocks
//     per SM, a cp.async ring and 16-byte loads are what it does about it.
// Not yet done (later work): wgmma/TMA, weights kept resident across tiles.
#include "dw_phase2.cuh"
#include "mlp_chain.cuh"

#define FB_MAX_EMBED 128

// Mirrored field by field by ctypes in cusrl_tpu_torch/nn/kernels/fused_block.py
// (_Chain / _Params): every pointer a void*, every scalar an int.
struct FbChain {
  const void* x;     // pre: [N, in] fp32 or bf16 (x_is_bf16); post: attn [N, E] fp32
  const void* h;     // [N, E] fp32 residual holding bf16 values (pre bwd, post fwd)
  const void* g;     // bwd: pre gqkv [N, 3E] bf16; post g [N, E] bf16
  const void* gh;    // pre bwd: [N, E] fp32 cotangent of h, or null (zero)
  const void* r1;    // post bwd: saved [N, E] bf16
  const void* s;     // post bwd: saved [N, F] bf16 (gelu: z1, else hid)
  const void* w[4];  // fp32 [out, in]: pre W_in, W_q, W_k, W_v; post W_o, W_up, W_down
  const void* b[4];  // fp32 [out], forwards: the matching biases
  const void* ln_g;  // fp32 [E]: LN1 (pre) or LN2 (post) scale
  const void* ln_b;  // fp32 [E]: its shift
  void* out0;        // pre fwd h [N, E] fp32; post fwd out [N, E] bf16;
                     // pre bwd dx [N, in] fp32 or null (skip_input_grad); post bwd dattn [N, E] fp32
  void* out1;        // pre fwd qkv [N, 3E] bf16; post fwd saved r1 [N, E] bf16 or null (primal);
                     // post bwd dh [N, E] fp32
  void* out2;        // post fwd saved s [N, F] bf16 (with out1)
  void* sa;          // bwd scratch [N, E] bf16: pre y, post y2
  void* sb;          // bwd scratch [N, E] bf16: pre bf16(dh), post bf16(dr1)
  void* sc;          // post bwd scratch [N, F] bf16: bf16(dz1)
  void* part;        // bwd scratch [row_tiles, num_sums] fp32: per-tile column sums
  void* dw;          // bwd out: the weight gradients [out, in] fp32, back to back in w[] order
  void* sums;        // bwd out [num_sums] fp32: pre db_in, dg1, dbb1, db_q, db_k, db_v;
                     //                          post db_o, dg2, dbb2, db_up, db_down
};

struct FbParams {
  FbChain chain[2];
  int num_rows;
  int in_dim;      // pre: the width of x
  int embed;       // E
  int ff;          // post: the FFN width F
  int activation;  // post: 0 identity, 1 elu, 2 relu, 3 tanh, 4 gelu (as mlp_chain.cuh)
  int x_is_bf16;   // pre
};

namespace fb {

using mlp::ACT_BYTES;
using mlp::BM;
using mlp::HLD;
using mlp::KS;
using mlp::NC;
using mlp::SLD;
using mlp::STG_BYTES;
using mlp::THREADS;
using mlp::WLD_COL;
using mlp::WLD_ROW;
using mlp::WS_BYTES;
using mlp::bf16;
namespace wmma = nvcuda::wmma;

constexpr int WARPS = THREADS / 32;
constexpr int RLD = FB_MAX_EMBED + 8;  // bf16 [BM][RLD] residual tile (post forward)
constexpr size_t R_BYTES = size_t(BM) * RLD * sizeof(bf16);
constexpr size_t SMEM_BYTES = 2 * ACT_BYTES + WS_BYTES + STG_BYTES + R_BYTES + 2 * BM * sizeof(float);
static_assert(R_BYTES % 128 == 0, "smem regions must stay 128-byte aligned");
static_assert(SMEM_BYTES <= 232448, "exceeds the 227 KB a block may use");
static_assert(3 * FB_MAX_EMBED <= MLP_MAX_WIDTH, "the qkv cotangent tile must fit an activation tile");
constexpr float LN_EPS = 1e-6f;

struct Smem {
  bf16* t0;     // [BM][HLD] activation / cotangent tiles
  bf16* t1;
  bf16* ws;     // staged weight slice
  float* stg;   // [BM][SLD] fp32 GEMM output
  bf16* r;      // [BM][RLD] residual r1 (post forward)
  float* mean;  // [BM] LayerNorm statistics of the tile's rows
  float* inv;
};

__device__ Smem carve(unsigned char* smem) {
  Smem s;
  s.t0 = reinterpret_cast<bf16*>(smem);
  s.t1 = reinterpret_cast<bf16*>(smem + ACT_BYTES);
  s.ws = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES);
  s.stg = reinterpret_cast<float*>(smem + 2 * ACT_BYTES + WS_BYTES);
  s.r = reinterpret_cast<bf16*>(smem + 2 * ACT_BYTES + WS_BYTES + STG_BYTES);
  s.mean = reinterpret_cast<float*>(smem + 2 * ACT_BYTES + WS_BYTES + STG_BYTES + R_BYTES);
  s.inv = s.mean + BM;
  return s;
}

// B(k, n) of a block GEMM from fp32 weights in the port's [out, in] layout;
// up to three matrices of `seg` rows side by side (q, k and v).
//   Rows: B(k, n) = W_s[n - s * seg][k], s = n / seg  (forward: y = a W^T)
//   Cols: B(k, n) = W_s[k - s * seg][n], s = k / seg  (backward data: d_in = d_out W)
struct Rows {
  const float* w[3];
  int seg, ld;
  __device__ float operator()(int k, int n) const {
    const int s = n / seg;
    return w[s][size_t(n - s * seg) * ld + k];
  }
};
struct Cols {
  const float* w[3];
  int seg, ld;
  __device__ float operator()(int k, int n) const {
    const int s = k / seg;
    return w[s][size_t(k - s * seg) * ld + n];
  }
};

template <class B>
__device__ B weights(const void* w0, const void* w1, const void* w2, int seg, int ld) {
  B b;
  b.w[0] = static_cast<const float*>(w0);
  b.w[1] = static_cast<const float*>(w1);
  b.w[2] = static_cast<const float*>(w2);
  b.seg = seg;
  b.ld = ld;
  return b;
}

// One NC-column chunk of C[BM, n_total] = A[BM, K] B[K, n_total], columns
// [n0, n0 + NC), into `stg`: mlp::gemm_chunk with B read through a functor.
// A is bf16 in shared memory (leading dim HLD); K and n_total are multiples
// of 16.  Ends with a block barrier, after which `stg` holds the chunk.
template <bool ROWS, class B>
__device__ void block_gemm(const bf16* A, int K, const B& b, int n0, int n_total, bf16* ws, float* stg) {
  const int warp = threadIdx.x / 32;
  const int wr = warp & 3;   // 16-row fragment row
  const int wc = warp >> 2;  // 64-column half
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int k0 = 0; k0 < K; k0 += KS) {
    __syncthreads();  // previous readers of ws / stg are done
    if constexpr (ROWS) {
      for (int i = threadIdx.x; i < NC * KS; i += THREADS) {
        const int n = i / KS, k = i % KS;
        const int gn = n0 + n, gk = k0 + k;
        ws[n * WLD_COL + k] = __float2bfloat16((gn < n_total && gk < K) ? b(gk, gn) : 0.f);
      }
    } else {
      for (int i = threadIdx.x; i < KS * NC; i += THREADS) {
        const int k = i / NC, n = i % NC;
        const int gn = n0 + n, gk = k0 + k;
        ws[k * WLD_ROW + n] = __float2bfloat16((gn < n_total && gk < K) ? b(gk, gn) : 0.f);
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
          if constexpr (ROWS) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bf;
            wmma::load_matrix_sync(bf, ws + nl * WLD_COL + kk, WLD_COL);
            wmma::mma_sync(acc[f], a, bf, acc[f]);
          } else {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bf;
            wmma::load_matrix_sync(bf, ws + kk * WLD_ROW + nl, WLD_ROW);
            wmma::mma_sync(acc[f], a, bf, acc[f]);
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Mean and 1 / sqrt(var + eps) of one row of E values read through `row`,
// by one warp: the population variance mean((x - mean)^2), as the TPU kernels.
template <class Row>
__device__ void row_stats(const Row& row, int E, float& mean, float& inv) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int j = lane; j < E; j += 32) s += row(j);
  mean = warp_sum(s) / E;
  float q = 0.f;
  for (int j = lane; j < E; j += 32) {
    const float c = row(j) - mean;
    q += c * c;
  }
  inv = 1.f / sqrtf(warp_sum(q) / E + LN_EPS);
}

// Tile of `width` columns from device memory into a bf16 shared tile (leading
// dim ld); rows past the end are 0.
__device__ void load_tile(const void* src, bool is_bf16, int width, int row0, int n_rows, bf16* dst, int ld) {
  for (int i = threadIdx.x; i < BM * width; i += THREADS) {
    const int r = i / width, k = i % width;
    const int gr = row0 + r;
    float v = 0.f;
    if (gr < n_rows) {
      const size_t idx = size_t(gr) * width + k;
      v = is_bf16 ? __bfloat162float(static_cast<const bf16*>(src)[idx]) : static_cast<const float*>(src)[idx];
    }
    dst[r * ld + k] = __float2bfloat16(v);
  }
}

// Column sums over the tile's rows of the fp32 tile `stg` (row order) into
// part[0 .. ncols).
__device__ void column_sums(const float* stg, int ncols, float* part) {
  for (int j = threadIdx.x; j < ncols; j += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < BM; ++r) acc += stg[r * SLD + j];
    part[j] = acc;
  }
}

// y = bf16(LN(src) * g + b) for each row of a bf16 shared tile, one warp per row.
__device__ void ln_tile(const bf16* src, int src_ld, int E, const float* g, const float* b, bf16* dst) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x / 32; r < BM; r += WARPS) {
    float mean, inv;
    row_stats([&](int j) { return __bfloat162float(src[r * src_ld + j]); }, E, mean, inv);
    for (int j = lane; j < E; j += 32) {
      const float xhat = (__bfloat162float(src[r * src_ld + j]) - mean) * inv;
      dst[r * HLD + j] = __float2bfloat16(xhat * g[j] + b[j]);
    }
  }
}

// LayerNorm recomputed from the saved rows `x` ([N, E], fp32 or bf16) of this
// tile: statistics into s.mean / s.inv (0 on rows past the end) and
// y = bf16(xhat * g + b) into `y` ([N, E] bf16 scratch for phase 2).
template <class T>
__device__ void ln_recompute(const T* x, int E, const float* g, const float* b, int row0, int n_rows, bf16* y,
                             const Smem& s) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x / 32; r < BM; r += WARPS) {
    const int gr = row0 + r;
    float mean = 0.f, inv = 0.f;
    if (gr < n_rows) {  // warp-uniform
      const T* row = x + size_t(gr) * E;
      row_stats([&](int j) { return to_f(row[j]); }, E, mean, inv);
      for (int j = lane; j < E; j += 32)
        y[size_t(gr) * E + j] = __float2bfloat16((to_f(row[j]) - mean) * inv * g[j] + b[j]);
    }
    if (lane == 0) {
      s.mean[r] = mean;
      s.inv[r] = inv;
    }
  }
}

// Per-tile sums of dg = dy * xhat and dbb = dy (dy: the fp32 tile in stg), in
// row order, with xhat from the saved rows `x` and the tile's statistics.
template <class T>
__device__ void ln_param_sums(const float* stg, const T* x, int E, int row0, int n_rows, const Smem& s, float* dg,
                              float* dbb) {
  for (int j = threadIdx.x; j < E; j += THREADS) {
    float a = 0.f, c = 0.f;
    for (int r = 0; r < BM && row0 + r < n_rows; ++r) {
      const float dy = stg[r * SLD + j];
      const float xhat = (to_f(x[size_t(row0 + r) * E + j]) - s.mean[r]) * s.inv[r];
      a += dy * xhat;
      c += dy;
    }
    dg[j] = a;
    dbb[j] = c;
  }
}

// The LayerNorm input cotangent from dy (fp32 in stg, per row):
// inv * (dy g - mean(dy g) - xhat mean(dy g xhat)) + extra(row, j), written
// back to stg, in bf16 to `tile` (leading dim HLD) and to `scratch` ([N, E]);
// rows past the end become 0.  One warp per row.
template <class T, class Extra>
__device__ void ln_backward(const T* x, const float* g, int E, int row0, int n_rows, const Smem& s,
                            const Extra& extra, bf16* tile, bf16* scratch) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x / 32; r < BM; r += WARPS) {
    const int gr = row0 + r;
    if (gr >= n_rows) {  // warp-uniform
      for (int j = lane; j < E; j += 32) {
        s.stg[r * SLD + j] = 0.f;
        tile[r * HLD + j] = __float2bfloat16(0.f);
      }
      continue;
    }
    const T* row = x + size_t(gr) * E;
    const float mean = s.mean[r], inv = s.inv[r];
    float m1 = 0.f, m2 = 0.f;
    for (int j = lane; j < E; j += 32) {
      const float dxhat = s.stg[r * SLD + j] * g[j];
      m1 += dxhat;
      m2 += dxhat * ((to_f(row[j]) - mean) * inv);
    }
    m1 = warp_sum(m1) / E;
    m2 = warp_sum(m2) / E;
    for (int j = lane; j < E; j += 32) {
      const float xhat = (to_f(row[j]) - mean) * inv;
      const float d = inv * (s.stg[r * SLD + j] * g[j] - m1 - xhat * m2) + extra(r, j);
      s.stg[r * SLD + j] = d;
      const bf16 db = __float2bfloat16(d);
      tile[r * HLD + j] = db;
      scratch[size_t(gr) * E + j] = db;
    }
  }
}

// ---------------------------------------------------------------------------
// Pre: h = bf16(x W_in^T + b_in); qkv = bf16(bf16(LN1(h)) W_qkv^T + b_qkv)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) pre_fwd_kernel(const FbParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem);
  const FbChain& c = p.chain[blockIdx.y];
  const int row0 = blockIdx.x * BM, n_rows = p.num_rows, in = p.in_dim, E = p.embed;

  load_tile(c.x, p.x_is_bf16, in, row0, n_rows, s.t0, HLD);
  const Rows w_in = weights<Rows>(c.w[0], c.w[0], c.w[0], E, in);
  const float* b_in = static_cast<const float*>(c.b[0]);
  float* h = static_cast<float*>(c.out0);
  for (int n0 = 0; n0 < E; n0 += NC) {
    block_gemm<true>(s.t0, in, w_in, n0, E, s.ws, s.stg);
    const int ncols = min(NC, E - n0);
    for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
      const int r = i / ncols, col = n0 + i % ncols;
      const bf16 hb = __float2bfloat16(s.stg[r * SLD + col - n0] + b_in[col]);
      s.t1[r * HLD + col] = hb;
      if (row0 + r < n_rows) h[size_t(row0 + r) * E + col] = __bfloat162float(hb);
    }
  }
  __syncthreads();
  ln_tile(s.t1, HLD, E, static_cast<const float*>(c.ln_g), static_cast<const float*>(c.ln_b), s.t0);

  const Rows w_qkv = weights<Rows>(c.w[1], c.w[2], c.w[3], E, E);
  bf16* qkv = static_cast<bf16*>(c.out1);
  const int E3 = 3 * E;
  for (int n0 = 0; n0 < E3; n0 += NC) {
    block_gemm<true>(s.t0, E, w_qkv, n0, E3, s.ws, s.stg);
    const int ncols = min(NC, E3 - n0);
    for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
      const int r = i / ncols, col = n0 + i % ncols;
      const int seg = col / E;
      const float bias = static_cast<const float*>(c.b[1 + seg])[col - seg * E];
      if (row0 + r < n_rows) qkv[size_t(row0 + r) * E3 + col] = __float2bfloat16(s.stg[r * SLD + col - n0] + bias);
    }
  }
}

// Phase 1 of the pre backward, one block per 64-row tile: from gqkv (bf16) and
// gh (fp32), dy = gqkv W_qkv, dh = LN1^T(dy) + gh, dx = bf16(dh) W_in; writes
// y and bf16(dh) for phase 2 and the tile's sums of db_in, dg1, dbb1, db_qkv.
__global__ void __launch_bounds__(THREADS) pre_bwd_rows_kernel(const FbParams p, int num_sums) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem);
  const FbChain& c = p.chain[blockIdx.y];
  const int row0 = blockIdx.x * BM, n_rows = p.num_rows, in = p.in_dim, E = p.embed, E3 = 3 * E;
  float* part = static_cast<float*>(c.part) + size_t(blockIdx.x) * num_sums;
  const float* h = static_cast<const float*>(c.h);
  const float* g1 = static_cast<const float*>(c.ln_g);

  load_tile(c.g, true, E3, row0, n_rows, s.t0, HLD);
  __syncthreads();
  for (int j = threadIdx.x; j < E3; j += THREADS) {  // db_q, db_k, db_v
    float acc = 0.f;
    for (int r = 0; r < BM; ++r) acc += __bfloat162float(s.t0[r * HLD + j]);
    part[3 * E + j] = acc;
  }
  ln_recompute(h, E, g1, static_cast<const float*>(c.ln_b), row0, n_rows, static_cast<bf16*>(c.sa), s);

  // dy = gqkv [W_q; W_k; W_v]: E <= NC columns, one chunk.
  block_gemm<false>(s.t0, E3, weights<Cols>(c.w[1], c.w[2], c.w[3], E, E), 0, E, s.ws, s.stg);
  ln_param_sums(s.stg, h, E, row0, n_rows, s, part + E, part + 2 * E);
  __syncthreads();  // the sums have read stg
  const float* gh = static_cast<const float*>(c.gh);
  ln_backward(h, g1, E, row0, n_rows, s,
              [&](int r, int j) { return gh != nullptr ? gh[size_t(row0 + r) * E + j] : 0.f; },
              s.t1, static_cast<bf16*>(c.sb));
  __syncthreads();
  column_sums(s.stg, E, part);  // db_in

  float* dx = static_cast<float*>(c.out0);
  if (dx == nullptr) return;
  const Cols w_in = weights<Cols>(c.w[0], c.w[0], c.w[0], E, in);
  for (int n0 = 0; n0 < in; n0 += NC) {
    block_gemm<false>(s.t1, E, w_in, n0, in, s.ws, s.stg);
    const int ncols = min(NC, in - n0);
    for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
      const int r = i / ncols, j = i % ncols;
      if (row0 + r < n_rows) dx[size_t(row0 + r) * in + n0 + j] = s.stg[r * SLD + j];
    }
  }
}

// ---------------------------------------------------------------------------
// Post: r1 = h + attn W_o^T + b_o; out = r1 + FFN(LN2(r1))
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) post_fwd_kernel(const FbParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem);
  const FbChain& c = p.chain[blockIdx.y];
  const int row0 = blockIdx.x * BM, n_rows = p.num_rows, E = p.embed, F = p.ff;
  bf16* r1_out = static_cast<bf16*>(c.out1);
  bf16* s_out = static_cast<bf16*>(c.out2);
  const bool save = r1_out != nullptr;

  load_tile(c.x, false, E, row0, n_rows, s.t0, HLD);
  const float* h = static_cast<const float*>(c.h);
  const float* b_o = static_cast<const float*>(c.b[0]);
  for (int n0 = 0; n0 < E; n0 += NC) {
    block_gemm<true>(s.t0, E, weights<Rows>(c.w[0], c.w[0], c.w[0], E, E), n0, E, s.ws, s.stg);
    const int ncols = min(NC, E - n0);
    for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
      const int r = i / ncols, col = n0 + i % ncols;
      const int gr = row0 + r;
      const float zo = mlp::bf16_round(s.stg[r * SLD + col - n0] + b_o[col]);
      const bf16 r1 = __float2bfloat16((gr < n_rows ? h[size_t(gr) * E + col] : 0.f) + zo);
      s.r[r * RLD + col] = r1;
      if (save && gr < n_rows) r1_out[size_t(gr) * E + col] = r1;
    }
  }
  __syncthreads();
  ln_tile(s.r, RLD, E, static_cast<const float*>(c.ln_g), static_cast<const float*>(c.ln_b), s.t1);

  const float* b_up = static_cast<const float*>(c.b[1]);
  const Rows w_up = weights<Rows>(c.w[1], c.w[1], c.w[1], F, E);
  for (int n0 = 0; n0 < F; n0 += NC) {
    block_gemm<true>(s.t1, E, w_up, n0, F, s.ws, s.stg);
    const int ncols = min(NC, F - n0);
    for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
      const int r = i / ncols, col = n0 + i % ncols;
      const int gr = row0 + r;
      const float zb = mlp::bf16_round(s.stg[r * SLD + col - n0] + b_up[col]);
      const bf16 hb = __float2bfloat16(mlp::act_fwd(p.activation, zb));
      s.t0[r * HLD + col] = hb;
      if (save && gr < n_rows) s_out[size_t(gr) * F + col] = mlp::saved_value(p.activation, __float2bfloat16(zb), hb);
    }
  }

  const float* b_down = static_cast<const float*>(c.b[2]);
  bf16* out = static_cast<bf16*>(c.out0);
  for (int n0 = 0; n0 < E; n0 += NC) {
    block_gemm<true>(s.t0, F, weights<Rows>(c.w[2], c.w[2], c.w[2], E, F), n0, E, s.ws, s.stg);
    const int ncols = min(NC, E - n0);
    for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
      const int r = i / ncols, col = n0 + i % ncols;
      const int gr = row0 + r;
      const float f = mlp::bf16_round(s.stg[r * SLD + col - n0] + b_down[col]);
      if (gr < n_rows) out[size_t(gr) * E + col] = __float2bfloat16(__bfloat162float(s.r[r * RLD + col]) + f);
    }
  }
}

// Phase 1 of the post backward, one block per 64-row tile: dz1 = (g W_down)
// act'(saved), dy2 = bf16(dz1) W_up, dr1 = g + LN2^T(dy2) (= dh, fp32),
// dattn = bf16(dr1) W_o; writes bf16(dz1), y2 and bf16(dr1) for phase 2 and
// the tile's sums of db_o, dg2, dbb2, db_up, db_down.
__global__ void __launch_bounds__(THREADS) post_bwd_rows_kernel(const FbParams p, int num_sums) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem);
  const FbChain& c = p.chain[blockIdx.y];
  const int row0 = blockIdx.x * BM, n_rows = p.num_rows, E = p.embed, F = p.ff;
  float* part = static_cast<float*>(c.part) + size_t(blockIdx.x) * num_sums;
  const bf16* saved = static_cast<const bf16*>(c.s);
  const bf16* r1 = static_cast<const bf16*>(c.r1);
  const float* g2 = static_cast<const float*>(c.ln_g);

  load_tile(c.g, true, E, row0, n_rows, s.t0, HLD);
  __syncthreads();
  for (int j = threadIdx.x; j < E; j += THREADS) {  // db_down
    float acc = 0.f;
    for (int r = 0; r < BM; ++r) acc += __bfloat162float(s.t0[r * HLD + j]);
    part[3 * E + F + j] = acc;
  }

  bf16* dz1 = static_cast<bf16*>(c.sc);
  const Cols w_down = weights<Cols>(c.w[2], c.w[2], c.w[2], E, F);
  for (int n0 = 0; n0 < F; n0 += NC) {
    block_gemm<false>(s.t0, E, w_down, n0, F, s.ws, s.stg);
    const int ncols = min(NC, F - n0);
    for (int i = threadIdx.x; i < BM * ncols; i += THREADS) {
      const int r = i / ncols, j = i % ncols;
      const int gr = row0 + r;
      float d = 0.f;
      if (gr < n_rows)
        d = s.stg[r * SLD + j] *
            mlp::act_grad_from_saved(p.activation, __bfloat162float(saved[size_t(gr) * F + n0 + j]));
      s.stg[r * SLD + j] = d;
      const bf16 db = __float2bfloat16(d);
      s.t1[r * HLD + n0 + j] = db;
      if (gr < n_rows) dz1[size_t(gr) * F + n0 + j] = db;
    }
    __syncthreads();
    column_sums(s.stg, ncols, part + 3 * E + n0);  // db_up
  }
  ln_recompute(r1, E, g2, static_cast<const float*>(c.ln_b), row0, n_rows, static_cast<bf16*>(c.sa), s);

  // dy2 = bf16(dz1) W_up: E <= NC columns, one chunk.
  block_gemm<false>(s.t1, F, weights<Cols>(c.w[1], c.w[1], c.w[1], F, E), 0, E, s.ws, s.stg);
  ln_param_sums(s.stg, r1, E, row0, n_rows, s, part + E, part + 2 * E);
  __syncthreads();  // the sums have read stg
  // The extra term is g, read from t0 by the thread that then overwrites that
  // element with bf16(dr1).
  const bf16* g_tile = s.t0;
  ln_backward(r1, g2, E, row0, n_rows, s, [&](int r, int j) { return __bfloat162float(g_tile[r * HLD + j]); },
              s.t0, static_cast<bf16*>(c.sb));
  __syncthreads();
  float* dh = static_cast<float*>(c.out1);
  for (int i = threadIdx.x; i < BM * E; i += THREADS) {
    const int r = i / E, j = i % E;
    if (row0 + r < n_rows) dh[size_t(row0 + r) * E + j] = s.stg[r * SLD + j];
  }
  column_sums(s.stg, E, part);  // db_o

  float* dattn = static_cast<float*>(c.out0);
  block_gemm<false>(s.t0, E, weights<Cols>(c.w[0], c.w[0], c.w[0], E, E), 0, E, s.ws, s.stg);
  for (int i = threadIdx.x; i < BM * E; i += THREADS) {
    const int r = i / E, j = i % E;
    if (row0 + r < n_rows) dattn[size_t(row0 + r) * E + j] = s.stg[r * SLD + j];
  }
}

int launch_rows(const void* kernel, const FbParams* p, int num_chains, cudaStream_t stream, int num_sums,
                bool with_sums) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p->num_rows + BM - 1) / BM, num_chains);
  FbParams copy = *p;
  void* args_fwd[] = {&copy};
  void* args_bwd[] = {&copy, &num_sums};
  err = cudaLaunchKernel(kernel, grid, dim3(THREADS), with_sums ? args_bwd : args_fwd, SMEM_BYTES, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fb

extern "C" const char* fused_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry point launches on `stream` for `num_chains` (1: K4, 2: K5) and
// returns cudaGetLastError() after its launches (0 on success).

extern "C" int fused_block_pre_fwd(const FbParams* p, int num_chains, void* stream) {
  return fb::launch_rows(reinterpret_cast<const void*>(fb::pre_fwd_kernel), p, num_chains,
                         static_cast<cudaStream_t>(stream), 0, false);
}

extern "C" int fused_block_post_fwd(const FbParams* p, int num_chains, void* stream) {
  return fb::launch_rows(reinterpret_cast<const void*>(fb::post_fwd_kernel), p, num_chains,
                         static_cast<cudaStream_t>(stream), 0, false);
}

// The backwards: phase 1 (the row kernel), then phase 2 (dw_phase2.cuh) on
// the jobs below; `s` is phase 2's split and scratch.
namespace fb {

int launch_bwd(const void* rows_kernel, const FbParams* p, int num_chains, int num_sums, dw::Phase2& P,
               const DwScratch* s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int c = 0; c < num_chains; ++c) {
    P.sum[c][0] = {static_cast<const float*>(p->chain[c].part), static_cast<float*>(p->chain[c].sums), num_sums, 0,
                   num_sums, 1};
    P.num_sums[c] = 1;
  }
  P.num_rows = p->num_rows;
  int err = launch_rows(rows_kernel, p, num_chains, st, num_sums, true);
  if (err != 0) return err;
  return dw::launch(P, num_chains, s, st);
}

}  // namespace fb

extern "C" int fused_block_pre_bwd(const FbParams* p, int num_chains, const DwScratch* s, void* stream) {
  const int E = p->embed, in = p->in_dim;
  dw::Phase2 P{};
  for (int c = 0; c < num_chains; ++c) {
    const FbChain& ch = p->chain[c];
    float* dwp = static_cast<float*>(ch.dw);
    P.job[c][0] = {ch.sb, ch.x, dwp, E, 0, p->x_is_bf16 ? dw::H_BF16 : dw::H_F32, E, in};  // W_in: bf16(dh)^T x
    dwp += size_t(E) * in;
    for (int q = 0; q < 3; ++q) {  // W_q, W_k, W_v: gqkv[:, qE:(q+1)E]^T y
      P.job[c][1 + q] = {ch.g, ch.sa, dwp, 3 * E, q * E, dw::H_BF16, E, E};
      dwp += size_t(E) * E;
    }
  }
  P.num_jobs = 4;
  P.activation = 0;
  return fb::launch_bwd(reinterpret_cast<const void*>(fb::pre_bwd_rows_kernel), p, num_chains, 6 * E, P, s, stream);
}

extern "C" int fused_block_post_bwd(const FbParams* p, int num_chains, const DwScratch* s, void* stream) {
  const int E = p->embed, F = p->ff;
  dw::Phase2 P{};
  for (int c = 0; c < num_chains; ++c) {
    const FbChain& ch = p->chain[c];
    float* dwp = static_cast<float*>(ch.dw);
    P.job[c][0] = {ch.sb, ch.x, dwp, E, 0, dw::H_F32, E, E};  // W_o: bf16(dr1)^T attn
    dwp += size_t(E) * E;
    P.job[c][1] = {ch.sc, ch.sa, dwp, F, 0, dw::H_BF16, F, E};  // W_up: bf16(dz1)^T y2
    dwp += size_t(F) * E;
    P.job[c][2] = {ch.g, ch.s, dwp, E, 0, dw::H_SAVED, E, F};  // W_down: g^T hid
  }
  P.num_jobs = 3;
  P.activation = p->activation;
  return fb::launch_bwd(reinterpret_cast<const void*>(fb::post_bwd_rows_kernel), p, num_chains, 4 * E + F, P, s,
                        stream);
}

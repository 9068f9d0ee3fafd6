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
// 128 -> 384; 128 -> 128 -> 512 -> 128) the forwards do 2 * 55,296 (pre) and
// 2 * 147,456 (post) FLOP per row against ~1.5 KB (pre) and ~1.3-2.6 KB
// (post, primal or saving) of device memory per row: ~75-230 FLOP per byte,
// below the card's ~295, so bytes bound them (0.029 ms for the pre forward
// and 0.050 ms for the saving post forward at 65,536 rows, at 3.35 TB/s).
//
// The forwards (namespace fbf; building blocks in hopper_wg.cuh):
//   * a pack kernel turns each fp32 [out, in] weight into bf16 images of
//     128 rows x 64 columns, 16 KB each, already in the 128-byte-swizzled
//     K-major layout that wgmma reads as its B operand, once per call (the
//     optimizer updates the weights in place, so nothing is cached);
//   * persistent blocks walk the row tiles of their chain (K5 splits the
//     blocks between the chains): consumer warpgroups of 64 rows each and
//     one producer warp that copies the images into a ring of shared-memory
//     slots (cp.async.bulk; an mbarrier per slot for "full" and one for
//     "empty"; a chunk may take more images than there are slots, each
//     released as soon as its products are done);
//   * pre: two consumer warpgroups (128-row tiles), one block per SM; its
//     images fit (7 images, 112 KB at the zoo's widths), so each block loads
//     them once and they stay;
//   * post: its images (18, 288 KB) exceed the 227 KB a block may use, so
//     they stream once per tile; one consumer warpgroup (64-row tiles) in
//     each of two blocks per SM, so that one block's loads, stores and
//     epilogues overlap the other's products (a shared ring keeps two
//     warpgroups of one block in step, which overlaps nothing);
//   * products are m64n128k16 wgmma with fp32 accumulators in registers;
//     bias, bf16 rounding, residual adds, LayerNorm (the four threads that
//     share a row reduce by shuffles) and the activation run on the
//     accumulators; the post op's 512-wide hidden is made and consumed in
//     128-column chunks (z1 chunk -> hid chunk in shared memory -> the
//     W_down product accumulates), so it never leaves the chip;
//   * outputs leave by 16-byte stores: qkv and the post op's saved
//     activations from registers, with no staging tile and no barrier (the
//     four threads of a quad transpose their bf16 words by shuffles so that
//     each holds eight columns of one row), fp32 h from registers after
//     neighbouring threads swap halves, r1 and out from their shared tiles
//     (out's shuffles cost the post kernel registers it spilled).
// What is left is not the products: the post op's gelu is ALU work (about
// 50 instructions an element, tanhf included) and its loads and stores wait
// on device memory; a block's phases follow each other, and the second
// block per SM is what overlaps them.
//
// The backwards, in two phases without atomics:
//   * phase 1 writes bf16(d) of each product and per-64-row-tile fp32 column
//     sums (biases, LayerNorm scale and shift); phase 2 (dw_phase2.cuh,
//     shared with mlp_chain_bwd.cu) forms each dW over row ranges split
//     across blocks and adds the partials and the per-tile sums in a fixed
//     order.  It serves _pre_run_bwd, _post_run_bwd and their pair forms.
//     Bytes bound it (d and the layer input read once: ~218 MB for the post
//     backward at 65,536 rows, 0.065 ms); one launch of wgmma blocks fed by
//     TMA, one wave of them, the splits added through distributed shared
//     memory in clusters, is what it does about it;
//   * the post backward's phase 1 (namespace fbb) is the post forward's
//     design turned around: a pack kernel writes images of W_down^T, W_up^T
//     and W_o^T (wgmma's K-major B of d_in = d_out W), which stream through
//     the ring of one consumer warpgroup in each of two blocks per SM; per
//     128-column chunk of the hidden, dz1 = (g W_down) act'(saved) on the
//     accumulators, bf16(dz1) to device memory and to the A tile of
//     dy2 += bf16(dz1) W_up (a second accumulator set), so the 512-wide dz1
//     never needs a whole tile; LN2's backward on dy2 with quad-shuffle row
//     reductions, dr1 = g + LN2^T(dy2) to dh (fp32) and as bf16 to the A tile
//     of dattn = bf16(dr1) W_o.  Column sums by shuffles over a warp's rows
//     and the four warps in order.  Bytes bound it (4,096 B a row: 0.080 ms
//     at 65,536 rows); what is left is its epilogues' ALU work (gelu's
//     derivative, the sums) and the latency of one tile's phases in turn
//     (probe_backward_phase1.py; PERF.md);
//   * the pre backward's phase 1 (namespace fbp) is fbb's design on the pre
//     op: a pack kernel writes images of W_q^T, W_k^T and W_v^T (the K
//     blocks of dy = gqkv [W_q; W_k; W_v]) and, unless skip_input_grad,
//     W_in^T (dx = bf16(dh) W_in); two consumer warpgroups per block split
//     every product's columns; the gqkv tile (three segments of pad64(E)
//     columns) comes in by 16-byte cp.async; while the dy product runs, h is
//     read at the accumulators' places and db_qkv summed from the tile; LN1
//     is recomputed from h on the accumulators (row sums across the halves
//     through shared memory), y goes to device memory from registers,
//     dh = LN1^T(dy) + gh (fp32 gh) in fp32, bf16(dh) to device memory and
//     to the A tile of dx.  The qkv images (96 KB at the zoo's widths) stay
//     resident in one block per SM beside two such tiles (the next tile's
//     gqkv arrives while one is worked on); the six column sums of
//     a tile are gathered as warp partials (a reduce-scatter over the lanes
//     that share a column) and added under one barrier.
//     Bytes bound it (2,304 B a row with skip_input_grad: 0.045 ms at 65,536
//     rows).
#include <algorithm>

#include "dw_phase2.cuh"
#include "hopper_wg.cuh"
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
  void* wpack;       // scratch [num_stages][128][64] bf16: the weights' images (fbf::, fbb::, fbp::)
};

struct FbParams {
  FbChain chain[2];
  int num_rows;
  int in_dim;      // pre: the width of x
  int embed;       // E
  int ff;          // post: the FFN width F
  int activation;  // post: 0 identity, 1 elu, 2 relu, 3 tanh, 4 gelu (as mlp_chain.cuh)
  int x_is_bf16;   // pre
  int num_stages;  // weight images per chain the caller allocated in wpack
};

// ---------------------------------------------------------------------------
// The forwards: a pack kernel, then one persistent kernel per op
// ---------------------------------------------------------------------------

namespace fbf {

using wg::bf16;
// Consumer warpgroups (64 rows each) per block and blocks per SM.  Pre: two
// warpgroups (128-row tiles) in one block per SM, which keeps its images
// resident (112 KB at the zoo's widths).  Post: one warpgroup (64-row tiles)
// in each of two blocks per SM, so that one block's loads, stores and
// epilogues overlap the other's products; each block streams its own images.
constexpr int PRE_WGS = 2, PRE_BLOCKS_PER_SM = 1;
constexpr int POST_WGS = 1, POST_BLOCKS_PER_SM = 2;
__host__ __device__ constexpr int threads(int wgs) { return wgs * 128 + 32; }  // and one producer warp
using wg::BLOCK_SMEM;
using wg::SM_SMEM;
constexpr int BARRIER_BYTES = 2 * 24 * 8;  // a ring's barriers: up to 24 slots
constexpr float LN_EPS = 1e-6f;

// A block's shared memory, byte offsets from its 1,024-aligned base: the
// ring, then each consumer warpgroup's tiles t[0..2], the biases and
// LayerNorm parameters (par), the ring's barriers (bar).
struct Layout {
  int per_tile;  // images per tile (Pack::count)
  int slots;     // ring slots
  int resident;  // slots == per_tile: each image is loaded once per block
  int tiles;     // tiles (64 rows per consumer warpgroup) per chain
  int ring, wg0, wg_bytes, t[3], par, bar;
  int bytes;  // dynamic shared memory requested, with 1 KB of alignment slack
};

using wg::kblocks;
using wg::nchunks;
using wg::Pack;
using wg::pad64;

// The images of one op in the order its kernel takes them (wg::Pack): pre:
// W_in by K block, then [W_q; W_k; W_v] by 128-row chunk and K block.
// Mirrored by fwd_stages in nn/kernels/fused_block.py.
inline Pack pre_pack(int in, int E) {
  Pack P{};
  for (int kb = 0; kb < kblocks(in); ++kb) wg::pack_add(P, 0, 0, 64 * kb);
  for (int c = 0; c < nchunks(3 * E); ++c)
    for (int kb = 0; kb < kblocks(E); ++kb) wg::pack_add(P, 1, 128 * c, 64 * kb);
  wg::pack_matrix(P, 0, 0, E, E, in);
  wg::pack_matrix(P, 1, 1, E, 3 * E, E);
  return P;
}

// Post: W_o by K block; then per 128-column chunk of the FFN hidden, the
// chunk's rows of W_up by K block and the chunk's columns of W_down.
inline Pack post_pack(int E, int F) {
  Pack P{};
  for (int kb = 0; kb < kblocks(E); ++kb) wg::pack_add(P, 0, 0, 64 * kb);
  for (int c = 0; c < nchunks(F); ++c) {
    for (int kb = 0; kb < kblocks(E); ++kb) wg::pack_add(P, 1, 128 * c, 64 * kb);
    for (int kb = 0; kb < kblocks(std::min(128, F - 128 * c)); ++kb) wg::pack_add(P, 2, 0, 128 * c + 64 * kb);
  }
  wg::pack_matrix(P, 0, 0, E, E, E);
  wg::pack_matrix(P, 1, 1, F, F, E);
  wg::pack_matrix(P, 2, 2, E, E, F);
  return P;
}

// The ring takes what the tiles (per warpgroup), parameters and barriers
// leave, up to one slot per image; 0 on success.
inline int make_layout(Layout& L, int wgs, int blocks_per_sm, int per_tile, int n_rows, const int (&tile_bytes)[3],
                       int par_floats) {
  L.per_tile = per_tile;
  L.tiles = (n_rows + wgs * wg::TILE_M - 1) / (wgs * wg::TILE_M);
  int off = 0;
  for (int i = 0; i < 3; ++i) {
    L.t[i] = off;
    off += tile_bytes[i];
  }
  L.wg_bytes = off;
  const int par_bytes = (par_floats * 4 + 15) & ~15;
  const int budget = std::min(BLOCK_SMEM, SM_SMEM / blocks_per_sm - 1024);  // the SM keeps 1 KB per block
  const int fit = (budget - 1024 - wgs * L.wg_bytes - par_bytes - BARRIER_BYTES) / wg::STAGE_BYTES;
  if (fit < 2) return static_cast<int>(cudaErrorInvalidValue);  // wg::issue keeps one image in flight
  L.slots = std::min(per_tile, fit);
  L.resident = L.slots == per_tile;
  L.ring = 0;
  L.wg0 = L.slots * wg::STAGE_BYTES;
  L.par = L.wg0 + wgs * L.wg_bytes;
  L.bar = L.par + par_bytes;
  L.bytes = L.bar + 2 * L.slots * 8 + 1024;
  return 0;
}

struct Plan {
  Pack pack;
  Layout L;
  int blocks;  // per chain
  int sms;
  int device;
};

// Images, shared memory and grid of one forward.  Blocks per chain: the
// op's blocks per SM on every SM, split between the chains, at most one per
// tile.  Mirrored by fwd_grid in nn/kernels/fused_block.py.
inline int plan(const FbParams& p, int num_chains, bool post, Plan& out) {
  const int E = p.embed, F = p.ff, in = p.in_dim;
  const int wide = post ? F : in;
  if (num_chains < 1 || num_chains > 2 || E < 16 || E > FB_MAX_EMBED || E % 16 || wide < 16 ||
      wide > MLP_MAX_WIDTH || wide % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kb_e = kblocks(E) * wg::ABLOCK_BYTES, chunk = 2 * wg::ABLOCK_BYTES;
  int err;
  if (post) {
    out.pack = post_pack(E, F);
    const int tiles[3] = {kb_e, kb_e, chunk};
    err = make_layout(out.L, POST_WGS, POST_BLOCKS_PER_SM, out.pack.count, p.num_rows, tiles, 4 * E + F);
  } else {
    out.pack = pre_pack(in, E);
    const int tiles[3] = {kblocks(in) * wg::ABLOCK_BYTES, kb_e, 0};
    err = make_layout(out.L, PRE_WGS, PRE_BLOCKS_PER_SM, out.pack.count, p.num_rows, tiles, 6 * E);
  }
  if (err != 0) return err;
  if (cudaGetDevice(&out.device) != cudaSuccess ||
      cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, out.device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const int per_sm = post ? POST_BLOCKS_PER_SM : PRE_BLOCKS_PER_SM;
  out.blocks = std::max(1, std::min(out.L.tiles, per_sm * out.sms / num_chains));
  return 0;
}

// ---- device side ----------------------------------------------------------

// fp32 [out, in] weights to their bf16 images, once per call (the optimizer
// updates them in place between calls): one 16-byte unit per thread, grid
// (images, chains, wg::PACK_SPLIT).
__global__ void __launch_bounds__(wg::PACK_THREADS) pack_kernel(const FbParams p, const Pack P) {
  const FbChain& c = p.chain[blockIdx.y];
  wg::pack_unit(P, c.w, blockIdx.x, blockIdx.z * wg::PACK_THREADS + threadIdx.x,
                static_cast<unsigned char*>(c.wpack) + size_t(blockIdx.x) * wg::STAGE_BYTES);
}

using wg::add_bias_round;
using wg::bf16r;
using wg::Frag;
using wg::store_bf16;
using wg::to_tile;
using wg::zero;

using wg::quad_sum;
using wg::store_f32;

// An fp32 [n_rows, ld] matrix's values at the accumulators' places (first
// `cols` columns; 0 elsewhere and past the end).
__device__ __forceinline__ void load_frag(const float* src, int ld, int cols, int row0, int n_rows, const Frag& f,
                                          float (&v)[64]) {
  const int ra = row0 + f.row, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float2 a = make_float2(0.f, 0.f), b = a;
    if (8 * j < cols) {
      if (ra < n_rows) a = *reinterpret_cast<const float2*>(src + size_t(ra) * ld + 8 * j + f.col);
      if (rb < n_rows) b = *reinterpret_cast<const float2*>(src + size_t(rb) * ld + 8 * j + f.col);
    }
    v[4 * j] = a.x;
    v[4 * j + 1] = a.y;
    v[4 * j + 2] = b.x;
    v[4 * j + 3] = b.y;
  }
}

// y = bf16((x - mean) inv g + b) over the first E columns of the thread's two
// rows (d holds x), population variance, into a swizzled tile (0 from E to the
// next multiple of 64); the four threads of a quad share a row.
__device__ __forceinline__ void layer_norm(const float (&d)[64], int E, const float* g, const float* b,
                                           unsigned char* tile, const Frag& f) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const bool valid = 8 * j < E;
    s0 += valid ? d[4 * j] + d[4 * j + 1] : 0.f;
    s1 += valid ? d[4 * j + 2] + d[4 * j + 3] : 0.f;
  }
  const float m0 = quad_sum(s0) / E, m1 = quad_sum(s1) / E;
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const bool valid = 8 * j < E;
    const float a0 = d[4 * j] - m0, a1 = d[4 * j + 1] - m0, c0 = d[4 * j + 2] - m1, c1 = d[4 * j + 3] - m1;
    q0 += valid ? a0 * a0 + a1 * a1 : 0.f;
    q1 += valid ? c0 * c0 + c1 * c1 : 0.f;
  }
  const float i0 = 1.f / sqrtf(quad_sum(q0) / E + LN_EPS), i1 = 1.f / sqrtf(quad_sum(q1) / E + LN_EPS);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + f.col;
    if (8 * j < E) {
      const float g0 = g[col], g1 = g[col + 1], b0 = b[col], b1 = b[col + 1];
      wg::put2(tile, f.row, col, (d[4 * j] - m0) * i0 * g0 + b0, (d[4 * j + 1] - m0) * i0 * g1 + b1);
      wg::put2(tile, f.row + 8, col, (d[4 * j + 2] - m1) * i1 * g0 + b0, (d[4 * j + 3] - m1) * i1 * g1 + b1);
    } else if (8 * j < pad64(E)) {  // the next product's K padding
      wg::put2(tile, f.row, col, 0.f, 0.f);
      wg::put2(tile, f.row + 8, col, 0.f, 0.f);
    }
  }
}

using wg::aligned_base;
using wg::warp_index;

template <int WGS>
__device__ __forceinline__ wg::Ring make_ring(unsigned char* smem, const Layout& L) {
  return wg::make_ring(smem, L.ring, L.bar, L.slots, L.resident, WGS * 4);
}

// The producer warp's first thread streams the images of this block's tiles;
// returns true on the producer warp (which then leaves).
template <int WGS>
__device__ __forceinline__ bool producer(const wg::Ring& r, unsigned char* smem, const Layout& L, const void* images) {
  if (warp_index() < WGS * 4) return false;
  if (threadIdx.x == WGS * 128) {
    const int tiles = (L.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
    wg::produce(r, smem + L.ring, static_cast<const unsigned char*>(images), L.per_tile, tiles);
  }
  return true;
}

// Pre: h = bf16(x W_in^T + b_in); qkv = bf16(bf16(LN1(h)) [W_q; W_k; W_v]^T + b_qkv).
// Each consumer warpgroup takes 64 rows of a 128-row tile; the images stay
// resident when they fit (the zoo's widths: 7 images, 112 KB).
__global__ void __launch_bounds__(threads(PRE_WGS), PRE_BLOCKS_PER_SM) pre_fwd_kernel(const FbParams p, const Layout L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  const FbChain& c = p.chain[blockIdx.y];
  const int in = p.in_dim, E = p.embed, E3 = 3 * E, n_rows = p.num_rows;
  float* par = reinterpret_cast<float*>(smem + L.par);  // b_in, g1, bb1 [E each], b_qkv [3E]
  wg::Ring ring = make_ring<PRE_WGS>(smem, L);
  for (int i = threadIdx.x; i < E3; i += threads(PRE_WGS)) {
    const int s = i / E;
    par[3 * E + i] = static_cast<const float*>(c.b[1 + s])[i - s * E];
    if (i < E) {
      par[i] = static_cast<const float*>(c.b[0])[i];
      par[E + i] = static_cast<const float*>(c.ln_g)[i];
      par[2 * E + i] = static_cast<const float*>(c.ln_b)[i];
    }
  }
  __syncthreads();
  if (producer<PRE_WGS>(ring, smem, L, c.wpack)) return;

  const int w = warp_index() / 4, t = threadIdx.x & 127, bar = 1 + w;
  unsigned char* mine = smem + L.wg0 + w * L.wg_bytes;
  unsigned char* tx = mine + L.t[0];  // x
  unsigned char* ty = mine + L.t[1];  // y = LN1(h)
  const Frag f(t);
  float* h = static_cast<float*>(c.out0);
  bf16* qkv = static_cast<bf16*>(c.out1);
  float d[64];
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
    const int row0 = (tile * PRE_WGS + w) * wg::TILE_M;
    if (ring.resident) ring.next = 0;
    wg::wg_sync(bar);  // the last tile's products are done with ty
    wg::load_rows(c.x, p.x_is_bf16, in, row0, n_rows, tx, t);
    wg::fence_async_smem();
    wg::wg_sync(bar);
    zero(d);
    wg::issue(d, wg::smem_u32(tx), in, ring);
    wg::finish(d, ring);
    add_bias_round(d, par, E, f);
    store_f32(d, E, h, E, 0, row0, n_rows, f);
    layer_norm(d, E, par + E, par + 2 * E, ty, f);
    wg::fence_async_smem();
    wg::wg_sync(bar);
    for (int c0 = 0; c0 < E3; c0 += wg::STAGE_N) {
      const int cols = min(wg::STAGE_N, E3 - c0);
      zero(d);
      wg::issue(d, wg::smem_u32(ty), E, ring);
      wg::finish(d, ring);
      add_bias_round(d, par + 3 * E + c0, cols, f);
      store_bf16(d, cols, qkv, E3, c0, row0, n_rows, f);
    }
  }
}

// Post: r1 = bf16(h + bf16(attn W_o^T + b_o)); y2 = bf16(LN2(r1));
// per 128-column chunk of the hidden: z1 = bf16(y2 W_up^T + b_up),
// hid = bf16(act(z1)), acc += hid W_down^T; out = bf16(r1 + bf16(acc + b_down)).
// The 512-wide hidden never leaves the chip; the images (288 KB at the zoo's
// widths) stream through the ring once per 64-row tile.
__global__ void __launch_bounds__(threads(POST_WGS), POST_BLOCKS_PER_SM)
    post_fwd_kernel(const FbParams p, const Layout L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_base(smem_raw);
  const FbChain& c = p.chain[blockIdx.y];
  const int E = p.embed, F = p.ff, n_rows = p.num_rows, act = p.activation;
  bf16* out = static_cast<bf16*>(c.out0);
  bf16* r1_out = static_cast<bf16*>(c.out1);
  bf16* s_out = static_cast<bf16*>(c.out2);
  const bool save = r1_out != nullptr, keep_z = save && act == mlp::ACT_GELU;
  float* par = reinterpret_cast<float*>(smem + L.par);  // b_o, g2, bb2, b_down [E each], b_up [F]
  wg::Ring ring = make_ring<POST_WGS>(smem, L);
  for (int i = threadIdx.x; i < max(E, F); i += threads(POST_WGS)) {
    if (i < F) par[4 * E + i] = static_cast<const float*>(c.b[1])[i];
    if (i < E) {
      par[i] = static_cast<const float*>(c.b[0])[i];
      par[E + i] = static_cast<const float*>(c.ln_g)[i];
      par[2 * E + i] = static_cast<const float*>(c.ln_b)[i];
      par[3 * E + i] = static_cast<const float*>(c.b[2])[i];
    }
  }
  __syncthreads();
  if (producer<POST_WGS>(ring, smem, L, c.wpack)) return;

  const int w = warp_index() / 4, t = threadIdx.x & 127, bar = 1 + w;
  unsigned char* mine = smem + L.wg0 + w * L.wg_bytes;
  unsigned char* ta = mine + L.t[0];  // attn, then y2, then out
  unsigned char* tr = mine + L.t[1];  // r1
  unsigned char* th = mine + L.t[2];  // a 128-column chunk of the hidden
  const Frag f(t);
  const float* h = static_cast<const float*>(c.h);
  float d[64], o[64];
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
    const int row0 = (tile * POST_WGS + w) * wg::TILE_M;
    if (ring.resident) ring.next = 0;
    wg::wg_sync(bar);  // the last tile's readers of ta are done
    wg::load_rows(c.x, false, E, row0, n_rows, ta, t);
    wg::fence_async_smem();
    wg::wg_sync(bar);
    zero(d);
    {
      wg::issue(d, wg::smem_u32(ta), E, ring);
      float hv[64];
      load_frag(h, E, E, row0, n_rows, f, hv);  // while the product runs
      wg::finish(d, ring);
      add_bias_round(d, par, E, f);
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = bf16r(hv[i] + d[i]);
    }
    to_tile(d, E, tr, f);
    layer_norm(d, E, par + E, par + 2 * E, ta, f);
    wg::fence_async_smem();
    wg::wg_sync(bar);
    if (save) wg::store_rows(tr, E, r1_out, E, 0, row0, n_rows, t);
    zero(o);
    for (int c0 = 0; c0 < F; c0 += wg::STAGE_N) {
      const int cols = min(wg::STAGE_N, F - c0);
      zero(d);
      wg::issue(d, wg::smem_u32(ta), E, ring);
      wg::finish(d, ring);
      add_bias_round(d, par + 4 * E + c0, cols, f);
      if (keep_z) store_bf16(d, cols, s_out, F, c0, row0, n_rows, f);  // gelu saves z1
      mlp::activate(d, act);
      if (save && !keep_z) store_bf16(d, cols, s_out, F, c0, row0, n_rows, f);  // the others hid
      to_tile(d, pad64(cols), th, f);  // past `cols` the accumulators and act(0) are 0
      wg::fence_async_smem();
      wg::wg_sync(bar);
      wg::issue(o, wg::smem_u32(th), cols, ring);
      wg::finish(o, ring);
      wg::wg_sync(bar);  // the chunk's products are done with th
    }
    add_bias_round(o, par + 3 * E, E, f);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bool valid = 8 * j < E;
      const float2 ra = valid ? wg::get2(tr, f.row, 8 * j + f.col) : make_float2(0.f, 0.f);
      const float2 rb = valid ? wg::get2(tr, f.row + 8, 8 * j + f.col) : make_float2(0.f, 0.f);
      o[4 * j] += ra.x;
      o[4 * j + 1] += ra.y;
      o[4 * j + 2] += rb.x;
      o[4 * j + 3] += rb.y;
    }
    to_tile(o, E, ta, f);  // rounds r1 + f to bf16 (y2's products are done)
    wg::wg_sync(bar);
    wg::store_rows(ta, E, out, E, 0, row0, n_rows, t);
  }
}

// The pack kernel, then the op's kernel, on `stream`.
int launch(const void* kernel, const FbParams* p, int num_chains, bool post, cudaStream_t stream) {
  Plan P;
  int err = plan(*p, num_chains, post, P);
  if (err != 0) return err;
  if (P.pack.count != p->num_stages) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[2][64] = {};  // the shared-memory limit, set once per kernel and device
  bool& done = opted_in[post][P.device & 63];
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  pack_kernel<<<dim3(P.pack.count, num_chains, wg::PACK_SPLIT), wg::PACK_THREADS, 0, stream>>>(*p, P.pack);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  FbParams copy = *p;
  Layout L = P.L;
  void* args[] = {&copy, &L};
  e = cudaLaunchKernel(kernel, dim3(P.blocks, num_chains), dim3(threads(post ? POST_WGS : PRE_WGS)), args, P.L.bytes,
                       stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fbf

// ---------------------------------------------------------------------------
// The post backward's phase 1 (namespace fbb): a pack kernel of the
// transposed weights' images, then one persistent kernel
// ---------------------------------------------------------------------------

namespace fbb {

using fbf::Layout;
using wg::bf16;
using wg::Frag;
using wg::Pack;
using wg::kblocks;
using wg::nchunks;
using wg::pad64;
// Two consumer warpgroups per block, each taking half the columns of every
// product (NW of 128: m64n64k16 on its half of each image), in each of two
// blocks per SM: sixteen consumer warps share an SM, so that one warp's
// epilogue overlaps another's products and latencies.
constexpr int WGS = 2, BLOCKS_PER_SM = 2, NW = 64, NA = NW / 2;
constexpr int RED_FLOATS = WGS * 3 * 4 * NW;  // per warpgroup the column sums' warp partials, three sets at once
constexpr int ROW_FLOATS = WGS * 64 * 4;      // per warpgroup and row, the halves of four row sums

// The images in the order the kernel takes them: per 128-column chunk c of
// the FFN hidden, W_down^T's rows [128 c, 128 c + 128) by K block of E (the
// chunk of dz1 = g W_down), then W_up^T's K blocks [128 c, ...) (its
// contribution to dy2 = dz1 W_up); last W_o^T by K block (dattn = dr1 W_o).
// Matrices: 0 W_o^T [E, E], 1 W_up^T [E, F], 2 W_down^T [F, E], each the
// transpose of the stored weight of the same index.  Mirrored by bwd_stages
// in nn/kernels/fused_block.py.
inline Pack post_bwd_pack(int E, int F) {
  Pack P{};
  for (int c = 0; c < nchunks(F); ++c) {
    for (int kb = 0; kb < kblocks(E); ++kb) wg::pack_add(P, 2, 128 * c, 64 * kb);
    for (int kb = 0; kb < kblocks(std::min(128, F - 128 * c)); ++kb) wg::pack_add(P, 1, 0, 128 * c + 64 * kb);
  }
  for (int kb = 0; kb < kblocks(E); ++kb) wg::pack_add(P, 0, 0, 64 * kb);
  wg::pack_matrix(P, 0, 0, E, E, E, 1);
  wg::pack_matrix(P, 1, 1, E, E, F, 1);
  wg::pack_matrix(P, 2, 2, F, F, E, 1);
  return P;
}

// Images, shared memory (the block's tiles of g, r1 and one 128-column chunk
// of the hidden; LN2's parameters, the column sums' and the row sums'
// partials) and grid: 64-row tiles, fbf::make_layout's accounting of one set
// of tiles.
// Mirrored by post_bwd_plan in nn/kernels/fused_block.py.
inline int plan(const FbParams& p, int num_chains, fbf::Plan& out) {
  const int E = p.embed, F = p.ff;
  if (num_chains < 1 || num_chains > 2 || E < 16 || E > FB_MAX_EMBED || E % 16 || F < 16 || F > MLP_MAX_WIDTH ||
      F % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  out.pack = post_bwd_pack(E, F);
  const int kb_e = kblocks(E) * wg::ABLOCK_BYTES;
  const int tiles[3] = {kb_e, kb_e, 2 * wg::ABLOCK_BYTES};
  const int err =
      fbf::make_layout(out.L, 1, BLOCKS_PER_SM, out.pack.count, p.num_rows, tiles, 2 * E + RED_FLOATS + ROW_FLOATS);
  if (err != 0) return err;
  if (cudaGetDevice(&out.device) != cudaSuccess ||
      cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, out.device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  out.blocks = std::max(1, std::min(out.L.tiles, BLOCKS_PER_SM * out.sms / num_chains));
  return 0;
}

__global__ void __launch_bounds__(wg::PACK_THREADS) pack_kernel(const FbParams p, const Pack P) {
  const FbChain& c = p.chain[blockIdx.y];
  wg::pack_unit(P, c.w, blockIdx.x, blockIdx.z * wg::PACK_THREADS + threadIdx.x,
                static_cast<unsigned char*>(c.wpack) + size_t(blockIdx.x) * wg::STAGE_BYTES);
}

// Where accumulator i of thread f sits in a 64-row tile: (row, column).
__device__ __forceinline__ int acc_row(const Frag& f, int i) { return f.row + ((i >> 1) & 1) * 8; }
__device__ __forceinline__ int acc_col(const Frag& f, int i) { return 8 * (i >> 2) + f.col + (i & 1); }

// Value i of a swizzled bf16 tile at the accumulators' places, from column col0.
__device__ __forceinline__ float tile_at(const unsigned char* tile, const Frag& f, int i, int col0) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + wg::swz(acc_row(f, i), col0 + acc_col(f, i))));
}

// Phase 1 of the post backward on this block's 64-row tiles, warpgroup w
// taking the columns [64 w, 64 w + 64) of every product's output:
//   per 128-column chunk of the hidden: dz1 = (g W_down) act'(saved) (fp32
//   accumulators), bf16(dz1) to sc and to the chunk's A tile, dy2 += bf16(dz1)
//   W_up (a second set of accumulators); then LN2's backward on dy2 with the
//   statistics recomputed from r1 (row sums: quad shuffles, then the two
//   warpgroups' halves in order), y2 to sa, dr1 = g + LN2^T(dy2) to dh (fp32)
//   and bf16(dr1) to sb and to the A tile of dattn = bf16(dr1) W_o (fp32
//   out).  The tile's column sums of db_o, dg2, dbb2, db_up and db_down go to
//   its row of `part`.
__global__ void __launch_bounds__(fbf::threads(WGS), BLOCKS_PER_SM)
    post_bwd_kernel(const FbParams p, const Layout L, int num_sums) {
  constexpr int NT = WGS * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_base(smem_raw);
  const FbChain& c = p.chain[blockIdx.y];
  const int E = p.embed, F = p.ff, n_rows = p.num_rows, act = p.activation;
  float* par = reinterpret_cast<float*>(smem + L.par);  // g2, bb2 [E each], the column sums', the row sums' partials
  wg::Ring ring = fbf::make_ring<WGS>(smem, L);
  for (int i = threadIdx.x; i < E; i += fbf::threads(WGS)) {
    par[i] = static_cast<const float*>(c.ln_g)[i];
    par[E + i] = static_cast<const float*>(c.ln_b)[i];
  }
  __syncthreads();
  if (fbf::producer<WGS>(ring, smem, L, c.wpack)) return;

  const int w = wg::warp_index() / 4, t = threadIdx.x & 127, bar = 2 + w;
  const int cw = w * NW;                                  // this warpgroup's first column of a product's output
  const uint32_t b_off = w * NW * wg::KBLOCK * 2;         // its rows of each image
  float* red = par + 2 * E + w * (RED_FLOATS / WGS);
  float* rowsum = par + 2 * E + RED_FLOATS;               // [WGS][64 rows][4]
  unsigned char* ta = smem + L.wg0 + L.t[0];  // g, then bf16(dr1)
  unsigned char* tr = smem + L.wg0 + L.t[1];  // r1
  unsigned char* th = smem + L.wg0 + L.t[2];  // a 128-column chunk of bf16(dz1), then y2
  const Frag f(t);
  const bf16* saved = static_cast<const bf16*>(c.s);
  bf16* sc = static_cast<bf16*>(c.sc);
  float* dattn = static_cast<float*>(c.out0);
  float* dh = static_cast<float*>(c.out1);
  const float* g2 = par;
  const int ecols = max(0, min(NW, E - cw));  // this warpgroup's columns of dy2, dr1 and dattn
  // The sums over both warpgroups' halves of a row of the thread's two rows'
  // values a and b (quad sums first), through slot `slot` of rowsum.
  auto row_totals = [&](float& a, float& b, int slot) {
    a = wg::quad_sum(a);
    b = wg::quad_sum(b);
    if ((t & 3) == 0) {
      rowsum[(w * 64 + f.row) * 4 + slot] = a;
      rowsum[(w * 64 + f.row + 8) * 4 + slot] = b;
    }
    wg::group_sync(1, NT);
    a = rowsum[f.row * 4 + slot] + rowsum[(64 + f.row) * 4 + slot];
    b = rowsum[(f.row + 8) * 4 + slot] + rowsum[(64 + f.row + 8) * 4 + slot];
  };
  float d[NA], acc[NA];
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
    const int row0 = tile * wg::TILE_M;
    float* part = static_cast<float*>(c.part) + size_t(tile) * num_sums;
    if (ring.resident) ring.next = 0;
    wg::group_sync(1, NT);  // the last tile's readers of the tiles and of rowsum are done
    wg::load_x<true, 2, NT>(c.g, E, row0, n_rows, ta, threadIdx.x);
    wg::load_x<true, 2, NT>(c.r1, E, row0, n_rows, tr, threadIdx.x);
    wg::fence_async_smem();
    wg::group_sync(1, NT);
    wg::zero(acc);
    for (int c0 = 0; c0 < F; c0 += wg::STAGE_N) {
      const int cols = min(wg::STAGE_N, F - c0), ccols = max(0, min(NW, cols - cw));  // the chunk's, this half's
      {
        uint32_t sv[NA / 2];
        // The loads fly during the ring's wait and the product.
        wg::load_pairs<NA>(saved, F, c0 + cw, ccols, row0, n_rows, f, sv);
        wg::zero(d);
        wg::issue(d, wg::smem_u32(ta), E, ring, b_off);
        wg::finish(d, ring);
        mlp::mul_act_grad(d, [&](int i) { return wg::pair_at(sv, i); }, act);
      }
      wg::col_sums<NA>([&](int i) { return d[i]; }, ccols, red, part + 3 * E + c0 + cw, f, t, bar);  // db_up
      wg::store_bf16(d, ccols, sc, F, c0 + cw, row0, n_rows, f);
      wg::to_tile(d, max(0, min(NW, pad64(cols) - cw)), th, f, cw);  // past `cols` the accumulators are 0
      wg::fence_async_smem();
      wg::group_sync(1, NT);  // both halves of the chunk are in th
      wg::issue(acc, wg::smem_u32(th), cols, ring, b_off);
      wg::finish(acc, ring);
      wg::group_sync(1, NT);  // both warpgroups' products are done with th
    }
    // LN2 recomputed from r1: xhat in d, per row mean and 1 / sqrt(var + eps).
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      d[i] = cw + 8 * (i >> 2) < E ? tile_at(tr, f, i, cw) : 0.f;
      ((i >> 1) & 1 ? s1 : s0) += d[i];
    }
    row_totals(s0, s1, 0);
    const float m0 = s0 / E, m1 = s1 / E;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float x = cw + 8 * (i >> 2) < E ? d[i] - ((i >> 1) & 1 ? m1 : m0) : 0.f;
      ((i >> 1) & 1 ? q1 : q0) += x * x;
    }
    row_totals(q0, q1, 1);
    const float inv0 = 1.f / sqrtf(q0 / E + fbf::LN_EPS), inv1 = 1.f / sqrtf(q1 / E + fbf::LN_EPS);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool hi = (i >> 1) & 1;
      d[i] = cw + 8 * (i >> 2) < E ? (d[i] - (hi ? m1 : m0)) * (hi ? inv1 : inv0) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {  // y2 = bf16(xhat g2 + bb2) into th (free since the last chunk)
      if (8 * j < ecols) {
        const int col = cw + 8 * j + f.col;
        const float ga = g2[col], gb = g2[col + 1], ba = par[E + col], bb = par[E + col + 1];
        wg::put2(th, f.row, col, d[4 * j] * ga + ba, d[4 * j + 1] * gb + bb);
        wg::put2(th, f.row + 8, col, d[4 * j + 2] * ga + ba, d[4 * j + 3] * gb + bb);
      }
    }
    {  // dg2 = sum dy2 xhat, dbb2 = sum dy2, db_down = sum g (its barriers also publish this half of y2)
      float* const outs[3] = {part + E + cw, part + 2 * E + cw, part + 3 * E + F + cw};
      wg::col_sums<NA, 3>(
          [&](int s, int i) { return s == 0 ? acc[i] * d[i] : (s == 1 ? acc[i] : tile_at(ta, f, i, cw)); }, ecols, red,
          outs, f, t, bar);
    }
    wg::store_rows(th + w * wg::ABLOCK_BYTES, ecols, static_cast<bf16*>(c.sa), E, cw, row0, n_rows, t);
    // dr1 = inv (dy2 g2 - mean(dy2 g2) - xhat mean(dy2 g2 xhat)) + g, in acc.
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      acc[i] = cw + 8 * (i >> 2) < E ? acc[i] * g2[cw + acc_col(f, i)] : 0.f;
      const bool hi = (i >> 1) & 1;
      (hi ? a1 : a0) += acc[i];
      (hi ? b1 : b0) += acc[i] * d[i];
    }
    row_totals(a0, a1, 2);
    row_totals(b0, b1, 3);
    const float mean0 = a0 / E, mean1 = a1 / E, mx0 = b0 / E, mx1 = b1 / E;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool hi = (i >> 1) & 1;
      acc[i] = cw + 8 * (i >> 2) < E
                   ? (hi ? inv1 : inv0) * (acc[i] - (hi ? mean1 : mean0) - d[i] * (hi ? mx1 : mx0)) + tile_at(ta, f, i, cw)
                   : 0.f;
    }
    wg::store_f32(acc, ecols, dh, E, cw, row0, n_rows, f);
    wg::col_sums<NA>([&](int i) { return acc[i]; }, ecols, red, part + cw, f, t, bar);  // db_o
    // Each warpgroup overwrites only the half of g it read; every product
    // that read g as its A operand is done.
    wg::to_tile(acc, max(0, min(NW, pad64(E) - cw)), ta, f, cw);
    wg::fence_async_smem();
    wg::wg_sync(bar);
    wg::store_rows(ta + w * wg::ABLOCK_BYTES, ecols, static_cast<bf16*>(c.sb), E, cw, row0, n_rows, t);
    wg::group_sync(1, NT);  // both halves of bf16(dr1) are in ta
    wg::zero(d);
    wg::issue(d, wg::smem_u32(ta), E, ring, b_off);
    wg::finish(d, ring);
    wg::store_f32(d, ecols, dattn, E, cw, row0, n_rows, f);
  }
}

// The pack kernel, then the persistent kernel, on `stream`.
int launch(const FbParams* p, int num_chains, int num_sums, cudaStream_t stream) {
  fbf::Plan P;
  int err = plan(*p, num_chains, P);
  if (err != 0) return err;
  if (P.pack.count != p->num_stages) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[64] = {};  // the shared-memory limit, set once per device
  if (!opted_in[P.device & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(post_bwd_kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, fbf::BLOCK_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[P.device & 63] = true;
  }
  pack_kernel<<<dim3(P.pack.count, num_chains, wg::PACK_SPLIT), wg::PACK_THREADS, 0, stream>>>(*p, P.pack);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  post_bwd_kernel<<<dim3(P.blocks, num_chains), fbf::threads(WGS), P.L.bytes, stream>>>(*p, P.L, num_sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fbb

// ---------------------------------------------------------------------------
// The pre backward's phase 1 (namespace fbp): a pack kernel of the
// transposed weights' images, then one persistent kernel
// ---------------------------------------------------------------------------

namespace fbp {

using fbb::acc_col;
using fbb::tile_at;
using fbf::Layout;
using wg::bf16;
using wg::Frag;
using wg::Pack;
using wg::kblocks;
using wg::nchunks;
using wg::pad64;
// Two consumer warpgroups per block, each taking half the columns of every
// product (NW of 128: m64n64k16 on its half of each image), as fbb; one
// block per SM, which holds the qkv images (96 KB at the zoo's widths)
// resident beside GQKV_TILES gqkv tiles (48 KB each; with two, the next
// tile's arrives by cp.async while one is worked on).  ptxas holds this
// 288-thread block to 168 registers a thread; the two-tile build fits them
// and the one-tile build spills (PERF.md has both, and two blocks per SM
// with the images streamed through three slots).
constexpr int WGS = 2, BLOCKS_PER_SM = 1, GQKV_TILES = 2, NW = 64, NA = NW / 2;
constexpr int SETS = 6;                           // column sums per tile: db_in, dg1, dbb1, db_q, db_k, db_v
constexpr int RED_FLOATS = WGS * SETS * 4 * NW;  // per warpgroup the column sums' warp partials
constexpr int ROW_FLOATS = WGS * 64 * 4;         // per warpgroup and row, the halves of four row sums

// The images in the order the kernel takes them: W_q^T, W_k^T and W_v^T by
// K block of E (dy = gqkv [W_q; W_k; W_v], one K block run over the gqkv
// tile's three segments), then, unless skip_input_grad, per 128-column chunk
// of the input width W_in^T's rows by K block of E (dx = bf16(dh) W_in).
// Matrices: 0-2 W_q^T, W_k^T, W_v^T [E, E], 3 W_in^T [in, E], each the
// transpose of its stored weight.  Mirrored by pre_bwd_stages in
// nn/kernels/fused_block.py.
inline Pack pre_bwd_pack(int in, int E, bool dx) {
  Pack P{};
  for (int q = 0; q < 3; ++q)
    for (int kb = 0; kb < kblocks(E); ++kb) wg::pack_add(P, q, 0, 64 * kb);
  if (dx)
    for (int c = 0; c < nchunks(in); ++c)
      for (int kb = 0; kb < kblocks(E); ++kb) wg::pack_add(P, 3, 128 * c, 64 * kb);
  for (int q = 0; q < 3; ++q) wg::pack_matrix(P, q, 1 + q, E, E, E, 1);
  wg::pack_matrix(P, 3, 0, in, in, E, 1);
  return P;
}

// Images, shared memory (the block's GQKV_TILES gqkv tiles, each three
// segments of pad64(E) columns, the current one later holding bf16(dh);
// LN1's parameters, the column sums' and the row sums' partials) and grid:
// 64-row tiles, fbf::make_layout's accounting of one set of tiles.  dX is written
// when out0 is set.  Mirrored by pre_bwd_plan in nn/kernels/fused_block.py.
inline int plan(const FbParams& p, int num_chains, fbf::Plan& out) {
  const int E = p.embed, in = p.in_dim;
  if (num_chains < 1 || num_chains > 2 || E < 16 || E > FB_MAX_EMBED || E % 16 || in < 16 || in > MLP_MAX_WIDTH ||
      in % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  out.pack = pre_bwd_pack(in, E, p.chain[0].out0 != nullptr);
  const int tiles[3] = {GQKV_TILES * 3 * kblocks(E) * wg::ABLOCK_BYTES, 0, 0};
  const int err =
      fbf::make_layout(out.L, 1, BLOCKS_PER_SM, out.pack.count, p.num_rows, tiles, 2 * E + RED_FLOATS + ROW_FLOATS);
  if (err != 0) return err;
  if (cudaGetDevice(&out.device) != cudaSuccess ||
      cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, out.device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  out.blocks = std::max(1, std::min(out.L.tiles, BLOCKS_PER_SM * out.sms / num_chains));
  return 0;
}

__global__ void __launch_bounds__(wg::PACK_THREADS) pack_kernel(const FbParams p, const Pack P) {
  const FbChain& c = p.chain[blockIdx.y];
  wg::pack_unit(P, c.w, blockIdx.x, blockIdx.z * wg::PACK_THREADS + threadIdx.x,
                static_cast<unsigned char*>(c.wpack) + size_t(blockIdx.x) * wg::STAGE_BYTES);
}

// Rows [row0, row0 + 64) of the bf16 [n_rows, 3E] gqkv into a swizzled
// tile as three segments of pad64(E) columns (q, k, v: the K blocks of the
// W_q^T, W_k^T and W_v^T images), 0 from E to pad64(E) and past the end, by
// 16-byte cp.async (a zero fill where there is no source), the NT threads
// (t of them) each issuing its units; then one commit group.
template <int NT>
__device__ __forceinline__ void load_gqkv(const bf16* src, int E, int row0, int n_rows, unsigned char* tile,
                                              int t) {
  const int units = pad64(E) / 8, per_seg = wg::TILE_M * units, total = 3 * per_seg;
  for (int i = t; i < total; i += NT) {
    const int q = i / per_seg, r = i - q * per_seg, m = r / units, col = (r - m * units) * 8;
    const bool on = row0 + m < n_rows && col < E;
    const bf16* from = on ? src + size_t(row0 + m) * 3 * E + q * E + col : src;
    const uint32_t to = wg::smem_u32(tile + wg::swz(m, q * pad64(E) + col));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(to), "l"(from), "r"(on ? 16 : 0) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wg::col_partials by reduce-scatter: the eight lanes that share a column
// pair halve the sixteen sums they hold in three rounds of exchanges with
// lanes 4, 8 and 16 apart (8 + 4 + 2 shuffles, against 48 for three rounds
// on every sum), after which each lane holds the warp's sums of two columns,
// 8 j + f.col and the next, j = 4 b4 + 2 b8 + b16 from its lane's bits.  A
// fixed order; red as col_partials writes it (col_combine adds the warps).
template <class Value>
__device__ __forceinline__ void col_rs(const Value& value, int cols, float* red, const Frag& f, int t) {
  const int lane = t & 31, warp = t >> 5;
  const bool b4 = lane & 4, b8 = lane & 8, b16 = lane & 16;
  float v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float a = 0.f, b = 0.f;
    if (8 * j < cols) {  // the warpgroup's columns: uniform
      a = value(4 * j) + value(4 * j + 2);
      b = value(4 * j + 1) + value(4 * j + 3);
    }
    v[2 * j] = a;
    v[2 * j + 1] = b;
  }
  float r[8], r2[4], r3[2];
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = (b4 ? v[8 + k] : v[k]) + __shfl_xor_sync(0xffffffffu, b4 ? v[k] : v[8 + k], 4);
#pragma unroll
  for (int k = 0; k < 4; ++k) r2[k] = (b8 ? r[4 + k] : r[k]) + __shfl_xor_sync(0xffffffffu, b8 ? r[k] : r[4 + k], 8);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    r3[k] = (b16 ? r2[2 + k] : r2[k]) + __shfl_xor_sync(0xffffffffu, b16 ? r2[k] : r2[2 + k], 16);
  const int j = 4 * b4 + 2 * b8 + b16;
  if (8 * j < cols) {
    red[warp * 2 * NA + 8 * j + f.col] = r3[0];
    red[warp * 2 * NA + 8 * j + f.col + 1] = r3[1];
  }
}

// An fp32 [n_rows, ld] matrix's values at the accumulators' places, columns
// col0 onwards (the first `cols` of them; 0 elsewhere, past the end and for
// a null src), one 8-byte load per pair.
__device__ __forceinline__ void load_f32(const float* src, int ld, int col0, int cols, int row0, int n_rows,
                                         const Frag& f, float (&v)[NA]) {
  const int ra = row0 + f.row, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    float2 a = make_float2(0.f, 0.f), b = a;
    if (src != nullptr && 8 * j < cols) {
      const float* s = src + col0 + 8 * j + f.col;
      if (ra < n_rows) a = *reinterpret_cast<const float2*>(s + size_t(ra) * ld);
      if (rb < n_rows) b = *reinterpret_cast<const float2*>(s + size_t(rb) * ld);
    }
    v[4 * j] = a.x;
    v[4 * j + 1] = a.y;
    v[4 * j + 2] = b.x;
    v[4 * j + 3] = b.y;
  }
}

// Phase 1 of the pre backward on this block's 64-row tiles, warpgroup w
// taking the columns [64 w, 64 w + 64) of every product's output: dy = gqkv
// [W_q; W_k; W_v] (fp32 accumulators; h at the accumulators' places and the
// partials of db_q, db_k and db_v from the gqkv tile are read while the
// product runs, and with two gqkv tiles the next tile's arrives); LN1 recomputed
// from h (row sums: quad shuffles, then the two warpgroups' halves in order),
// y to sa; dh = LN1^T(dy) + gh, bf16(dh) to sb and, unless skip_input_grad,
// to the A tile of dx = bf16(dh) W_in (fp32 out).  The tile's six column
// sums (db_in, dg1, dbb1, db_qkv) are gathered as warp partials and added
// in warp order under one barrier into its row of `part`.
__global__ void __launch_bounds__(fbf::threads(WGS), BLOCKS_PER_SM)
    pre_bwd_kernel(const FbParams p, const Layout L, int num_sums) {
  constexpr int NT = WGS * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_base(smem_raw);
  const FbChain& c = p.chain[blockIdx.y];
  const int E = p.embed, in = p.in_dim, n_rows = p.num_rows, seg = pad64(E);
  float* par = reinterpret_cast<float*>(smem + L.par);  // g1, bb1 [E each], the column sums', the row sums' partials
  wg::Ring ring = fbf::make_ring<WGS>(smem, L);
  for (int i = threadIdx.x; i < E; i += fbf::threads(WGS)) {
    par[i] = static_cast<const float*>(c.ln_g)[i];
    par[E + i] = static_cast<const float*>(c.ln_b)[i];
  }
  __syncthreads();
  if (fbf::producer<WGS>(ring, smem, L, c.wpack)) return;

  const int w = wg::warp_index() / 4, t = threadIdx.x & 127, bar = 2 + w;
  const int cw = w * NW;                           // this warpgroup's first column of a product's output
  const uint32_t b_off = w * NW * wg::KBLOCK * 2;  // its rows of each image
  float* red = par + 2 * E + w * (RED_FLOATS / WGS);  // [SETS][4 warps][2 NA], in part's order of the sums
  float* rowsum = par + 2 * E + RED_FLOATS;           // [WGS][64 rows][4]
  const Frag f(t);
  const bf16* gqkv = static_cast<const bf16*>(c.g);
  const float* h = static_cast<const float*>(c.h);
  const float* gh = static_cast<const float*>(c.gh);
  float* dx = static_cast<float*>(c.out0);
  const float *g1 = par, *bb1 = par + E;
  const int ecols = max(0, min(NW, E - cw));  // this warpgroup's columns of dy, y and dh
  // The sums over both warpgroups' halves of a row of the thread's two rows'
  // values a and b (quad sums first), through slot `slot` of rowsum (and
  // with `pairs` 2 the values a2, b2 through the next slot, one barrier).
  auto row_totals = [&](float& a, float& b, float& a2, float& b2, int slot, int pairs) {
    a = wg::quad_sum(a);
    b = wg::quad_sum(b);
    a2 = wg::quad_sum(a2);
    b2 = wg::quad_sum(b2);
    if ((t & 3) == 0) {
      rowsum[(w * 64 + f.row) * 4 + slot] = a;
      rowsum[(w * 64 + f.row + 8) * 4 + slot] = b;
      if (pairs == 2) {
        rowsum[(w * 64 + f.row) * 4 + slot + 1] = a2;
        rowsum[(w * 64 + f.row + 8) * 4 + slot + 1] = b2;
      }
    }
    wg::group_sync(1, NT);
    a = rowsum[f.row * 4 + slot] + rowsum[(64 + f.row) * 4 + slot];
    b = rowsum[(f.row + 8) * 4 + slot] + rowsum[(64 + f.row + 8) * 4 + slot];
    if (pairs == 2) {
      a2 = rowsum[f.row * 4 + slot + 1] + rowsum[(64 + f.row) * 4 + slot + 1];
      b2 = rowsum[(f.row + 8) * 4 + slot + 1] + rowsum[(64 + f.row + 8) * 4 + slot + 1];
    }
  };
  auto valid = [&](int i) { return cw + 8 * (i >> 2) < E; };
  float d[NA], x[NA], e[NA];
  const int tile_bytes = 3 * kblocks(E) * wg::ABLOCK_BYTES;
  int buf = 0;
  if (GQKV_TILES == 2 && static_cast<int>(blockIdx.x) < L.tiles)
    load_gqkv<NT>(gqkv, E, blockIdx.x * wg::TILE_M, n_rows, smem + L.wg0 + L.t[0], threadIdx.x);
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x, buf = GQKV_TILES - 1 - buf) {
    const int row0 = tile * wg::TILE_M;
    float* part = static_cast<float*>(c.part) + size_t(tile) * num_sums;
    unsigned char* ta = smem + L.wg0 + L.t[0] + buf * tile_bytes;  // gqkv, then bf16(dh) in its first K blocks
    if (ring.resident) ring.next = 0;
    if (GQKV_TILES == 1) {
      wg::group_sync(1, NT);  // the last tile's readers of ta, of rowsum and of red are done
      load_gqkv<NT>(gqkv, E, row0, n_rows, ta, threadIdx.x);
    }
    asm volatile("cp.async.wait_group 0;" ::: "memory");  // this thread's units of this tile's gqkv
    wg::fence_async_smem();
    // Every thread's units are in ta; with two tiles, the last tile's
    // readers of the other one, of rowsum and of red are done.
    wg::group_sync(1, NT);
    if (GQKV_TILES == 2 && tile + static_cast<int>(gridDim.x) < L.tiles)
      load_gqkv<NT>(gqkv, E, row0 + gridDim.x * wg::TILE_M, n_rows, smem + L.wg0 + L.t[0] + (1 - buf) * tile_bytes,
                    threadIdx.x);
    wg::zero(d);
    wg::issue(d, wg::smem_u32(ta), 3 * seg, ring, b_off);
    load_f32(h, E, cw, ecols, row0, n_rows, f, x);  // while the product runs
#pragma unroll
    for (int s = 0; s < 3; ++s)  // db_q, db_k, db_v
      col_rs([&](int i) { return tile_at(ta, f, i, s * seg + cw); }, ecols, red + (3 + s) * 8 * NA, f, t);
    wg::finish(d, ring);
    // LN1 recomputed from h: xhat in x, per row mean and 1 / sqrt(var + eps).
    float s0 = 0.f, s1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) ((i >> 1) & 1 ? s1 : s0) += x[i];  // 0 past E
    row_totals(s0, s1, u0, u1, 0, 1);  // also: both warpgroups' products are done with ta
    const float m0 = s0 / E, m1 = s1 / E;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float v = valid(i) ? x[i] - ((i >> 1) & 1 ? m1 : m0) : 0.f;
      ((i >> 1) & 1 ? q1 : q0) += v * v;
    }
    row_totals(q0, q1, u0, u1, 1, 1);
    const float inv0 = 1.f / sqrtf(q0 / E + fbf::LN_EPS), inv1 = 1.f / sqrtf(q1 / E + fbf::LN_EPS);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool hi = (i >> 1) & 1;
      x[i] = valid(i) ? (x[i] - (hi ? m1 : m0)) * (hi ? inv1 : inv0) : 0.f;
      e[i] = valid(i) ? x[i] * g1[cw + acc_col(f, i)] + bb1[cw + acc_col(f, i)] : 0.f;  // y
    }
    wg::store_bf16(e, ecols, static_cast<bf16*>(c.sa), E, cw, row0, n_rows, f);
    load_f32(gh, E, cw, ecols, row0, n_rows, f, e);  // flies during the sums
    col_rs([&](int i) { return d[i] * x[i]; }, ecols, red + 1 * 8 * NA, f, t);  // dg1
    col_rs([&](int i) { return d[i]; }, ecols, red + 2 * 8 * NA, f, t);         // dbb1
    // dh = inv (dy g1 - mean(dy g1) - xhat mean(dy g1 xhat)) + gh, in d.
    float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      d[i] = valid(i) ? d[i] * g1[cw + acc_col(f, i)] : 0.f;
      const bool hi = (i >> 1) & 1;
      (hi ? a1 : a0) += d[i];
      (hi ? b1 : b0) += d[i] * x[i];
    }
    row_totals(a0, a1, b0, b1, 2, 2);
    const float mean0 = a0 / E, mean1 = a1 / E, mx0 = b0 / E, mx1 = b1 / E;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const bool hi = (i >> 1) & 1;
      d[i] = valid(i) ? (hi ? inv1 : inv0) * (d[i] - (hi ? mean1 : mean0) - x[i] * (hi ? mx1 : mx0)) + e[i] : 0.f;
    }
    col_rs([&](int i) { return d[i]; }, ecols, red, f, t);  // db_in
    wg::store_bf16(d, ecols, static_cast<bf16*>(c.sb), E, cw, row0, n_rows, f);
    {  // the six sums in warp order into the tile's row of part (red is next written after the next tile's barriers)
      float* const outs_t[SETS] = {part + cw, part + E + cw, part + 2 * E + cw, part + 3 * E + cw, part + 4 * E + cw,
                                   part + 5 * E + cw};
      wg::col_combine<NA, SETS>(ecols, red, outs_t, t, bar);
    }
    if (dx == nullptr) continue;
    // bf16(dh) into the first segment's K blocks of ta (every product that
    // read gqkv is done: row_totals' barriers), then dx by 128-column chunk.
    wg::to_tile(d, max(0, min(NW, seg - cw)), ta, f, cw);
    wg::fence_async_smem();
    wg::group_sync(1, NT);  // both halves of bf16(dh) are in ta
    for (int c0 = 0; c0 < in; c0 += wg::STAGE_N) {
      const int cols = min(wg::STAGE_N, in - c0);
      wg::zero(d);
      wg::issue(d, wg::smem_u32(ta), E, ring, b_off);
      wg::finish(d, ring);
      wg::store_f32(d, max(0, min(NW, cols - cw)), dx, in, c0 + cw, row0, n_rows, f);
    }
  }
}

// The pack kernel, then the persistent kernel, on `stream`.
int launch(const FbParams* p, int num_chains, int num_sums, cudaStream_t stream) {
  fbf::Plan P;
  int err = plan(*p, num_chains, P);
  if (err != 0) return err;
  if (P.pack.count != p->num_stages) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[64] = {};  // the shared-memory limit, set once per device
  if (!opted_in[P.device & 63]) {
    const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(pre_bwd_kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, fbf::BLOCK_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in[P.device & 63] = true;
  }
  pack_kernel<<<dim3(P.pack.count, num_chains, wg::PACK_SPLIT), wg::PACK_THREADS, 0, stream>>>(*p, P.pack);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pre_bwd_kernel<<<dim3(P.blocks, num_chains), fbf::threads(WGS), P.L.bytes, stream>>>(*p, P.L, num_sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fbp

extern "C" const char* fused_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry point launches on `stream` for `num_chains` (1: K4, 2: K5) and
// returns cudaGetLastError() after its launches (0 on success).

extern "C" int fused_block_pre_fwd(const FbParams* p, int num_chains, void* stream) {
  return fbf::launch(reinterpret_cast<const void*>(fbf::pre_fwd_kernel), p, num_chains, false,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int fused_block_post_fwd(const FbParams* p, int num_chains, void* stream) {
  return fbf::launch(reinterpret_cast<const void*>(fbf::post_fwd_kernel), p, num_chains, true,
                     static_cast<cudaStream_t>(stream));
}

// A forward's plan as the launch takes it: out = {images per tile, ring
// slots, resident, tiles per chain, blocks per chain, dynamic shared memory
// bytes, SMs}.
extern "C" int fused_block_fwd_plan(const FbParams* p, int num_chains, int post, int* out) {
  fbf::Plan P;
  const int err = fbf::plan(*p, num_chains, post != 0, P);
  if (err != 0) return err;
  const int v[7] = {P.pack.count, P.L.slots, P.L.resident, P.L.tiles, P.blocks, P.L.bytes, P.sms};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// The post backward's plan as the launch takes it (fused_block_fwd_plan's
// fields).
extern "C" int fused_block_post_bwd_plan(const FbParams* p, int num_chains, int* out) {
  fbf::Plan P;
  const int err = fbb::plan(*p, num_chains, P);
  if (err != 0) return err;
  const int v[7] = {P.pack.count, P.L.slots, P.L.resident, P.L.tiles, P.blocks, P.L.bytes, P.sms};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// The pre backward's plan (fbp::plan; dX when out0 is set), with the same
// fields.
extern "C" int fused_block_pre_bwd_plan(const FbParams* p, int num_chains, int* out) {
  fbf::Plan P;
  const int err = fbp::plan(*p, num_chains, P);
  if (err != 0) return err;
  const int v[7] = {P.pack.count, P.L.slots, P.L.resident, P.L.tiles, P.blocks, P.L.bytes, P.sms};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// The backwards: phase 1 (a pack kernel and a persistent kernel: fbp for
// the pre backward, fbb for the post backward), then phase 2 (dw_phase2.cuh) on the jobs
// below; `s` is phase 2's split and scratch.
namespace fb {

// Phase 2's column sums: each chain's per-tile partials [row_tiles,
// num_sums] into its `sums`.
void set_sums(dw::Phase2& P, const FbParams* p, int num_chains, int num_sums) {
  for (int c = 0; c < num_chains; ++c) {
    P.sum[c][0] = {static_cast<const float*>(p->chain[c].part), static_cast<float*>(p->chain[c].sums), num_sums, 0,
                   num_sums, 1};
    P.num_sums[c] = 1;
  }
  P.num_rows = p->num_rows;
}

}  // namespace fb

extern "C" int fused_block_pre_bwd(const FbParams* p, int num_chains, const DwScratch* s, void* stream) {
  const int E = p->embed, in = p->in_dim;
  dw::Phase2 P{};
  for (int c = 0; c < num_chains; ++c) {
    const FbChain& ch = p->chain[c];
    float* dwp = static_cast<float*>(ch.dw);
    P.job[c][0] = {ch.sb, ch.x, dwp, E, 0, E, in};  // W_in: bf16(dh)^T x
    dwp += size_t(E) * in;
    for (int q = 0; q < 3; ++q) {  // W_q, W_k, W_v: gqkv[:, qE:(q+1)E]^T y
      P.job[c][1 + q] = {ch.g, ch.sa, dwp, 3 * E, q * E, E, E};
      dwp += size_t(E) * E;
    }
  }
  P.num_jobs = 4;
  fb::set_sums(P, p, num_chains, 6 * E);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = fbp::launch(p, num_chains, 6 * E, st);
  if (err != 0) return err;
  return dw::launch(P, num_chains, s, st);
}

extern "C" int fused_block_post_bwd(const FbParams* p, int num_chains, const DwScratch* s, void* stream) {
  const int E = p->embed, F = p->ff;
  dw::Phase2 P{};
  for (int c = 0; c < num_chains; ++c) {
    const FbChain& ch = p->chain[c];
    float* dwp = static_cast<float*>(ch.dw);
    P.job[c][0] = {ch.sb, ch.x, dwp, E, 0, E, E};  // W_o: bf16(dr1)^T attn
    dwp += size_t(E) * E;
    P.job[c][1] = {ch.sc, ch.sa, dwp, F, 0, F, E};  // W_up: bf16(dz1)^T y2
    dwp += size_t(F) * E;
    P.job[c][2] = {ch.g, ch.s, dwp, E, 0, E, F};  // W_down: g^T hid
  }
  P.num_jobs = 3;
  fb::set_sums(P, p, num_chains, 4 * E + F);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = fbb::launch(p, num_chains, 4 * E + F, st);
  if (err != 0) return err;
  return dw::launch(P, num_chains, s, st);
}

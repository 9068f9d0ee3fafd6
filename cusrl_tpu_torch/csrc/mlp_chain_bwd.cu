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
// K9m (mlp_ppo_step, namespace mlpm): the losses are separable per row and
// per chain (the surrogate needs only the actor's mean, the value loss only
// the critic's value), so a persistent block of one chain runs, per 64-row
// tile, the chain forward of K2f (mlpf::forward_tile, mlp_chain.cuh) and then
// K9s's heads, loss and backward (mlpb::backward_tile) on the same tile: the
// latent stays in shared memory from the forward's last layer to the heads
// and the top layer's act'.  The forward writes every layer's bf16
// activation to device memory, since the lower layers' act' and phase 2's dW
// products read them (the tile's own rows, written a few microseconds
// before, from L2).  One ring streams the tile's images in the order it
// takes them: the forward's images of W_l, then the backward's of W_l^T,
// packed once per call by one pack kernel.  Phase 2 is K9s's, as the third
// kernel of the same call.  The products, their order and every rounding are
// K2f's and K9s's, so mono and split (K2f + K9s) give the same activations
// and gradients.  The forward's two tiles (96 KB at the main path's widths:
// the 512-wide h1) leave room for one block per SM, of four warpgroups,
// where K9s alone runs two of two; its backward part pays for that: K9s
// forced into that layout took 0.2352 ms against 0.1898 (probe_backward_
// phase1.py --variants, NVIDIA H100 80GB HBM3 at 700 W).
//
// K8b and K9s add the heads to phase 1 (head_tile): per 64-row tile the
// latent is staged in shared memory; K9s first runs the heads' forward, the
// Normal logp, ratio, clipped surrogate and (clipped) value loss, and their
// analytic per-row gradients (mlp::loss_row), where K8b reads the heads'
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
//   phase 1 (per 64-row tile): the gradient chain, top layer down; writes
//     every layer's d_bf to device memory (D_l, [N, out_l] bf16) and the
//     tile's fp32 column sums of d (db partials, [tiles, out_l]), and dX
//     unless skipped;
//   phase 2 (dw_phase2.cuh, shared with fused_block.cu): dW_l = D_l^T h_l
//     over row ranges split across blocks, and the db partials, summed in a
//     fixed order.  It serves all five TPU kernels above (_run_bwd,
//     _pair_run_bwd, _pair_heads_run_bwd, _run_loss_bwd, _run_ppo_step).
//     Bytes bound it (D_l and h_l read once, 2 * out_l * in_l FLOP per
//     row); one launch of wgmma blocks fed by TMA, one wave of them, the
//     row splits added through distributed shared memory in clusters, is
//     what the design does about it.
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
//
// Phase 1 of K1b, K2b, K8b and K9s (namespace mlpb) is the chain forward's
// design (mlp_chain_fwd.cu) turned around: the data product d_{l-1} =
// bf16(d_l) W_l takes wgmma's B from images of W_l^T, converted in the
// block where they fit (the transformer's 128 -> 128 head) and otherwise
// packed per call and streamed through a ring; persistent blocks walk the row
// tiles of their chain, the warpgroups of a block split each 128-column chunk
// of a product, and the epilogue runs on the accumulators: act' of the saved
// value (4-byte loads at the accumulators' places), bf16(d) to D_l by
// 16-byte stores and into the next product's A tile, the column sums by
// shuffles over a warp's rows and the four warps in order.  K8b's and K9s's
// heads stay fp32 and scalar but for their top d = gh W_head (+ gl), which is
// taken at the accumulators' places.  Bytes bound phase 1 (3,840 B a row per
// chain at the main path's widths: 0.056 ms for K2b at 2 x 24,576 rows).
// With heads the top layer's act' reads the latent where the heads read it,
// in its tile.
#include <algorithm>

#include "dw_phase2.cuh"
#include "hopper_wg.cuh"
#include "mlp_chain.cuh"

namespace mlp {

// K9s: the PPO + value loss of one row (gr, real when gr < num_rows) from
// the heads' outputs `out` ([dim] fp32), with the analytic gradient of
// loss_core = w_surr * surrogate + w_value * value_loss
// (fused_ppo_step.py:_loss_tail, :196-266): the head cotangent into gh[0 ..
// dim) (0 on pad rows) and the row's loss terms into `terms`:
//   chain 0: [min(t1, t2), |dlt|, the dstd terms (dim)]
//   chain 1: [sum of value-loss terms, sum vhat]
// Conventions kept from the TPU kernel: dlt is 0 on pad rows before the exp;
// pick_t1 = t1 <= t2; the clip passes the gradient for lo <= r <= hi;
// pick_u = u2 >= w2; w_inside = |delta| <= loss_clip; inv_n counts real rows.
__device__ void loss_row(const MlpParams& p, const MlpHead& hd, int chain, int gr, const float* out, float* gh,
                         float* terms) {
  const MlpLoss& ls = p.loss;
  const int dim = hd.dim;
  const bool valid = gr < p.num_rows;
  if (chain == 0) {
    const float* action = reinterpret_cast<const float*>(ls.action);
    const float* old_logp = reinterpret_cast<const float*>(ls.old_logp);
    const float* advantage = reinterpret_cast<const float*>(ls.advantage);
    const float* std = reinterpret_cast<const float*>(ls.std);
    const float lo = 1.f - ls.clip_ratio, hi = 1.f + ls.clip_ratio;
    const float g_row = -ls.w_surr * ls.inv_n;
    float logp = 0.f;
    for (int o = 0; o < dim; ++o) {
      const float a = valid ? action[size_t(gr) * dim + o] : 0.f;
      const float z = (a - out[o]) / std[o];
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
      const float z = (a - out[o]) / std[o];
      gh[o] = dlogp * (z / std[o]);
      terms[2 + o] = dlogp * ((z * z - 1.f) / std[o]);
    }
    terms[0] = fminf(t1, t2);
    terms[1] = fabsf(dlt);
  } else {
    const float* returns = reinterpret_cast<const float*>(ls.returns);
    const float* old_value = reinterpret_cast<const float*>(ls.old_value);
    const float coef = ls.w_value * ls.inv_nv;
    float loss_sum = 0.f, vhat_sum = 0.f;
    for (int o = 0; o < dim; ++o) {
      const float vhat = out[o];
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
      gh[o] = valid ? dv : 0.f;
      if (valid) {
        loss_sum += term;
        vhat_sum += vhat;
      }
    }
    terms[0] = loss_sum;
    terms[1] = vhat_sum;
  }
}


}  // namespace mlp

// ---------------------------------------------------------------------------
// Phase 1 of K1b, K2b, K8b and K9s (namespace mlpb): a pack kernel of the
// transposed weights' images where they stream, then one persistent kernel
// ---------------------------------------------------------------------------

namespace mlpb {

using wg::bf16;
// Consumer warpgroups per block, by blocks per SM, as the forward (mlpf):
// the warpgroups of a block split each 128-column chunk of a product.
__host__ __device__ constexpr int consumer_wgs(int per_sm) { return per_sm == 1 ? 4 : 2; }
__host__ __device__ constexpr int threads(int per_sm) { return consumer_wgs(per_sm) * 128 + 32; }  // and a producer warp
using wg::BLOCK_SMEM;
constexpr int RED_BYTES = 4 * 128 * 4;           // the column sums' warp partials of all warpgroups (wg::col_sums)

// A block's shared memory, byte offsets from its 1,024-aligned base: the
// ring's slots, the two swizzled tiles, the column sums' partials, the heads'
// scratch, the ring's barriers.
struct Layout {
  int per_tile;  // images per tile (the chain's Pack::count; 0 for one layer without dX)
  int slots;     // ring slots
  int resident;  // slots == per_tile: every image is converted once per block into its own slot
  int tiles;     // 64-row tiles per chain
  int per_sm;    // blocks per SM (the kernel instance launched)
  int buf[2];    // the tiles of the even and the odd layers' bf16(d_l) (and the heads' latent)
  int red;       // [consumer warpgroups][4][columns per warpgroup] fp32
  int head;      // gh [64][dim]; K9s also the heads' outputs [64][dim] and the loss terms [64][2 + dim]
  int bar;       // full[slots], empty[slots]
  int bytes;     // dynamic shared memory requested, with 1 KB of alignment slack
};

struct Plan {
  wg::Pack pack;
  Layout L;
  int blocks;  // per chain
  int sms;
  int device;
};

// Whether layer l's data product d_{l-1} = bf16(d_l) W_l runs (layer 0's is
// dX, skipped with skip_input_grad).
__host__ __device__ inline bool has_product(const MlpParams& p, int l) { return l > 0 || !p.skip_input_grad; }
__host__ __device__ inline bool has_act(const MlpParams& p, int l) { return l < p.num_layers - 1 || p.trailing; }

// The images in the order the kernel takes them: per layer from the top
// down, while its product runs, per 128-row chunk of W_l^T ([in, out], the
// product's output columns), per 64-column K block.  Mirrored by
// chain_bwd_stages in nn/kernels/weight_images.py.
inline wg::Pack bwd_pack(const MlpParams& p) {
  wg::Pack P{};
  for (int l = p.num_layers - 1; l >= 0 && has_product(p, l); --l) {
    const int K = p.dims[l + 1], N = p.dims[l];
    wg::pack_matrix(P, l, l, N, N, K, 1);
    for (int c = 0; c < wg::nchunks(N); ++c)
      for (int kb = 0; kb < wg::kblocks(K); ++kb) wg::pack_add(P, l, 128 * c, 64 * kb);
  }
  return P;
}

// Bytes of the tile of this parity: bf16(d_l) of each layer l of the parity
// whose product runs (its A operand), and with heads the latent (parity L).
inline int tile_bytes(const MlpParams& p, int parity) {
  int widest = 0;
  for (int l = parity; l < p.num_layers; l += 2)
    if (has_product(p, l)) widest = std::max(widest, wg::kblocks(p.dims[l + 1]));
  if (p.head_mode != 0 && (p.num_layers & 1) == parity) widest = std::max(widest, wg::kblocks(p.dims[p.num_layers]));
  return widest * wg::ABLOCK_BYTES;
}

inline int head_bytes(const MlpParams& p, int num_chains) {
  if (p.head_mode == 0) return 0;
  int dim = 0;
  for (int c = 0; c < num_chains; ++c) dim = std::max(dim, p.head[c].dim);
  return wg::TILE_M * (p.head_mode == 2 ? 3 * dim + 2 : dim) * 4;
}

// Images, shared memory (wg::ring_slots) and grid of one phase 1.  Mirrored
// by chain_bwd_plan in nn/kernels/weight_images.py.
inline int plan(const MlpParams& p, int num_chains, Plan& out) {
  if (num_chains < 1 || num_chains > 2 || p.num_layers < 1 || p.num_layers > MLP_MAX_LAYERS)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i <= p.num_layers; ++i)
    if (p.dims[i] < 16 || p.dims[i] > MLP_MAX_WIDTH || p.dims[i] % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (p.head_mode != 0)
    for (int c = 0; c < num_chains; ++c)
      if (p.head[c].dim < 1 || p.head[c].dim > mlp::MAX_HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  out.pack = bwd_pack(p);
  if (cudaGetDevice(&out.device) != cudaSuccess ||
      cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, out.device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  Layout& L = out.L;
  L.per_tile = out.pack.count;
  L.tiles = (p.num_rows + wg::TILE_M - 1) / wg::TILE_M;
  const int t0 = tile_bytes(p, 0), t1 = tile_bytes(p, 1), hb = head_bytes(p, num_chains);
  L.slots = wg::ring_slots(L.per_tile, t0 + t1 + RED_BYTES + hb, L.tiles * num_chains <= out.sms, L.per_sm);
  if (L.slots < 0) return static_cast<int>(cudaErrorInvalidValue);
  L.resident = L.slots == L.per_tile;
  L.buf[0] = L.slots * wg::STAGE_BYTES;
  L.buf[1] = L.buf[0] + t0;
  L.red = L.buf[1] + t1;
  L.head = L.red + RED_BYTES;
  L.bar = L.head + hb;
  L.bytes = L.bar + 2 * L.slots * 8 + 1024;
  out.blocks = std::max(1, std::min(L.tiles, L.per_sm * out.sms / num_chains));
  return 0;
}

// ---- device side ----------------------------------------------------------

__global__ void __launch_bounds__(wg::PACK_THREADS) pack_kernel(const MlpParams p, const wg::Pack P) {
  const MlpChain& c = p.chain[blockIdx.y];
  wg::pack_unit(P, c.w, blockIdx.x, blockIdx.z * wg::PACK_THREADS + threadIdx.x,
                static_cast<unsigned char*>(c.wpack) + size_t(blockIdx.x) * wg::STAGE_BYTES);
}

__device__ __forceinline__ float tile_val(const unsigned char* tile, int r, int k) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + wg::swz(r, k)));
}

// K8b / K9s / K9m: the heads' part of one row tile, by the NT consumer
// threads: the latent (the saved chain output) into `lat` where load_latent
// is set (K9m's forward leaves it there); K9s and K9m the heads' forward
// (fp32 FMAs in column order) and loss_row per row, K8b the heads'
// cotangents from hd.g, into gh ([64][dim] fp32, 0 on pad rows); the tile's
// partials of the head's dW = f32(latent)^T gh and db = sum gh (and K9s's
// loss sums), in row order, into its row of hd.part.
template <int HEADS, int NT>
__device__ __forceinline__ void head_tile(const MlpParams& p, const MlpChain& c, int chain, int tile, int row0,
                                          unsigned char* lat, float* gh, int t, bool load_latent) {
  const MlpHead& hd = p.head[chain];
  const int latent = p.dims[p.num_layers], dim = hd.dim, n_rows = p.num_rows;
  float* part = static_cast<float*>(hd.part) + size_t(tile) * hd.stride;
  if (load_latent) {
    wg::load_x<true, 4 * 128 / NT, NT>(c.h[p.num_layers - 1], latent, row0, n_rows, lat, t);
    wg::group_sync(1, NT);
  }
  if constexpr (HEADS == 2) {
    const float* W = static_cast<const float*>(hd.w);
    const float* bias = static_cast<const float*>(hd.b);
    float* hout = gh + wg::TILE_M * dim;
    float* terms = hout + wg::TILE_M * dim;  // [64][2 + dim]
    // The four lanes of a quad share an output: lane q sums the 8-column
    // chunks q, q + 4, ... of the latent in order (16-byte loads), then the
    // quad adds its four sums by shuffles (mlpf::heads' order).
    for (int i = t; i < wg::TILE_M * dim * 4; i += NT) {
      const int q = i >> 2, part4 = i & 3, r = q / dim, o = q - r * dim;
      const float* w = W + size_t(o) * latent;
      float s = 0.f;
      for (int k = part4 * 8; k < latent; k += 32) {
        const uint4 v = *reinterpret_cast<const uint4*>(lat + wg::swz(r, k));
        const float4 wa = __ldg(reinterpret_cast<const float4*>(w + k));
        const float4 wb = __ldg(reinterpret_cast<const float4*>(w + k + 4));
        s = fmaf(__uint_as_float(v.x << 16), wa.x, s);  // a bf16 pair's low half, then its high half
        s = fmaf(__uint_as_float(v.x & 0xffff0000u), wa.y, s);
        s = fmaf(__uint_as_float(v.y << 16), wa.z, s);
        s = fmaf(__uint_as_float(v.y & 0xffff0000u), wa.w, s);
        s = fmaf(__uint_as_float(v.z << 16), wb.x, s);
        s = fmaf(__uint_as_float(v.z & 0xffff0000u), wb.y, s);
        s = fmaf(__uint_as_float(v.w << 16), wb.z, s);
        s = fmaf(__uint_as_float(v.w & 0xffff0000u), wb.w, s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part4 == 0) hout[q] = s + bias[o];
    }
    wg::group_sync(1, NT);
    for (int r = t; r < wg::TILE_M; r += NT)
      mlp::loss_row(p, hd, chain, row0 + r, hout + r * dim, gh + r * dim, terms + r * (2 + dim));
    wg::group_sync(1, NT);
    const int extra = chain == 0 ? 2 + dim : 2;
    for (int q = t; q < extra; q += NT) {
      float s = 0.f;
      for (int r = 0; r < wg::TILE_M; ++r) s += terms[r * (2 + dim) + q];
      part[dim * latent + dim + q] = s;
    }
  } else {
    const float* g = static_cast<const float*>(hd.g);
    for (int i = t; i < wg::TILE_M * dim; i += NT) {
      const int r = i / dim;
      gh[i] = row0 + r < n_rows ? g[size_t(row0) * dim + i] : 0.f;
    }
    wg::group_sync(1, NT);
  }
  // dW_head's partials, four outputs (o0 .. o0 + 3, one latent column k) a
  // thread: each latent value is loaded once for the four, and gh's four by
  // one broadcast load where its rows allow (the loads, not the FMAs, bound
  // this loop); each sum runs over the rows in order.
  for (int q = t; q < (dim + 3) / 4 * latent; q += NT) {
    const int o0 = q / latent * 4, k = q - o0 / 4 * latent, no = min(4, dim - o0);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int r = 0; r < wg::TILE_M; ++r) {
      const float x = tile_val(lat, r, k);
      const float* g = gh + r * dim + o0;
      if ((dim & 3) == 0) {
        const float4 g4 = *reinterpret_cast<const float4*>(g);
        s[0] = fmaf(x, g4.x, s[0]);
        s[1] = fmaf(x, g4.y, s[1]);
        s[2] = fmaf(x, g4.z, s[2]);
        s[3] = fmaf(x, g4.w, s[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < no) s[e] = fmaf(x, g[e], s[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < no) part[(o0 + e) * latent + k] = s[e];
  }
  for (int o = t; o < dim; o += NT) {
    float s = 0.f;
    for (int r = 0; r < wg::TILE_M; ++r) s += gh[r * dim + o];
    part[dim * latent + o] = s;
  }
}

// Phase 1 of chain `chain` on the 64-row tile `tile`, by the WGS consumer
// warpgroups of a block (t: the thread among them): the top d from the bf16
// cotangent (or the heads: d = gh W_head (+ gl), fp32, at the accumulators'
// places), then per layer from the top down the epilogue of d_l at the
// accumulators' places (times act' of the saved value, bf16(d_l) to D_l and
// to the next product's A tile, the column sums into the tile's db
// partials) and the product bf16(d_l) W_l, whose output is d_{l-1}'s (or
// dX, fp32).  Warpgroup w takes the columns [w * NW, (w + 1) * NW) of each
// 128-column chunk.  HEADS: the head mode (0, K8b's 1, K9s's and K9m's 2);
// with heads the latent sits in buf[L & 1] (read there for the top layer's
// act'), loaded from device memory where load_latent is set.
template <int WGS, int HEADS>
__device__ __forceinline__ void backward_tile(const MlpParams& p, const MlpChain& c, int chain, int tile,
                                              wg::Ring& ring, unsigned char* smem, const Layout& L, bool load_latent,
                                              int t) {
  constexpr int NT = WGS * 128, NW = wg::STAGE_N / WGS, NA = NW / 2;
  const int w = wg::warp_index() / 4, tw = t & 127, bar = 2 + w;
  const int num_layers = p.num_layers, top = p.dims[num_layers], n_rows = p.num_rows, act = p.activation;
  const uint32_t b_off = w * NW * wg::KBLOCK * 2;  // this warpgroup's rows of each image
  const wg::Frag f(tw);
  unsigned char* const buf[2] = {smem + L.buf[0], smem + L.buf[1]};
  unsigned char* const lat = buf[num_layers & 1];
  float* red = reinterpret_cast<float*>(smem + L.red) + w * 4 * NW;
  float* gh = reinterpret_cast<float*>(smem + L.head);
  const MlpHead& hd = p.head[chain];
  float* dx = static_cast<float*>(c.dx);
  const int row0 = tile * wg::TILE_M;
  float d[NA];
  uint32_t sv[NA / 2];
  // The epilogue of d_l's columns [c0, c0 + cols) (d: the upstream cotangent).
  auto epilogue = [&](int l, int c0, int cols) {
    const int n_out = p.dims[l + 1];
    if (has_act(p, l)) mlp::mul_act_grad(d, [&](int i) { return wg::pair_at(sv, i); }, act);
    wg::store_bf16(d, cols, static_cast<bf16*>(c.d[l]), n_out, c0, row0, n_rows, f);
    wg::col_sums<NA>([&](int i) { return d[i]; }, cols, red,
                     static_cast<float*>(c.dbp[l]) + size_t(tile) * n_out + c0, f, tw, bar);
    // Past `cols` the accumulators are 0: the next product's K padding, up
    // to the next multiple of 64, in each warpgroup's columns.
    if (has_product(p, l)) wg::to_tile(d, max(0, min(NW, wg::pad64(n_out) - c0)), buf[l & 1], f, c0);
  };
  if constexpr (HEADS != 0) head_tile<HEADS, NT>(p, c, chain, tile, row0, lat, gh, t, load_latent);
  for (int n0 = 0; n0 < top; n0 += wg::STAGE_N) {
    const int c0 = n0 + w * NW, cols = max(0, min(NW, top - c0));  // this warpgroup's columns
    if (has_act(p, num_layers - 1)) {
      if constexpr (HEADS != 0) {
        wg::tile_pairs<NA>(lat, c0, cols, f, sv);  // the latent, already in its tile
      } else {
        wg::load_pairs<NA>(static_cast<const bf16*>(c.h[num_layers - 1]), top, c0, cols, row0, n_rows, f, sv);
      }
    }
    if constexpr (HEADS != 0) {  // d = gh W_head (+ gl): per element fp32 FMAs in the order of the head's outputs
      const float* gl = static_cast<const float*>(hd.gl);
      const int ra = row0 + f.row, rb = ra + 8;
      wg::zero(d);
      for (int o = 0; o < hd.dim; ++o) {
        const float ga = gh[f.row * hd.dim + o], gb = gh[(f.row + 8) * hd.dim + o];
        const float* w = static_cast<const float*>(hd.w) + size_t(o) * top + c0 + f.col;
#pragma unroll
        for (int j = 0; j < NA / 4; ++j) {
          if (8 * j < cols) {
            const float2 wv = __ldg(reinterpret_cast<const float2*>(w + 8 * j));
            d[4 * j] = fmaf(ga, wv.x, d[4 * j]);
            d[4 * j + 1] = fmaf(ga, wv.y, d[4 * j + 1]);
            d[4 * j + 2] = fmaf(gb, wv.x, d[4 * j + 2]);
            d[4 * j + 3] = fmaf(gb, wv.y, d[4 * j + 3]);
          }
        }
      }
      if (gl != nullptr) {
#pragma unroll
        for (int j = 0; j < NA / 4; ++j) {
          if (8 * j < cols) {
            const float* q = gl + c0 + 8 * j + f.col;
            if (ra < n_rows) {
              const float2 v = *reinterpret_cast<const float2*>(q + size_t(ra) * top);
              d[4 * j] += v.x;
              d[4 * j + 1] += v.y;
            }
            if (rb < n_rows) {
              const float2 v = *reinterpret_cast<const float2*>(q + size_t(rb) * top);
              d[4 * j + 2] += v.x;
              d[4 * j + 3] += v.y;
            }
          }
        }
      }
    } else {  // the bf16 cotangent of the chain output
      uint32_t gv[NA / 2];
      wg::load_pairs<NA>(static_cast<const bf16*>(c.g), top, c0, cols, row0, n_rows, f, gv);
#pragma unroll
      for (int i = 0; i < NA; ++i) d[i] = wg::pair_at(gv, i);
    }
    epilogue(num_layers - 1, c0, cols);
  }
  for (int l = num_layers - 1; l >= 0 && has_product(p, l); --l) {
    wg::fence_async_smem();
    wg::group_sync(1, NT);  // bf16(d_l) is in its tile for every warpgroup
    const int K = p.dims[l + 1], N = p.dims[l];
    const uint32_t a_in = wg::smem_u32(buf[l & 1]);
    for (int n0 = 0; n0 < N; n0 += wg::STAGE_N) {
      const int c0 = n0 + w * NW, cols = max(0, min(NW, N - c0));
      if (l > 0) wg::load_pairs<NA>(static_cast<const bf16*>(c.h[l - 1]), N, c0, cols, row0, n_rows, f, sv);
      wg::zero(d);
      wg::issue(d, a_in, K, ring, b_off);  // the loads above fly during the ring's wait and the product
      wg::finish(d, ring);
      if (l > 0) {
        epilogue(l - 1, c0, cols);
      } else {
        wg::store_f32(d, cols, dx, N, c0, row0, n_rows, f);
      }
    }
  }
}

// Phase 1 of chain blockIdx.y on this block's 64-row tiles (backward_tile
// each).  Warps 0 .. 4 WGS - 1 are the consumer warpgroups; the last warp is
// the producer (streamed images) or, with resident images, a helper of the
// conversion only.
template <int PER_SM, int HEADS>
__global__ void __launch_bounds__(threads(PER_SM), PER_SM) chain_bwd_kernel(const MlpParams p, const Layout L,
                                                                            const wg::Pack P) {
  constexpr int WGS = consumer_wgs(PER_SM), NT = WGS * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_base(smem_raw);
  const int chain = blockIdx.y;
  const MlpChain& c = p.chain[chain];
  wg::Ring ring = wg::make_ring(smem, 0, L.bar, L.slots, L.resident, WGS * 4);
  if (L.resident) wg::convert_images(P, c.w, smem, threadIdx.x, threads(PER_SM));  // each image once, into its slot
  __syncthreads();  // the barriers are initialised (and the images converted)
  if (wg::warp_index() == WGS * 4) {
    if (!L.resident && threadIdx.x == NT) {
      const int tiles = (L.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
      wg::produce(ring, smem, static_cast<const unsigned char*>(c.wpack), L.per_tile, tiles);
    }
    return;
  }
  // Resident: each slot's "full" phase completes once, here, and stays.
  const int t = threadIdx.x;
  wg::mbar_arrive_if(&ring.full[t < L.slots ? t : 0], L.resident && t < L.slots);
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
    if (ring.resident) ring.next = 0;
    wg::group_sync(1, NT);  // the last tile's products and heads are done with the tiles
    backward_tile<WGS, HEADS>(p, c, chain, tile, ring, smem, L, true, t);
  }
}

// The pack kernel (streamed images), then the persistent kernel, on `stream`.
int launch(const MlpParams* p, int num_chains, cudaStream_t stream) {
  Plan P;
  int err = plan(*p, num_chains, P);
  if (err != 0) return err;
  if (!P.L.resident) {
    if (p->num_stages != P.pack.count) return static_cast<int>(cudaErrorInvalidValue);
    for (int c = 0; c < num_chains; ++c)
      if (p->chain[c].wpack == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    pack_kernel<<<dim3(P.pack.count, num_chains, wg::PACK_SPLIT), wg::PACK_THREADS, 0, stream>>>(*p, P.pack);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int per_sm = P.L.per_sm, heads = p->head_mode;
  if (heads < 0 || heads > 2) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernels[2][3] = {{reinterpret_cast<const void*>(chain_bwd_kernel<1, 0>),
                                 reinterpret_cast<const void*>(chain_bwd_kernel<1, 1>),
                                 reinterpret_cast<const void*>(chain_bwd_kernel<1, 2>)},
                                {reinterpret_cast<const void*>(chain_bwd_kernel<2, 0>),
                                 reinterpret_cast<const void*>(chain_bwd_kernel<2, 1>),
                                 reinterpret_cast<const void*>(chain_bwd_kernel<2, 2>)}};
  const void* kernel = kernels[per_sm - 1][heads];
  static bool opted_in[2][3][64] = {};  // the shared-memory limit, set once per kernel and device
  bool& done = opted_in[per_sm - 1][heads][P.device & 63];
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  MlpParams copy = *p;
  Layout L = P.L;
  void* args[] = {&copy, &L, &P.pack};
  cudaError_t e = cudaLaunchKernel(kernel, dim3(P.blocks, num_chains), dim3(threads(per_sm)), args, L.bytes, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mlpb

// ---------------------------------------------------------------------------
// K9m (namespace mlpm): the whole PPO step's phase 1 in one persistent kernel
// after one pack kernel of the forward's and the backward's images
// ---------------------------------------------------------------------------

namespace mlpm {

using mlpb::consumer_wgs;
using mlpb::Layout;
using mlpb::threads;
using wg::BLOCK_SMEM;

struct Plan {
  wg::Pack fwd;  // the images of W_l, in the forward's order (mlpf::chain_pack)
  wg::Pack bwd;  // the images of W_l^T, in the backward's order (mlpb::bwd_pack)
  Layout L;
  int blocks;  // per chain
  int sms;
  int device;
};

// Images, shared memory and grid of K9m's phase 1.  A tile takes the
// forward's images, then the backward's, from one ring (per_tile = both
// counts), always streamed; the ring gets the slots that fit beside the two
// tiles (each as large as the forward's or the backward's of its parity),
// the column sums' partials and the heads' scratch: two blocks per SM before
// one, unless the launch has no more tiles than SMs, and at least 2 slots.
// Mirrored by ppo_step_plan in nn/kernels/weight_images.py.
inline int plan(const MlpParams& p, Plan& out) {
  if (p.num_layers < 1 || p.num_layers > MLP_MAX_LAYERS || p.head_mode != 2 || !p.skip_input_grad)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i <= p.num_layers; ++i)
    if (p.dims[i] < 16 || p.dims[i] > MLP_MAX_WIDTH || p.dims[i] % 16) return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < 2; ++c)
    if (p.head[c].dim < 1 || p.head[c].dim > mlp::MAX_HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  out.fwd = mlpf::chain_pack(p);
  out.bwd = mlpb::bwd_pack(p);
  if (cudaGetDevice(&out.device) != cudaSuccess ||
      cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, out.device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  Layout& L = out.L;
  L.per_tile = out.fwd.count + out.bwd.count;
  L.tiles = (p.num_rows + wg::TILE_M - 1) / wg::TILE_M;
  L.resident = 0;
  const int t0 = std::max(mlpf::tile_bytes(p, 0), mlpb::tile_bytes(p, 0));
  const int t1 = std::max(mlpf::tile_bytes(p, 1), mlpb::tile_bytes(p, 1));
  const int hb = mlpb::head_bytes(p, 2), fixed = t0 + t1 + mlpb::RED_BYTES + hb;
  L.slots = -1;
  for (L.per_sm = L.tiles * 2 <= out.sms ? 1 : 2; L.per_sm >= 1; --L.per_sm) {
    const int fit = (std::min(BLOCK_SMEM, wg::SM_SMEM / L.per_sm - 1024) - 1024 - fixed) / wg::SLOT_COST;
    if (fit >= 2) {
      L.slots = std::min(fit, std::max(L.per_tile, 2));
      break;
    }
  }
  if (L.slots < 2) return static_cast<int>(cudaErrorInvalidValue);
  L.buf[0] = L.slots * wg::STAGE_BYTES;
  L.buf[1] = L.buf[0] + t0;
  L.red = L.buf[1] + t1;
  L.head = L.red + mlpb::RED_BYTES;
  L.bar = L.head + hb;
  L.bytes = L.bar + 2 * L.slots * 8 + 1024;
  out.blocks = std::max(1, std::min(L.tiles, L.per_sm * out.sms / 2));
  return 0;
}

// The fp32 weights of both chains and where their images go (the pack
// kernel's argument: two Packs and MlpParams would pass the 4 KB a kernel's
// parameters may take).
struct Images {
  const void* w[2][MLP_MAX_LAYERS];
  void* wpack[2];
};

// Both chains' images, once per call: the forward's (F) then the backward's
// (B), one 16-byte unit per thread, grid (images, chains, wg::PACK_SPLIT).
__global__ void __launch_bounds__(wg::PACK_THREADS) pack_kernel(const Images I, const wg::Pack F, const wg::Pack B) {
  const int s = blockIdx.x, u = blockIdx.z * wg::PACK_THREADS + threadIdx.x;
  unsigned char* img = static_cast<unsigned char*>(I.wpack[blockIdx.y]) + size_t(s) * wg::STAGE_BYTES;
  if (s < F.count) {
    wg::pack_unit(F, I.w[blockIdx.y], s, u, img);
  } else {
    wg::pack_unit(B, I.w[blockIdx.y], s - F.count, u, img);
  }
}

// Phase 1 of chain blockIdx.y on this block's 64-row tiles: per tile the
// chain forward (mlpf::forward_tile, the latent kept in its tile), then the
// heads, the loss and the backward from it (mlpb::backward_tile, the latent
// not loaded again).  Warps 0 .. 4 WGS - 1 are the consumer warpgroups, the
// last warp the producer, which streams each tile's forward and backward
// images through the one ring in the order the consumers take them.
template <int PER_SM>
__global__ void __launch_bounds__(threads(PER_SM), PER_SM) ppo_step_kernel(const MlpParams p, const Layout L) {
  constexpr int WGS = consumer_wgs(PER_SM), NT = WGS * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_base(smem_raw);
  const int chain = blockIdx.y;
  const MlpChain& c = p.chain[chain];
  wg::Ring ring = wg::make_ring(smem, 0, L.bar, L.slots, 0, WGS * 4);
  __syncthreads();  // the barriers are initialised
  if (wg::warp_index() == WGS * 4) {
    if (threadIdx.x == NT) {
      const int tiles = (L.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
      wg::produce(ring, smem, static_cast<const unsigned char*>(c.wpack), L.per_tile, tiles);
    }
    return;
  }
  const int t = threadIdx.x;
  unsigned char* const buf[2] = {smem + L.buf[0], smem + L.buf[1]};
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
    wg::group_sync(1, NT);  // the last tile's products and heads are done with the tiles
    mlpf::forward_tile<WGS>(p, c, ring, buf, tile * wg::TILE_M, true, t);
    mlpb::backward_tile<WGS, 2>(p, c, chain, tile, ring, smem, L, false, t);
  }
}

// The pack kernel, then the persistent kernel, on `stream`.
int launch(const MlpParams* p, cudaStream_t stream) {
  Plan P;
  int err = plan(*p, P);
  if (err != 0) return err;
  if (p->num_stages != P.L.per_tile) return static_cast<int>(cudaErrorInvalidValue);
  Images I{};
  for (int c = 0; c < 2; ++c) {
    if (p->chain[c].wpack == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    for (int l = 0; l < p->num_layers; ++l) I.w[c][l] = p->chain[c].w[l];
    I.wpack[c] = p->chain[c].wpack;
  }
  pack_kernel<<<dim3(P.L.per_tile, 2, wg::PACK_SPLIT), wg::PACK_THREADS, 0, stream>>>(I, P.fwd, P.bwd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int per_sm = P.L.per_sm;
  const void* kernel = per_sm == 1 ? reinterpret_cast<const void*>(ppo_step_kernel<1>)
                                   : reinterpret_cast<const void*>(ppo_step_kernel<2>);
  static bool opted_in[2][64] = {};  // the shared-memory limit, set once per kernel and device
  bool& done = opted_in[per_sm - 1][P.device & 63];
  if (!done) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  MlpParams copy = *p;
  Layout L = P.L;
  void* args[] = {&copy, &L};
  e = cudaLaunchKernel(kernel, dim3(P.blocks, 2), dim3(threads(per_sm)), args, L.bytes, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mlpm

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
      P.job[c][l] = {ch.d[l], l > 0 ? ch.h[l - 1] : ch.x, static_cast<float*>(ch.dw[l]), n_out, 0, n_out, n_in};
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
  return dw::launch(P, num_chains, s, stream);
}

}  // namespace

// K1b, K2b, K8b, K9s: both phases from saved activations (0 on success).
// `s`: phase 2's split and scratch.
extern "C" int mlp_chain_bwd(const MlpParams* p, int num_chains, const DwScratch* s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = mlpb::launch(p, num_chains, st);
  if (err != 0) return err;
  return launch_dw(p, num_chains, s, st);
}

// K9m: both chains' forward, heads, loss and backward per row tile in one
// phase-1 launch after the images' pack (head_mode 2, save_hiddens, the
// biases and every h[l] set, num_stages and wpack as mlp_ppo_step_plan
// says), then phase 2 (0 on success).
extern "C" int mlp_ppo_step(const MlpParams* p, const DwScratch* s, void* stream) {
  if (!p->save_hiddens) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = mlpm::launch(p, st);
  if (err != 0) return err;
  return launch_dw(p, 2, s, st);
}

// Blocks of phase 2 (dw_phase2.cuh) the card holds at once in clusters of
// `cluster` with `col_chunk` column sums per block (0 where the query fails).
extern "C" int dw_phase2_max_blocks(int cluster, int col_chunk) { return dw::max_active_blocks(cluster, col_chunk); }

// Stages of phase 2's ring with `col_chunk` column sums per block for a tile
// whose H is of `kind` (dw::HKind) and takes `hb` 64-column blocks.
extern "C" int dw_phase2_stages(int col_chunk, int kind, int hb) {
  return dw::ring_stages(kind, hb, dw::ring_bytes(col_chunk));
}

// Phase 1's plan of mlp_chain_bwd as the launch takes it: out = {images per
// tile, ring slots, resident, tiles per chain, blocks per chain, dynamic
// shared memory bytes, SMs, blocks per SM}.
extern "C" int mlp_chain_bwd_plan(const MlpParams* p, int num_chains, int* out) {
  mlpb::Plan P;
  const int err = mlpb::plan(*p, num_chains, P);
  if (err != 0) return err;
  const int v[8] = {P.pack.count, P.L.slots, P.L.resident, P.L.tiles, P.blocks, P.L.bytes, P.sms, P.L.per_sm};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// K9m's phase-1 plan as the launch takes it: out = {images per tile, ring
// slots, resident (0), tiles per chain, blocks per chain, dynamic shared
// memory bytes, SMs, blocks per SM, the forward's images per tile}.
extern "C" int mlp_ppo_step_plan(const MlpParams* p, int* out) {
  mlpm::Plan P;
  const int err = mlpm::plan(*p, P);
  if (err != 0) return err;
  const int v[9] = {P.L.per_tile, P.L.slots, P.L.resident, P.L.tiles, P.blocks, P.L.bytes, P.sms, P.L.per_sm,
                    P.fwd.count};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

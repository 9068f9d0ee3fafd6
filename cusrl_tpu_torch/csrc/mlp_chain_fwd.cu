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
// Numerics are the TPU kernels': bf16 operands, fp32 accumulation, + fp32
// bias, round to bf16, the activation in fp32 on that bf16 value, round to
// bf16 again; gelu saves the bf16 pre-activation of its hidden layers (its
// derivative is not a function of the output).  K8f: the heads read the
// latent tile while it is still in shared memory, fp32 FMAs on the fp32 head
// weights, never rounded to bf16 (the TPU kernel's fp32 island).  Without
// `save` only the heads' fp32 outputs leave the block.
//
// What bounds it on the H100: at the main-path widths 48->512->256->128 the
// chain does 2 * 188,416 FLOP per row against ~96 bytes of x in and 256 bytes
// of output out (plus 1,792 bytes of saved hiddens per row on the grad path),
// so by the roofline it is compute bound (0.0375 ms at 98,304 rows); the
// transformer's 128->128 ELU head does 32,768 FLOP per row against 512 bytes
// (bf16 in and out), so bytes bound it (0.040 ms at 262,144 rows).
//
// Design (namespace mlpf; the per-tile forward, forward_tile, in
// mlp_chain.cuh, shared with K9m's single-launch step; building blocks in
// hopper_wg.cuh, shared with the fused block's forwards):
//   * each layer's fp32 [out, in] weight becomes bf16 images of 128 output
//     rows x 64 K columns (16 KB, 128-byte swizzled, the B operand of
//     wgmma), taken per layer, per 128-column output chunk, per K block;
//     nothing is cached across calls (an optimizer updates the weights in
//     place);
//   * resident or streamed, chosen by the plan from the widths: a chain whose
//     images fit beside its activation tiles (the transformer's 128->128
//     head: 2 images, 32 KB) converts them from fp32 once per block into its
//     own slots, with no second launch; a chain that does not (the main
//     path's 24 images, 384 KB; the gelu FFN's 16) is packed by a pack kernel
//     into device memory and streams through a ring of 16 KB slots that one
//     producer warp fills with cp.async.bulk, once per tile;
//   * persistent blocks walk the row tiles of their chain, one 64-row tile
//     each per turn (K2f/K8f split the blocks between the two chains); the
//     block's consumer warpgroups split each 128-column chunk of a layer
//     (four of 32 columns in one block per SM, two of 64 in each of two
//     blocks per SM) and take it with m64n32k16 / m64n64k16 wgmma on their
//     rows of the image, fp32 accumulators in registers;
//   * the activations stay on chip: two swizzled tiles per block (even and odd
//     layers' inputs, each as wide as the widest it holds: 32 + 64 KB at the
//     main-path widths), the epilogue (bias, rounding, activation) runs on
//     the accumulators and writes bf16 straight into the next layer's A tile;
//   * the shared-memory budget (the plan): the main path's chain holds 96 KB
//     of tiles and streams its 24 images through 8 slots, 230,528 bytes in
//     one block per SM; the gelu FFN (128-512-128) 80 KB and 9 slots of its
//     16 images; the 128->128 head 32 KB of tiles beside its 2 resident
//     images, 66,592 bytes, two blocks per SM.  Chains whose tiles and ring
//     fit in half an SM run two blocks per SM, unless the launch has no more
//     tiles than SMs.  The other way to fit the main path, consuming the
//     512-wide h1 in 128-column chunks as it is made, would hold layer 2's
//     256 accumulator columns beside layer 1's chunk in registers: not tried;
//   * global traffic is 16 bytes wide: x is read as 16-byte vectors (fp32 or
//     bf16) into the swizzled tile; outputs and saved hiddens leave from
//     registers as 16-byte stores after a quad's shuffle transpose;
//   * each row tile has one owner: two calls give the same bits.
// What bounds it (probe_chain_forward.py takes parts out; PERF.md): the
// epilogue, not the products or the weight stream.  With one warpgroup per
// SM every epilogue instruction's latency is exposed (0.41 ms for the
// 98,304-row main-path chain); sixteen consumer warps per SM (the column
// split), elu without a per-element branch and bf16 rounding in packed
// pairs bring it to about 0.25 ms, of which products, x and the ring take
// about 0.09.
#include <algorithm>

#include "hopper_wg.cuh"
#include "mlp_chain.cuh"

namespace mlpf {

// Consumer warpgroups per block, by blocks per SM: the warpgroups of a block
// split each 128-column chunk of a layer (a quarter or a half of the image's
// rows each), four in one block per SM, two in each of two blocks per SM, so
// that sixteen consumer warps share an SM and one warp's epilogue overlaps
// another's products and latencies.
__host__ __device__ constexpr int consumer_wgs(int per_sm) { return per_sm == 1 ? 4 : 2; }
__host__ __device__ constexpr int threads(int per_sm) { return consumer_wgs(per_sm) * 128 + 32; }  // and a producer warp
using wg::BLOCK_SMEM;

// A block's shared memory, byte offsets from its 1,024-aligned base: the
// ring's slots, the two activation tiles, the ring's barriers.
struct Layout {
  int per_tile;  // images per tile (the chain's Pack::count)
  int slots;     // ring slots
  int resident;  // slots == per_tile: every image is converted once per block into its own slot
  int tiles;     // 64-row tiles per chain
  int per_sm;    // blocks per SM (the kernel instance launched)
  int buf[2];    // the tiles of the even and the odd layers' inputs
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

// Images, shared memory and grid of one forward.  Mirrored by chain_plan in
// nn/kernels/weight_images.py.
inline int plan(const MlpParams& p, int num_chains, Plan& out) {
  if (num_chains < 1 || num_chains > 2 || p.num_layers < 1 || p.num_layers > MLP_MAX_LAYERS)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i <= p.num_layers; ++i)
    if (p.dims[i] < 16 || p.dims[i] > MLP_MAX_WIDTH || p.dims[i] % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (p.head_mode == 1)
    for (int c = 0; c < num_chains; ++c)
      if (p.head[c].dim < 0 || p.head[c].dim > mlp::MAX_HEAD_DIM) return static_cast<int>(cudaErrorInvalidValue);
  out.pack = chain_pack(p);
  if (cudaGetDevice(&out.device) != cudaSuccess ||
      cudaDeviceGetAttribute(&out.sms, cudaDevAttrMultiProcessorCount, out.device) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  Layout& L = out.L;
  L.per_tile = out.pack.count;
  L.tiles = (p.num_rows + wg::TILE_M - 1) / wg::TILE_M;
  const int t0 = tile_bytes(p, 0), t1 = tile_bytes(p, 1);
  L.slots = wg::ring_slots(L.per_tile, t0 + t1, L.tiles * num_chains <= out.sms, L.per_sm);
  if (L.slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  L.resident = L.slots == L.per_tile;
  L.buf[0] = L.slots * wg::STAGE_BYTES;
  L.buf[1] = L.buf[0] + t0;
  L.bar = L.buf[1] + t1;
  L.bytes = L.bar + 2 * L.slots * 8 + 1024;
  out.blocks = std::max(1, std::min(L.tiles, L.per_sm * out.sms / num_chains));
  return 0;
}

// ---- device side ----------------------------------------------------------

// fp32 [out, in] weights to their bf16 images (streamed chains), once per
// call: one 16-byte unit per thread, grid (images, chains, wg::PACK_SPLIT).
__global__ void __launch_bounds__(wg::PACK_THREADS) pack_kernel(const MlpParams p, const wg::Pack P) {
  const MlpChain& c = p.chain[blockIdx.y];
  wg::pack_unit(P, c.w, blockIdx.x, blockIdx.z * wg::PACK_THREADS + threadIdx.x,
                static_cast<unsigned char*>(c.wpack) + size_t(blockIdx.x) * wg::STAGE_BYTES);
}

// K8f: out[r][o] = f32(latent[r]) . W[o] + b[o] for the tile's rows, in
// fp32 FMAs on the latent tile (bf16, swizzled) and the fp32 head weights.
// The four lanes of a quad share an output: lane p sums the 8-column chunks
// p, p + 4, ... in order, then the quad adds its four sums by shuffles, a
// fixed order (a thread per output runs one long chain of FMAs and loads).
// All lanes of a warp stay in step (64 * dim * 4 is a multiple of 32); rows
// past the end are computed and not stored.
__device__ __forceinline__ void heads(const MlpHead& hd, int latent, const unsigned char* tile, int row0, int n_rows,
                                      int t, int nt) {
  const int dim = hd.dim;
  const float* W = static_cast<const float*>(hd.w);
  const float* bias = static_cast<const float*>(hd.b);
  float* out = static_cast<float*>(hd.out);
  for (int i = t; i < wg::TILE_M * dim * 4; i += nt) {
    const int q = i >> 2, part = i & 3, r = q / dim, o = q - r * dim;
    const float* w = W + size_t(o) * latent;
    float s = 0.f;
    for (int k = part * 8; k < latent; k += 32) {
      const uint4 v = *reinterpret_cast<const uint4*>(tile + wg::swz(r, k));
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
    if (part == 0 && row0 + r < n_rows) out[size_t(row0 + r) * dim + o] = s + bias[o];
  }
}

// The chain of blockIdx.y on this block's row tiles (blockIdx.x, + gridDim.x,
// ...).  Warps 0 .. 4 WGS - 1 are the consumer warpgroups, warpgroup w taking
// the columns [w * NW, (w + 1) * NW) of each 128-column chunk (NW / 2
// accumulators per thread); the last warp is the producer (streamed images)
// or, with resident images, a helper of the conversion only.  HEADS: K8f's
// instances (the heads' code slowed the instances that never ran it).
template <int PER_SM, bool HEADS>
__global__ void __launch_bounds__(threads(PER_SM), PER_SM) chain_fwd_kernel(const MlpParams p, const Layout L,
                                                                            const wg::Pack P) {
  constexpr int WGS = consumer_wgs(PER_SM), NT = WGS * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = wg::aligned_base(smem_raw);
  const MlpChain& c = p.chain[blockIdx.y];
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

  unsigned char* const buf[2] = {smem + L.buf[0], smem + L.buf[1]};
  const MlpHead& hd = p.head[blockIdx.y];
  const bool head = HEADS && hd.dim > 0;
  for (int tile = blockIdx.x; tile < L.tiles; tile += gridDim.x) {
    const int row0 = tile * wg::TILE_M;
    if (ring.resident) ring.next = 0;
    wg::group_sync(1, NT);  // the last tile's products and heads are done with the tiles
    forward_tile<WGS>(p, c, ring, buf, row0, head, t);
    if (HEADS && head) heads(hd, p.dims[p.num_layers], buf[p.num_layers & 1], row0, p.num_rows, t, NT);
  }
}

// The pack kernel (streamed images), then the chain kernel, on `stream`.
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
  const int per_sm = P.L.per_sm, with_heads = p->head_mode == 1;
  const void* kernels[2][2] = {{reinterpret_cast<const void*>(chain_fwd_kernel<1, false>),
                                 reinterpret_cast<const void*>(chain_fwd_kernel<1, true>)},
                                {reinterpret_cast<const void*>(chain_fwd_kernel<2, false>),
                                 reinterpret_cast<const void*>(chain_fwd_kernel<2, true>)}};
  const void* kernel = kernels[per_sm - 1][with_heads];
  static bool opted_in[2][2][64] = {};  // the shared-memory limit, set once per kernel and device
  bool& done = opted_in[per_sm - 1][with_heads][P.device & 63];
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

}  // namespace mlpf

extern "C" const char* mlp_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the forward for `num_chains` (1 or 2) chains on `stream`; returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int mlp_chain_fwd(const MlpParams* p, int num_chains, void* stream) {
  return mlpf::launch(p, num_chains, static_cast<cudaStream_t>(stream));
}

// The forward's plan as the launch takes it: out = {images per tile, ring
// slots, resident, tiles per chain, blocks per chain, dynamic shared memory
// bytes, SMs, blocks per SM}.
extern "C" int mlp_chain_fwd_plan(const MlpParams* p, int num_chains, int* out) {
  mlpf::Plan P;
  const int err = mlpf::plan(*p, num_chains, P);
  if (err != 0) return err;
  const int v[8] = {P.pack.count, P.L.slots, P.L.resident, P.L.tiles, P.blocks, P.L.bytes, P.sms, P.L.per_sm};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

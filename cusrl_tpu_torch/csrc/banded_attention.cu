// Banded sliding-window attention for long sequences on Hopper (sm_90a):
// K7f, the forward of window-, segment- and validity-masked attention over
// [cache ++ sequence] keys for T > 64 (the lane kernels' K3f takes T <= 64).
//
// Replaces the Pallas kernel cusrl_tpu/nn/kernels/banded_attention.py:
//   K7f  _attention_kernel  (via _banded_pallas, banded_window_attention)
// The JAX package has no backward kernel for it: its custom VJP recomputes
// through the banded reference, and so does the port (banded_plain under
// autograd).  K7f saves nothing for the backward.
//
// Semantics (_banded_reference): query t of an (env, head) problem sits at
// combined position W+t and sees the combined keys s in [t, W+t] (key t+j,
// j = 0..W, is W-j steps in the past) where k_seg[s] == q_seg[t] and
// k_valid[s] > 0.  Scores are fp32, q.k * D^-1/2 minus the ALiBi slope times
// the distance W-j; masked keys drop out of the softmax; a query with no
// valid key gets exactly 0.  Any T >= 1 and any window W that fits work: the
// query block need not divide T, and W may be below, at or above it.
//
// Design.  The TPU kernel walks a grid (N, H, query block, key block) with an
// online softmax carried in VMEM scratch over the 1 + ceil(W/BQ) key blocks
// of the band.  Here one block owns one (env, head, query block), the blocks
// of one problem consecutive in the grid, and stages only the block's band
// by 16-byte cp.async, every operand read in place with its strides (the
// transformer hands over head-split views and a transposed q_seg): the key
// and value rows [t0, t0+BQ+W) (cut at W+T) and the keys' (segment, valid)
// pairs.  Two paths:
// - bf16 with D >= 16 (the transformer's), on tensor cores
//   (banded_fwd_kernel): BQ = 128 queries, one warp per 16; the block's q
//   rows staged too, every row padded by 16 bytes so that ldmatrix reads
//   without bank conflicts.  A warp's 16 queries see 16 + W keys, taken in
//   chunks of 32 (one at W = 16): the scores by mma.sync (bf16 products are
//   exact, the sums fp32), masked in registers, an online softmax across
//   chunks, and P V by mma.sync with each fp32 weight split into three bf16
//   terms, which keeps fp32 accuracy.  Each key row is read from shared
//   memory once per warp and the softmax is taken once per (query, key),
//   where the lanes path reads each row for every query that sees it and
//   takes every exp on four lanes.
// - fp32, or D = 8, or a bf16 window too wide for the tensor-core staging
//   at 16 queries (banded_lanes_kernel): K3f's layout and query
//   (band::attend_band, csrc/lane_band.cuh): LQ lanes per query on 16-byte
//   units, BQ = 256 / LQ, the W+1 scores kept in registers.  It stages a
//   block's band rows and nothing more, so it takes the widest windows
//   (W up to 872 at D = 64 in bf16, 1,701 at D = 32, 3,220 at D = 16).
// The query block shrinks for a short T and is halved while the band does
// not fit shared memory.
//
// What bounds it on the H100: bytes.  At the long-rollout update's shape
// (256 envs x 4 heads, T = 256, W = 16, D = 32, bf16 in, fp32 out) it reads
// q, k and v (52.4 MB) and writes out (33.6 MB): about 26 us at 3.35 TB/s;
// the work is 2 x 2 x 17 x 32 FLOP per query (scores and the weighted sum),
// 0.57 GFLOP, about 8.5 us at the CUDA cores' 67 TFLOP/s (the tensor cores
// do it, on the whole 16 x 32 tile a warp's chunk covers, 3.8x the band's
// products counting P's three terms, in far less).  Each key row is read by
// the two query blocks whose bands hold it when W > 0 (W of every BQ+W rows
// twice; the second read mostly from L2, since a problem's blocks run side
// by side), every other byte once.  What keeps it above the bound is
// latency: a block waits on its staging before any product, which the
// other blocks on its SM overlap only in part.
//
// Not yet done (later work): one persistent block per SM that stages its
// next query block while it computes; fusing RoPE into the staging; the
// tensor-core path for fp32 operands (three-term splits of q and k).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "lane_band.cuh"

#define BANDED_MAX_HEADS 32

// Mirrored field by field by ctypes in
// cusrl_tpu_torch/nn/kernels/banded_attention.py (_BandedParams).
struct BandedParams {
  const void* q;        // [N, H, T, D] bf16 or fp32 (is_bf16)
  const void* k;        // [N, H, S, D], S = W + T
  const void* v;        // [N, H, S, D]
  const int* q_seg;     // [N, T]
  const int* k_seg;     // [N, S]
  const int* k_valid;   // [N, S]
  float* out;           // [N, H, T, D] fp32
  int n;
  int heads;
  int t_len;
  int window;
  int dim;
  int is_bf16;
  int use_alibi;
  float scale;          // D^-1/2
  float slopes[BANDED_MAX_HEADS];
  // Every operand is read in place: element strides (n, h, t or s) of q, k
  // and v (the last dim contiguous; each row 16-byte aligned), and (n, t or
  // s) of q_seg, k_seg and k_valid.
  long long sq[3], sk[3], sv[3];
  long long sqseg[2], skseg[2], skval[2];
};

namespace banded {

using band::Lanes;
using bf16 = band::bf16;

constexpr size_t MAX_SMEM = 232448;  // the 227 KB a block may use

// ---- The tensor-core path: bf16 operands, D >= 16 --------------------------

constexpr int TC_BQ = 128;     // queries per block: eight warps of 16
constexpr int TC_MIN_BQ = 16;  // one warp's queries
constexpr int TC_KEYS = 32;    // keys per chunk: four tiles of 8

template <int D>
struct Tc {
  static constexpr int LD = D + 8;  // a staged row padded by 16 bytes: ldmatrix's eight rows fall on distinct banks
  static constexpr int KSTEPS = D / 16;  // depth steps of the score product
  static constexpr int DTILES = D / 8;   // 8-column tiles of the output
  static constexpr int BLOCKS = D <= 32 ? 3 : 2;  // blocks to an SM the instance is built for
};

// Key chunks of a warp's band: its 16 queries see 16 + W keys.
__host__ __device__ inline int tc_chunks(int window) { return (16 + window + TC_KEYS - 1) / TC_KEYS; }

// Rows staged for K and V: the last warp's chunks end at bq - 16 + 32 * chunks
// (>= bq + W); rows past the band are zero.
__host__ __device__ inline int tc_rows(int bq, int window) { return bq - 16 + TC_KEYS * tc_chunks(window); }

template <int D>
size_t tc_smem(int bq, int window) {
  const size_t rows = tc_rows(bq, window);
  return (2 * rows + bq) * Tc<D>::LD * sizeof(bf16) + rows * sizeof(int2);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory, each thread giving one row's
// address (thread i: row i % 8 of matrix i / 8); .trans delivers them
// transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, rows) * b (16x8, columns), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as a bf16 pair (the first at the lower address), and what
// the rounding left of each.
__device__ __forceinline__ uint32_t split_bf16(float& x, float& y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 back = __bfloat1622float2(h);
  x -= back.x;  // exact: x and its rounding lie within a factor of two
  y -= back.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}

// K7f on tensor cores.  Block: the `bq` queries from t0 of one problem, one
// warp per 16 of them.  The band's K and V rows, the block's q rows (each
// padded by 16 bytes) and the keys' (segment, valid) pairs are staged by
// cp.async, read in place with their strides.  A warp takes its 16 + W keys
// in chunks of 32: the scores S = q k^T / sqrt(D) by mma.sync m16n8k16 (bf16
// products are exact, the sums fp32), masked by window, segment and
// validity in registers (ALiBi subtracted), then an online softmax (the
// running maximum, the sums and the output rescaled when it rises; with
// W <= 16 one chunk and no rescale).  The weights e = exp(s - max) are fp32;
// for the product with V each is split into three bf16 terms (hi + mid + lo
// leaves less than 2^-26 of it), so P V by mma.sync keeps fp32 accuracy.  The
// output is divided by the sum at the end (0 where a query has no valid key)
// and stored in 8-byte pairs.
template <typename T, int D>
__global__ void __launch_bounds__(TC_BQ * 2, Tc<D>::BLOCKS)
    banded_fwd_kernel(const BandedParams p, int bq, int q_blocks, int chunks) {
  using C = Tc<D>;
  static_assert(sizeof(T) == 2 && D % 16 == 0, "bf16 rows of whole 16-column steps");
  constexpr int LD = C::LD, UNITS = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = p.window, tl = p.t_len, S = W + tl;
  const int pr = blockIdx.x / q_blocks, t0 = (blockIdx.x - pr * q_blocks) * bq;
  const int n = pr / p.heads, h = pr - n * p.heads;
  const int alloc = tc_rows(bq, W), rows = min(alloc, S - t0), qrows = min(bq, tl - t0);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + size_t(alloc) * LD;
  bf16* qs = vs + size_t(alloc) * LD;
  int2* ms = reinterpret_cast<int2*>(qs + size_t(bq) * LD);  // per key: (segment, valid)
  const bf16* kg = static_cast<const bf16*>(p.k) + n * p.sk[0] + h * p.sk[1] + t0 * p.sk[2];
  const bf16* vg = static_cast<const bf16*>(p.v) + n * p.sv[0] + h * p.sv[1] + t0 * p.sv[2];
  const bf16* qg = static_cast<const bf16*>(p.q) + n * p.sq[0] + h * p.sq[1] + t0 * p.sq[2];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < alloc * UNITS; i += blockDim.x) {
    const int r = i / UNITS, u = i - r * UNITS;
    bf16* kd = ks + r * LD + u * 8;
    bf16* vd = vs + r * LD + u * 8;
    if (r < rows) {
      band::cp_async16(kd, kg + r * p.sk[2] + u * 8);
      band::cp_async16(vd, vg + r * p.sv[2] + u * 8);
    } else {  // past the band: zero, so that a masked key adds 0 * 0
      *reinterpret_cast<uint4*>(kd) = zero;
      *reinterpret_cast<uint4*>(vd) = zero;
    }
  }
  for (int i = threadIdx.x; i < bq * UNITS; i += blockDim.x) {
    const int r = i / UNITS, u = i - r * UNITS;
    if (r < qrows)
      band::cp_async16(qs + r * LD + u * 8, qg + r * p.sq[2] + u * 8);
    else
      *reinterpret_cast<uint4*>(qs + r * LD + u * 8) = zero;
  }
  band::cp_async_commit();
  for (int r = threadIdx.x; r < alloc; r += blockDim.x) {
    const int s = t0 + r;
    ms[r] = r < rows ? make_int2(p.k_seg[n * p.skseg[0] + s * p.skseg[1]], p.k_valid[n * p.skval[0] + s * p.skval[1]] > 0)
                     : make_int2(0, 0);
  }
  const int lane = threadIdx.x & 31, q0 = (threadIdx.x >> 5) * 16;  // the warp's first query (local)
  const int g = lane >> 2, c = lane & 3;  // the thread's rows q0 + g and q0 + g + 8; its column pair 2c
  const int qsa = p.q_seg[n * p.sqseg[0] + min(t0 + q0 + g, tl - 1) * p.sqseg[1]];
  const int qsb = p.q_seg[n * p.sqseg[0] + min(t0 + q0 + g + 8, tl - 1) * p.sqseg[1]];
  band::cp_async_wait_all();
  __syncthreads();
  if (q0 >= qrows) return;  // whole warps leave; no barrier follows

  uint32_t qa[C::KSTEPS][4];
#pragma unroll
  for (int k = 0; k < C::KSTEPS; ++k)
    ldsm_x4(qa[k], qs + (q0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 16 * k + 8 * (lane >> 4));
  const float slope = p.use_alibi ? p.slopes[h] : 0.f;
  float o[C::DTILES][4];
#pragma unroll
  for (int d = 0; d < C::DTILES; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float ma = band::NEG, mb = band::NEG, la = 0.f, lb = 0.f;  // rows g and g + 8
  for (int ch = 0; ch < chunks; ++ch) {
    const int kb = q0 + ch * TC_KEYS;  // the chunk's first key row (local)
    float sc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
#pragma unroll
    for (int k = 0; k < C::KSTEPS; ++k)
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        uint32_t b[4];
        ldsm_x4(b, ks + (kb + 16 * pair + (lane & 7) + 8 * (lane >> 4)) * LD + 16 * k + 8 * ((lane >> 3) & 1));
        mma_bf16(sc[2 * pair], qa[k], b[0], b[1]);
        mma_bf16(sc[2 * pair + 1], qa[k], b[2], b[3]);
      }
    // Mask, scale and ALiBi; the chunk's maximum per row.
    unsigned ok = 0u;  // bit 4t + e: element e of tile t is a valid key
    float ta = band::NEG, tb = band::NEG;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kb + 8 * t + 2 * c + e, ja = key - (q0 + g), jb = ja - 8;
        const int2 mk = ms[key];
        const bool oka = ja >= 0 && ja <= W && mk.x == qsa && mk.y;
        const bool okb = jb >= 0 && jb <= W && mk.x == qsb && mk.y;
        float sa = sc[t][e] * p.scale, sb = sc[t][2 + e] * p.scale;
        if (p.use_alibi) {
          sa -= slope * float(W - ja);
          sb -= slope * float(W - jb);
        }
        sc[t][e] = sa;
        sc[t][2 + e] = sb;
        ta = oka ? fmaxf(ta, sa) : ta;
        tb = okb ? fmaxf(tb, sb) : tb;
        ok |= (unsigned(oka) << (4 * t + e)) | (unsigned(okb) << (4 * t + 2 + e));
      }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {  // the quad holds a row's 32 keys
      ta = fmaxf(ta, __shfl_xor_sync(0xffffffffu, ta, o_));
      tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, o_));
    }
    const float na = fmaxf(ma, ta), nb = fmaxf(mb, tb);
    const float ra = expf(ma - na), rb = expf(mb - nb);  // 1 while the maximum stays
    ma = na;
    mb = nb;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[t][e] = (ok >> (4 * t + e)) & 1u ? expf(sc[t][e] - ma) : 0.f;
        sc[t][2 + e] = (ok >> (4 * t + 2 + e)) & 1u ? expf(sc[t][2 + e] - mb) : 0.f;
        sa += sc[t][e];
        sb += sc[t][2 + e];
      }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, o_);
      sb += __shfl_xor_sync(0xffffffffu, sb, o_);
    }
    la = la * ra + sa;
    lb = lb * rb + sb;
#pragma unroll
    for (int d = 0; d < C::DTILES; ++d) {
      o[d][0] *= ra, o[d][1] *= ra;
      o[d][2] *= rb, o[d][3] *= rb;
    }
    // o += e V over the chunk's two 16-key steps, e in three bf16 terms.
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      uint32_t pa[3][4];  // the A fragment of e: rows g, g + 8; keys 2c, 2c + 8 of the step
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        pa[part][0] = split_bf16(sc[2 * k][0], sc[2 * k][1]);
        pa[part][1] = split_bf16(sc[2 * k][2], sc[2 * k][3]);
        pa[part][2] = split_bf16(sc[2 * k + 1][0], sc[2 * k + 1][1]);
        pa[part][3] = split_bf16(sc[2 * k + 1][2], sc[2 * k + 1][3]);
      }
#pragma unroll
      for (int d = 0; d < C::DTILES; d += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + (kb + 16 * k + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * d + 8 * (lane >> 4));
#pragma unroll
        for (int part = 2; part >= 0; --part) {  // the smallest terms first
          mma_bf16(o[d], pa[part], b[0], b[1]);
          mma_bf16(o[d + 1], pa[part], b[2], b[3]);
        }
      }
    }
  }
  const float ia = la > 0.f ? 1.f / la : 0.f, ib = lb > 0.f ? 1.f / lb : 0.f;
  const int ta_ = t0 + q0 + g, tb_ = ta_ + 8;
  float* oa = p.out + (size_t(pr) * tl + ta_) * D + 2 * c;
  float* ob = oa + 8 * D;
#pragma unroll
  for (int d = 0; d < C::DTILES; ++d) {
    if (ta_ < tl) *reinterpret_cast<float2*>(oa + 8 * d) = make_float2(o[d][0] * ia, o[d][1] * ia);
    if (tb_ < tl) *reinterpret_cast<float2*>(ob + 8 * d) = make_float2(o[d][2] * ib, o[d][3] * ib);
  }
}

// ---- The lanes path: fp32 operands, or D = 8 -------------------------------

constexpr int THREADS = 256, BLOCKS = 3;  // a block's threads at most, and the blocks to an SM they are built for
constexpr int MIN_BQ = 8;

// Dynamic shared memory of one block: the band's K and V rows and one
// (segment, valid) pair per key.
template <typename T, int D>
size_t smem_bytes(int bq, int window) {
  return size_t(bq + window) * (2 * D * sizeof(T) + sizeof(int2));
}

// K7f on K3f's layout.  Block: the `bq` queries from t0 of one problem, LQ
// lanes each; the band's K and V rows staged by cp.async, each query's band
// through band::attend_band.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, BLOCKS) banded_lanes_kernel(const BandedParams p, int bq, int q_blocks) {
  using X = Lanes<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = p.window, tl = p.t_len, S = W + tl;
  const int pr = blockIdx.x / q_blocks, t0 = (blockIdx.x - pr * q_blocks) * bq;
  const int n = pr / p.heads, h = pr - n * p.heads;
  const int rows = min(bq + W, S - t0);  // the band: combined keys [t0, t0 + rows)
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + size_t(bq + W) * D;
  int2* ms = reinterpret_cast<int2*>(vs + size_t(bq + W) * D);  // per key: (segment, valid)
  const T* kg = static_cast<const T*>(p.k) + n * p.sk[0] + h * p.sk[1] + t0 * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + n * p.sv[0] + h * p.sv[1] + t0 * p.sv[2];
  for (int i = threadIdx.x; i < rows * X::UNITS; i += blockDim.x) {
    const int r = i / X::UNITS, u = i - r * X::UNITS;
    band::cp_async16(ks + r * D + u * X::VEC, kg + r * p.sk[2] + u * X::VEC);
    band::cp_async16(vs + r * D + u * X::VEC, vg + r * p.sv[2] + u * X::VEC);
  }
  band::cp_async_commit();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int s = t0 + r;
    ms[r] = make_int2(p.k_seg[n * p.skseg[0] + s * p.skseg[1]], p.k_valid[n * p.skval[0] + s * p.skval[1]] > 0);
  }
  // The query's own operands while the copies fly.
  const int local = threadIdx.x / X::LQ, l = threadIdx.x - local * X::LQ, t = t0 + local;
  const bool active = t < tl;  // the same for the LQ lanes of a query
  float q[X::PER], acc[X::PER];
  int qs = 0;
  if (active) {
    band::lane_row<T, D>(static_cast<const T*>(p.q) + n * p.sq[0] + h * p.sq[1] + t * p.sq[2], l, q);
    qs = p.q_seg[n * p.sqseg[0] + t * p.sqseg[1]];
  }
  band::cp_async_wait_all();
  __syncthreads();
  if (!active) return;  // whole queries leave; no barrier follows

  band::attend_band<T, D>(q, ks + local * D, vs + local * D, ms + local, W, qs, p.scale, p.use_alibi,
                          p.use_alibi ? p.slopes[h] : 0.f, l, nullptr, acc);
  band::store_lane_row<T, D>(p.out + (size_t(pr) * tl + t) * D, l, acc);
}

// Launches `kernel` with `smem` bytes of dynamic shared memory (raising the
// limit above 48 KB first).
template <typename... Params, typename... Args>
cudaError_t start(void (*kernel)(Params...), unsigned blocks, int threads, size_t smem, cudaStream_t stream,
                  Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The plan of either path: {lanes (threads) per query, queries per block,
// threads, shared memory bytes, passes over the band, blocks per SM the
// instance is built for, tensor cores (1) or lanes (0)}; queries per block 0
// where even the smallest block's band does not fit.  bf16 at D >= 16 takes
// the tensor cores unless a window this wide does not fit their staging at
// 16 queries; it then takes the lanes path, which stages less per key row.
// Mirrored by banded_attention.py:fwd_plan.
template <typename T, int D>
void plan_of(int t_len, int window, int (&v)[7]) {
  if constexpr (sizeof(T) == 2 && D >= 16) {
    int bq = std::min(TC_BQ, (t_len + 15) / 16 * 16);
    while (bq > TC_MIN_BQ && tc_smem<D>(bq, window) > MAX_SMEM) bq = std::max(TC_MIN_BQ, bq / 2 / 16 * 16);
    if (tc_smem<D>(bq, window) <= MAX_SMEM) {
      const int out[7] = {2, bq, 2 * bq, int(tc_smem<D>(bq, window)), tc_chunks(window), Tc<D>::BLOCKS, 1};
      std::copy(out, out + 7, v);
      return;
    }
  }
  const int lq = Lanes<T, D>::LQ;
  int bq = std::min(THREADS / lq, (t_len + 7) / 8 * 8);
  while (bq > MIN_BQ && smem_bytes<T, D>(bq, window) > MAX_SMEM) bq = std::max(MIN_BQ, bq / 2);
  const bool fits = smem_bytes<T, D>(bq, window) <= MAX_SMEM;
  const int out[7] = {lq, fits ? bq : 0, fits ? bq * lq : 0, int(smem_bytes<T, D>(bq, window)),
                      window < band::NB ? 1 : 2, BLOCKS, 0};
  std::copy(out, out + 7, v);
}

// With `plan` set writes the launch plan there and launches nothing.
template <typename T, int D>
cudaError_t launch(const BandedParams& p, cudaStream_t stream, int* plan) {
  if (p.t_len <= 0 || p.window < 0) return cudaErrorInvalidValue;
  int v[7];
  plan_of<T, D>(p.t_len, p.window, v);
  const int bq = v[1], threads = v[2];
  const size_t smem = size_t(v[3]);
  if (bq == 0) return cudaErrorInvalidValue;
  if (plan != nullptr) {
    std::copy(v, v + 7, plan);
    return cudaSuccess;
  }
  const long long q_blocks = (p.t_len + bq - 1) / bq, blocks = q_blocks * p.n * p.heads;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2 && D >= 16)
    if (v[6])
      return start(banded_fwd_kernel<T, D>, unsigned(blocks), threads, smem, stream, p, bq, int(q_blocks), v[4]);
  return start(banded_lanes_kernel<T, D>, unsigned(blocks), threads, smem, stream, p, bq, int(q_blocks));
}

template <typename T>
cudaError_t dispatch_dim(const BandedParams& p, cudaStream_t stream, int* plan) {
  switch (p.dim) {
    case 8: return launch<T, 8>(p, stream, plan);
    case 16: return launch<T, 16>(p, stream, plan);
    case 32: return launch<T, 32>(p, stream, plan);
    case 64: return launch<T, 64>(p, stream, plan);
    default: return cudaErrorInvalidValue;
  }
}

int run(const BandedParams* p, void* stream, int* plan) {
  if (p->n <= 0 || p->heads <= 0 || p->heads > BANDED_MAX_HEADS) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(p->is_bf16 ? dispatch_dim<bf16>(*p, s, plan) : dispatch_dim<float>(*p, s, plan));
}

}  // namespace banded

extern "C" const char* banded_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues K7f on `stream` and returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int banded_attention_fwd(const BandedParams* p, void* stream) { return banded::run(p, stream, nullptr); }

// K7f's launch plan: out = {lanes (threads) per query, queries per block,
// threads per block, dynamic shared memory bytes, passes over the band (on
// tensor cores its chunks of 32 keys; on lanes 1 where its W+1 keys fit
// band::NB, else 2: the scores computed again), blocks per SM, tensor cores
// (1) or lanes (0)}.
extern "C" int banded_attention_fwd_plan(const BandedParams* p, int* out) { return banded::run(p, nullptr, out); }

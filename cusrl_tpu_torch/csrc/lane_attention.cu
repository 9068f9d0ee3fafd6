// Windowed, segment- and validity-masked attention for the short per-env
// attention problems of RL training on Hopper (sm_90a): K3f (forward, with
// or without the saved probabilities), K3b (backward from them) and K6 (the
// counterfactual-append "next token" forward).
//
// Replaces the Pallas kernels cusrl_tpu/nn/kernels/lane_attention.py:
//   K3f  _fwd_kernel       (via _lane_pallas_fwd, lane_window_attention)
//   K3b  _bwd_kernel       (via _lane_pallas_bwd, the custom VJP of the above)
//   K6   _next_fwd_kernel  (via lane_next_token_attention)
//
// Semantics (the band form of the TPU kernels): query t of an (env, head)
// problem sees the W+1 combined keys s = t + j, j = 0..W (key t+j is W-j
// steps in the past; j = W is the query's own token), where key s is valid
// iff k_seg[s] == q_seg[t] and k_valid[s] > 0.  Scores are fp32,
// q.k * D^-1/2 minus the ALiBi slope times the distance; masked keys drop
// out of the softmax; a query with no valid key gets exactly 0 (denominator
// 0 -> inverse 0).  K6's query t sees the band j = 1..W (ALiBi distance
// W+1-j) plus its own key k_self[t] at distance 0, always valid.
//
// The TPU kernels lay environments in the 128 vector lanes ([H, D, T, N])
// so that the tiny per-env products become dense elementwise slabs.  On
// Hopper all three take LQ lanes per query (4 at D = 32 in bf16), each on
// D / LQ columns in 16-byte units (csrc/lane_band.cuh): the problem's W+T
// key and value rows are staged once by 16-byte cp.async without padding
// (the lanes of a warp read consecutive units of consecutive rows), every
// operand read in place with its strides (the transformer hands over a
// transposed q_seg, head-split views and a transposed cotangent), each score
// computed once and kept in registers, 288 threads per block at the entry's
// shapes (three problems of 24 queries), blocks of up to 288 threads built
// for three to an SM.  K3f's band of W+1 keys (17 at W = 16) fits one pass
// of 32 registers: the maximum, the denominator, the probabilities and the
// weighted sum all come from them, in the plain version's order, the keys
// taken two at a time without a branch so that their latencies overlap
// (band::attend_band, shared with K7f).
//
// K3b: dk and dv sum over the up to W+1 queries that see each key.  One
// block owns whole (env, head) problems, so no sum crosses blocks and no
// atomic is needed.  The problem's K, V and q rows, the fp32 cotangent g
// (rows padded by 16 bytes, so that the two rows a quarter-warp reads fall
// on different banks) and the saved probabilities w (rows padded to an odd
// count, so that phase B's diagonal reads fall on different banks) are
// staged by cp.async.  Phase A (LQ lanes per query) forms
// dw_j = g . v_{t+j} for the band (lane partial dots summed over the lanes
// by shuffles, kept in registers as K3f keeps its scores, keys in pairs),
// rho = sum_j dw_j w_j, ds_j = (dw_j - rho) w_j / sqrt(D) (to shared memory
// for phase B) and dq_t = sum_j ds_j k_{t+j}; phase B (LQ lanes per key row
// s) sums dv_s = sum_j w[s-j][j] g[s-j] and dk_s = sum_j ds[s-j][j] q[s-j]
// in the TPU kernel's order (j ascending), an out-of-range t = s-j masked
// without a branch (weight 0).  dq, dk and dv leave in 16-byte units, fp32
// or, for the autograd wrapper, bf16: one rounding of the same fp32 sums, so
// the bf16 outputs are the fp32 ones cast.  The result is deterministic.
//
// What bounds them on the H100: bytes.  At the entry's update shape
// (256 envs x 4 heads, T = 24, W = 16, D = 32, bf16 in) K3f reads q, k, v
// (6.8 MB) and writes out in fp32 (3.1 MB) and the probabilities (1.7 MB),
// about 3.5 us at 3.35 TB/s; K3b reads q, k, v, g (fp32) and the
// probabilities (11.5 MB) and writes dq, dk, dv (6.8 MB in bf16), about
// 5.5 us.  The work is 2 x 2 x 17 x 32 FLOP per query forward and twice
// that backward, far below the card's FLOP rate.  Every input byte is read
// once per block and every output written once.  What keeps them above
// the bound is latency: a block waits on its staging before any product
// (three blocks to an SM overlap one block's staging with the others'
// arithmetic), and the registers capped for three blocks spill at the wider
// instances (ptxas's usage is printed by chip_smoke.py).
//
// Not yet done (later work): fusing RoPE and the head split into the
// staging; one persistent block per SM that stages its next problems while
// it computes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "lane_band.cuh"

#define LANE_MAX_HEADS 32

// Mirrored field by field by ctypes in
// cusrl_tpu_torch/nn/kernels/lane_attention.py (_LaneParams).
struct LaneParams {
  const void* q;         // [N, H, T, D] bf16 or fp32 (is_bf16)
  const void* k;         // [N, H, S, D], S = W + T (K3f, K3b, K6)
  const void* v;         // [N, H, S, D]
  const void* k_self;    // K6: [N, H, T, D]
  const void* v_self;    // K6: [N, H, T, D]
  const int* q_seg;      // [N, T]
  const int* k_seg;      // [N, S]
  const int* k_valid;    // [N, S]
  const float* g;        // K3b: [N, H, T, D] fp32 cotangent of out
  float* out;            // K3f, K6: [N, H, T, D] fp32
  float* probs;          // K3f: [N, H, T, W+1] fp32 or null (primal); K3b reads it
  void* dq;              // K3b: [N, H, T, D] fp32 or bf16 (out_bf16)
  void* dk;              // K3b: [N, H, S, D]
  void* dv;              // K3b: [N, H, S, D]
  int n;
  int heads;
  int t_len;
  int window;
  int dim;
  int is_bf16;
  int use_alibi;
  int out_bf16;          // K3b: dq, dk and dv in bf16
  float scale;           // D^-1/2
  float slopes[LANE_MAX_HEADS];
  // Every operand is read in place: element strides (n, h, t or s) of q,
  // k_self, v_self, k, v and g (the last dim contiguous; each row 16-byte
  // aligned), and (n, t or s) of q_seg, k_seg and k_valid.
  long long sq[3], sks[3], svs[3], sk[3], sv[3], sg[3];
  long long sqseg[2], skseg[2], skval[2];
};

namespace lane {

using bf16 = __nv_bfloat16;
using band::Lanes;
using band::lane_row;
using band::NEG;

constexpr int TARGET_THREADS = 128;  // the most queries of one problem
constexpr size_t MAX_SMEM = 232448;  // the 227 KB a block may use

// ---- K6 ---------------------------------------------------------------------

constexpr int NEXT_NB = 16;  // K6's band keys scored per pass and kept in registers
constexpr int NEXT_TARGET_THREADS = 256, NEXT_MAX_THREADS = 512;
constexpr size_t NEXT_SOFT_SMEM = 64 * 1024;  // more problems per block only while the block stays this small

// Stages the band of the block's `pb` problems from `first` on: the W+T K and
// V rows of each by 16-byte cp.async (one commit group, waited for by the
// caller), and each key's (segment, valid) pair; rows of problems past the
// end stay unset.  K3f's and K6's operands are read in place with their
// strides.
template <typename T, int D>
__device__ __forceinline__ void stage_band(const LaneParams& p, int first, int pb, T* ks, T* vs, int2* ms) {
  using X = Lanes<T, D>;
  const int S = p.window + p.t_len, H = p.heads, problems = p.n * H;
  for (int i = threadIdx.x; i < pb * S * X::UNITS; i += blockDim.x) {
    const int b = i / (S * X::UNITS), r = i - b * S * X::UNITS, s = r / X::UNITS, u = r - s * X::UNITS;
    const int pr = first + b;
    if (pr < problems) {
      const int n = pr / H, h = pr - n * H;
      const size_t dst = (size_t(b) * S + s) * D + u * X::VEC;
      band::cp_async16(ks + dst, static_cast<const T*>(p.k) + n * p.sk[0] + h * p.sk[1] + s * p.sk[2] + u * X::VEC);
      band::cp_async16(vs + dst, static_cast<const T*>(p.v) + n * p.sv[0] + h * p.sv[1] + s * p.sv[2] + u * X::VEC);
    }
  }
  band::cp_async_commit();
  for (int i = threadIdx.x; i < pb * S; i += blockDim.x) {
    const int b = i / S, s = i - b * S, pr = first + b;
    if (pr < problems) {
      const int n = pr / H;
      ms[i] = make_int2(p.k_seg[n * p.skseg[0] + s * p.skseg[1]], p.k_valid[n * p.skval[0] + s * p.skval[1]] > 0);
    }
  }
}

// K6: query t over the band j = 1..W (ALiBi distance W+1-j) plus its own key
// k_self[t] at distance 0, which is always valid.  A block holds `pb`
// problems x T queries x LQ lanes: K and V rows and the keys' (segment,
// valid) pairs are staged once with 16-byte cp.async (no padding: the lanes
// of a warp read consecutive 16-byte units), q, k_self and v_self come
// straight from device memory in 16-byte units, and each lane keeps its
// D / LQ output columns in fp32.  Each band score is computed once (a dot
// over the lane's columns, then a fixed-order sum over the LQ lanes by
// shuffles) and kept in registers; the softmax is taken per pass of NB keys
// against the running maximum (the weights found so far rescaled when it
// rises; with W <= NB there is one pass and no rescale), the weighted sum of
// V in fp32 FMAs, and the sum times the inverse denominator leaves by
// 16-byte stores.
template <typename T, int D>
__global__ void __launch_bounds__(NEXT_MAX_THREADS) lane_next_kernel(const LaneParams p, int pb) {
  using X = Lanes<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tl = p.t_len, W = p.window, S = W + tl, H = p.heads;
  const int problems = p.n * H, first = blockIdx.x * pb;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + size_t(pb) * S * D;
  int2* ms = reinterpret_cast<int2*>(vs + size_t(pb) * S * D);  // per key: (segment, valid)
  stage_band<T, D>(p, first, pb, ks, vs, ms);
  // The query's own operands while the copies fly.
  const int qi = threadIdx.x / X::LQ, l = threadIdx.x - qi * X::LQ, b = qi / tl, t = qi - b * tl, pr = first + b;
  const bool active = pr < problems;  // the same for the LQ lanes of a query
  const int n = active ? pr / H : 0, h = active ? pr - n * H : 0;
  float q[X::PER], acc[X::PER], tmp[X::PER];
  float self_dot = 0.f;
  int qs = 0;
  if (active) {
    lane_row<T, D>(static_cast<const T*>(p.q) + n * p.sq[0] + h * p.sq[1] + t * p.sq[2], l, q);
    lane_row<T, D>(static_cast<const T*>(p.k_self) + n * p.sks[0] + h * p.sks[1] + t * p.sks[2], l, tmp);
    lane_row<T, D>(static_cast<const T*>(p.v_self) + n * p.svs[0] + h * p.svs[1] + t * p.svs[2], l, acc);
#pragma unroll
    for (int d = 0; d < X::PER; ++d) self_dot = fmaf(q[d], tmp[d], self_dot);
    qs = p.q_seg[n * p.sqseg[0] + t * p.sqseg[1]];
  }
  band::cp_async_wait_all();
  __syncthreads();
  if (!active) return;  // whole queries leave; no barrier follows

  const unsigned group = band::lane_group<X::LQ>();
  auto lanes_sum = [&](float v) {  // the same fixed order on every lane of the query
#pragma unroll
    for (int o = 1; o < X::LQ; o <<= 1) v += __shfl_xor_sync(group, v, o);
    return v;
  };
  const float slope = p.use_alibi ? p.slopes[h] : 0.f;
  const T* kp = ks + size_t(b) * S * D;
  const T* vp = vs + size_t(b) * S * D;
  const int2* mp = ms + size_t(b) * S;
  float m = lanes_sum(self_dot) * p.scale, denom = 1.f;  // the own key: weight exp(0), v_self already in acc
  for (int j0 = 1; j0 <= W; j0 += NEXT_NB) {
    float sc[NEXT_NB];
    float top = NEG;
#pragma unroll
    for (int u = 0; u < NEXT_NB; ++u) {
      const int j = j0 + u;
      sc[u] = NEG;  // masked: exp(NEG - m) = 0
      if (j <= W) {
        const int2 key = mp[t + j];
        if (key.x == qs && key.y) {
          lane_row<T, D>(kp + (t + j) * D, l, tmp);
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < X::PER; ++d) dot = fmaf(q[d], tmp[d], dot);
          float s = lanes_sum(dot) * p.scale;
          if (p.use_alibi) s -= slope * float(W + 1 - j);
          sc[u] = s;
          top = fmaxf(top, s);
        }
      }
    }
    const float mn = fmaxf(m, top), r = expf(m - mn);  // r = 1 while the maximum stays
    denom *= r;
#pragma unroll
    for (int d = 0; d < X::PER; ++d) acc[d] *= r;
    m = mn;
#pragma unroll
    for (int u = 0; u < NEXT_NB; ++u) {
      const float e = j0 + u <= W ? expf(sc[u] - m) : 0.f;
      if (e > 0.f) {
        denom += e;
        lane_row<T, D>(vp + (t + j0 + u) * D, l, tmp);
#pragma unroll
        for (int d = 0; d < X::PER; ++d) acc[d] = fmaf(e, tmp[d], acc[d]);
      }
    }
  }
  const float inv = 1.f / denom;
  float* orow = p.out + ((size_t(pr) * tl + t) * D);
#pragma unroll
  for (int k = 0; k < X::UPL; ++k) {
#pragma unroll
    for (int e = 0; e < X::VEC; e += 4) {
      const float* a = acc + k * X::VEC + e;
      *reinterpret_cast<float4*>(orow + (l + k * X::LQ) * X::VEC + e) =
          make_float4(a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv);
    }
  }
}

// ---- K3f --------------------------------------------------------------------

// K3f's blocks of up to SMALL_THREADS run SMALL_BLOCKS to an SM (the
// registers capped to fit); larger ones, one to an SM.  K3b's likewise.
constexpr int SMALL_THREADS = 288, SMALL_BLOCKS = 3;

// K3f: query t over the band j = 0..W (ALiBi distance W-j), masked by
// segment and validity; probs == null: the primal variant.  K6's layout and
// staging (LQ lanes per query on 16-byte units, K and V by cp.async without
// padding, q and the masks read in place with their strides), then
// band::attend_band: each band score computed once and kept in registers,
// the weights written to probs and summed into the output in the plain
// version's order, the keys in pairs without a branch.  SMALL: the instance
// for blocks of up to SMALL_THREADS, three to an SM (a block waits on its
// staging while the others compute).
template <typename T, int D, bool SMALL>
__global__ void __launch_bounds__(SMALL ? SMALL_THREADS : NEXT_MAX_THREADS, SMALL ? SMALL_BLOCKS : 1)
    lane_fwd_kernel(const LaneParams p, int pb) {
  using X = Lanes<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tl = p.t_len, W = p.window, S = W + tl, H = p.heads;
  const int problems = p.n * H, first = blockIdx.x * pb;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + size_t(pb) * S * D;
  int2* ms = reinterpret_cast<int2*>(vs + size_t(pb) * S * D);  // per key: (segment, valid)
  stage_band<T, D>(p, first, pb, ks, vs, ms);
  // The query's own operands while the copies fly.
  const int qi = threadIdx.x / X::LQ, l = threadIdx.x - qi * X::LQ, b = qi / tl, t = qi - b * tl, pr = first + b;
  const bool active = pr < problems;  // the same for the LQ lanes of a query
  const int n = active ? pr / H : 0, h = active ? pr - n * H : 0;
  float q[X::PER], acc[X::PER];
  int qs = 0;
  if (active) {
    lane_row<T, D>(static_cast<const T*>(p.q) + n * p.sq[0] + h * p.sq[1] + t * p.sq[2], l, q);
    qs = p.q_seg[n * p.sqseg[0] + t * p.sqseg[1]];
  }
  band::cp_async_wait_all();
  __syncthreads();
  if (!active) return;  // whole queries leave; no barrier follows

  const size_t row0 = size_t(b) * S + t;  // key j = 0 of the query
  float* prow = p.probs == nullptr ? nullptr : p.probs + (size_t(pr) * tl + t) * (W + 1);
  band::attend_band<T, D>(q, ks + row0 * D, vs + row0 * D, ms + row0, W, qs, p.scale, p.use_alibi,
                          p.use_alibi ? p.slopes[h] : 0.f, l, prow, acc);
  band::store_lane_row<T, D>(p.out + (size_t(pr) * tl + t) * D, l, acc);
}

// The problems a block of K3f, K3b or K6 holds: at least NEXT_TARGET_THREADS
// threads where the queries allow, at most NEXT_MAX_THREADS, fewer problems
// while the block's staging (`per_problem` bytes a problem) exceeds
// NEXT_SOFT_SMEM.  Mirrored by next_plan, fwd_plan and bwd_plan in
// nn/kernels/lane_attention.py.
template <typename T, int D>
int block_problems(const LaneParams& p, size_t per_problem) {
  const int per = p.t_len * Lanes<T, D>::LQ;
  int pb = std::max(1, (NEXT_TARGET_THREADS + per - 1) / per);
  while (pb > 1 && (pb * per > NEXT_MAX_THREADS || pb * per_problem > NEXT_SOFT_SMEM)) --pb;
  return pb;
}

// K3f's and K6's staging per problem: the K and V rows and one (segment,
// valid) pair per key.
template <typename T, int D>
size_t band_smem(const LaneParams& p) {
  return size_t(p.window + p.t_len) * (2 * D * sizeof(T) + sizeof(int2));
}

// ---- K3b --------------------------------------------------------------------

// K3b's staging of one problem, in this order: K and V ([S][D]), q ([T][D]),
// the cotangent g ([T][D + 4] fp32), the probabilities and ds ([T][BP] fp32
// each, BP = W+1 rounded up to an odd count).
template <typename T, int D>
struct BwdStage {
  static constexpr int GLD = D + 4;  // 16 bytes of padding: consecutive rows start four banks apart
  static __host__ __device__ int bp(int window) { return (window + 1) | 1; }
  static __host__ __device__ size_t rows_bytes(int window, int t_len) {
    return size_t(2 * (window + t_len) + t_len) * D * sizeof(T) + size_t(t_len) * GLD * sizeof(float);
  }
  static __host__ __device__ size_t bytes(int window, int t_len) {
    return rows_bytes(window, t_len) + 2 * size_t(t_len) * bp(window) * sizeof(float);
  }
};

// K3b.  A block holds `pb` whole problems; phase A takes LQ lanes per query,
// phase B LQ lanes per key row.  SMALL as K3f's.
template <typename T, int D, bool SMALL>
__global__ void __launch_bounds__(SMALL ? SMALL_THREADS : NEXT_MAX_THREADS, SMALL ? SMALL_BLOCKS : 1)
    lane_bwd_kernel(const LaneParams p, int pb) {
  using X = Lanes<T, D>;
  using G = BwdStage<T, D>;
  constexpr int NB = band::NB, KG = band::KG, LQ = X::LQ;
  static_assert(NB % KG == 0 && NB % LQ == 0, "a pass holds whole groups, and lanes agree with keys mod LQ");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tl = p.t_len, W = p.window, B = W + 1, S = W + tl, H = p.heads, BP = G::bp(W);
  const int problems = p.n * H, first = blockIdx.x * pb;
  T* ks = reinterpret_cast<T*>(smem);                            // [pb][S][D]
  T* vs = ks + size_t(pb) * S * D;                               // [pb][S][D]
  T* qs = vs + size_t(pb) * S * D;                               // [pb][T][D]
  float* gs = reinterpret_cast<float*>(qs + size_t(pb) * tl * D);  // [pb][T][GLD]
  float* ws = gs + size_t(pb) * tl * G::GLD;                     // [pb][T][BP] probabilities
  float* dss = ws + size_t(pb) * tl * BP;                        // [pb][T][BP] ds
  band::stage_rows<T, D>(ks, D, static_cast<const T*>(p.k), p.sk, first, pb, problems, H, S);
  band::stage_rows<T, D>(vs, D, static_cast<const T*>(p.v), p.sv, first, pb, problems, H, S);
  band::stage_rows<T, D>(qs, D, static_cast<const T*>(p.q), p.sq, first, pb, problems, H, tl);
  band::stage_rows<float, D>(gs, G::GLD, p.g, p.sg, first, pb, problems, H, tl);
  {  // the block's probabilities: pb * T rows of W+1, contiguous in device memory
    const float* src = p.probs + size_t(first) * tl * B;
    const int count = (min(first + pb, problems) - first) * tl * B;
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int r = i / B;
      band::cp_async4(ws + r * BP + (i - r * B), src + i);
    }
  }
  band::cp_async_commit();
  const int qi = threadIdx.x / LQ, l = threadIdx.x - qi * LQ;
  const unsigned group = band::lane_group<LQ>();
  band::cp_async_wait_all();
  __syncthreads();

  // Phase A: LQ lanes per query t.
  {
    const int b = qi / tl, t = qi - b * tl, pr = first + b;
    if (pr < problems) {  // the same for the LQ lanes of a query
      float gq[X::PER], sc[NB];
      band::lane_row_f32<T, D>(gs + (size_t(b) * tl + t) * G::GLD, l, gq);
      const T* kp = ks + (size_t(b) * S + t) * D;  // key j = 0 of the query
      const T* vp = vs + (size_t(b) * S + t) * D;
      const float* wp = ws + (size_t(b) * tl + t) * BP;
      float* dp = dss + (size_t(b) * tl + t) * BP;
      // dw_j = g . v_{t+j} for keys j0 .. j0 + NB - 1 into sc.
      auto dw_pass = [&](int j0) {
#pragma unroll
        for (int g = 0; g < NB; g += KG) {
          if (j0 + g > W) break;  // the same on every thread: the band has ended
          float dot[KG];
#pragma unroll
          for (int e = 0; e < KG; ++e) {
            float row[X::PER];
            lane_row<T, D>(vp + min(j0 + g + e, W) * D, l, row);
            dot[e] = 0.f;
#pragma unroll
            for (int d = 0; d < X::PER; ++d) dot[e] = fmaf(gq[d], row[d], dot[e]);
          }
#pragma unroll
          for (int o = 1; o < LQ; o <<= 1)  // the same order on every lane
#pragma unroll
            for (int e = 0; e < KG; ++e) dot[e] += __shfl_xor_sync(group, dot[e], o);
#pragma unroll
          for (int e = 0; e < KG; ++e) sc[g + e] = dot[e];
        }
      };
      float rho = 0.f;
      for (int j0 = 0; j0 < B; j0 += NB) {
        dw_pass(j0);
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          if (j0 + u > W) break;
          rho = fmaf(sc[u], wp[j0 + u], rho);
        }
      }
      float acc[X::PER];
#pragma unroll
      for (int d = 0; d < X::PER; ++d) acc[d] = 0.f;
      for (int j0 = 0; j0 < B; j0 += NB) {
        if (W >= NB) dw_pass(j0);  // a band of several passes: its dw again
#pragma unroll
        for (int g = 0; g < NB; g += KG) {
          if (j0 + g > W) break;
#pragma unroll
          for (int e = 0; e < KG; ++e) {
            const int u = g + e, j = j0 + u, jc = min(j, W);
            const float ds = j <= W ? (sc[u] - rho) * wp[jc] * p.scale : 0.f;  // 0 past the band
            if (j <= W && (u & (LQ - 1)) == l) dp[j] = ds;  // u and j agree mod LQ
            float row[X::PER];
            lane_row<T, D>(kp + jc * D, l, row);
#pragma unroll
            for (int d = 0; d < X::PER; ++d) acc[d] = fmaf(ds, row[d], acc[d]);
          }
        }
      }
      const size_t at = (size_t(pr) * tl + t) * D;
      if (p.out_bf16)
        band::store_lane_row<T, D>(static_cast<bf16*>(p.dq) + at, l, acc);
      else
        band::store_lane_row<T, D>(static_cast<float*>(p.dq) + at, l, acc);
    }
  }
  __syncthreads();

  // Phase B: LQ lanes per key row s, over the queries t = s - j that see it
  // (j ascending, in pairs; t out of range is weight 0).
  const int groups = blockDim.x / LQ;
  for (int item = qi; item < pb * S; item += groups) {
    const int b = item / S, s = item - b * S, pr = first + b;
    if (pr >= problems) break;  // later items lie further past the end
    const T* qb = qs + size_t(b) * tl * D;
    const float* gb = gs + size_t(b) * tl * G::GLD;
    const float* wb = ws + size_t(b) * tl * BP;
    const float* db = dss + size_t(b) * tl * BP;
    float ak[X::PER], av[X::PER];
#pragma unroll
    for (int d = 0; d < X::PER; ++d) ak[d] = av[d] = 0.f;
    for (int j0 = 0; j0 < B; j0 += KG) {
#pragma unroll
      for (int e = 0; e < KG; ++e) {
        const int j = j0 + e, t = s - j;
        const bool ok = j < B && unsigned(t) < unsigned(tl);
        const int tc = min(max(t, 0), tl - 1), at = tc * BP + min(j, W);
        const float w = ok ? wb[at] : 0.f, ds = ok ? db[at] : 0.f;
        float grow[X::PER], qrow[X::PER];
        band::lane_row_f32<T, D>(gb + tc * G::GLD, l, grow);
        lane_row<T, D>(qb + tc * D, l, qrow);
#pragma unroll
        for (int d = 0; d < X::PER; ++d) {
          av[d] = fmaf(w, grow[d], av[d]);
          ak[d] = fmaf(ds, qrow[d], ak[d]);
        }
      }
    }
    const size_t at = (size_t(pr) * S + s) * D;
    if (p.out_bf16) {
      band::store_lane_row<T, D>(static_cast<bf16*>(p.dk) + at, l, ak);
      band::store_lane_row<T, D>(static_cast<bf16*>(p.dv) + at, l, av);
    } else {
      band::store_lane_row<T, D>(static_cast<float*>(p.dk) + at, l, ak);
      band::store_lane_row<T, D>(static_cast<float*>(p.dv) + at, l, av);
    }
  }
}

// K3f (kind 0), K3b (kind 1) or K6 (kind 2); with `plan` set writes the
// launch plan there ({lanes per query, problems per block, threads, shared
// memory bytes, and for K3f and K3b their passes over the band and the
// blocks per SM their instance is built for}) and launches nothing.
template <typename T, int D>
cudaError_t launch(const LaneParams& p, int kind, cudaStream_t stream, int* plan) {
  if (p.t_len <= 0 || p.t_len > TARGET_THREADS || p.window < 0) return cudaErrorInvalidValue;
  const size_t per_problem = kind == 1 ? BwdStage<T, D>::bytes(p.window, p.t_len) : band_smem<T, D>(p);
  const int pb = block_problems<T, D>(p, per_problem);
  const size_t smem = pb * per_problem;
  const int threads = pb * p.t_len * Lanes<T, D>::LQ;
  const bool small = threads <= SMALL_THREADS;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (plan != nullptr) {
    const int v[6] = {Lanes<T, D>::LQ, pb, threads, static_cast<int>(smem), p.window < band::NB ? 1 : 2,
                      small ? SMALL_BLOCKS : 1};
    for (int i = 0; i < (kind == 2 ? 4 : 6); ++i) plan[i] = v[i];
    return cudaSuccess;
  }
  void (*kernel)(const LaneParams, int) = kind == 2 ? lane_next_kernel<T, D>
                                          : kind == 1 ? (small ? lane_bwd_kernel<T, D, true> : lane_bwd_kernel<T, D, false>)
                                          : small     ? lane_fwd_kernel<T, D, true>
                                                      : lane_fwd_kernel<T, D, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const int problems = p.n * p.heads;
  kernel<<<(problems + pb - 1) / pb, threads, smem, stream>>>(p, pb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const LaneParams& p, int kind, cudaStream_t stream, int* plan) {
  switch (p.dim) {
    case 8: return launch<T, 8>(p, kind, stream, plan);
    case 16: return launch<T, 16>(p, kind, stream, plan);
    case 32: return launch<T, 32>(p, kind, stream, plan);
    case 64: return launch<T, 64>(p, kind, stream, plan);
    default: return cudaErrorInvalidValue;
  }
}

// Launches kernel `kind` (0 K3f, 1 K3b, 2 K6), or with `plan` set writes
// its launch plan there and launches nothing.
int run(const LaneParams* p, int kind, void* stream, int* plan = nullptr) {
  if (p->n <= 0 || p->heads <= 0 || p->heads > LANE_MAX_HEADS) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(p->is_bf16 ? dispatch_dim<bf16>(*p, kind, s, plan) : dispatch_dim<float>(*p, kind, s, plan));
}

}  // namespace lane

extern "C" const char* lane_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int lane_attention_fwd(const LaneParams* p, void* stream) { return lane::run(p, 0, stream); }
extern "C" int lane_attention_bwd(const LaneParams* p, void* stream) { return lane::run(p, 1, stream); }
extern "C" int lane_attention_next(const LaneParams* p, void* stream) { return lane::run(p, 2, stream); }

// K6's launch plan: out = {lanes per query, problems per block, threads per
// block, dynamic shared memory bytes}.
extern "C" int lane_attention_next_plan(const LaneParams* p, int* out) { return lane::run(p, 2, nullptr, out); }

// K3f's launch plan: K6's four values, then the score passes over the band
// (1 where its W+1 keys fit band::NB, else 2: the scores computed again) and
// the blocks per SM of the instance launched (SMALL_BLOCKS for blocks of up
// to SMALL_THREADS, else 1).
extern "C" int lane_attention_fwd_plan(const LaneParams* p, int* out) { return lane::run(p, 0, nullptr, out); }

// K3b's launch plan: the same six values for its own staging (dw computed
// again in a second pass where the band exceeds band::NB keys).
extern "C" int lane_attention_bwd_plan(const LaneParams* p, int* out) { return lane::run(p, 1, nullptr, out); }

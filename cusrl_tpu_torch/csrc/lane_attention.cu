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
// Hopper K3f and K6 take LQ lanes per query (4 at D = 32 in bf16), each on
// D / LQ columns in 16-byte units: the problem's W+T key and value rows are
// staged once by 16-byte cp.async without padding (the lanes of a warp read
// consecutive units of consecutive rows), q (and K6's k_self, v_self) read
// and out written in 16-byte units, every operand read in place with its
// strides (the transformer hands over a transposed q_seg and head-split
// views), each score computed once and kept in registers, 288 threads per
// block at the entry's shapes (three problems of 24 queries).  K3f's band
// of W+1 keys (17 at W = 16) fits one pass of 32 registers: the maximum,
// the denominator, the probabilities and the weighted sum all come from
// them, in the plain version's order, the keys taken two at a time without
// a branch so that their latencies overlap, three blocks to an SM
// (lane_fwd_kernel below).  K3b takes
// one thread per (env, head, query): q (D floats) and the D output
// accumulators live in registers, the loop over the W+1 band keys runs in
// fp32, and the problem's W+T key and value rows are staged once,
// coalesced, in shared memory (rows padded by two elements so that
// neighbouring queries read different banks); a block holds floor(128 / T)
// problems (5 at T = 24: 120 threads).
//
// What bounds them on the H100: bytes.  At the entry's update shape
// (256 envs x 4 heads, T = 24, W = 16, D = 32, bf16 in, fp32 out) K3f reads
// q, k, v (6.8 MB) and writes out (3.1 MB) and the probabilities (1.7 MB),
// about 3.5 us at 3.35 TB/s; the work is 2 x 2 x 17 x 32 FLOP per query (the
// scores and the weighted sum), far below the card's FLOP rate.  The design
// reads every input byte once per block and writes every output once;
// nothing is re-read from device memory.
//
// K3b: dk and dv sum over the up to W+1 queries that see each key.  One
// block owns whole (env, head) problems, so no sum crosses blocks and no
// atomic is needed: phase A (one thread per query) forms
// dw_j = g . v_{t+j}, ds_j = (dw_j - sum_j dw_j w_j) w_j / sqrt(D) and
// dq_t = sum_j ds_j k_{t+j}, with g, w and ds staged in shared memory;
// phase B (one thread per key row s) sums dv_s = sum_j w[s-j][j] g[s-j]
// and dk_s = sum_j ds[s-j][j] q[s-j] in the TPU kernel's order (j
// ascending).  The result is deterministic.
//
// Not yet done (later work): K3b's warp-cooperative dot products and vector
// loads (K3f's and K6's design), fusing RoPE and the head split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

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
  float* dq;             // K3b: [N, H, T, D] fp32
  float* dk;             // K3b: [N, H, S, D] fp32
  float* dv;             // K3b: [N, H, S, D] fp32
  int n;
  int heads;
  int t_len;
  int window;
  int dim;
  int is_bf16;
  int use_alibi;
  float scale;           // D^-1/2
  float slopes[LANE_MAX_HEADS];
  // K3f and K6 read their operands in place: element strides (n, h, t or s)
  // of q, k_self, v_self, k and v (the last dim contiguous; each row 16-byte
  // aligned), and (n, t or s) of q_seg, k_seg and k_valid.  K3b reads them
  // contiguous.
  long long sq[3], sks[3], svs[3], sk[3], sv[3];
  long long sqseg[2], skseg[2], skval[2];
};

namespace lane {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr int TARGET_THREADS = 128;
constexpr size_t MAX_SMEM = 232448;  // the 227 KB a block may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Copies the W+T rows of `src` ([problems, S, D]) for the block's problems
// into `dst` ([pb][S][D + 2]); rows of problems past the end stay unset.
template <typename T, int D>
__device__ void stage_rows(T* dst, const T* __restrict__ src, int first, int pb, int problems, int rows) {
  constexpr int LD = D + 2;
  for (int i = threadIdx.x; i < pb * rows * D; i += blockDim.x) {
    const int b = i / (rows * D), rem = i % (rows * D), r = rem / D, d = rem % D;
    if (first + b < problems) dst[(b * rows + r) * LD + d] = src[(size_t(first + b) * rows + r) * D + d];
  }
}

// ---- K6 ---------------------------------------------------------------------

// K6's thread layout: LQ lanes per query, lane l taking the 16-byte units
// l, l + LQ, ... of a row (VEC elements each), so that the lanes of a warp
// read consecutive units of consecutive rows.  NB band keys are scored per
// pass and kept in registers (one pass at W <= NB).
template <typename T, int D>
struct Next {
  static constexpr int VEC = 16 / int(sizeof(T));
  static constexpr int UNITS = D / VEC;
  static constexpr int LQ = UNITS < 4 ? UNITS : 4;
  static constexpr int UPL = UNITS / LQ;
  static constexpr int PER = UPL * VEC;
  static constexpr int NB = 16;
};
constexpr int NEXT_TARGET_THREADS = 256, NEXT_MAX_THREADS = 512;
constexpr size_t NEXT_SOFT_SMEM = 64 * 1024;  // more problems per block only while the block stays this small

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// One 16-byte unit as fp32 values (four fp32 or eight bf16).
__device__ __forceinline__ void unit_to_f(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x), out[1] = __uint_as_float(raw.y), out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unit_to_f(const uint4& raw, float* out, bf16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    out[2 * e] = f.x;
    out[2 * e + 1] = f.y;
  }
}

// The lane's PER elements of the row at `row` (units l, l + LQ, ...) as fp32.
template <typename T, int D>
__device__ __forceinline__ void lane_row(const T* row, int l, float (&v)[Next<T, D>::PER]) {
  using X = Next<T, D>;
#pragma unroll
  for (int k = 0; k < X::UPL; ++k)
    unit_to_f(*reinterpret_cast<const uint4*>(row + (l + k * X::LQ) * X::VEC), v + k * X::VEC, T());
}

// Stages the band of the block's `pb` problems from `first` on: the W+T K and
// V rows of each by 16-byte cp.async (one commit group, waited for by the
// caller), and each key's (segment, valid) pair; rows of problems past the
// end stay unset.  K3f's and K6's operands are read in place with their
// strides.
template <typename T, int D>
__device__ __forceinline__ void stage_band(const LaneParams& p, int first, int pb, T* ks, T* vs, int2* ms) {
  using X = Next<T, D>;
  const int S = p.window + p.t_len, H = p.heads, problems = p.n * H;
  for (int i = threadIdx.x; i < pb * S * X::UNITS; i += blockDim.x) {
    const int b = i / (S * X::UNITS), r = i - b * S * X::UNITS, s = r / X::UNITS, u = r - s * X::UNITS;
    const int pr = first + b;
    if (pr < problems) {
      const int n = pr / H, h = pr - n * H;
      const size_t dst = (size_t(b) * S + s) * D + u * X::VEC;
      cp_async16(ks + dst, static_cast<const T*>(p.k) + n * p.sk[0] + h * p.sk[1] + s * p.sk[2] + u * X::VEC);
      cp_async16(vs + dst, static_cast<const T*>(p.v) + n * p.sv[0] + h * p.sv[1] + s * p.sv[2] + u * X::VEC);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
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
  using X = Next<T, D>;
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
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  if (!active) return;  // whole queries leave; no barrier follows

  const unsigned group = X::LQ == 32 ? 0xffffffffu : ((1u << X::LQ) - 1u) << ((threadIdx.x & 31) & ~(X::LQ - 1));
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
  for (int j0 = 1; j0 <= W; j0 += X::NB) {
    float sc[X::NB];
    float top = NEG;
#pragma unroll
    for (int u = 0; u < X::NB; ++u) {
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
    for (int u = 0; u < X::NB; ++u) {
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

constexpr int FWD_NB = 32;  // K3f's band keys scored per pass and kept in registers
constexpr int FWD_KG = 2;   // band keys taken together, without a branch: their loads, products and shuffles overlap
// K3f's blocks of up to FWD_SMALL_THREADS run FWD_SMALL_BLOCKS to an SM (the
// registers capped to fit); larger ones, one to an SM.
constexpr int FWD_SMALL_THREADS = 288, FWD_SMALL_BLOCKS = 3;

// K3f: query t over the band j = 0..W (ALiBi distance W-j), masked by
// segment and validity; probs == null: the primal variant.  K6's layout and
// staging (LQ lanes per query on 16-byte units, K and V by cp.async without
// padding, q and the masks read in place with their strides), each band
// score computed once (a dot over the lane's columns, a fixed-order sum over
// the LQ lanes by shuffles) and kept in registers: the maximum and the
// denominator from them (each exp(s_j - max) taken once, kept, and summed j
// ascending), then each weight w_j = exp(s_j - max) / denominator, written
// to probs (lane l the
// keys j = l mod LQ) and summed into the output as sum_j w_j v_j in fp32
// FMAs, j ascending: the plain version's order.  The keys go in groups of
// FWD_KG with no branch inside a group (a masked key's score is computed
// and dropped, its value added with weight 0; a group's keys past the band
// read the last key again), so that the group's loads, products and
// shuffles overlap instead of waiting on each other.  A band wider than
// FWD_NB keys takes its scores in passes of FWD_NB with the denominator
// rescaled as the maximum rises, and computes them again for the weighted
// sum.  A query with no valid key has denominator 0 and gets exactly 0.
// SMALL: the instance for blocks of up to FWD_SMALL_THREADS, three to an SM
// (a block waits on its staging while the others compute).
template <typename T, int D, bool SMALL>
__global__ void __launch_bounds__(SMALL ? FWD_SMALL_THREADS : NEXT_MAX_THREADS, SMALL ? FWD_SMALL_BLOCKS : 1)
    lane_fwd_kernel(const LaneParams p, int pb) {
  using X = Next<T, D>;
  constexpr int NB = FWD_NB, KG = FWD_KG;
  static_assert(NB % KG == 0 && NB % X::LQ == 0, "a pass holds whole groups, and lanes agree with keys mod LQ");
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
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  if (!active) return;  // whole queries leave; no barrier follows

  const unsigned group = X::LQ == 32 ? 0xffffffffu : ((1u << X::LQ) - 1u) << ((threadIdx.x & 31) & ~(X::LQ - 1));
  const float slope = p.use_alibi ? p.slopes[h] : 0.f;
  const T* kp = ks + size_t(b) * S * D;
  const T* vp = vs + size_t(b) * S * D;
  const int2* mp = ms + size_t(b) * S;
  float sc[NB];
  unsigned valid = 0u;  // bit u: key j0 + u of the pass is valid
  // The scores of keys j0 .. j0 + NB - 1 into sc and valid; returns the
  // largest valid one (NEG where none is).
  auto score_pass = [&](int j0) {
    float top = NEG;
    valid = 0u;
#pragma unroll
    for (int g = 0; g < NB; g += KG) {
      if (j0 + g > W) break;  // the same on every thread: the band has ended
      float dot[KG];
#pragma unroll
      for (int e = 0; e < KG; ++e) {
        float row[X::PER];
        lane_row<T, D>(kp + (t + min(j0 + g + e, W)) * D, l, row);
        dot[e] = 0.f;
#pragma unroll
        for (int d = 0; d < X::PER; ++d) dot[e] = fmaf(q[d], row[d], dot[e]);
      }
#pragma unroll
      for (int o = 1; o < X::LQ; o <<= 1)  // the same order on every lane
#pragma unroll
        for (int e = 0; e < KG; ++e) dot[e] += __shfl_xor_sync(group, dot[e], o);
#pragma unroll
      for (int e = 0; e < KG; ++e) {
        const int j = j0 + g + e;
        const int2 key = mp[t + min(j, W)];
        const bool ok = j <= W && key.x == qs && key.y;
        float s = dot[e] * p.scale;
        if (p.use_alibi) s -= slope * float(W - j);
        sc[g + e] = ok ? s : NEG;
        top = ok ? fmaxf(top, s) : top;
        valid |= unsigned(ok) << (g + e);
      }
    }
    return top;
  };
  // Each valid key's exp(s_j - max) replaces its score in sc, 0 for the
  // other keys of the groups score_pass took: with one pass the weighted sum
  // takes it from there.
  auto exp_pass = [&](int j0, float mx) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (j0 + u - u % KG > W) break;
      sc[u] = (valid >> u) & 1u ? expf(sc[u] - mx) : 0.f;
    }
  };
  float m = NEG, denom = 0.f;
  for (int j0 = 0; j0 <= W; j0 += NB) {
    const float mn = fmaxf(m, score_pass(j0));
    denom *= expf(m - mn);  // 1 while the maximum stays (always with one pass)
    m = mn;
    exp_pass(j0, m);
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (j0 + u > W) break;
      denom += sc[u];
    }
  }
  const float inv = denom > 0.f ? 1.f / denom : 0.f;
  float* prow = p.probs == nullptr ? nullptr : p.probs + (size_t(pr) * tl + t) * (W + 1);
#pragma unroll
  for (int d = 0; d < X::PER; ++d) acc[d] = 0.f;
  for (int j0 = 0; j0 <= W; j0 += NB) {
    if (W >= NB) {  // a band of several passes: its scores and exps again
      score_pass(j0);
      exp_pass(j0, m);
    }
#pragma unroll
    for (int g = 0; g < NB; g += KG) {
      if (j0 + g > W) break;
#pragma unroll
      for (int e = 0; e < KG; ++e) {
        const int u = g + e, j = j0 + u;
        const float w = sc[u] * inv;  // 0 for masked keys and past the band
        if (prow != nullptr && j <= W && (u & (X::LQ - 1)) == l) prow[j] = w;  // u and j agree mod LQ
        float row[X::PER];
        lane_row<T, D>(vp + (t + min(j, W)) * D, l, row);
#pragma unroll
        for (int d = 0; d < X::PER; ++d) acc[d] = fmaf(w, row[d], acc[d]);
      }
    }
  }
  float* orow = p.out + ((size_t(pr) * tl + t) * D);
#pragma unroll
  for (int k = 0; k < X::UPL; ++k) {
#pragma unroll
    for (int e = 0; e < X::VEC; e += 4) {
      const float* a = acc + k * X::VEC + e;
      *reinterpret_cast<float4*>(orow + (l + k * X::LQ) * X::VEC + e) = make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

// K3f's and K6's problems per block and dynamic shared memory (the same
// staging): at least NEXT_TARGET_THREADS threads where the queries allow, at
// most NEXT_MAX_THREADS, fewer problems while the block's staging exceeds
// NEXT_SOFT_SMEM.  Mirrored by next_plan and fwd_plan in
// nn/kernels/lane_attention.py.
template <typename T, int D>
size_t band_smem(const LaneParams& p, int pb) {
  return size_t(pb) * (p.window + p.t_len) * (2 * D * sizeof(T) + sizeof(int2));
}

template <typename T, int D>
int band_problems(const LaneParams& p) {
  const int per = p.t_len * Next<T, D>::LQ;
  int pb = std::max(1, (NEXT_TARGET_THREADS + per - 1) / per);
  while (pb > 1 && (pb * per > NEXT_MAX_THREADS || band_smem<T, D>(p, pb) > NEXT_SOFT_SMEM)) --pb;
  return pb;
}

// K3b.  Block: `pb` whole problems; phase A per query, phase B per key row.
template <typename T, int D>
__global__ void lane_bwd_kernel(const LaneParams p, int pb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = D + 2, GLD = D + 1;
  const int tl = p.t_len, W = p.window, B = W + 1, S = W + tl;
  const int problems = p.n * p.heads, first = blockIdx.x * pb;
  float* gs = reinterpret_cast<float*>(smem);        // [pb][T][D + 1]
  float* ws = gs + size_t(pb) * tl * GLD;             // [pb][T][B] probabilities
  float* dss = ws + size_t(pb) * tl * B;              // [pb][T][B] dw, then ds
  T* ks = reinterpret_cast<T*>(dss + size_t(pb) * tl * B);  // [pb][S][LD]
  T* vs = ks + size_t(pb) * S * LD;
  T* qs = vs + size_t(pb) * S * LD;                   // [pb][T][LD]
  stage_rows<T, D>(ks, static_cast<const T*>(p.k), first, pb, problems, S);
  stage_rows<T, D>(vs, static_cast<const T*>(p.v), first, pb, problems, S);
  stage_rows<T, D>(qs, static_cast<const T*>(p.q), first, pb, problems, tl);
  for (int i = threadIdx.x; i < pb * tl * D; i += blockDim.x) {
    const int b = i / (tl * D), rem = i % (tl * D), t = rem / D, d = rem % D;
    if (first + b < problems) gs[(b * tl + t) * GLD + d] = p.g[(size_t(first + b) * tl + t) * D + d];
  }
  for (int i = threadIdx.x; i < pb * tl * B; i += blockDim.x) {
    const int b = i / (tl * B);
    if (first + b < problems) ws[i] = p.probs[size_t(first) * tl * B + i];
  }
  __syncthreads();

  // Phase A: one thread per query.
  {
    const int b = threadIdx.x / tl, t = threadIdx.x % tl, pr = first + b;
    if (b < pb && pr < problems) {
      const float* g = gs + (b * tl + t) * GLD;
      const float* w = ws + (b * tl + t) * B;
      float* ds = dss + (b * tl + t) * B;
      const T* kp = ks + size_t(b) * S * LD;
      const T* vp = vs + size_t(b) * S * LD;
      float rho = 0.f;
      for (int j = 0; j < B; ++j) {
        const T* vrow = vp + (t + j) * LD;
        float dw = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dw = fmaf(g[d], to_f(vrow[d]), dw);
        ds[j] = dw;
        rho = fmaf(dw, w[j], rho);
      }
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = 0.f;
      for (int j = 0; j < B; ++j) {
        const float dsj = (ds[j] - rho) * w[j] * p.scale;
        ds[j] = dsj;
        const T* krow = kp + (t + j) * LD;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(dsj, to_f(krow[d]), acc[d]);
      }
      float* dq = p.dq + (size_t(pr) * tl + t) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = acc[d];
    }
  }
  __syncthreads();

  // Phase B: one thread per key row s; the queries t = s - j that see it.
  for (int item = threadIdx.x; item < pb * S; item += blockDim.x) {
    const int b = item / S, s = item % S, pr = first + b;
    if (pr >= problems) continue;
    float ak[D], av[D];
#pragma unroll
    for (int d = 0; d < D; ++d) ak[d] = av[d] = 0.f;
    for (int j = 0; j < B; ++j) {
      const int t = s - j;
      if (t < 0 || t >= tl) continue;
      const float w = ws[(b * tl + t) * B + j];
      const float ds = dss[(b * tl + t) * B + j];
      const float* g = gs + (b * tl + t) * GLD;
      const T* qrow = qs + (b * tl + t) * LD;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        av[d] = fmaf(w, g[d], av[d]);
        ak[d] = fmaf(ds, to_f(qrow[d]), ak[d]);
      }
    }
    float* dk = p.dk + (size_t(pr) * S + s) * D;
    float* dv = p.dv + (size_t(pr) * S + s) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[d] = ak[d];
      dv[d] = av[d];
    }
  }
}

// K3b's problems per block (threads = pb * T <= 128; T itself is at most 128)
// and the dynamic shared memory that takes; pb shrinks until it fits.
template <typename T, int D>
size_t smem_bytes(const LaneParams& p, int pb) {
  const size_t S = p.window + p.t_len, LD = D + 2;
  return pb * (2 * S * LD * sizeof(T) + p.t_len * LD * sizeof(T) + p.t_len * (D + 1) * sizeof(float)
               + 2 * size_t(p.t_len) * (p.window + 1) * sizeof(float));
}

// K3f (kind 0) or K6 (kind 2); with `plan` set writes the launch plan there
// ({lanes per query, problems per block, threads, shared memory bytes, and
// for K3f its score passes and the blocks per SM its instance is built
// for}) and launches nothing.
template <typename T, int D>
cudaError_t launch_band(const LaneParams& p, int kind, cudaStream_t stream, int* plan) {
  const int pb = band_problems<T, D>(p);
  const size_t smem = band_smem<T, D>(p, pb);
  const int threads = pb * p.t_len * Next<T, D>::LQ;
  const bool small = threads <= FWD_SMALL_THREADS;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (plan != nullptr) {
    const int v[6] = {Next<T, D>::LQ, pb, threads, static_cast<int>(smem), p.window < FWD_NB ? 1 : 2,
                      small ? FWD_SMALL_BLOCKS : 1};
    for (int i = 0; i < (kind == 0 ? 6 : 4); ++i) plan[i] = v[i];
    return cudaSuccess;
  }
  void (*kernel)(const LaneParams, int) = kind == 2 ? lane_next_kernel<T, D>
                                          : small   ? lane_fwd_kernel<T, D, true>
                                                    : lane_fwd_kernel<T, D, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const int problems = p.n * p.heads;
  kernel<<<(problems + pb - 1) / pb, threads, smem, stream>>>(p, pb);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const LaneParams& p, int kind, cudaStream_t stream, int* plan) {
  if (p.t_len <= 0 || p.t_len > TARGET_THREADS) return cudaErrorInvalidValue;
  if (kind != 1) return launch_band<T, D>(p, kind, stream, plan);
  int pb = TARGET_THREADS / p.t_len;
  while (pb > 1 && smem_bytes<T, D>(p, pb) > MAX_SMEM) --pb;
  const size_t smem = smem_bytes<T, D>(p, pb);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int problems = p.n * p.heads;
  const dim3 grid((problems + pb - 1) / pb), block(pb * p.t_len);
  cudaError_t err = cudaFuncSetAttribute(lane_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  lane_bwd_kernel<T, D><<<grid, block, smem, stream>>>(p, pb);
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
// K3f's or K6's launch plan there and launches nothing.
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
// (1 where its W+1 keys fit FWD_NB, else 2: the scores computed again) and
// the blocks per SM of the instance launched (FWD_SMALL_BLOCKS for blocks of
// up to FWD_SMALL_THREADS, else 1).
extern "C" int lane_attention_fwd_plan(const LaneParams* p, int* out) { return lane::run(p, 0, nullptr, out); }

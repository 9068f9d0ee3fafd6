// Device pieces shared by the band attention kernels on Hopper (sm_90a):
// K3f, K3b and K6 (csrc/lane_attention.cu) and K7f (csrc/banded_attention.cu).
//
// Layout: LQ lanes per query (or, in K3b's second phase, per key row), lane
// l taking the 16-byte units l, l + LQ, ... of a row (VEC elements each), so
// that the lanes of a warp read consecutive units of consecutive rows.  Rows
// are staged by 16-byte cp.async; each lane holds its PER columns in fp32.
//
// attend_band is K3f's and K7f's query: the scores of its band of W+1 keys
// computed once and kept in registers, the keys taken in groups of KG
// without a branch, the softmax and the weighted sum in the plain version's
// order (j ascending).
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace band {

using bf16 = __nv_bfloat16;

constexpr float NEG = -1e30f;
constexpr int NB = 32;  // band keys scored per pass and kept in registers
constexpr int KG = 2;   // band keys taken together, without a branch: their loads, products and shuffles overlap

template <typename T, int D>
struct Lanes {
  static constexpr int VEC = 16 / int(sizeof(T));
  static constexpr int UNITS = D / VEC;
  static constexpr int LQ = UNITS < 4 ? UNITS : 4;
  static constexpr int UPL = UNITS / LQ;
  static constexpr int PER = UPL * VEC;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// The lanes of the caller's query (LQ consecutive threads of one warp).
template <int LQ>
__device__ __forceinline__ unsigned lane_group() {
  return LQ == 32 ? 0xffffffffu : ((1u << LQ) - 1u) << ((threadIdx.x & 31) & ~(LQ - 1));
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
__device__ __forceinline__ void lane_row(const T* row, int l, float (&v)[Lanes<T, D>::PER]) {
  using X = Lanes<T, D>;
#pragma unroll
  for (int k = 0; k < X::UPL; ++k)
    unit_to_f(*reinterpret_cast<const uint4*>(row + (l + k * X::LQ) * X::VEC), v + k * X::VEC, T());
}

// The same columns of an fp32 row (a cotangent), in float4s.
template <typename T, int D>
__device__ __forceinline__ void lane_row_f32(const float* row, int l, float (&v)[Lanes<T, D>::PER]) {
  using X = Lanes<T, D>;
#pragma unroll
  for (int k = 0; k < X::UPL; ++k)
#pragma unroll
    for (int e = 0; e < X::VEC; e += 4)
      unit_to_f(*reinterpret_cast<const uint4*>(row + (l + k * X::LQ) * X::VEC + e), v + k * X::VEC + e, 0.f);
}

// Writes the lane's PER fp32 values to those columns of `row`, fp32 or
// rounded to bf16 (one rounding, as a cast of the fp32 value), in units of up
// to 16 bytes.
template <typename T, int D>
__device__ __forceinline__ void store_lane_row(float* row, int l, const float (&v)[Lanes<T, D>::PER]) {
  using X = Lanes<T, D>;
#pragma unroll
  for (int k = 0; k < X::UPL; ++k)
#pragma unroll
    for (int e = 0; e < X::VEC; e += 4) {
      const float* a = v + k * X::VEC + e;
      *reinterpret_cast<float4*>(row + (l + k * X::LQ) * X::VEC + e) = make_float4(a[0], a[1], a[2], a[3]);
    }
}
template <typename T, int D>
__device__ __forceinline__ void store_lane_row(bf16* row, int l, const float (&v)[Lanes<T, D>::PER]) {
  using X = Lanes<T, D>;
#pragma unroll
  for (int k = 0; k < X::UPL; ++k) {
    uint32_t w[X::VEC / 2];
#pragma unroll
    for (int e = 0; e < X::VEC / 2; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[k * X::VEC + 2 * e], v[k * X::VEC + 2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    bf16* dst = row + (l + k * X::LQ) * X::VEC;
    if constexpr (X::VEC == 8)
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  }
}

// Stages `rows` rows of each of the block's `pb` problems from `first` on,
// read in place with element strides `st` (n, h, row; the last dim
// contiguous, each row 16-byte aligned), into dst[b][r] (row stride `ld`
// elements) by 16-byte cp.async; rows of problems past the end stay unset.
// The caller commits and waits.
template <typename E, int D>
__device__ __forceinline__ void stage_rows(E* dst, int ld, const E* __restrict__ src, const long long* st, int first,
                                           int pb, int problems, int heads, int rows) {
  constexpr int VE = 16 / int(sizeof(E)), UNITS = D / VE;
  for (int i = threadIdx.x; i < pb * rows * UNITS; i += blockDim.x) {
    const int b = i / (rows * UNITS), r = i - b * rows * UNITS, s = r / UNITS, u = r - s * UNITS;
    const int pr = first + b;
    if (pr < problems) {
      const int n = pr / heads, h = pr - n * heads;
      cp_async16(dst + (size_t(b) * rows + s) * ld + u * VE, src + n * st[0] + h * st[1] + s * st[2] + u * VE);
    }
  }
}

// One query's attention over its band: key j = 0..W is row j of kp and vp
// and entry j of mp ((segment, valid) pairs), ALiBi distance W - j.  Each
// band score is computed once (a dot over the lane's columns, a fixed-order
// sum over the LQ lanes by shuffles) and kept in registers: the maximum and
// the denominator from them (each exp(s_j - max) taken once, kept, and summed
// j ascending), then each weight w_j = exp(s_j - max) / denominator, written
// to prow where it is not null (lane l the keys j = l mod LQ), and summed
// into acc as sum_j w_j v_j in fp32 FMAs, j ascending: the plain version's
// order.  The keys go in groups of KG with no branch inside a group (a
// masked key's score is computed and dropped, its value added with weight
// 0; a group's keys past the band read the last key again), so that the
// group's loads, products and shuffles overlap.  A band wider than NB keys
// takes its scores in passes of NB with the denominator rescaled as the
// maximum rises, and computes them again for the weighted sum.  A query
// with no valid key has denominator 0 and gets exactly 0.
template <typename T, int D>
__device__ __forceinline__ void attend_band(const float (&q)[Lanes<T, D>::PER], const T* kp, const T* vp,
                                            const int2* mp, int W, int qs, float scale, bool use_alibi, float slope,
                                            int l, float* prow, float (&acc)[Lanes<T, D>::PER]) {
  using X = Lanes<T, D>;
  static_assert(NB % KG == 0 && NB % X::LQ == 0, "a pass holds whole groups, and lanes agree with keys mod LQ");
  const unsigned group = lane_group<X::LQ>();
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
        lane_row<T, D>(kp + min(j0 + g + e, W) * D, l, row);
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
        const int2 key = mp[min(j, W)];
        const bool ok = j <= W && key.x == qs && key.y;
        float s = dot[e] * scale;
        if (use_alibi) s -= slope * float(W - j);
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
        lane_row<T, D>(vp + min(j, W) * D, l, row);
#pragma unroll
        for (int d = 0; d < X::PER; ++d) acc[d] = fmaf(w, row[d], acc[d]);
      }
    }
  }
}

}  // namespace band

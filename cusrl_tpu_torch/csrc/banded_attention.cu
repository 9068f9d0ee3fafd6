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
// valid key gets exactly 0.  Any T >= 1 and any window W work: the query
// block need not divide T, and W may be below, at or above it.
//
// Design.  The TPU kernel walks a grid (N, H, query block, key block) with an
// online softmax carried in VMEM scratch over the 1 + ceil(W/BQ) key blocks
// of the band.  The port's K3f stages all W+T keys of a problem in shared
// memory, which does not scale to long T.  Here one block owns one
// (env, head, query block) of BQ queries (BQ = 128, fewer for a short T,
// halved while the band does not fit shared memory) and stages only the
// block's band: the BQ+W key and value rows [t0, t0+BQ+W) (cut at W+T), read
// once, coalesced, as 32-bit words into rows padded to an odd number of words
// (neighbouring queries read different banks), with the band's segments and
// validity beside them.  One thread per query keeps q (D floats) and the D
// output accumulators in registers and runs an fp32 online softmax over its
// W+1 keys (the running max is raised, and the sum and accumulators rescaled,
// only when a larger score arrives).  Nothing is written but the output.
//
// What bounds it on the H100: bytes.  At the long-rollout update's shape
// (256 envs x 4 heads, T = 256, W = 16, D = 32, bf16 in, fp32 out) it reads
// q, k and v (52.4 MB) and writes out (33.6 MB): about 26 us at 3.35 TB/s;
// the work is 2 x 2 x 17 x 32 FLOP per query (scores and the weighted sum),
// 0.57 GFLOP in fp32 on the CUDA cores, about 8.5 us at 67 TFLOP/s.  Each
// key row is read from device memory by the two query blocks whose bands
// hold it when W > 0 (W of every 128+W rows twice), every other byte once.
//
// Not yet done (later work): warp-cooperative dot products or tensor-core
// (mma/wgmma) tiles over the band, vector loads of q, cp.async/TMA staging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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
  int block_q;          // queries per block (threads), a multiple of 32
  float scale;          // D^-1/2
  float slopes[BANDED_MAX_HEADS];
};

namespace banded {

using bf16 = __nv_bfloat16;

constexpr size_t MAX_SMEM = 232448;  // the 227 KB a block may use

// 32-bit words of one staged key/value row: the row's words plus one, an odd
// count for every instantiated head dim (bf16: D/2 + 1; fp32: D + 1).
template <typename T, int D>
struct Row {
  static constexpr int WORDS = D * int(sizeof(T)) / 4;
  static constexpr int LD = WORDS + 1;
};

// The two bf16 values of a 32-bit word as floats (a bf16 is the high half of
// its fp32 value; the element at the lower address is the word's low half).
__device__ __forceinline__ void unpack(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* q, const uint32_t* row) {
  float acc = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int w = 0; w < D / 2; ++w) {
      float a, b;
      unpack(row[w], a, b);
      acc = fmaf(q[2 * w], a, acc);
      acc = fmaf(q[2 * w + 1], b, acc);
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) acc = fmaf(q[d], __uint_as_float(row[d]), acc);
  }
  return acc;
}

template <typename T, int D>
__device__ __forceinline__ void axpy_row(float w, const uint32_t* row, float* acc) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      float a, b;
      unpack(row[i], a, b);
      acc[2 * i] = fmaf(w, a, acc[2 * i]);
      acc[2 * i + 1] = fmaf(w, b, acc[2 * i + 1]);
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(w, __uint_as_float(row[d]), acc[d]);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// K7f.  Grid (N*H problems, query blocks); block: block_q threads, one query each.
template <typename T, int D>
__global__ void banded_fwd_kernel(const BandedParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using R = Row<T, D>;
  const int bq = p.block_q, W = p.window, tl = p.t_len, S = W + tl;
  const int pr = blockIdx.x, t0 = blockIdx.y * bq;
  const int n = pr / p.heads, h = pr % p.heads;
  const int rows = min(bq + W, S - t0);  // the band: combined keys [t0, t0 + rows)
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem);
  uint32_t* vs = ks + size_t(bq + W) * R::LD;
  int* segs = reinterpret_cast<int*>(vs + size_t(bq + W) * R::LD);
  int* valid = segs + (bq + W);

  // Stage the band, coalesced: rows*WORDS consecutive words of k and of v.
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(p.k) + (size_t(pr) * S + t0) * R::WORDS;
  const uint32_t* vw = reinterpret_cast<const uint32_t*>(p.v) + (size_t(pr) * S + t0) * R::WORDS;
  for (int i = threadIdx.x; i < rows * R::WORDS; i += blockDim.x) {
    const int r = i / R::WORDS, w = i % R::WORDS;
    ks[r * R::LD + w] = kw[i];
    vs[r * R::LD + w] = vw[i];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    segs[r] = p.k_seg[size_t(n) * S + t0 + r];
    valid[r] = p.k_valid[size_t(n) * S + t0 + r] > 0;
  }
  __syncthreads();

  const int local = threadIdx.x, t = t0 + local;
  if (t >= tl) return;
  float q[D];
  const T* qrow = static_cast<const T*>(p.q) + (size_t(pr) * tl + t) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = to_f(qrow[d]);
  const int qs = p.q_seg[size_t(n) * tl + t];
  const float slope = p.use_alibi ? p.slopes[h] : 0.f;

  float m = -INFINITY, l = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int j = 0; j <= W; ++j) {
    const int r = local + j;  // combined key t + j, row r of the band
    if (segs[r] != qs || !valid[r]) continue;
    float s = dot_row<T, D>(q, ks + size_t(r) * R::LD) * p.scale;
    if (p.use_alibi) s -= slope * float(W - j);
    if (s > m) {  // a new running max: rescale what was summed so far
      const float a = expf(m - s);
      l *= a;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= a;
      m = s;
    }
    const float e = expf(s - m);
    l += e;
    axpy_row<T, D>(e, vs + size_t(r) * R::LD, acc);
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float4* orow = reinterpret_cast<float4*>(p.out + (size_t(pr) * tl + t) * D);
#pragma unroll
  for (int d = 0; d < D; d += 4) orow[d / 4] = make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv,
                                                          acc[d + 3] * inv);
}

// Dynamic shared memory of one block: the band's k and v rows and two ints
// per key (mirrored by banded_attention.py:smem_bytes).
template <typename T, int D>
size_t smem_bytes(int block_q, int window) {
  const size_t rows = size_t(block_q) + window;
  return rows * (2 * 4 * size_t(Row<T, D>::LD) + 2 * sizeof(int));
}

template <typename T, int D>
cudaError_t launch(const BandedParams& p, cudaStream_t stream) {
  if (p.block_q <= 0 || p.block_q % 32 || p.block_q > 1024 || p.t_len <= 0 || p.window < 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, D>(p.block_q, p.window);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int problems = p.n * p.heads;
  const int q_blocks = (p.t_len + p.block_q - 1) / p.block_q;
  if (q_blocks > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(banded_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  banded_fwd_kernel<T, D><<<dim3(problems, q_blocks), p.block_q, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const BandedParams& p, cudaStream_t stream) {
  switch (p.dim) {
    case 8: return launch<T, 8>(p, stream);
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace banded

extern "C" const char* banded_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues K7f on `stream` and returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int banded_attention_fwd(const BandedParams* p, void* stream) {
  if (p->n <= 0 || p->heads <= 0 || p->heads > BANDED_MAX_HEADS) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(p->is_bf16 ? banded::dispatch_dim<banded::bf16>(*p, s) : banded::dispatch_dim<float>(*p, s));
}

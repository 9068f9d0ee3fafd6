// Hopper (sm_90a) building blocks for persistent, warp-specialised kernels:
// mbarriers, bulk copies into shared memory, warpgroup products (wgmma) on
// 128-byte-swizzled K-major bf16 operands, the swizzled tile layout those
// operands live in, the weight images (the pack) and the accumulator
// epilogues.  Used by the fused block's forwards and backwards
// (fused_block.cu, fbf, fbp and fbb) and the MLP chain's forward, backward
// and single-launch PPO step (mlp_chain.cuh and mlp_chain_fwd.cu, mlpf;
// mlp_chain_bwd.cu, mlpb and mlpm).
//
// Tile layout ("swizzled tile"): a bf16 matrix of R rows is kept in K blocks
// of 64 columns; block b holds R rows of 128 bytes at b * R * 128, and the
// 16-byte chunk c (columns 8c .. 8c + 7 of the block) of row r sits at chunk
// c ^ (r % 8) of that row.  This is the layout TMA's 128-byte swizzle writes
// and the one a wgmma descriptor with layout type 1 (SWIZZLE_128B) reads,
// with 8-row groups 1,024 bytes apart.  Every tile starts 1,024-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int TILE_M = 64;                      // rows of one warpgroup product
constexpr int KBLOCK = 64;                      // bf16 columns per swizzled row block (128 bytes)
constexpr int STAGE_N = 128;                    // weight rows (output columns) per stage image
constexpr int STAGE_BYTES = STAGE_N * KBLOCK * 2;  // 16 KB: one [128][64] bf16 weight slice
constexpr int ABLOCK_BYTES = TILE_M * KBLOCK * 2;  // 8 KB: one K block of a 64-row tile
constexpr int SM_SMEM = 233472;                     // shared memory of one SM
constexpr int BLOCK_SMEM = 232448;                  // the most one block may use
constexpr int SLOT_COST = STAGE_BYTES + 16;         // a ring slot and its two barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, col) in a swizzled tile of 64 rows.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (col >> 6) * ABLOCK_BYTES + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1);
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory"); }

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Waits until the phase with this parity has completed.  The loop lives in
// the PTX, so the compiler sees no divergent path next to the products; a
// wait that lasts 2^34 cycles (about 9 s) traps, so that a broken pipeline
// fails its launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 17179869184;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Arrives on `bar` from the threads with `pred` set (a predicated
// instruction, no branch).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(static_cast<int>(pred))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory; completion counts against `bar`'s transactions.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands).
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }

// Barrier over the 128 threads of one warpgroup (named barrier `id` >= 1).
__device__ __forceinline__ void wg_sync(int id) { asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory"); }

// Barrier over `threads` threads (several warpgroups; named barrier `id` >= 1).
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma --------------------------------------------------------------

// Descriptor of a K-major operand in the swizzled layout starting at shared
// address `addr`: 8-row groups 1,024 bytes apart (SBO), 128-byte swizzle.
// Stepping 16 columns of K inside a 64-column block adds 32 bytes to `addr`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous product.
template <int NA>
__device__ __forceinline__ void fence_regs(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] B[128 x 16]^T, bf16 operands from shared memory,
// fp32 accumulators in registers.  Thread t of the warpgroup (warp w = t / 32,
// lane l) holds d[4j + 2h + e] = D[16w + l / 4 + 8h][8j + 2(l % 4) + e].
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[64 x 16]^T: as wgmma_m64n128k16 on half the
// columns (d[4j + 2h + e], j < 8).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[32 x 16]^T (d[4j + 2h + e], j < 4).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The product of NA accumulators per thread: 128 (NA = 64), 64 (NA = 32) or
// 32 (NA = 16) output columns, B's rows from its descriptor on.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  wgmma_m64n128k16(d, desc_a, desc_b);
}
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  wgmma_m64n64k16(d, desc_a, desc_b);
}
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  wgmma_m64n32k16(d, desc_a, desc_b);
}

// d[64 x 128] += A B with both operands MN-major (the transposed forms, imm-trans-a
// and imm-trans-b set): A[m][k] at m of K row k, B[k][n] at n of K row k, as
// row-major [K, M] and [K, N] tiles load (dw_phase2.cuh).  The accumulators
// lie as wgmma_m64n128k16's.
__device__ __forceinline__ void wgmma_mn(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x 64] += A B, MN-major operands: as above on 64 columns.
__device__ __forceinline__ void wgmma_mn(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x 256] += A B, MN-major operands: as above on 256 columns.
__device__ __forceinline__ void wgmma_mn(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ---- a ring of weight stages --------------------------------------------

// Stage images of STAGE_BYTES stream from device memory through `slots`
// ring buffers: `full[s]` completes when slot s holds its next image (one
// producer arrival plus the copy's bytes), `empty[s]` when every consumer
// warp has finished reading it.  When all `per_tile` images of a tile fit
// (`resident`), each is loaded once and stays for every tile of the block.
struct Ring {
  uint32_t base;  // shared address of slot 0
  uint64_t* full;
  uint64_t* empty;
  int slots;
  int resident;
  uint32_t next;  // index of the next image consumed (per tile when resident)
};

// The ring of a block at `ring_off` of `smem`, its barriers at `bar_off`:
// thread 0 initialises them (full: the producer's arrival; empty: every
// consumer warp's), which the block's first barrier publishes.
__device__ __forceinline__ Ring make_ring(unsigned char* smem, int ring_off, int bar_off, int slots, int resident,
                                         int consumer_warps) {
  Ring r;
  r.base = smem_u32(smem + ring_off);
  r.full = reinterpret_cast<uint64_t*>(smem + bar_off);
  r.empty = r.full + slots;
  r.slots = slots;
  r.resident = resident;
  r.next = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], consumer_warps);
    }
    mbar_fence_init();
  }
  return r;
}

// The ring of a chain kernel (mlp_chain_fwd.cu, mlp_chain_bwd.cu) beside
// `fixed` bytes of shared memory per block: resident (a slot per image)
// before streamed (at least 2 slots: wg::issue keeps one image in flight),
// and for each two blocks per SM before one, unless the launch has no more
// tiles than SMs (`few_tiles`).  Returns the slots (-1: none fits) and sets
// per_sm.  Mirrored by weight_images.py (_ring).
inline int ring_slots(int per_tile, int fixed, bool few_tiles, int& per_sm) {
  for (int pass = 0; pass < 2; ++pass) {
    for (per_sm = few_tiles ? 1 : 2; per_sm >= 1; --per_sm) {
      const int fit = (std::min(BLOCK_SMEM, SM_SMEM / per_sm - 1024) - 1024 - fixed) / SLOT_COST;
      if (pass == 0 && fit >= per_tile) return per_tile;
      if (pass == 1 && fit >= 2) return fit;
    }
  }
  return -1;
}

// The producer thread: loads the images of `tiles` tiles in order.
__device__ __forceinline__ void produce(const Ring& r, unsigned char* ring_ptr, const unsigned char* images,
                                        int per_tile, int tiles) {
  if (r.resident) {
    for (int s = 0; s < per_tile; ++s) {
      mbar_expect_tx(&r.full[s], STAGE_BYTES);
      bulk_load(ring_ptr + s * STAGE_BYTES, images + size_t(s) * STAGE_BYTES, STAGE_BYTES, &r.full[s]);
    }
    return;
  }
  uint32_t g = 0;
  for (int t = 0; t < tiles; ++t) {
    for (int s = 0; s < per_tile; ++s, ++g) {
      const int slot = g % r.slots;
      const uint32_t use = g / r.slots;
      if (use > 0) mbar_wait(&r.empty[slot], (use - 1) & 1);
      mbar_expect_tx(&r.full[slot], STAGE_BYTES);
      bulk_load(ring_ptr + slot * STAGE_BYTES, images + size_t(s) * STAGE_BYTES, STAGE_BYTES, &r.full[slot]);
    }
  }
}

// Hands image g's slot back to the producer (every consumer warp arrives).
__device__ __forceinline__ void release(const Ring& r, uint32_t g) {
  mbar_arrive_if(&r.empty[g % r.slots], !r.resident && (threadIdx.x & 31) == 0);
}

// The products of one weight image: waits for it, then d += A[:, 64 kb .. 64 kb
// + 64) W^T in four k16 steps (the fence follows the wait, so the compiler
// needs none of its own after the wait's loop).  From the second image of a
// chunk on, the previous image is released once its products are done.  With
// NA < 64 the product takes NA * 2 of the image's rows, from byte b_off (a
// multiple of 1,024: whole 8-row groups) on.
template <int NA>
__device__ __forceinline__ void issue_block(float (&d)[NA], uint32_t a, int kb, Ring& r, uint32_t b_off) {
  const int slot = r.next % r.slots;
  mbar_wait(&r.full[slot], (r.next / r.slots) & 1);
  wgmma_fence();
  const uint32_t b = r.base + slot * STAGE_BYTES + b_off;
#pragma unroll
  for (int kk = 0; kk < KBLOCK / 16; ++kk)
    wgmma(d, desc_sw128(a + kb * ABLOCK_BYTES + kk * 32), desc_sw128(b + kk * 32));
  wgmma_commit();
  if (kb > 0) {
    wgmma_wait<1>();
    release(r, r.next - 1);
  }
  ++r.next;
}

template <int BLOCKS, int NA>
__device__ __forceinline__ void issue_blocks(float (&d)[NA], uint32_t a, Ring& r, uint32_t b_off) {
#pragma unroll
  for (int kb = 0; kb < BLOCKS; ++kb) issue_block(d, a, kb, r, b_off);
}

// Issues d += A[:, 0:K] W^T for one 128-column chunk of the output, taking
// the chunk's ceil(K / 64) weight images from the ring in order; `a` is the
// shared address of the swizzled 64-row A tile, whose columns from K up to
// the next multiple of 64 hold 0 (as the images' do), so that every image
// takes four k16 steps without a branch between the products.  Each image
// but the last is released as soon as its products are done, so a chunk may
// take more images than the ring has slots; `finish` waits for the last
// products and releases the last image.  One and two images (every product
// at the zoo's widths) have bodies of their own, without a loop.
template <int NA>
__device__ __forceinline__ void issue(float (&d)[NA], uint32_t a, int K, Ring& r, uint32_t b_off = 0) {
  const int blocks = (K + KBLOCK - 1) / KBLOCK;
  fence_regs(d);
  if (blocks == 2) {
    issue_blocks<2>(d, a, r, b_off);
  } else if (blocks == 1) {
    issue_blocks<1>(d, a, r, b_off);
  } else {
    for (int kb = 0; kb < blocks; ++kb) issue_block(d, a, kb, r, b_off);
  }
}

template <int NA>
__device__ __forceinline__ void finish(float (&d)[NA], Ring& r) {
  wgmma_wait<0>();
  fence_regs(d);
  release(r, r.next - 1);
}

// ---- tiles in and out ---------------------------------------------------

// Rows [row0, row0 + 64) of a row-major [n_rows, width] fp32 or bf16 matrix
// into a swizzled bf16 tile, four columns per access by the 128 threads of a
// warpgroup (`t` = thread in the warpgroup); rows past the end, and columns
// from `width` to the next multiple of 64, are 0.  Four loads are in flight
// per thread before their stores (more cost the post kernel registers).
__device__ __forceinline__ void load_rows(const void* src, bool is_bf16, int width, int row0, int n_rows,
                                          unsigned char* tile, int t) {
  constexpr int BATCH = 4;
  const int quads = ((width + KBLOCK - 1) / KBLOCK) * (KBLOCK / 4), total = TILE_M * quads;
  for (int base = t; base < total; base += BATCH * 128) {
    float4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * 128;
      const int m = i / quads;
      const int col = (i - m * quads) * 4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && row0 + m < n_rows && col < width) {
        const size_t idx = size_t(row0 + m) * width + col;
        if (is_bf16) {
          const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(src) + idx);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          v[u] = make_float4(lo.x, lo.y, hi.x, hi.y);
        } else {
          v[u] = *reinterpret_cast<const float4*>(static_cast<const float*>(src) + idx);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = base + u * 128;
      if (i < total) {
        const int m = i / quads;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[u].x, v[u].y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[u].z, v[u].w);
        uint2 packed;
        packed.x = *reinterpret_cast<const uint32_t*>(&lo);
        packed.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(tile + swz(m, (i - m * quads) * 4)) = packed;
      }
    }
  }
}

// Columns [0, cols) (a multiple of 8) of a swizzled 64-row bf16 tile to rows
// [row0, row0 + 64) of `dst` (leading dimension ld), columns col0 onwards,
// as 16-byte stores; rows past n_rows are skipped.
__device__ __forceinline__ void store_rows(const unsigned char* tile, int cols, bf16* dst, int ld, int col0, int row0,
                                           int n_rows, int t) {
  const int units = cols >> 3;
  for (int i = t; i < TILE_M * units; i += 128) {
    const int m = i / units, u = i - m * units;
    if (row0 + m < n_rows) {
      const uint4 v = *reinterpret_cast<const uint4*>(tile + (u >> 3) * ABLOCK_BYTES + m * 128 + (((u & 7) ^ (m & 7)) << 4));
      *reinterpret_cast<uint4*>(dst + size_t(row0 + m) * ld + col0 + u * 8) = v;
    }
  }
}

__device__ __forceinline__ void put2(unsigned char* tile, int row, int col, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(tile + swz(row, col)) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 get2(const unsigned char* tile, int row, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + swz(row, col)));
}

// ---- weight images (the pack) -------------------------------------------

// A weight image is rows [n0, n0 + 128) and columns [k0, k0 + 64) of one
// matrix, bf16 in the swizzled layout (STAGE_BYTES, wgmma's B operand), 0
// past the matrix.  A Pack lists the images of one kernel in the order it
// takes them, and the matrices they come from: matrix m stacks the fp32
// [out, in] weights w[first[m]], w[first[m] + 1], ... of seg[m] rows each,
// rows[m] x cols[m] in all; or, with trans[m], it is the transpose of the one
// weight w[first[m]] ([cols[m], rows[m]] as stored): a backward's data
// product d_in = d_out W takes B(k = out, n = in) = W[k][n], whose K-major
// image is one of W^T.  The images are made afresh on every call (an
// optimizer updates the weights in place).  Mirrored by
// nn/kernels/weight_images.py (pack_plain).
constexpr int PACK_MAX_STAGES = 256;  // an 8-layer chain of 512-wide layers
constexpr int PACK_MAX_MATS = 8;
constexpr int PACK_UNITS = STAGE_N * 8;  // 16-byte units of one image
constexpr int PACK_THREADS = 256, PACK_SPLIT = PACK_UNITS / PACK_THREADS;  // a pack kernel's block and grid.z

struct Stage {
  int16_t mat, n0, k0;
};

struct Pack {
  int count;
  Stage st[PACK_MAX_STAGES];
  int first[PACK_MAX_MATS], seg[PACK_MAX_MATS], rows[PACK_MAX_MATS], cols[PACK_MAX_MATS], trans[PACK_MAX_MATS];
};

__host__ __device__ constexpr int kblocks(int k) { return (k + KBLOCK - 1) / KBLOCK; }
__host__ __device__ constexpr int nchunks(int n) { return (n + STAGE_N - 1) / STAGE_N; }
__host__ __device__ constexpr int pad64(int n) { return (n + KBLOCK - 1) & ~(KBLOCK - 1); }

inline void pack_add(Pack& P, int mat, int n0, int k0) {
  P.st[P.count++] = Stage{static_cast<int16_t>(mat), static_cast<int16_t>(n0), static_cast<int16_t>(k0)};
}

inline void pack_matrix(Pack& P, int m, int first, int seg, int rows, int cols, int trans = 0) {
  P.first[m] = first;
  P.seg[m] = trans ? rows : seg;
  P.rows[m] = rows;
  P.cols[m] = cols;
  P.trans[m] = trans;
}

// The eight fp32 weights of unit u (image row u / 8, logical 16-byte chunk
// u % 8) of image s, 0 past the matrix; 16-byte loads where the row allows.
__device__ __forceinline__ void pack_load(const Pack& P, const void* const* w, int s, int u, float (&v)[8]) {
  const Stage st = P.st[s];
  const int m = st.mat, cols = P.cols[m];
  const int row = st.n0 + (u >> 3), col0 = st.k0 + (u & 7) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (row < P.rows[m] && col0 < cols && P.trans[m]) {  // column `row` of the stored weight, 8 of its rows
    const float* src = static_cast<const float*>(w[P.first[m]]) + size_t(col0) * P.rows[m] + row;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = src[size_t(e) * P.rows[m]];
  } else if (row < P.rows[m] && col0 < cols) {  // cols is a multiple of 16: the unit is whole
    const int q = row / P.seg[m];
    const float* src = static_cast<const float*>(w[P.first[m] + q]) + size_t(row - q * P.seg[m]) * cols + col0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4 a = *reinterpret_cast<const float4*>(src), b = *reinterpret_cast<const float4*>(src + 4);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = src[e];
    }
  }
}

// Those eight values as bf16 into their swizzled place in `img` (the image's
// first byte, in device or shared memory).
__device__ __forceinline__ void pack_store(const float (&v)[8], int u, unsigned char* img) {
  const int n = u >> 3, ch = u & 7;
  uint32_t words[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    words[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(img + n * 128 + ((ch ^ (n & 7)) << 4)) = make_uint4(words[0], words[1], words[2], words[3]);
}

// Unit u of image s from the weights `w` into `img`.
__device__ __forceinline__ void pack_unit(const Pack& P, const void* const* w, int s, int u, unsigned char* img) {
  float v[8];
  pack_load(P, w, s, u, v);
  pack_store(v, u, img);
}

// Every image of P once, image s into the slot at smem + s * STAGE_BYTES
// (a resident ring), by the nt threads of a block (t of them), four units in
// flight each; then the writes are made visible to wgmma.
__device__ __forceinline__ void convert_images(const Pack& P, const void* const* w, unsigned char* smem, int t, int nt) {
  const int total = P.count * PACK_UNITS;
  for (int base = t; base < total; base += 4 * nt) {
    float v[4][8];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = base + b * nt;
      if (i < total) pack_load(P, w, i / PACK_UNITS, i % PACK_UNITS, v[b]);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = base + b * nt;
      if (i < total) pack_store(v[b], i % PACK_UNITS, smem + (i / PACK_UNITS) * STAGE_BYTES);
    }
  }
  fence_async_smem();
}

// ---- accumulator epilogues ------------------------------------------------

// Where thread t of a consumer warpgroup holds the accumulators: d[4j], d[4j + 1]
// at (row, 8j + col), (row, 8j + col + 1); d[4j + 2], d[4j + 3] at row + 8.
struct Frag {
  int row, col;
  __device__ explicit Frag(int t) : row((t >> 5) * 16 + ((t & 31) >> 2)), col((t & 3) * 2) {}
};

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16(v)); }

// a, b = bf16(a), bf16(b), kept as fp32, by one packed conversion.
__device__ __forceinline__ void bf16r2(float& a, float& b) {
  const float2 h = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  a = h.x;
  b = h.y;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int NA>
__device__ __forceinline__ void zero(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) d[i] = 0.f;
}

// d = bf16(d + bias[col]) on the first `cols` columns, kept as fp32 (the
// accumulators are touched without a branch; the bias is read only where it
// exists).
template <int NA>
__device__ __forceinline__ void add_bias_round(float (&d)[NA], const float* bias, int cols, const Frag& f) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const bool valid = 8 * j < cols;
    const float b0 = valid ? bias[8 * j + f.col] : 0.f, b1 = valid ? bias[8 * j + f.col + 1] : 0.f;
    float a0 = d[4 * j] + b0, a1 = d[4 * j + 1] + b1, c0 = d[4 * j + 2] + b0, c1 = d[4 * j + 3] + b1;
    bf16r2(a0, a1);
    bf16r2(c0, c1);
    d[4 * j] = valid ? a0 : d[4 * j];
    d[4 * j + 1] = valid ? a1 : d[4 * j + 1];
    d[4 * j + 2] = valid ? c0 : d[4 * j + 2];
    d[4 * j + 3] = valid ? c1 : d[4 * j + 3];
  }
}

// The first `cols` columns of d into a swizzled bf16 tile, from column col0.
template <int NA>
__device__ __forceinline__ void to_tile(const float (&d)[NA], int cols, unsigned char* tile, const Frag& f,
                                        int col0 = 0) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    if (8 * j < cols) {
      put2(tile, f.row, col0 + 8 * j + f.col, d[4 * j], d[4 * j + 1]);
      put2(tile, f.row + 8, col0 + 8 * j + f.col, d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// The first `cols` (a multiple of 16) columns of d as bf16 rows of dst
// (leading dimension ld, from column col0), 16-byte stores from registers:
// per pair of 8-column chunks the four threads of a quad transpose their
// 32-bit words in two rounds of shuffles, after which thread t holds the
// eight columns of chunk 2q + t / 2 in row `row` (+ 8 for odd t).
template <int NA>
__device__ __forceinline__ void store_bf16(const float (&d)[NA], int cols, bf16* dst, int ld, int col0, int row0,
                                           int n_rows, const Frag& f) {
  const bool odd = threadIdx.x & 1, hi = threadIdx.x & 2;
  const int row = row0 + f.row + (odd ? 8 : 0);
#pragma unroll
  for (int q = 0; q < NA / 8; ++q) {
    if (16 * q < cols) {
      const int a = 8 * q, b = a + 4;  // accumulators of chunks 2q and 2q + 1
      const uint32_t m0 = pack2(d[a], d[a + 1]), m1 = pack2(d[a + 2], d[a + 3]);
      const uint32_t m2 = pack2(d[b], d[b + 1]), m3 = pack2(d[b + 2], d[b + 3]);
      const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? m0 : m1, 1);
      const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? m2 : m3, 1);
      const uint32_t p0 = odd ? r0 : m0, p1 = odd ? m1 : r0, p2 = odd ? r1 : m2, p3 = odd ? m3 : r1;
      const uint32_t v0 = __shfl_xor_sync(0xffffffffu, hi ? p0 : p2, 2);
      const uint32_t v1 = __shfl_xor_sync(0xffffffffu, hi ? p1 : p3, 2);
      const uint4 out = hi ? make_uint4(v0, v1, p2, p3) : make_uint4(p0, p1, v0, v1);
      if (row < n_rows) *reinterpret_cast<uint4*>(dst + size_t(row) * ld + col0 + 16 * q + (hi ? 8 : 0)) = out;
    }
  }
}

// The first `cols` columns of d as fp32 rows of dst (leading dimension ld,
// from column col0), 16-byte stores: the two threads of a pair swap halves
// so that the even one holds four columns of `row`, the odd one four of
// `row + 8`.
template <int NA>
__device__ __forceinline__ void store_f32(const float (&d)[NA], int cols, float* dst, int ld, int col0, int row0,
                                          int n_rows, const Frag& f) {
  const bool odd = threadIdx.x & 1;
  const int row = row0 + f.row + (odd ? 8 : 0);
  const int col = col0 + f.col - (odd ? 2 : 0);
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    if (8 * j < cols) {
      const float s0 = odd ? d[4 * j] : d[4 * j + 2], s1 = odd ? d[4 * j + 1] : d[4 * j + 3];
      const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1), r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      const float4 v = odd ? make_float4(r0, r1, d[4 * j + 2], d[4 * j + 3]) : make_float4(d[4 * j], d[4 * j + 1], r0, r1);
      if (row < n_rows) *reinterpret_cast<float4*>(dst + size_t(row) * ld + 8 * j + col) = v;
    }
  }
}

// The bf16 pairs of a row-major [n_rows, ld] matrix at the accumulators'
// places, columns col0 onwards (the first `cols` of them; 0 elsewhere and
// past the end), one 4-byte load each: v[i / 2] holds accumulator i's value
// (pair_at), half the registers of fp32 values.
template <int NA>
__device__ __forceinline__ void load_pairs(const bf16* src, int ld, int col0, int cols, int row0, int n_rows,
                                           const Frag& f, uint32_t (&v)[NA / 2]) {
  const int ra = row0 + f.row, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    uint32_t a = 0u, b = 0u;
    if (8 * j < cols) {
      const bf16* p = src + col0 + 8 * j + f.col;
      if (ra < n_rows) a = *reinterpret_cast<const uint32_t*>(p + size_t(ra) * ld);
      if (rb < n_rows) b = *reinterpret_cast<const uint32_t*>(p + size_t(rb) * ld);
    }
    v[2 * j] = a;
    v[2 * j + 1] = b;
  }
}

// The bf16 pairs of a swizzled 64-row tile at the accumulators' places, as
// load_pairs gives them from device memory (columns col0 onwards, the first
// `cols` of them; 0 elsewhere).
template <int NA>
__device__ __forceinline__ void tile_pairs(const unsigned char* tile, int col0, int cols, const Frag& f,
                                           uint32_t (&v)[NA / 2]) {
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const bool in = 8 * j < cols;
    const int col = col0 + 8 * j + f.col;
    v[2 * j] = in ? *reinterpret_cast<const uint32_t*>(tile + swz(f.row, col)) : 0u;
    v[2 * j + 1] = in ? *reinterpret_cast<const uint32_t*>(tile + swz(f.row + 8, col)) : 0u;
  }
}

template <int N>
__device__ __forceinline__ float pair_at(const uint32_t (&v)[N], int i) {
  return __uint_as_float(i & 1 ? v[i >> 1] & 0xffff0000u : v[i >> 1] << 16);
}

// Column sums over a warpgroup's 64 rows of values value(i) at the
// accumulators' places (i < NA), first `cols` columns, in two halves: each
// thread adds its two rows and the eight lanes that share a column add by
// shuffles, the four warps' sums going to `red` ([4][2 NA] floats of shared
// memory, this warpgroup's own, one set); then col_combine adds the four
// warps' sums of each column in warp order.  A fixed order, no atomics.
template <int NA, class Value>
__device__ __forceinline__ void col_partials(const Value& value, int cols, float* red, const Frag& f, int t) {
  const int warp = t >> 5;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    if (8 * j < cols) {
      float s0 = value(4 * j) + value(4 * j + 2), s1 = value(4 * j + 1) + value(4 * j + 3);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if ((t & 31) < 4) {
        red[warp * 2 * NA + 8 * j + f.col] = s0;
        red[warp * 2 * NA + 8 * j + f.col + 1] = s1;
      }
    }
  }
}

// After the warpgroup's barrier, S sets of partials (set s at red + s * 8 NA)
// into out[s][0 .. cols).  `red` may be written again after a later barrier
// of the warpgroup.
template <int NA, int S>
__device__ __forceinline__ void col_combine(int cols, const float* red, float* const (&out)[S], int t, int bar) {
  wg_sync(bar);
  for (int q = t; q < S * cols; q += 128) {
    const int s = q / cols, c = q - s * cols;
    const float* r = red + s * 8 * NA;
    out[s][c] = ((r[c] + r[2 * NA + c]) + r[4 * NA + c]) + r[6 * NA + c];
  }
}

// S sets of values value(s, i), into out[s][0 .. cols), through `red`
// ([S][4][2 NA] floats): one pair of barriers for the S sets.  `bar`: the
// warpgroup's named barrier; `t`: the thread in the warpgroup.
template <int NA, int S, class Value>
__device__ __forceinline__ void col_sums(const Value& value, int cols, float* red, float* const (&out)[S],
                                         const Frag& f, int t, int bar) {
#pragma unroll
  for (int s = 0; s < S; ++s) col_partials<NA>([&](int i) { return value(s, i); }, cols, red + s * 8 * NA, f, t);
  col_combine<NA, S>(cols, red, out, t, bar);
  wg_sync(bar);  // red is free for the next sums
}

// One set: value(i), into out[0 .. cols).
template <int NA, class Value>
__device__ __forceinline__ void col_sums(const Value& value, int cols, float* red, float* out, const Frag& f, int t,
                                         int bar) {
  float* const outs[1] = {out};
  col_sums<NA, 1>([&](int, int i) { return value(i); }, cols, red, outs, f, t, bar);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [row0, row0 + 64) of x ([n_rows, width], fp32 or bf16, 16-byte aligned
// rows) into a swizzled bf16 tile, one 16-byte chunk of the tile (8 columns)
// per unit, by the NT threads (`t` of them); rows past the end, and columns
// from `width` to the next multiple of 64, are 0.  B units are in flight per
// thread before their stores.
template <bool BF16, int B, int NT>
__device__ __forceinline__ void load_x(const void* src, int width, int row0, int n_rows, unsigned char* tile, int t) {
  const int units = pad64(width) / 8, total = TILE_M * units;
  for (int base = t; base < total; base += B * NT) {
    uint4 v[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = base + u * NT;
      const int m = i / units, col = (i - m * units) * 8;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && row0 + m < n_rows && col < width) {
        const size_t idx = size_t(row0 + m) * width + col;
        if (BF16) {
          v[u] = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(src) + idx);
        } else {
          const float4 a = *reinterpret_cast<const float4*>(static_cast<const float*>(src) + idx);
          const float4 b = *reinterpret_cast<const float4*>(static_cast<const float*>(src) + idx + 4);
          v[u] = make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = base + u * NT;
      if (i < total) {
        const int m = i / units;
        *reinterpret_cast<uint4*>(tile + swz(m, (i - m * units) * 8)) = v[u];
      }
    }
  }
}

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The warp's index, broadcast from lane 0 so that the compiler knows it is
// the same across the warp (the roles and warpgroups branch on it).
__device__ __forceinline__ int warp_index() { return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0); }

}  // namespace wg

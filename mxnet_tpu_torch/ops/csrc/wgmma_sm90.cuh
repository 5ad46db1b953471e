// Hopper (sm_90a) building blocks: TMA tile loads and stores, mbarriers,
// wgmma.
//
// Small inline-PTX primitives for kernels that stream tiles into shared
// memory with the Tensor Memory Accelerator (tiled boxes, and the im2col
// boxes of a convolution), multiply them with warpgroup MMAs (wgmma:
// 16-bit types into fp32, s8 into s32) and store result tiles back with
// TMA, and the host side that encodes the TMA tensor maps. Nothing here is
// specific to attention.
//
// Shared-memory tiles. A 16-bit (rows, 64) box loaded by TMA with 128-byte
// swizzle lies as `rows` rows of 128 bytes, 16-byte chunk j of row r stored
// at chunk j ^ (r % 8); the pattern repeats every 8 rows (1024 bytes), so a
// tile starts on a 1024-byte boundary. Wider matrices are cut into 64-column
// boxes placed one after the other ("chunks").
//
// wgmma operands in such tiles (`smem_desc`):
//   K-major (the reduction index runs along the 128-byte row; A, or B of
//   x y^T): stride between 8-row groups 1024 bytes; the k16 step kk of a
//   chunk starts 32 * kk bytes into the row.
//   MN-major (the reduction index runs down the rows; B of x y with y
//   stored (k, n) row major): the k16 step kk starts 16 * kk rows down,
//   2048 * kk bytes, with 1024 bytes between its two 8-row groups; n = 64
//   is one chunk. The instruction's transpose bit (TB = 1) selects it,
//   which 16-bit types allow.
// Register A (`wgmma_rs`): warp w of the warpgroup holds rows 16w..16w+15
// of the 64-row A slab in mma.sync's m16n8k16 A layout, which is also the
// layout of the fp32 accumulator of two neighbouring 8-column blocks: so an
// accumulator, rounded to 16 bits by `pack_a` (mma_sm90.cuh), is the A
// operand of a following product.
// Accumulator (m64nN, N/2 floats a thread): element 4j + e of warp w, lane
// 4g + c holds row 16w + g + 8 (e >> 1), column 8j + 2c + (e & 1).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxt {
namespace sm90 {

// -- shared memory, mbarriers -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); follow
// with a CTA-wide barrier before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` more of TMA traffic this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Expect `bytes` more of TMA traffic this phase, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 2^x by the special-function unit (ex2.approx, relative error about
// 2^-22; subnormal results flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- TMA -----------------------------------------------------------------

// The box of `map` at coordinates (c0, c1, c2), innermost first, into
// shared memory at dst; completes `bytes` of the transaction on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The im2col box of a 4-D (c, w, h, n) `map` (`encode_im2col_4d`): the
// map's pixels-per-column pixels, channels c .. c + channels-per-pixel - 1
// of each, walked from pixel (w, h, n) along w, then h, then n inside the
// map's bounding box, each read at (w + dw, h + dh); pixels and channels
// outside the tensor read as zero.
__device__ __forceinline__ void tma_load_im2col_4d(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c,
                                                   int w, int h, int n,
                                                   int dw, int dh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c),
      "r"(w), "r"(h), "r"(n), "h"((uint16_t)dw), "h"((uint16_t)dh)
      : "memory");
}

// The shared-memory box at src into the box of `map` at coordinates (c0,
// c1, c2); elements outside the tensor are not written. Completion is
// tracked by bulk groups: commit with `bulk_commit`, and wait with
// `bulk_wait_read` before src is written again or the CTA exits. The
// threads that wrote src issue `fence_proxy_async` first, and the issuing
// thread is ordered after them (an mbarrier).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory writes before later async-proxy
// (TMA) operations that read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma ----------------------------------------------------------------

enum Swizzle : int { kSwizzle128 = 1, kSwizzle64 = 2, kSwizzle32 = 3 };

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units in the descriptor), swizzle mode. Tiles start on a
// 1024-byte boundary, so the base offset field stays 0.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo,
                                              int swizzle = kSwizzle128) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFu) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFFu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFFu) << 32 | (uint64_t)swizzle << 62;
}

// K-major 16-bit operand in a 128-byte-swizzled tile (see the top).
__device__ __forceinline__ uint64_t desc_k_major(const void* p) {
  return smem_desc(p, 0, 1024);
}

// MN-major 16-bit operand, n = 64, in a 128-byte-swizzled tile: both
// offsets are the 1024 bytes between 8-row groups (the leading one is not
// used at n = 64).
__device__ __forceinline__ uint64_t desc_mn_major(const void* p) {
  return smem_desc(p, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Register budget of a warpgroup (all four warps execute it together).
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Element-type tag for overloads.
template <typename T>
struct Op {};

// d (m64nN, fp32) = [d if scale_d] + A B, issued asynchronously by the
// warpgroup. N follows from d's size (16 floats: n32, 32: n64). A is
// K-major: from a shared-memory descriptor (wgmma_ss) or from registers
// (wgmma_rs, 4 x 2 16-bit values). B is a descriptor, MN-major when TB = 1.
// clang-format off
#define MXT_WGMMA_DEFS(T, TY) \
  template <int TB> \
  __device__ __forceinline__ void wgmma_ss( \
      Op<T>, float (&d)[16], uint64_t da, uint64_t db, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15}, " \
      "%16, %17, p, 1, 1, 0, %19;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB)); \
  } \
  template <int TB> \
  __device__ __forceinline__ void wgmma_rs( \
      Op<T>, float (&d)[16], const uint32_t (&a)[4], uint64_t db, \
      int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15}, " \
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), \
        "r"(scale_d), "n"(TB)); \
  } \
  template <int TB> \
  __device__ __forceinline__ void wgmma_ss( \
      Op<T>, float (&d)[32], uint64_t da, uint64_t db, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, %35;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB)); \
  } \
  template <int TB> \
  __device__ __forceinline__ void wgmma_rs( \
      Op<T>, float (&d)[32], const uint32_t (&a)[4], uint64_t db, \
      int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), \
        "r"(scale_d), "n"(TB)); \
  }
// clang-format on

MXT_WGMMA_DEFS(__nv_bfloat16, "bf16")
MXT_WGMMA_DEFS(__half, "f16")
#undef MXT_WGMMA_DEFS

// The same with both operands from shared memory at n128 (64 floats of d)
// and n256 (128 floats): one instruction covers a 128- or 256-column tile,
// so A is read from shared memory once per k16 step instead of once per
// 64 columns.
// clang-format off
#define MXT_WGMMA_WIDE_DEFS(T, TY) \
  template <int TB> \
  __device__ __forceinline__ void wgmma_ss( \
      Op<T>, float (&d)[64], uint64_t da, uint64_t db, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, 0, %67;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB)); \
  } \
  template <int TB> \
  __device__ __forceinline__ void wgmma_ss( \
      Op<T>, float (&d)[128], uint64_t da, uint64_t db, int scale_d) { \
    asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, " \
      "%104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127}, " \
      "%128, %129, p, 1, 1, 0, %131;\n}\n" \
      : \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB)); \
  }
// clang-format on

MXT_WGMMA_WIDE_DEFS(__nv_bfloat16, "bf16")
MXT_WGMMA_WIDE_DEFS(__half, "f16")
#undef MXT_WGMMA_WIDE_DEFS

// d (m64n128, s32) = [d if scale_d] + A B for s8 A and B, both K-major
// descriptors (8-bit wgmma has no transpose bit), exact in s32. One k32
// step: 32 bytes of each operand's 128-byte rows.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// -- host: TMA tensor maps ------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime, so
// that the library needs no link against libcuda. nullptr if unavailable.
inline EncodeTiled encode_tiled_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Map of a contiguous (n, rows, cols) 16-bit tensor as 3-D (cols, rows, n)
// with a (64, box_rows, 1) box and 128-byte swizzle. Columns past `cols`
// and rows past `rows` are zero-filled inside each of the n matrices.
// Returns cudaErrorInvalidValue if the driver refuses the map,
// cudaErrorNotSupported if it has no encoder.
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base, int n,
                                   int rows, int cols, int box_rows,
                                   CUtensorMapDataType type) {
  EncodeTiled fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box,
                  estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Map of a contiguous (n, rows, cols) tensor of `elem`-byte elements as
// 3-D (cols, rows, n) with a (box_cols, box_rows, box_n) box: the general
// form of `encode_rows_map` for any element size, box and swizzle. Returns
// as `encode_rows_map`.
inline cudaError_t encode_map_3d(CUtensorMap* map, const void* base, int n,
                                 int rows, int cols, int elem, int box_cols,
                                 int box_rows, int box_n,
                                 CUtensorMapDataType type,
                                 CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem,
                                 (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows,
                             (cuuint32_t)box_n};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box,
                  estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

using EncodeIm2col = decltype(&cuTensorMapEncodeIm2col);

// cuTensorMapEncodeIm2col, fetched as `encode_tiled_fn` fetches its
// encoder.
inline EncodeIm2col encode_im2col_fn() {
  static EncodeIm2col fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeIm2col", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeIm2col", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeIm2col>(p)
               : nullptr;
  }();
  return fn;
}

// Im2col map of a contiguous NHWC 16-bit tensor (n, h, w, c) for a
// stride-1 conv with kernel (kh, kw) and zero padding (ph, pw): the
// bounding box walks the output pixels' tap-(0, 0) corners, from (-pw,
// -ph) to (w - 1 + pw - kw + 1, h - 1 + ph - kh + 1) (corners innermost
// first); a load (`tma_load_im2col_4d`) takes `pixels` pixels of 64
// channels in 128-byte swizzle, each tap by its offsets (dx, dy). The
// encoder takes corners in [-128, 127] (`im2col_fits`). Returns as
// `encode_rows_map`.
inline bool im2col_fits(int kh, int kw, int ph, int pw) {
  return ph <= 128 && pw <= 128 && kh - 1 - ph <= 128 && kw - 1 - pw <= 128 &&
         kh <= 256 && kw <= 256;
}

inline cudaError_t encode_im2col_4d(CUtensorMap* map, const void* base,
                                    int n, int h, int w, int c, int kh,
                                    int kw, int ph, int pw, int pixels,
                                    CUtensorMapDataType type) {
  EncodeIm2col fn = encode_im2col_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (!im2col_fits(kh, kw, ph, pw)) return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const int lower[2] = {-pw, -ph};
  const int upper[2] = {pw - (kw - 1), ph - (kh - 1)};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides, lower,
                  upper, 64, (cuuint32_t)pixels, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace mxt

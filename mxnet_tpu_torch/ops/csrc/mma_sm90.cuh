// Warp-level tensor-core helpers shared by the flash-attention kernels.
//
// mma.sync m16n8k16 with 16-bit inputs and fp32 accumulation. Fragment
// layout, for lane = 4 * g + c2 / 2 (g = lane >> 2, c2 = (lane & 3) * 2):
//   A (16 x 16, row major): a0 = (row g,     cols c2, c2+1)
//                           a1 = (row g + 8, cols c2, c2+1)
//                           a2 = (row g,     cols c2+8, c2+9)
//                           a3 = (row g + 8, cols c2+8, c2+9)
//   B (16 x 8, col major):  b0 = (k c2, c2+1; col g), b1 = (k c2+8, c2+9; col g)
//   C (16 x 8, fp32):       c0, c1 = (row g, cols c2, c2+1)
//                           c2, c3 = (row g + 8, cols c2, c2+1)
// So the C fragments of two neighbouring n-tiles form the A fragment of one
// 16-wide k-chunk of a following product (see `pack_a`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace mxt {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// The A fragment of one 16-wide k-chunk from the fp32 C fragments of two
// neighbouring 8-wide n-tiles (c_lo: cols 0-7 of the chunk, c_hi: 8-15),
// rounded to 16 bits.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t* a, const float* c_lo,
                                       const float* c_hi) {
  a[0] = Mma<T>::pack(c_lo[0], c_lo[1]);
  a[1] = Mma<T>::pack(c_lo[2], c_lo[3]);
  a[2] = Mma<T>::pack(c_hi[0], c_hi[1]);
  a[3] = Mma<T>::pack(c_hi[2], c_hi[3]);
}

}  // namespace mxt

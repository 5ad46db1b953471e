// int8 matrix product with exact s32 accumulation and a fused dequantize /
// relu / requantize epilogue, for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `_int8_mm_kernel` of
// mxnet_tpu/ops/pallas_kernels.py, launched by `int8_matmul`: x (M, K) s8
// times w (K, N) s8, summed exactly in s32 over all of K, then
// out = f32(acc) * scale, optionally max(out, 0), and optionally
// clip(rint(out * out_scale), -127, 127) stored as s8. The output is (M, N)
// fp32, or s8 when out_scale is given.
//
// Layout: x, w and the output contiguous row major; K and N multiples of
// 16 (16-byte vectors of x, 8-byte vectors of w, two-column stores), K at
// most 131071 (no s32 sum of |x w| <= 2^14 products can overflow); any
// M >= 1, the ragged last m-tile masked (the TPU's `int8_blocks` refuses
// an M that its tiles do not divide, such as 392 rows).
//
// Design: mma.sync m16n8k32 (s8 x s8 -> s32) with the sums in registers.
// CTA tile 128 x 64 output, k-tile 64 bytes, 4 warps each owning 64 x 32,
// two-stage ring in shared memory. x is staged by cp.async (rows past M
// zero-filled), in the byte geometry of the bf16 tiles of
// conv_gemm_sm90.cuh (80-byte rows, conflict-free fragment reads). mma's B
// operand wants 4 consecutive k of one column n in each 32-bit register,
// but w lies (K, N) with N contiguous, and ldmatrix.trans moves 16-bit
// elements only. So each thread loads a 4 (k) x 8 (n) block of w as four
// 8-byte vectors into registers, transposes it with byte permutes, and
// stores it to shared memory as (n, k): the next k-tile's block is loaded
// before the current tile's products and stored after them, so the loads'
// latency hides behind the products. The TPU kernel carries the s32 sum
// across its sequential k grid axis in a VMEM scratch tile and applies the
// epilogue on the last k step; here the k loop runs inside the CTA and the
// epilogue runs on the registers after it. Rounding as the reference:
// __int2float_rn(acc), then * scale and * out_scale as two separate fp32
// multiplies, __float2int_rn (half to even, as jnp.round; never roundf).
//
// What bounds it on an H100 SXM (3.35 TB/s, 1979 TOP/s int8 dense): 2 M K N
// operations; x and w read once, the output written once. At the
// microbench shape (M, K, N) = (25088, 512, 128): 25.8 MB with the fp32
// output -> 7.7 us, 16.1 MB with the s8 output -> 4.8 us; 3.29 GOP ->
// 1.7 us. Byte-bound. This first version is plain: mma.sync rather than
// wgmma, no TMA, no persistent schedule, 8-byte fp32 stores.

#include <climits>

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_gemm_sm90.cuh"

namespace {

using mxt::conv::cp_async16;
using mxt::conv::cp_async_commit;
using mxt::conv::cp_async_wait_one;
using mxt::conv::tile_row;

constexpr int BM = 128;                  // rows of x per CTA
constexpr int BN = 64;                   // output columns per CTA
constexpr int BK = 64;                   // k (bytes of a row of x) per stage
constexpr int NT = 128;                  // 4 warps: 2 (m) x 2 (n)
constexpr int LDS = BK + 16;             // shared row stride in bytes
constexpr int XVEC = BM * BK / 16 / NT;  // x vectors per thread per stage

using X = mxt::conv::DenseA<int8_t, XVEC>;

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The stage's (BM, BK) tile of x at k0, as 16-byte vectors.
__device__ __forceinline__ void load_x(int8_t* As, const X& x, int k0,
                                       int tid) {
  const int c = (tid & 3) * 16;
  const int8_t* p[XVEC];
  x.gather(p, k0 + c);
#pragma unroll
  for (int i = 0; i < XVEC; ++i)
    cp_async16(As + tile_row(tid, i) * LDS + c, p[i] ? p[i] : x.x,
               p[i] != nullptr);
}

// This thread's 4 (k) x 8 (n) block of the (BK, BN) tile of w at (k0, n0):
// rows k0 + 4 (tid & 15) + i, columns n0 + 8 (tid >> 4) .. + 7, zero past
// K or N (K and N are multiples of 16, so a block lies wholly inside or
// outside).
__device__ __forceinline__ void fetch_w(uint2 (&r)[4],
                                        const int8_t* __restrict__ w, int N,
                                        int K, int n0, int k0, int tid) {
  const int k = k0 + (tid & 15) * 4, n = n0 + (tid >> 4) * 8;
  const bool ok = k < K && n < N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = ok ? __ldg(reinterpret_cast<const uint2*>(w + (size_t)(k + i) * N +
                                                     n))
              : make_uint2(0u, 0u);
}

// 4 x 4 bytes: r_i holds (row i, columns 0..3); o[j] gets (rows 0..3,
// column j), row 0 in the low byte.
__device__ __forceinline__ void transpose4(uint32_t* o, uint32_t r0,
                                           uint32_t r1, uint32_t r2,
                                           uint32_t r3) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// The block, transposed into the (BN, BK) tile Bs[n][k].
__device__ __forceinline__ void stash_w(int8_t* Bs, const uint2 (&r)[4],
                                        int tid) {
  const int k = (tid & 15) * 4, n = (tid >> 4) * 8;
  uint32_t o[8];
  transpose4(o, r[0].x, r[1].x, r[2].x, r[3].x);
  transpose4(o + 4, r[0].y, r[1].y, r[2].y, r[3].y);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<uint32_t*>(Bs + (n + j) * LDS + k) = o[j];
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mi][ni][.] += the warp's (64, 32) block of As @ Bs^T. m16n8k32
// fragments, g = lane >> 2, t4 = (lane & 3) * 4 (bytes): a0 = (row g, k t4
// .. t4+3), a1 = row g+8, a2 / a3 = the same at k + 16; b0 = (k t4 ..
// t4+3, column g), b1 = k + 16; c0, c1 = (row g, columns 2 (lane & 3) + 0,
// 1), c2, c3 = row g + 8.
__device__ __forceinline__ void mma_tile(int (&acc)[4][4][4],
                                         const int8_t* As, const int8_t* Bs,
                                         int wm, int wn, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* p = As + (wm + mi * 16 + g) * LDS + kk + t4;
      a[mi][0] = ld32(p);
      a[mi][1] = ld32(p + 8 * LDS);
      a[mi][2] = ld32(p + 16);
      a[mi][3] = ld32(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = Bs + (wn + ni * 8 + g) * LDS + kk + t4;
      b[ni][0] = ld32(p);
      b[ni][1] = ld32(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

template <bool RELU, bool REQUANT>
__global__ void __launch_bounds__(NT)
    int8_mm(X x, const int8_t* __restrict__ w, void* __restrict__ out, int N,
            int K, float scale, float out_scale) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  x.init(m0, tid);
  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int kt_n = (K + BK - 1) / BK;
  uint2 wr[4];
  load_x(As[0], x, 0, tid);
  cp_async_commit();
  fetch_w(wr, w, N, K, n0, 0, tid);
  stash_w(Bs[0], wr, tid);
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt & 1;
    const bool more = kt + 1 < kt_n;
    if (more) {   // the other stage was released by the last sync
      load_x(As[st ^ 1], x, (kt + 1) * BK, tid);
      fetch_w(wr, w, N, K, n0, (kt + 1) * BK, tid);
    }
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait_one(); // stage st of x has landed (this thread's copies)
    __syncthreads();     // ... and every thread's, and Bs[st] is stored
    mma_tile(acc, As[st], Bs[st], wm, wn, g, t4);
    if (more) stash_w(Bs[st ^ 1], wr, tid);
    __syncthreads();     // stage st is free for the loads of kt + 2
  }

  // the epilogue, in registers; rows past M and columns past N skipped
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + (lane & 3) * 2;   // even; N % 16 == 0
    if (col >= N) continue;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= x.M) continue;
        float v0 = __int2float_rn(acc[mi][ni][2 * h]) * scale;
        float v1 = __int2float_rn(acc[mi][ni][2 * h + 1]) * scale;
        if (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const size_t o = (size_t)row * N + col;
        if (REQUANT) {
          const int q0 = min(max(__float2int_rn(v0 * out_scale), -127), 127);
          const int q1 = min(max(__float2int_rn(v1 * out_scale), -127), 127);
          *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o) =
              make_char2((signed char)q0, (signed char)q1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(v0, v1);
        }
      }
  }
}

template <bool RELU, bool REQUANT>
void launch(dim3 grid, cudaStream_t st, const X& x, const void* w, void* out,
            int n, int k, float scale, float out_scale) {
  int8_mm<RELU, REQUANT><<<grid, NT, 0, st>>>(
      x, static_cast<const int8_t*>(w), out, n, k, scale, out_scale);
}

}  // namespace

// out: (m, n) fp32, or s8 when requant != 0. Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take, else
// cudaGetLastError() right after the launch.
extern "C" int mxt_int8_matmul(const void* x, const void* w, void* out,
                               int m, int n, int k, float scale, int relu,
                               int requant, float out_scale, void* stream) {
  if (m <= 0 || n < 16 || n % 16 != 0 || k < 16 || k % 16 != 0 ||
      (long long)k * 16384 > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const X xa{static_cast<const int8_t*>(x), m, k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (relu && requant)
    launch<true, true>(grid, st, xa, w, out, n, k, scale, out_scale);
  else if (relu)
    launch<true, false>(grid, st, xa, w, out, n, k, scale, out_scale);
  else if (requant)
    launch<false, true>(grid, st, xa, w, out, n, k, scale, out_scale);
  else
    launch<false, false>(grid, st, xa, w, out, n, k, scale, out_scale);
  return (int)cudaGetLastError();
}

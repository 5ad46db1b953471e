// Fused 1x1-conv / batch-norm epilogue kernels for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces two Pallas TPU kernels of mxnet_tpu/ops/pallas_kernels.py, which
// `conv1x1_bn_act_train` runs for every bottleneck 1x1 conv of the ResNet
// train step under MXNET_FUSED_EPILOGUE:
//
//   matmul_stats    (`_mm_statsonly_kernel`, launched by `matmul_stats`):
//       per-column s = sum_i z_ij and ss = sum_i z_ij^2 in fp32 of
//       z = x @ w, without writing z;
//   matmul_epilogue (`_mm_epilogue_kernel`, launched by `matmul_epilogue`):
//       out = act(z * scale + shift [+ residual]) in x's dtype, with scale
//       and shift fp32 per column and the residual added before the relu.
//
// Layout: x is contiguous (M, K); the weight comes as wt = w^T, contiguous
// (N, K) -- the OHWI 1x1 conv weight (Cout, Cin) as it lies in memory, and
// the column-major B operand mma.sync wants. K and N are multiples of 8
// (rows are read as 16-byte vectors, columns stored in pairs); any M >= 1:
// rows past M are zero-filled on load, so they add 0 to the sums, and their
// stores are skipped.
//
// Design. One CTA per (m-tile, n-tile); the k-loop runs inside the CTA with
// a two-stage cp.async ring in shared memory. The TPU kernel of
// matmul_stats accumulates its (1, N) stats across the m grid axis, which
// is race-free there only because TPU grid steps run in order. Here the
// CTAs of all m-tiles run at once, so each CTA reduces its z tile in
// registers (then across warps in shared memory, in a fixed order) to one
// row of per-column partial sums, written to a (m_tiles, N) fp32 scratch;
// the wrapper sums the partials over m_tiles. No atomics: the stats are
// deterministic, which the fused-vs-unfused checks rely on.
//   bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate), CTA tile
//     128 x 64 x 32, 4 warps each owning 64 x 32 of the output.
//   fp32: FMA in exact fp32 (no TF32), CTA tile 64 x 64 x 16, 256 threads
//     each owning 4 x 4 of the output.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense,
// 67 TFLOP/s fp32): 2*M*K*N operations each; bytes: matmul_stats reads x
// and w and writes 2N floats, matmul_epilogue also writes out and reads the
// residual. At the ResNet-50 bf16 batch-128 sites:
//   stage-1 conv3 (M 401408, K 64, N 256, residual): 13.2 GFLOP;
//     matmul_stats 51 MB -> 15 us of memory against 13 us of tensor-core
//     time; matmul_epilogue 462 MB -> 138 us: memory-bound.
//   stage-4 conv3 (M 6272, K 512, N 2048, residual): 13.2 GFLOP -> 13 us
//     of tensor-core time; 8.5 MB (stats) / 60 MB (epilogue, 18 us).
// This first version is plain: mma.sync rather than wgmma, cp.async rather
// than TMA, 4-byte epilogue stores, and no persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using mxt::kFull;
using mxt::Mma;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BM = 128;       // rows of x per CTA
constexpr int BN = 64;        // output columns per CTA
constexpr int BK = 32;        // k per pipeline stage
constexpr int NT = 128;       // 4 warps: 2 (m) x 2 (n), 64 x 32 each
constexpr int LDS = BK + 8;   // shared row stride in elements (80 bytes)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One stage: the (BM, BK) tile of x at (m0, k0) and the (BN, BK) tile of wt
// at (n0, k0), as 16-byte vectors; vectors past M, N or K are zero-filled.
__device__ __forceinline__ void load_stage(__nv_bfloat16* As,
                                           __nv_bfloat16* Bs,
                                           const __nv_bfloat16* x,
                                           const __nv_bfloat16* wt, int M,
                                           int N, int K, int m0, int n0,
                                           int k0, int tid) {
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / NT; ++i) {
    const int v = tid + i * NT;
    const int r = v >> 2, c = (v & 3) * 8;
    const bool ok = m0 + r < M && k0 + c < K;
    cp_async16(As + r * LDS + c, ok ? x + (size_t)(m0 + r) * K + k0 + c : x,
               ok);
  }
#pragma unroll
  for (int i = 0; i < BN * BK / 8 / NT; ++i) {
    const int v = tid + i * NT;
    const int r = v >> 2, c = (v & 3) * 8;
    const bool ok = n0 + r < N && k0 + c < K;
    cp_async16(Bs + r * LDS + c,
               ok ? wt + (size_t)(n0 + r) * K + k0 + c : wt, ok);
  }
}

// acc[mi][ni][.] += the warp's (64, 32) block of x_tile @ wt_tile^T.
// Fragment layout: see mma_sm90.cuh (g = lane >> 2, c2 = (lane & 3) * 2).
__device__ __forceinline__ void mma_tile(float (&acc)[4][4][4],
                                         const __nv_bfloat16* A,
                                         const __nv_bfloat16* B, int wm,
                                         int wn, int g, int c2) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const __nv_bfloat16* p = A + (wm + mi * 16 + g) * LDS + kk + c2;
      a[mi][0] = ld32(p);
      a[mi][1] = ld32(p + 8 * LDS);
      a[mi][2] = ld32(p + 8);
      a[mi][3] = ld32(p + 8 * LDS + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* p = B + (wn + ni * 8 + g) * LDS + kk + c2;
      b[ni][0] = ld32(p);
      b[ni][1] = ld32(p + 8);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        Mma<__nv_bfloat16>::run(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// The CTA's (BM, BN) tile of z = x @ wt^T in fp32 registers.
__device__ __forceinline__ void gemm_bf16(float (&acc)[4][4][4],
                                          const __nv_bfloat16* x,
                                          const __nv_bfloat16* wt, int M,
                                          int N, int K, int m0, int n0,
                                          int tid, int wm, int wn, int g,
                                          int c2) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BN * LDS];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int kt_n = (K + BK - 1) / BK;
  load_stage(As[0], Bs[0], x, wt, M, N, K, m0, n0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_n)   // the other stage was released by the last sync
      load_stage(As[st ^ 1], Bs[st ^ 1], x, wt, M, N, K, m0, n0,
                 (kt + 1) * BK, tid);
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait_one(); // stage st has landed (this thread's copies)
    __syncthreads();     // ... and every other thread's
    mma_tile(acc, As[st], Bs[st], wm, wn, g, c2);
    __syncthreads();     // stage st is free for the load of kt + 2
  }
}

__global__ void __launch_bounds__(NT)
    stats_bf16(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ wt, float* __restrict__ ps,
               float* __restrict__ pss, int M, int N, int K) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[4][4][4];
  gemm_bf16(acc, x, wt, M, N, K, m0, n0, tid, wm, wn, g, c2);

  // per-column sums over this warp's 64 rows: first the thread's 8 rows,
  // then across the 8 lanes of equal c2 (g = 0..7)
  __shared__ float red[2][2][BN];   // [sum or sumsq][warp row][column]
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const float* c = acc[mi][ni];
      s0 += c[0] + c[2];
      s1 += c[1] + c[3];
      q0 += c[0] * c[0] + c[2] * c[2];
      q1 += c[1] * c[1] + c[3] * c[3];
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(kFull, s0, off);
      s1 += __shfl_xor_sync(kFull, s1, off);
      q0 += __shfl_xor_sync(kFull, q0, off);
      q1 += __shfl_xor_sync(kFull, q1, off);
    }
    if (g == 0) {
      const int col = wn + ni * 8 + c2;
      red[0][warp >> 1][col] = s0;
      red[0][warp >> 1][col + 1] = s1;
      red[1][warp >> 1][col] = q0;
      red[1][warp >> 1][col + 1] = q1;
    }
  }
  __syncthreads();
  if (tid < BN && n0 + tid < N) {
    const size_t o = (size_t)blockIdx.x * N + n0 + tid;
    ps[o] = red[0][0][tid] + red[0][1][tid];
    pss[o] = red[1][0][tid] + red[1][1][tid];
  }
}

template <bool RES, bool RELU>
__global__ void __launch_bounds__(NT)
    epilogue_bf16(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ wt,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift,
                  const __nv_bfloat16* __restrict__ res,
                  __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  float acc[4][4][4];
  gemm_bf16(acc, x, wt, M, N, K, m0, n0, tid, wm, wn, g, c2);

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + c2;   // even; N % 8 == 0
    if (col >= N) continue;
    const float2 sc = *reinterpret_cast<const float2*>(scale + col);
    const float2 sh = *reinterpret_cast<const float2*>(shift + col);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= M) continue;
        const size_t o = (size_t)row * N + col;
        float v0 = acc[mi][ni][2 * h] * sc.x + sh.x;
        float v1 = acc[mi][ni][2 * h + 1] * sc.y + sh.y;
        if (RES) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + o));
          v0 += r.x;
          v1 += r.y;
        }
        if (RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + o) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA, exact fp32
// ---------------------------------------------------------------------------

constexpr int FBM = 64;       // rows per CTA
constexpr int FBN = 64;       // columns per CTA
constexpr int FBK = 16;       // k per stage
constexpr int FNT = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int FLD = FBM + 4;  // shared row stride (FBM == FBN)

// One (64, 16) tile of a row-major (rows, K) matrix at (r0, k0): one float4
// per thread, zero past the edges (K % 8 == 0, so a vector is whole).
__device__ __forceinline__ float4 fetch_fp32(const float* p, int rows, int K,
                                             int r0, int k0, int tid) {
  const int r = tid >> 2, c = (tid & 3) * 4;
  if (r0 + r < rows && k0 + c < K)
    return *reinterpret_cast<const float4*>(p + (size_t)(r0 + r) * K + k0 + c);
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// ... stored transposed: S[k][row], so the compute loop reads along rows.
__device__ __forceinline__ void stash_fp32(float* S, float4 v, int tid) {
  const int r = tid >> 2, c = (tid & 3) * 4;
  S[(c + 0) * FLD + r] = v.x;
  S[(c + 1) * FLD + r] = v.y;
  S[(c + 2) * FLD + r] = v.z;
  S[(c + 3) * FLD + r] = v.w;
}

// The thread's (4, 4) block, rows m0 + ty*4 + i, columns n0 + tx*4 + j, of
// z = x @ wt^T, with the next k-tile fetched into registers during the
// current one's products.
__device__ __forceinline__ void gemm_fp32(float (&acc)[4][4], const float* x,
                                          const float* wt, int M, int N,
                                          int K, int m0, int n0, int tid,
                                          int ty, int tx) {
  __shared__ __align__(16) float As[2][FBK * FLD];
  __shared__ __align__(16) float Bs[2][FBK * FLD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int kt_n = (K + FBK - 1) / FBK;
  stash_fp32(As[0], fetch_fp32(x, M, K, m0, 0, tid), tid);
  stash_fp32(Bs[0], fetch_fp32(wt, N, K, n0, 0, tid), tid);
  __syncthreads();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt & 1;
    float4 na = make_float4(0.f, 0.f, 0.f, 0.f), nb = na;
    if (kt + 1 < kt_n) {
      na = fetch_fp32(x, M, K, m0, (kt + 1) * FBK, tid);
      nb = fetch_fp32(wt, N, K, n0, (kt + 1) * FBK, tid);
    }
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As[st] + k * FLD +
                                                        ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Bs[st] + k * FLD +
                                                        tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < kt_n) {   // the other stage was released by the last sync
      stash_fp32(As[st ^ 1], na, tid);
      stash_fp32(Bs[st ^ 1], nb, tid);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(FNT)
    stats_fp32(const float* __restrict__ x, const float* __restrict__ wt,
               float* __restrict__ ps, float* __restrict__ pss, int M, int N,
               int K) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  float acc[4][4];
  gemm_fp32(acc, x, wt, M, N, K, m0, n0, tid, ty, tx);

  // column sums: the thread's 4 rows, then ty and ty ^ 1 (lanes l, l ^ 16),
  // then the 8 warps in order through shared memory
  __shared__ float red[2][FNT / 32][FBN];
  float s[4], q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = acc[0][j] + acc[1][j] + acc[2][j] + acc[3][j];
    q[j] = acc[0][j] * acc[0][j] + acc[1][j] * acc[1][j] +
           acc[2][j] * acc[2][j] + acc[3][j] * acc[3][j];
    s[j] += __shfl_xor_sync(kFull, s[j], 16);
    q[j] += __shfl_xor_sync(kFull, q[j], 16);
  }
  if ((tid & 31) < 16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][tid >> 5][tx * 4 + j] = s[j];
      red[1][tid >> 5][tx * 4 + j] = q[j];
    }
  }
  __syncthreads();
  if (tid < FBN && n0 + tid < N) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < FNT / 32; ++w) {
      a += red[0][w][tid];
      b += red[1][w][tid];
    }
    const size_t o = (size_t)blockIdx.x * N + n0 + tid;
    ps[o] = a;
    pss[o] = b;
  }
}

template <bool RES, bool RELU>
__global__ void __launch_bounds__(FNT)
    epilogue_fp32(const float* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift,
                  const float* __restrict__ res, float* __restrict__ out,
                  int M, int N, int K) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  float acc[4][4];
  gemm_fp32(acc, x, wt, M, N, K, m0, n0, tid, ty, tx);
  const int col = n0 + tx * 4;   // N % 8 == 0: the 4 columns are all in
  if (col >= N) return;
  const float4 sc = *reinterpret_cast<const float4*>(scale + col);
  const float4 sh = *reinterpret_cast<const float4*>(shift + col);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) break;
    const size_t o = (size_t)row * N + col;
    float4 v = make_float4(acc[i][0] * sc.x + sh.x, acc[i][1] * sc.y + sh.y,
                           acc[i][2] * sc.z + sh.z, acc[i][3] * sc.w + sh.w);
    if (RES) {
      const float4 r = *reinterpret_cast<const float4*>(res + o);
      v.x += r.x;
      v.y += r.y;
      v.z += r.z;
      v.w += r.w;
    }
    if (RELU) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f);
      v.w = fmaxf(v.w, 0.f);
    }
    *reinterpret_cast<float4*>(out + o) = v;
  }
}

bool bad_shape(int M, int N, int K, int dtype) {
  return M <= 0 || N < 8 || K < 8 || N % 8 != 0 || K % 8 != 0 || dtype < 0 ||
         dtype > 1;
}

int m_tile(int dtype) { return dtype == 0 ? FBM : BM; }

dim3 grid_of(int M, int N, int dtype) {
  const int bm = m_tile(dtype), bn = dtype == 0 ? FBN : BN;
  return dim3((M + bm - 1) / bm, (N + bn - 1) / bn);
}

template <bool RES, bool RELU>
void launch_epilogue(const void* x, const void* wt, const float* scale,
                     const float* shift, const void* res, void* out, int M,
                     int N, int K, int dtype, cudaStream_t st) {
  const dim3 grid = grid_of(M, N, dtype);
  if (dtype == 0)
    epilogue_fp32<RES, RELU><<<grid, FNT, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), scale,
        shift, static_cast<const float*>(res), static_cast<float*>(out), M, N,
        K);
  else
    epilogue_bf16<RES, RELU><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(wt), scale, shift,
        static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(out), M, N, K);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernels do not take, else
// cudaGetLastError() right after the launch.

// Rows of x per CTA, hence rows of the partial-sum scratch per m-tile.
extern "C" int mxt_conv_bn_m_tile(int dtype) { return m_tile(dtype); }

// ps, pss: (ceil(M / m_tile), N) fp32 partial column sums of z and z^2.
extern "C" int mxt_matmul_stats(const void* x, const void* wt, void* ps,
                                void* pss, int M, int N, int K, int dtype,
                                void* stream) {
  if (bad_shape(M, N, K, dtype)) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(M, N, dtype);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    stats_fp32<<<grid, FNT, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt),
        static_cast<float*>(ps), static_cast<float*>(pss), M, N, K);
  else
    stats_bf16<<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(wt), static_cast<float*>(ps),
        static_cast<float*>(pss), M, N, K);
  return (int)cudaGetLastError();
}

// out: (M, N) in x's dtype; residual: (M, N) in x's dtype, or null.
extern "C" int mxt_matmul_epilogue(const void* x, const void* wt,
                                   const void* scale, const void* shift,
                                   const void* residual, void* out, int M,
                                   int N, int K, int relu, int dtype,
                                   void* stream) {
  if (bad_shape(M, N, K, dtype)) return (int)cudaErrorInvalidValue;
  if (grid_of(M, N, dtype).y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (residual != nullptr) {
    if (relu)
      launch_epilogue<true, true>(x, wt, sc, sh, residual, out, M, N, K,
                                  dtype, st);
    else
      launch_epilogue<true, false>(x, wt, sc, sh, residual, out, M, N, K,
                                   dtype, st);
  } else {
    if (relu)
      launch_epilogue<false, true>(x, wt, sc, sh, residual, out, M, N, K,
                                   dtype, st);
    else
      launch_epilogue<false, false>(x, wt, sc, sh, residual, out, M, N, K,
                                    dtype, st);
  }
  return (int)cudaGetLastError();
}

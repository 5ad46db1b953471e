// Tiled GEMM building blocks of the conv / batch-norm kernels that are not
// on wgmma_sm90.cuh: the KxK conv with batch-norm statistics
// (convkxk_bn_stats.cu, bf16 and fp32) and the fp32 kernels of
// conv_bn_epilogue.cu. conv_bn_epilogue.cu's bf16 kernels are persistent
// TMA + wgmma GEMMs on wgmma_sm90.cuh.
//
// Each CTA computes one (m-tile, n-tile) of z = A @ wt^T in fp32 registers:
// A has M rows and K columns and is read through a loader, wt is the
// contiguous (N, K) weight -- an OHWI conv weight (Cout, kh, kw, Cin) as it
// lies in memory, and the column-major B operand mma.sync wants. The
// loaders:
//   DenseA: A = x, a contiguous (M, K) matrix (the 1x1 conv's NHWC input
//     seen as (N*H*W, Cin));
//   ConvA: A = the implicit im2col matrix of a stride-1 KxK NHWC conv with
//     symmetric zero padding: row m = (image, oy, ox), column k = (dy, dx,
//     ci) in the weight's order, entry x[image, oy + dy - ph, ox + dx - pw,
//     ci], 0 where that pixel lies in the padding.
// K and N are multiples of 8 and, for ConvA, so is Cin: a 16-byte vector
// of A never straddles a row's end or a tap. Vectors past M, N or K, and
// ConvA's padding, are zero-filled on load, so they add 0 to every sum.
//
//   bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate), CTA tile
//     128 x 64 x 32, 4 warps each owning 64 x 32 of the output, two-stage
//     cp.async ring in shared memory.
//   fp32: FMA in exact fp32 (no TF32), CTA tile 64 x 64 x 16, 256 threads
//     each owning 4 x 4 of the output, the next k-tile fetched into
//     registers during the current one's products.
//
// The batch-norm statistics: the TPU kernels accumulate their per-column
// sums across a sequential grid axis, race-free there only because TPU
// grid steps run in order. Here the CTAs of all m-tiles run at once, so
// each CTA reduces its tile in registers, then across warps in shared
// memory in a fixed order, to one row of per-column partial sums written
// to an (m_tiles, N) fp32 scratch, which the wrapper sums over m_tiles.
// No atomics: the statistics repeat bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace mxt {
namespace conv {

// bf16 tiles
constexpr int BM = 128;       // rows of A per CTA
constexpr int BN = 64;        // output columns per CTA
constexpr int BK = 32;        // k per pipeline stage
constexpr int NT = 128;       // 4 warps: 2 (m) x 2 (n), 64 x 32 each
constexpr int LDS = BK + 8;   // shared row stride in elements (80 bytes)
constexpr int AROWS = BM * BK / 8 / NT;   // A vectors per thread per stage

// fp32 tiles
constexpr int FBM = 64;       // rows per CTA
constexpr int FBN = 64;       // columns per CTA
constexpr int FBK = 16;       // k per stage
constexpr int FNT = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int FLD = FBM + 4;  // shared row stride (FBM == FBN)

// Every thread loads the same rows of every k-tile: (tid >> 2) + 32 i of
// the CTA's tile, i < AROWS (bf16) or i = 0 (fp32), at columns k0 +
// (tid & 3) * 8 (bf16) or * 4 (fp32).
__device__ __forceinline__ int tile_row(int tid, int i) {
  return (tid >> 2) + 32 * i;
}

// A = x, contiguous (M, K).
template <typename T, int ROWS>
struct DenseA {
  const T* x;
  int M, K;
  const T* row[ROWS];   // this thread's rows, null past M

  __device__ __forceinline__ void init(int m0, int tid) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int m = m0 + tile_row(tid, i);
      row[i] = m < M ? x + (size_t)m * K : nullptr;
    }
  }

  // p[i] = the vector at column k of row i, or null (zero-fill)
  __device__ __forceinline__ void gather(const T* (&p)[ROWS], int k) const {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      p[i] = (row[i] != nullptr && k < K) ? row[i] + k : nullptr;
  }
};

// The geometry of a stride-1 KxK conv: input H x W x C, kernel kh x kw
// (only kw is needed to split k), padding ph, pw, output Ho x Wo.
struct ConvShape {
  int H, W, C, kw, ph, pw, Ho, Wo;
};

// A = the implicit im2col matrix of x, contiguous NHWC (see the top).
template <typename T, int ROWS>
struct ConvA {
  const T* x;
  int M, K;
  ConvShape s;
  const T* img[ROWS];   // this thread's rows' images, null past M
  int iy0[ROWS], ix0[ROWS];   // the input pixel of tap (0, 0)

  __device__ __forceinline__ void init(int m0, int tid) {
    const int hw = s.Ho * s.Wo;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int m = m0 + tile_row(tid, i);
      if (m < M) {
        const int n = m / hw, p = m - n * hw;
        const int oy = p / s.Wo;
        img[i] = x + (size_t)n * s.H * s.W * s.C;
        iy0[i] = oy - s.ph;
        ix0[i] = p - oy * s.Wo - s.pw;
      } else {
        img[i] = nullptr;
        iy0[i] = ix0[i] = 0;
      }
    }
  }

  __device__ __forceinline__ void gather(const T* (&p)[ROWS], int k) const {
    const int tap = k / s.C, ci = k - tap * s.C;
    const int dy = tap / s.kw, dx = tap - dy * s.kw;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int iy = iy0[i] + dy, ix = ix0[i] + dx;
      const bool ok = img[i] != nullptr && k < K && iy >= 0 && iy < s.H &&
                      ix >= 0 && ix < s.W;
      p[i] = ok ? img[i] + ((size_t)iy * s.W + ix) * s.C + ci : nullptr;
    }
  }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

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

// One stage: the (BM, BK) tile of A at k0 and the (BN, BK) tile of wt at
// (n0, k0), as 16-byte vectors.
template <class A>
__device__ __forceinline__ void load_stage(__nv_bfloat16* As,
                                           __nv_bfloat16* Bs, const A& a,
                                           const __nv_bfloat16* wt, int N,
                                           int K, int n0, int k0, int tid) {
  const int c = (tid & 3) * 8;
  const __nv_bfloat16* p[AROWS];
  a.gather(p, k0 + c);
#pragma unroll
  for (int i = 0; i < AROWS; ++i)
    cp_async16(As + tile_row(tid, i) * LDS + c, p[i] ? p[i] : wt,
               p[i] != nullptr);
#pragma unroll
  for (int i = 0; i < BN * BK / 8 / NT; ++i) {
    const int r = tile_row(tid, i);
    const bool ok = n0 + r < N && k0 + c < K;
    cp_async16(Bs + r * LDS + c,
               ok ? wt + (size_t)(n0 + r) * K + k0 + c : wt, ok);
  }
}

// acc[mi][ni][.] += the warp's (64, 32) block of A_tile @ wt_tile^T.
// Fragment layout: see mma_sm90.cuh (g = lane >> 2, c2 = (lane & 3) * 2).
__device__ __forceinline__ void mma_tile(float (&acc)[4][4][4],
                                         const __nv_bfloat16* As,
                                         const __nv_bfloat16* Bs, int wm,
                                         int wn, int g, int c2) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const __nv_bfloat16* p = As + (wm + mi * 16 + g) * LDS + kk + c2;
      a[mi][0] = ld32(p);
      a[mi][1] = ld32(p + 8 * LDS);
      a[mi][2] = ld32(p + 8);
      a[mi][3] = ld32(p + 8 * LDS + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const __nv_bfloat16* p = Bs + (wn + ni * 8 + g) * LDS + kk + c2;
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

// The CTA's (BM, BN) tile of z = A @ wt^T in fp32 registers; `a` has been
// init-ed with the CTA's m0.
template <class A>
__device__ __forceinline__ void gemm_bf16(float (&acc)[4][4][4], const A& a,
                                          const __nv_bfloat16* wt, int N,
                                          int K, int n0, int tid, int wm,
                                          int wn, int g, int c2) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BN * LDS];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int kt_n = (K + BK - 1) / BK;
  load_stage(As[0], Bs[0], a, wt, N, K, n0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_n)   // the other stage was released by the last sync
      load_stage(As[st ^ 1], Bs[st ^ 1], a, wt, N, K, n0, (kt + 1) * BK,
                 tid);
    cp_async_commit();   // possibly empty: keeps the group count uniform
    cp_async_wait_one(); // stage st has landed (this thread's copies)
    __syncthreads();     // ... and every other thread's
    mma_tile(acc, As[st], Bs[st], wm, wn, g, c2);
    __syncthreads();     // stage st is free for the load of kt + 2
  }
}

// Per-column sums of the tile and of its squares over its BM rows (the
// thread's 8 rows, then the 8 lanes of equal c2, then the two warp rows in
// order), written to row `mt` of the (m_tiles, N) partials.
__device__ __forceinline__ void col_sums_bf16(const float (&acc)[4][4][4],
                                              float* __restrict__ ps,
                                              float* __restrict__ pss, int N,
                                              int n0, int mt, int tid,
                                              int warp, int wn, int g,
                                              int c2) {
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
    const size_t o = (size_t)mt * N + n0 + tid;
    ps[o] = red[0][0][tid] + red[0][1][tid];
    pss[o] = red[1][0][tid] + red[1][1][tid];
  }
}

// The tile rounded to bf16 into row-major (M, N) y; rows past M skipped.
__device__ __forceinline__ void store_bf16(const float (&acc)[4][4][4],
                                           __nv_bfloat16* __restrict__ y,
                                           int M, int N, int m0, int n0,
                                           int wm, int wn, int g, int c2) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + c2;   // even; N % 8 == 0
    if (col >= N) continue;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  }
}

// z = act(A @ wt^T): with STORE, z rounded to bf16 into y (M, N); always
// the partial column sums of z and z^2 from the fp32 values, after the
// optional relu and before the rounding.
template <class A, bool STORE, bool RELU>
__global__ void __launch_bounds__(NT)
    stats_bf16(A a, const __nv_bfloat16* __restrict__ wt,
               __nv_bfloat16* __restrict__ y, float* __restrict__ ps,
               float* __restrict__ pss, int N, int K) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  a.init(m0, tid);
  float acc[4][4][4];
  gemm_bf16(acc, a, wt, N, K, n0, tid, wm, wn, g, c2);
  if (RELU) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][ni][e] = fmaxf(acc[mi][ni][e], 0.f);
  }
  if (STORE) store_bf16(acc, y, a.M, N, m0, n0, wm, wn, g, c2);
  col_sums_bf16(acc, ps, pss, N, n0, blockIdx.x, tid, warp, wn, g, c2);
}

// ---------------------------------------------------------------------------
// fp32: FMA, exact fp32
// ---------------------------------------------------------------------------

// One (64, 16) tile of A at k0: one float4 per thread, zero where the
// loader says so.
template <class A>
__device__ __forceinline__ float4 fetch_a(const A& a, int k0, int tid) {
  const float* p[1];
  a.gather(p, k0 + (tid & 3) * 4);
  return p[0] ? *reinterpret_cast<const float4*>(p[0])
              : make_float4(0.f, 0.f, 0.f, 0.f);
}

// ... and of the row-major (N, K) weight at (n0, k0).
__device__ __forceinline__ float4 fetch_w(const float* wt, int N, int K,
                                          int n0, int k0, int tid) {
  const int r = tid >> 2, c = (tid & 3) * 4;
  if (n0 + r < N && k0 + c < K)
    return *reinterpret_cast<const float4*>(wt + (size_t)(n0 + r) * K + k0 +
                                            c);
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
// z = A @ wt^T; `a` has been init-ed with the CTA's m0.
template <class A>
__device__ __forceinline__ void gemm_fp32(float (&acc)[4][4], const A& a,
                                          const float* wt, int N, int K,
                                          int n0, int tid, int ty, int tx) {
  __shared__ __align__(16) float As[2][FBK * FLD];
  __shared__ __align__(16) float Bs[2][FBK * FLD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int kt_n = (K + FBK - 1) / FBK;
  stash_fp32(As[0], fetch_a(a, 0, tid), tid);
  stash_fp32(Bs[0], fetch_w(wt, N, K, n0, 0, tid), tid);
  __syncthreads();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt & 1;
    float4 na = make_float4(0.f, 0.f, 0.f, 0.f), nb = na;
    if (kt + 1 < kt_n) {
      na = fetch_a(a, (kt + 1) * FBK, tid);
      nb = fetch_w(wt, N, K, n0, (kt + 1) * FBK, tid);
    }
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 av4 = *reinterpret_cast<const float4*>(As[st] + k * FLD +
                                                          ty * 4);
      const float4 bv4 = *reinterpret_cast<const float4*>(Bs[st] + k * FLD +
                                                          tx * 4);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
      const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
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

// Column sums over the tile's 64 rows: the thread's 4 rows, then ty and
// ty ^ 1 (lanes l, l ^ 16), then the 8 warps in order through shared
// memory; written to row `mt` of the partials.
__device__ __forceinline__ void col_sums_fp32(const float (&acc)[4][4],
                                              float* __restrict__ ps,
                                              float* __restrict__ pss, int N,
                                              int n0, int mt, int tid,
                                              int tx) {
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
    const size_t o = (size_t)mt * N + n0 + tid;
    ps[o] = a;
    pss[o] = b;
  }
}

template <class A, bool STORE, bool RELU>
__global__ void __launch_bounds__(FNT)
    stats_fp32(A a, const float* __restrict__ wt, float* __restrict__ y,
               float* __restrict__ ps, float* __restrict__ pss, int N,
               int K) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  a.init(m0, tid);
  float acc[4][4];
  gemm_fp32(acc, a, wt, N, K, n0, tid, ty, tx);
  if (RELU) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaxf(acc[i][j], 0.f);
  }
  const int col = n0 + tx * 4;   // N % 8 == 0: the 4 columns are all in
  if (STORE && col < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row < a.M)
        *reinterpret_cast<float4*>(y + (size_t)row * N + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  col_sums_fp32(acc, ps, pss, N, n0, blockIdx.x, tid, tx);
}

// Rows of A per CTA (hence rows of the partial-sum scratch per m-tile),
// and the grid, by dtype: 0 = float32, 1 = bfloat16.
inline int m_tile(int dtype) { return dtype == 0 ? FBM : BM; }

inline dim3 grid_of(int M, int N, int dtype) {
  const int bm = m_tile(dtype), bn = dtype == 0 ? FBN : BN;
  return dim3((M + bm - 1) / bm, (N + bn - 1) / bn);
}

}  // namespace conv
}  // namespace mxt

// The fp32 GEMM building blocks of the conv / batch-norm kernels: the
// correctness route of the KxK conv with batch-norm statistics
// (convkxk_bn_stats.cu) and of conv_bn_epilogue.cu's kernels, whose bf16
// kernels are persistent TMA + wgmma GEMMs (gemm_wgmma_sm90.cuh).
//
// Each CTA computes one (m-tile, n-tile) of z = A @ wt^T in fp32 registers:
// A has M rows and K columns and is read through a loader, wt is the
// contiguous (N, K) weight -- an OHWI conv weight (Cout, kh, kw, Cin) as it
// lies in memory. The loaders:
//   DenseA: A = x, a contiguous (M, K) matrix (the 1x1 conv's NHWC input
//     seen as (N*H*W, Cin));
//   ConvA: A = the implicit im2col matrix of a stride-1 KxK NHWC conv with
//     symmetric zero padding: row m = (image, oy, ox), column k = (dy, dx,
//     ci) in the weight's order, entry x[image, oy + dy - ph, ox + dx - pw,
//     ci], 0 where that pixel lies in the padding.
// K and N are multiples of 8 and, for ConvA, so is Cin: a 16-byte vector
// of A never straddles a row's end or a tap. Vectors past M, N or K, and
// ConvA's padding, are zero-filled on load, so they add 0 to every sum.
// FMA in exact fp32 (no TF32), CTA tile 64 x 64 x 16, 256 threads each
// owning 4 x 4 of the output, the next k-tile fetched into registers
// during the current one's products.
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

constexpr int FBM = 64;       // rows per CTA
constexpr int FBN = 64;       // columns per CTA
constexpr int FBK = 16;       // k per stage
constexpr int FNT = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int FLD = FBM + 4;  // shared row stride (FBM == FBN)

// Every thread loads the same rows of every k-tile: (tid >> 2) + 32 i of
// the CTA's tile (i = 0 for the fp32 tiles), at columns k0 + (tid & 3) * 4.
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

// Rows of A per CTA (hence rows of the partial-sum scratch per m-tile) of
// the per-tile kernels, by dtype: 0 = float32; -1 for bfloat16 (1), whose
// kernels keep no per-tile partials.
inline int m_tile(int dtype) { return dtype == 0 ? FBM : -1; }

inline dim3 grid_of(int M, int N) {
  return dim3((M + FBM - 1) / FBM, (N + FBN - 1) / FBN);
}

}  // namespace conv
}  // namespace mxt

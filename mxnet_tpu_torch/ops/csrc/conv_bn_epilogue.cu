// Fused 1x1-conv / batch-norm kernels for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces three Pallas TPU kernels of mxnet_tpu/ops/pallas_kernels.py. Two
// run for every bottleneck 1x1 conv of the ResNet train step under
// MXNET_FUSED_EPILOGUE (through `conv1x1_bn_act_train`), one for every 1x1
// conv that feeds a BatchNorm under MXNET_FUSED_CONV_BN (through
// `conv1x1_bn_stats_train`):
//
//   matmul_stats    (`_mm_statsonly_kernel`, launched by `matmul_stats`):
//       per-column s = sum_i z_ij and ss = sum_i z_ij^2 in fp32 of
//       z = x @ w, without writing z;
//   matmul_epilogue (`_mm_epilogue_kernel`, launched by `matmul_epilogue`):
//       out = act(z * scale + shift [+ residual]) in x's dtype, with scale
//       and shift fp32 per column and the residual added before the relu;
//   matmul_bn_stats (`_mm_stats_kernel`, launched by `matmul_bn_stats`):
//       y = act(z) written in x's dtype, and per-column s and ss of act(z)
//       from the fp32 accumulator, before y's rounding.
//
// Layout: x is contiguous (M, K); the weight comes as wt = w^T, contiguous
// (N, K) -- the OHWI 1x1 conv weight (Cout, Cin) as it lies in memory. K
// and N are multiples of 8 (rows are read as 16-byte vectors, columns
// stored in pairs); any M >= 1: rows past M are zero-filled on load, so
// they add 0 to the sums, and their stores are skipped.
//
// Design: conv_gemm_sm90.cuh (one CTA per (m-tile, n-tile), mma.sync for
// bf16 and FMA for fp32, per-CTA partial statistics in an (m_tiles, N)
// scratch that the wrapper sums in a fixed order: no atomics, so the
// statistics repeat bit for bit, which the fused-vs-unfused checks rely on).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense,
// 67 TFLOP/s fp32): 2*M*K*N operations each; bytes: matmul_stats reads x
// and w and writes 2N floats, matmul_epilogue also writes out and reads the
// residual, matmul_bn_stats writes y. At the ResNet-50 bf16 batch-128
// sites:
//   stage-1 conv3 (M 401408, K 64, N 256): 13.2 GFLOP -> 13 us of
//     tensor-core time; matmul_stats 51 MB -> 15 us of memory;
//     matmul_epilogue (residual) 462 MB -> 138 us; matmul_bn_stats 257 MB
//     -> 77 us: the last two memory-bound.
//   stage-4 conv3 (M 6272, K 512, N 2048): 13.2 GFLOP -> 13 us of
//     tensor-core time; 8.5 MB (stats) / 60 MB (epilogue, 18 us) / 34 MB
//     (bn_stats, 10 us).
// This first version is plain: mma.sync rather than wgmma, cp.async rather
// than TMA, 4-byte epilogue stores, and no persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_gemm_sm90.cuh"

namespace {

using namespace mxt::conv;

using Dense16 = DenseA<__nv_bfloat16, AROWS>;
using Dense32 = DenseA<float, 1>;

template <bool RES, bool RELU>
__global__ void __launch_bounds__(NT)
    epilogue_bf16(Dense16 a, const __nv_bfloat16* __restrict__ wt,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift,
                  const __nv_bfloat16* __restrict__ res,
                  __nv_bfloat16* __restrict__ out, int N, int K) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  a.init(m0, tid);
  float acc[4][4][4];
  gemm_bf16(acc, a, wt, N, K, n0, tid, wm, wn, g, c2);

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
        if (row >= a.M) continue;
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

template <bool RES, bool RELU>
__global__ void __launch_bounds__(FNT)
    epilogue_fp32(Dense32 a, const float* __restrict__ wt,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift,
                  const float* __restrict__ res, float* __restrict__ out,
                  int N, int K) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;
  a.init(m0, tid);
  float acc[4][4];
  gemm_fp32(acc, a, wt, N, K, n0, tid, ty, tx);
  const int col = n0 + tx * 4;   // N % 8 == 0: the 4 columns are all in
  if (col >= N) return;
  const float4 sc = *reinterpret_cast<const float4*>(scale + col);
  const float4 sh = *reinterpret_cast<const float4*>(shift + col);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= a.M) break;
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
         dtype > 1 || grid_of(M, N, dtype).y > 65535;
}

template <bool RES, bool RELU>
void launch_epilogue(const void* x, const void* wt, const float* scale,
                     const float* shift, const void* res, void* out, int M,
                     int N, int K, int dtype, cudaStream_t st) {
  const dim3 grid = grid_of(M, N, dtype);
  if (dtype == 0)
    epilogue_fp32<RES, RELU><<<grid, FNT, 0, st>>>(
        Dense32{static_cast<const float*>(x), M, K},
        static_cast<const float*>(wt), scale, shift,
        static_cast<const float*>(res), static_cast<float*>(out), N, K);
  else
    epilogue_bf16<RES, RELU><<<grid, NT, 0, st>>>(
        Dense16{static_cast<const __nv_bfloat16*>(x), M, K},
        static_cast<const __nv_bfloat16*>(wt), scale, shift,
        static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(out), N, K);
}

// The statistics kernels: y (STORE) and the partial sums of act(x @ w).
template <bool STORE, bool RELU>
void launch_stats(const void* x, const void* wt, void* y, void* ps,
                  void* pss, int M, int N, int K, int dtype,
                  cudaStream_t st) {
  const dim3 grid = grid_of(M, N, dtype);
  if (dtype == 0)
    stats_fp32<Dense32, STORE, RELU><<<grid, FNT, 0, st>>>(
        Dense32{static_cast<const float*>(x), M, K},
        static_cast<const float*>(wt), static_cast<float*>(y),
        static_cast<float*>(ps), static_cast<float*>(pss), N, K);
  else
    stats_bf16<Dense16, STORE, RELU><<<grid, NT, 0, st>>>(
        Dense16{static_cast<const __nv_bfloat16*>(x), M, K},
        static_cast<const __nv_bfloat16*>(wt),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(ps),
        static_cast<float*>(pss), N, K);
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
  launch_stats<false, false>(x, wt, nullptr, ps, pss, M, N, K, dtype,
                             static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// y: (M, N) in x's dtype, act(z); ps, pss as for mxt_matmul_stats, of
// act(z) in fp32.
extern "C" int mxt_matmul_bn_stats(const void* x, const void* wt, void* y,
                                   void* ps, void* pss, int M, int N, int K,
                                   int relu, int dtype, void* stream) {
  if (bad_shape(M, N, K, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (relu)
    launch_stats<true, true>(x, wt, y, ps, pss, M, N, K, dtype, st);
  else
    launch_stats<true, false>(x, wt, y, ps, pss, M, N, K, dtype, st);
  return (int)cudaGetLastError();
}

// out: (M, N) in x's dtype; residual: (M, N) in x's dtype, or null.
extern "C" int mxt_matmul_epilogue(const void* x, const void* wt,
                                   const void* scale, const void* shift,
                                   const void* residual, void* out, int M,
                                   int N, int K, int relu, int dtype,
                                   void* stream) {
  if (bad_shape(M, N, K, dtype)) return (int)cudaErrorInvalidValue;
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

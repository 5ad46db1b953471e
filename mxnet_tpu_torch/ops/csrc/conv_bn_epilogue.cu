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
// and N are multiples of 8 (a TMA map's row stride is a multiple of 16
// bytes; the fp32 kernels read rows as 16-byte vectors and store columns in
// fours); any M >= 1: rows past M are zero-filled on load, so they add 0
// to the sums, and their stores are clipped.
//
// bf16: all three kernels are one persistent TMA + wgmma GEMM,
// `gemm_wgmma<BN, NRB, KIND>` of gemm_wgmma_sm90.cuh (which describes the
// ring, the producer threads, the TMA stores and the statistics' running
// sums and final sum), that differ after the product. The n-tile runs
// fastest in the static walk, so the n-tiles of one m-tile run together: x
// is read from HBM once, even where it outgrows the 50 MB L2 (stage 1),
// and its other n-tiles' reads hit L2. x and wt are K-major 2-D TMA maps
// (a 3-D map with n = 1). Tiles of matmul_epilogue are 64, 128 or 256
// columns, the least that covers N (256 above), with two tile buffers,
// except at 256-column tiles with K >= DEEP_K, where one buffer leaves room
// for a third ring stage; the statistics kernels take 64- or 128-column
// tiles (`stats_tile_n`; 256 columns, lanes g and g ^ 4 splitting the
// column groups, measured slower at every 1x1 site of the ResNet-50 step:
// tools/torch_stats_ablation.py builds that variant); matmul_stats stores
// nothing, has no tile buffer and takes the deepest ring.
//
// fp32 (a correctness route, not the timed path): FMA kernels of
// conv_gemm_sm90.cuh, one CTA per (m-tile, n-tile), per-CTA partial
// statistics in an (m_tiles, N) scratch that the wrapper sums.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense,
// 67 TFLOP/s fp32): 2*M*K*N operations each; bytes: matmul_stats reads x
// and w and writes 2N floats, matmul_epilogue also writes out and reads the
// residual, matmul_bn_stats writes y. At the ResNet-50 bf16 batch-128
// sites:
//   stage-1 conv3 (M 401408, K 64, N 256): 13.2 GFLOP -> 13 us of
//     tensor-core time; matmul_stats 51 MB -> 15 us of memory;
//     matmul_epilogue (residual) 462 MB -> 138 us; matmul_bn_stats 257 MB
//     -> 77 us: all three memory-bound.
//   stage-4 conv3 (M 6272, K 512, N 2048): 13.2 GFLOP -> 13 us of
//     tensor-core time, the bound of matmul_stats (8.5 MB) and of
//     matmul_bn_stats (34 MB, 10 us); matmul_epilogue 60 MB -> 18 us.
// At stage 1 matmul_epilogue and matmul_bn_stats stream HBM: one CTA per
// SM keeps the ring's x, the next tile buffer and the last tile's store in
// flight at once. matmul_stats there is held by the consumers: each
// 128 x 128 tile is one k-box of products, then its column sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_gemm_sm90.cuh"
#include "gemm_wgmma_sm90.cuh"

namespace {

using namespace mxt::conv;

using Dense32 = DenseA<float, 1>;

// ---------------------------------------------------------------------------
// bf16: persistent TMA + wgmma GEMM with the epilogue or the statistics
// ---------------------------------------------------------------------------

namespace wg {

using namespace mxt::sm90;
using namespace mxt::gemm;

// Columns per tile of matmul_epilogue for N output columns: the least of
// 64, 128 and 256 that covers N, and 256 for wider N.
inline int tile_n(int N) { return N <= 64 ? 64 : N <= 128 ? 128 : 256; }

// Calls f with the Tag of the kernel that takes N and K: BN = tile_n(N)
// with two tile buffers, one at 256-column tiles with K >= DEEP_K, for
// matmul_epilogue; BN = stats_tile_n(N) with two tile buffers for
// matmul_bn_stats, none for matmul_stats.
template <int KIND, class F>
auto dispatch(int N, int K, F&& f) {
  if constexpr (KIND != kEpilogue) {
    constexpr int NRB = KIND == kStats ? 0 : 2;
    return stats_tile_n(N) == 64 ? f(Tag<64, NRB>{}) : f(Tag<128, NRB>{});
  } else {
    const int bn = tile_n(N);
    return bn == 64      ? f(Tag<64, 2>{})
           : bn == 128   ? f(Tag<128, 2>{})
           : K < DEEP_K ? f(Tag<256, 2>{})
                        : f(Tag<256, 1>{});
  }
}

// One launch of the family. out: matmul_epilogue's output or
// matmul_bn_stats's y (null for matmul_stats); res: the residual or null;
// grid: min(tiles, SMs) for matmul_epilogue, R x n-tiles for the
// statistics.
template <int BN, int NRB, int KIND>
cudaError_t launch(const void* x, const void* wt, const void* res, void* out,
                   const float* scale, const float* shift, float* parts,
                   float* sums, unsigned* counters, int M, int N, int K,
                   int relu, int grid, cudaStream_t st) {
  using L = Smem<BN, NRB>;
  const CUtensorMapDataType ty = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap m[4];
  cudaError_t err = encode_rows_map(&m[0], x, 1, M, K, TM, ty);
  if (err == cudaSuccess) err = encode_rows_map(&m[1], wt, 1, N, K, BN, ty);
  // maps that are never read describe x or the output
  if (err == cudaSuccess && out != nullptr)
    err = encode_rows_map(&m[3], out, 1, M, N, TM, ty);
  if (err != cudaSuccess) return err;
  if (out == nullptr) m[3] = m[0];
  m[2] = m[3];
  if (res != nullptr) err = encode_rows_map(&m[2], res, 1, M, N, TM, ty);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_wgmma<BN, NRB, KIND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::BYTES);
  if (err != cudaSuccess) return err;
  gemm_wgmma<BN, NRB, KIND><<<grid, THREADS, L::BYTES, st>>>(
      m[0], m[1], m[2], m[3], scale, shift, parts, sums, counters, M, N, K,
      res != nullptr, relu, ConvGeom{});
  return cudaGetLastError();
}

// The statistics kernels (y null: matmul_stats). scratch: the (2, rows, N)
// fp32 partial sums, then one uint32 counter per n-tile, which are zeroed
// here: each launch has its own, so launches may run at the same time.
cudaError_t launch_stats_wgmma(const void* x, const void* wt, void* y,
                               void* scratch, void* sums, int M, int N, int K,
                               int rows, int relu, cudaStream_t st) {
  if (M <= 0 || N < 8 || K < 8 || N % 8 != 0 || K % 8 != 0)
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int n_nt = (N + stats_tile_n(N) - 1) / stats_tile_n(N);
  if (rows != stats_rows(M, N, sms, stats_tile_n(N)) ||
      (long long)rows * n_nt > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int grid = rows * n_nt;
  float* p = static_cast<float*>(scratch);
  float* s = static_cast<float*>(sums);
  unsigned* c = reinterpret_cast<unsigned*>(p + 2 * (size_t)rows * N);
  err = cudaMemsetAsync(c, 0, n_nt * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  if (y == nullptr)
    return dispatch<kStats>(N, K, [&](auto tag) {
      return launch<decltype(tag)::BN, 0, kStats>(
          x, wt, nullptr, nullptr, nullptr, nullptr, p, s, c, M, N, K, 0,
          grid, st);
    });
  return dispatch<kStatsStore>(N, K, [&](auto tag) {
    using T = decltype(tag);
    return launch<T::BN, T::NRB, kStatsStore>(x, wt, nullptr, y, nullptr,
                                              nullptr, p, s, c, M, N, K, relu,
                                              grid, st);
  });
}

template <int KIND>
int config(int N, int K, int what) {
  return dispatch<KIND>(N, K, [&](auto tag) {
    using T = decltype(tag);
    using L = Smem<T::BN, T::NRB>;
    return what == 0 ? L::BYTES : what == 1 ? L::NST : T::NRB;
  });
}

}  // namespace wg

// ---------------------------------------------------------------------------
// fp32
// ---------------------------------------------------------------------------

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
         dtype > 1 || grid_of(M, N).y > 65535;
}

template <bool RES, bool RELU>
void launch_epilogue_fp32(const float* x, const float* wt, const float* scale,
                          const float* shift, const float* res, float* out,
                          int M, int N, int K, cudaStream_t st) {
  epilogue_fp32<RES, RELU><<<grid_of(M, N), FNT, 0, st>>>(
      Dense32{x, M, K}, wt, scale, shift, res, out, N, K);
}

// The per-tile fp32 statistics kernels: y (STORE) and the partial sums of
// act(x @ w), one row per m-tile.
template <bool STORE, bool RELU>
void launch_stats_fp32(const float* x, const float* wt, float* y, float* ps,
                       float* pss, int M, int N, int K, cudaStream_t st) {
  stats_fp32<Dense32, STORE, RELU><<<grid_of(M, N), FNT, 0, st>>>(
      Dense32{x, M, K}, wt, y, ps, pss, N, K);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernels do not take (or, for a
// TMA kernel, a map cuTensorMapEncodeTiled refuses), else the first error
// of the launch, else cudaGetLastError() right after it.

// Rows of x per CTA of the per-tile (fp32) statistics kernels, hence rows
// of their partial-sum scratch per m-tile; -1 for bf16, which has none.
extern "C" int mxt_conv_bn_m_tile(int dtype) { return m_tile(dtype); }

// The per-tile statistics kernels, fp32 only (dtype 0; bf16 runs the wgmma
// kernels below). ps, pss: (ceil(M / m_tile), N) fp32 partial column sums
// of z and z^2.
extern "C" int mxt_matmul_stats(const void* x, const void* wt, void* ps,
                                void* pss, int M, int N, int K, int dtype,
                                void* stream) {
  if (dtype != 0 || bad_shape(M, N, K, 0)) return (int)cudaErrorInvalidValue;
  launch_stats_fp32<false, false>(
      static_cast<const float*>(x), static_cast<const float*>(wt), nullptr,
      static_cast<float*>(ps), static_cast<float*>(pss), M, N, K,
      static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// y: (M, N) fp32, act(z); ps, pss as for mxt_matmul_stats, of act(z).
extern "C" int mxt_matmul_bn_stats(const void* x, const void* wt, void* y,
                                   void* ps, void* pss, int M, int N, int K,
                                   int relu, int dtype, void* stream) {
  if (dtype != 0 || bad_shape(M, N, K, 0)) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wt);
  float *yf = static_cast<float*>(y), *pf = static_cast<float*>(ps),
        *qf = static_cast<float*>(pss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (relu)
    launch_stats_fp32<true, true>(xf, wf, yf, pf, qf, M, N, K, st);
  else
    launch_stats_fp32<true, false>(xf, wf, yf, pf, qf, M, N, K, st);
  return (int)cudaGetLastError();
}

// Rows of the bf16 statistics kernels' partial-sum scratch for M x N
// outputs on the current device, or -1 if the device cannot be queried.
extern "C" int mxt_stats_rows(int M, int N) {
  int sms = 0;
  if (M <= 0 || N <= 0 || wg::sm_count(&sms) != cudaSuccess) return -1;
  return wg::stats_rows(M, N, sms, wg::stats_tile_n(N));
}

// The bf16 statistics kernels (K and N multiples of 8, M >= 1). scratch:
// 2 x rows x N fp32 partial sums, rows = mxt_stats_rows(M, N), followed by
// room for ceil(N / 64) uint32 counters, which the launch zeroes; sums:
// (2, N) fp32, the column sums of z and z^2 (of act(z) with y).
extern "C" int mxt_matmul_stats_wgmma(const void* x, const void* wt,
                                      void* scratch, void* sums, int M, int N,
                                      int K, int rows, void* stream) {
  return (int)wg::launch_stats_wgmma(x, wt, nullptr, scratch, sums, M, N, K,
                                     rows, 0,
                                     static_cast<cudaStream_t>(stream));
}

// y: (M, N) bf16, act(z); the rest as for mxt_matmul_stats_wgmma.
extern "C" int mxt_matmul_bn_stats_wgmma(const void* x, const void* wt,
                                         void* y, void* scratch, void* sums,
                                         int M, int N, int K, int rows,
                                         int relu, void* stream) {
  return (int)wg::launch_stats_wgmma(x, wt, y, scratch, sums, M, N, K, rows,
                                     relu,
                                     static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory in bytes (what = 0), ring stages (1) or tile
// buffers (2) of the bf16 statistics kernel for an (M, K) x (K, N) product,
// with the store of y (matmul_bn_stats) or without (matmul_stats).
extern "C" int mxt_stats_config(int N, int K, int store, int what) {
  return store ? wg::config<wg::kStatsStore>(N, K, what)
               : wg::config<wg::kStats>(N, K, what);
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
  if (dtype == 1) {
    int sms = 0;
    cudaError_t err = wg::sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    const int bn = wg::tile_n(N);
    const long long tiles = (long long)((M + wg::TM - 1) / wg::TM) *
                            ((N + bn - 1) / bn);
    if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const int grid = (int)(tiles < sms ? tiles : sms);
    return (int)wg::dispatch<wg::kEpilogue>(N, K, [&](auto tag) {
      using T = decltype(tag);
      return wg::launch<T::BN, T::NRB, wg::kEpilogue>(
          x, wt, residual, out, sc, sh, nullptr, nullptr, nullptr, M, N, K,
          relu, grid, st);
    });
  }
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(wt);
  const float* rf = static_cast<const float*>(residual);
  float* of = static_cast<float*>(out);
  if (residual != nullptr) {
    if (relu)
      launch_epilogue_fp32<true, true>(xf, wf, sc, sh, rf, of, M, N, K, st);
    else
      launch_epilogue_fp32<true, false>(xf, wf, sc, sh, rf, of, M, N, K, st);
  } else {
    if (relu)
      launch_epilogue_fp32<false, true>(xf, wf, sc, sh, rf, of, M, N, K, st);
    else
      launch_epilogue_fp32<false, false>(xf, wf, sc, sh, rf, of, M, N, K, st);
  }
  return (int)cudaGetLastError();
}

// Columns per tile of the bf16 matmul_epilogue kernel for N output
// columns, and of the bf16 statistics kernels.
extern "C" int mxt_matmul_epilogue_tile_n(int N) { return wg::tile_n(N); }
extern "C" int mxt_stats_tile_n(int N) { return wg::stats_tile_n(N); }

// Dynamic shared memory in bytes (what = 0), ring stages (1) or tile
// buffers (2) of the bf16 matmul_epilogue kernel for an (M, K) x (K, N)
// product.
extern "C" int mxt_matmul_epilogue_config(int N, int K, int what) {
  return wg::config<wg::kEpilogue>(N, K, what);
}

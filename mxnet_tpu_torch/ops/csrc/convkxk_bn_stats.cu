// Stride-1 KxK NHWC convolution with fused batch-norm statistics for
// Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `_ckxk_kernel` (with `_tap_accumulate`) of
// mxnet_tpu/ops/pallas_kernels.py, launched by `convkxk_bn_stats`, which
// `convkxk_bn_stats_train` runs for every stride-1 KxK conv that feeds a
// BatchNorm under MXNET_FUSED_CONV_BN (the 16 3x3/pad-1 convs of the
// ResNet-50 step): z = conv(x, w) with symmetric zero padding, written in
// x's dtype, and per-channel s = sum z, ss = sum z^2 in fp32 from the fp32
// accumulator, before z's rounding.
//
// Layout: x contiguous NHWC (N, H, W, Cin), w contiguous OHWI (Cout, kh, kw,
// Cin), z contiguous NHWC (N, Ho, Wo, Cout) with Ho = H + 2 ph - kh + 1 and
// Wo likewise; Cin and Cout multiples of 8; 0 <= ph < kh, 0 <= pw < kw.
//
// Design: an implicit GEMM (conv_gemm_sm90.cuh's ConvA loader): M = N Ho Wo
// output pixels, K = kh kw Cin, N = Cout, the weight read in place as the
// (Cout, K) operand. The TPU kernel copies each image into a padded fp32
// VMEM buffer and sums kh*kw shifted matmuls; here each 16-byte vector of
// the A tile is gathered from the tap and pixel it belongs to, and the taps
// that fall in the padding are zero-filled by the copy itself, so no padded
// copy of x exists. bf16 products are exact in fp32, so mma.sync with fp32
// accumulation computes the TPU kernel's fp32 sums in another order; fp32
// takes FMA, never TF32. The statistics go to an (m_tiles, Cout) scratch
// of per-CTA partials that the wrapper sums in a fixed order, as the
// matmul_stats kernel does, where the TPU kernel accumulates over its
// ordered batch grid axis.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): 2 M K N
// operations; x, w read once and z written once. At the ResNet-50 bf16
// batch-128 3x3 sites:
//   stage 1 (128, 56, 56, 64) -> 64: 29.6 GFLOP -> 30 us of tensor-core
//     time, 103 MB -> 31 us of memory;
//   stage 4 (128, 7, 7, 512) -> 512: 29.6 GFLOP -> 30 us, 18 MB -> 5 us.
// This first version is plain: mma.sync rather than wgmma, cp.async
// gathers rather than TMA im2col, the tap split recomputed per k-tile, no
// persistent schedule.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_gemm_sm90.cuh"

namespace {

using namespace mxt::conv;

using Conv16 = ConvA<__nv_bfloat16, AROWS>;
using Conv32 = ConvA<float, 1>;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.

// Output pixels per CTA, hence rows of the partial-sum scratch per m-tile.
extern "C" int mxt_convkxk_m_tile(int dtype) { return m_tile(dtype); }

// z: (n, ho, wo, cout) in x's dtype; ps, pss: (ceil(n ho wo / m_tile),
// cout) fp32 partial channel sums of z and z^2. Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take, else
// cudaGetLastError() right after the launch.
extern "C" int mxt_convkxk_bn_stats(const void* x, const void* w, void* z,
                                    void* ps, void* pss, int n, int h,
                                    int wd, int cin, int cout, int kh,
                                    int kw, int ph, int pw, int dtype,
                                    void* stream) {
  const long long ho = (long long)h + 2 * ph - kh + 1;
  const long long wo = (long long)wd + 2 * pw - kw + 1;
  const long long m = n * ho * wo, k = (long long)kh * kw * cin;
  if (n <= 0 || h <= 0 || wd <= 0 || cin < 8 || cin % 8 != 0 || cout < 8 ||
      cout % 8 != 0 || kh <= 0 || kw <= 0 || ph < 0 || ph >= kh || pw < 0 ||
      pw >= kw || ho <= 0 || wo <= 0 || m > INT_MAX || k > INT_MAX ||
      dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int M = (int)m, K = (int)k;
  const dim3 grid = grid_of(M, cout, dtype);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const ConvShape s{h, wd, cin, kw, ph, pw, (int)ho, (int)wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    stats_fp32<Conv32, true, false><<<grid, FNT, 0, st>>>(
        Conv32{static_cast<const float*>(x), M, K, s},
        static_cast<const float*>(w), static_cast<float*>(z),
        static_cast<float*>(ps), static_cast<float*>(pss), cout, K);
  else
    stats_bf16<Conv16, true, false><<<grid, NT, 0, st>>>(
        Conv16{static_cast<const __nv_bfloat16*>(x), M, K, s},
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(z), static_cast<float*>(ps),
        static_cast<float*>(pss), cout, K);
  return (int)cudaGetLastError();
}

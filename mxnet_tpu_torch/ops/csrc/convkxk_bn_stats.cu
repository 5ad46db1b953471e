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
// Design: an implicit GEMM, M = N Ho Wo output pixels, K = kh kw Cin,
// N = Cout. The TPU kernel copies each image into a padded fp32 VMEM
// buffer and sums kh*kw shifted matmuls; no padded copy of x exists here.
// bf16 runs the persistent TMA + wgmma GEMM of the 1x1 statistics kernels
// (gemm_wgmma_sm90.cuh, KIND kConvStats), which also describes the
// statistics: running column sums per thread across the CTA's tiles, one
// scratch row per CTA, the final sum by the last CTA of each n-tile, all in
// one launch and bitwise repeatable. A is read by TMA in im2col mode: one
// load per (tap, 64-channel block) k-box brings the tile's 128 output
// pixels' inputs at that tap, the hardware walking the pixels across rows
// and images and zero-filling the padding, the pixels past M and the
// channels past Cin. B is the OHWI weight as it lies, a 3-D (Cin, taps,
// Cout) map. Tiles are 128 pixels by 64, 128 or 256 columns
// (`conv_tile_n`). Measured (PERF.md): an input band a tile in place of
// the per-tap loads, and the weight panel kept in shared memory, gained
// nothing at stage 1; the deep ring and 256-column tiles at stage 4 did
// (tools/torch_kxk_int8_ablation.py times these two). The im2col map's
// bounding box takes corners in [-128, 127] (`im2col_fits`); wider kernels
// or pads run the fp32 kernel (the wrapper converts x and w and rounds z).
// bf16 products are exact in fp32, so the sums are the TPU kernel's fp32
// sums in another order.
//
// fp32 (a correctness route): conv_gemm_sm90.cuh's ConvA loader and FMA
// tiles, never TF32, per-CTA partial statistics in an (m_tiles, Cout)
// scratch that the wrapper sums in a fixed order.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): 2 M K N
// operations; x, w read once and z written once. At the ResNet-50 bf16
// batch-128 3x3 sites every conv is 29.6 GFLOP -> 30 us of tensor-core
// time; stage 1 (128, 56, 56, 64) -> 64 moves 103 MB -> 31 us of memory,
// stage 4 (128, 7, 7, 512) -> 512 18 MB -> 5 us. The per-tap loads read
// each input pixel kh*kw times, from L2 after the first: 9 x 51 MB at
// stage 1.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_gemm_sm90.cuh"
#include "gemm_wgmma_sm90.cuh"

namespace {

using namespace mxt::conv;

using Conv32 = ConvA<float, 1>;

// The conv of one call, as the host sees it.
struct Conv {
  int n, h, w, cin, cout, kh, kw, ph, pw, ho, wo;
  int M() const { return n * ho * wo; }
  int ncb() const { return (cin + 63) / 64; }
  int n_kb() const { return kh * kw * ncb(); }
};

// The arguments the kernels take: Cin and Cout multiples of 8, pad <
// kernel, a non-empty output, M and K below 2^31. Fills c.
bool conv_of(Conv* c, int n, int h, int wd, int cin, int cout, int kh,
             int kw, int ph, int pw) {
  const long long ho = (long long)h + 2 * ph - kh + 1;
  const long long wo = (long long)wd + 2 * pw - kw + 1;
  const long long m = n * ho * wo, k = (long long)kh * kw * cin;
  if (n <= 0 || h <= 0 || wd <= 0 || cin < 8 || cin % 8 != 0 || cout < 8 ||
      cout % 8 != 0 || kh <= 0 || kw <= 0 || ph < 0 || ph >= kh || pw < 0 ||
      pw >= kw || ho <= 0 || wo <= 0 || m > INT_MAX || k > INT_MAX)
    return false;
  *c = Conv{n, h, wd, cin, cout, kh, kw, ph, pw, (int)ho, (int)wo};
  return (long long)kh * kw * c->ncb() <= INT_MAX;
}

namespace wg {

using namespace mxt::sm90;
using namespace mxt::gemm;

// Columns per tile for M output pixels and cout channels on sms SMs: 64
// for cout <= 64, else 128, or 256 (lanes splitting the running sums,
// gemm_wgmma_sm90.cuh `Cols`) from 256 channels on where the busiest CTA
// then has no more columns to compute: x's k-boxes cross L2 for half as
// many n-tiles (ResNet-50's stage 4), but where 256 leaves fewer, larger
// tiles than SMs can share evenly (stage 3), 128 is faster.
inline int conv_tile_n(int M, int cout, int sms) {
  if (cout <= 64) return 64;
  const long long mt = (M + TM - 1) / TM;
  const long long w128 = (mt * ((cout + 127) / 128) + sms - 1) / sms * 128;
  const long long w256 = (mt * ((cout + 255) / 256) + sms - 1) / sms * 256;
  return cout >= 256 && w256 <= w128 ? 256 : 128;
}

// Calls f with the Tag of the kernel for bn-column tiles: 256-column tiles
// with one tile buffer (a third ring stage), narrower ones with two.
template <class F>
auto pick(int bn, F&& f) {
  return bn == 256 ? f(Tag<256, 1>{})
         : bn == 128 ? f(Tag<128, 2>{})
                     : f(Tag<64, 2>{});
}

template <int BN, int NRB>
cudaError_t launch(const void* x, const void* w, void* z, float* parts,
                   float* sums, unsigned* counters, const Conv& c, int grid,
                   cudaStream_t st) {
  using L = Smem<BN, NRB>;
  const CUtensorMapDataType ty = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int taps = c.kh * c.kw;
  CUtensorMap m[3];
  cudaError_t err = encode_im2col_4d(&m[0], x, c.n, c.h, c.w, c.cin, c.kh,
                                     c.kw, c.ph, c.pw, TM, ty);
  if (err == cudaSuccess)
    err = encode_map_3d(&m[1], w, c.cout, taps, c.cin, 2, 64, 1, BN, ty,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = encode_rows_map(&m[2], z, 1, c.M(), c.cout, TM, ty);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_wgmma<BN, NRB, kConvStats>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::BYTES);
  if (err != cudaSuccess) return err;
  const ConvGeom g{c.ho * c.wo, c.wo, c.ph, c.pw, c.kw, c.ncb(), c.n_kb()};
  gemm_wgmma<BN, NRB, kConvStats><<<grid, THREADS, L::BYTES, st>>>(
      m[0], m[1], m[2], m[2], nullptr, nullptr, parts, sums, counters,
      c.M(), c.cout, taps * c.cin, 0, 0, g);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const void* x, const void* w, void* z,
                         void* scratch, void* sums, const Conv& c, int rows,
                         cudaStream_t st) {
  if (!im2col_fits(c.kh, c.kw, c.ph, c.pw)) return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int bn = conv_tile_n(c.M(), c.cout, sms);
  const int n_nt = (c.cout + bn - 1) / bn;
  if (rows != stats_rows(c.M(), c.cout, sms, bn) ||
      (long long)rows * n_nt > 0x7fffffff)
    return cudaErrorInvalidValue;
  float* p = static_cast<float*>(scratch);
  unsigned* cnt = reinterpret_cast<unsigned*>(p + 2 * (size_t)rows * c.cout);
  err = cudaMemsetAsync(cnt, 0, n_nt * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  return pick(bn, [&](auto tag) {
    using T = decltype(tag);
    return launch<T::BN, T::NRB>(x, w, z, p, static_cast<float*>(sums), cnt,
                                 c, rows * n_nt, st);
  });
}

}  // namespace wg
}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take (or a map
// cuTensorMapEncode* refuses), else the first error of the launch, else
// cudaGetLastError() right after it.

// Output pixels per CTA of the per-tile (fp32) kernel, hence rows of its
// partial-sum scratch per m-tile; -1 for bf16, which has none.
extern "C" int mxt_convkxk_m_tile(int dtype) { return m_tile(dtype); }

// The fp32 kernel (dtype 0; bf16 runs mxt_convkxk_bn_stats_wgmma). z: (n,
// ho, wo, cout) fp32; ps, pss: (ceil(n ho wo / m_tile), cout) fp32 partial
// channel sums of z and z^2.
extern "C" int mxt_convkxk_bn_stats(const void* x, const void* w, void* z,
                                    void* ps, void* pss, int n, int h,
                                    int wd, int cin, int cout, int kh,
                                    int kw, int ph, int pw, int dtype,
                                    void* stream) {
  Conv c;
  if (dtype != 0 || !conv_of(&c, n, h, wd, cin, cout, kh, kw, ph, pw))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(c.M(), cout);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const ConvShape s{h, wd, cin, kw, ph, pw, c.ho, c.wo};
  stats_fp32<Conv32, true, false>
      <<<grid, FNT, 0, static_cast<cudaStream_t>(stream)>>>(
          Conv32{static_cast<const float*>(x), c.M(), kh * kw * cin, s},
          static_cast<const float*>(w), static_cast<float*>(z),
          static_cast<float*>(ps), static_cast<float*>(pss), cout,
          kh * kw * cin);
  return (int)cudaGetLastError();
}

// Whether the bf16 kernel's im2col map takes a kernel (kh, kw) with
// padding (ph, pw): the map's bounding-box corners within [-128, 127].
extern "C" int mxt_convkxk_tma_fits(int kh, int kw, int ph, int pw) {
  return mxt::sm90::im2col_fits(kh, kw, ph, pw) ? 1 : 0;
}

// Rows of the bf16 kernel's partial-sum scratch for M output pixels and
// Cout channels on the current device, or -1 if the device cannot be
// queried.
extern "C" int mxt_convkxk_stats_rows(int M, int cout) {
  int sms = 0;
  if (M <= 0 || cout <= 0 || wg::sm_count(&sms) != cudaSuccess) return -1;
  return wg::stats_rows(M, cout, sms, wg::conv_tile_n(M, cout, sms));
}

// Columns per tile of the bf16 kernel for M output pixels and cout
// channels on the current device, or -1 if it cannot be queried.
extern "C" int mxt_convkxk_tile_n(int M, int cout) {
  int sms = 0;
  if (M <= 0 || cout <= 0 || wg::sm_count(&sms) != cudaSuccess) return -1;
  return wg::conv_tile_n(M, cout, sms);
}

// The bf16 kernel. z: (n, ho, wo, cout) bf16; scratch: 2 x rows x cout
// fp32 partial sums, rows = mxt_convkxk_stats_rows(n ho wo, cout),
// followed by room for ceil(cout / 64) uint32 counters, which the launch
// zeroes; sums: (2, cout) fp32, the channel sums of z and z^2.
extern "C" int mxt_convkxk_bn_stats_wgmma(const void* x, const void* w,
                                          void* z, void* scratch, void* sums,
                                          int n, int h, int wd, int cin,
                                          int cout, int kh, int kw, int ph,
                                          int pw, int rows, void* stream) {
  Conv c;
  if (!conv_of(&c, n, h, wd, cin, cout, kh, kw, ph, pw))
    return (int)cudaErrorInvalidValue;
  return (int)wg::launch_wgmma(x, w, z, scratch, sums, c, rows,
                               static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory in bytes (what = 0), ring stages (1) or tile
// buffers (2) of the bf16 kernel for tile_n-column tiles.
extern "C" int mxt_convkxk_config(int tile_n, int what) {
  return wg::pick(tile_n, [&](auto tag) {
    using T = decltype(tag);
    using L = wg::Smem<T::BN, T::NRB>;
    return what == 0 ? L::BYTES : what == 1 ? L::NST : T::NRB;
  });
}

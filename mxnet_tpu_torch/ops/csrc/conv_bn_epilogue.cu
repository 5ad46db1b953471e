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
// bytes; the other kernels read rows as 16-byte vectors and store columns in
// pairs); any M >= 1: rows past M are zero-filled on load, so they add 0 to
// the sums, and their stores are skipped.
//
// Design: matmul_stats and matmul_bn_stats, and every fp32 kernel, on
// conv_gemm_sm90.cuh (one CTA per (m-tile, n-tile), mma.sync for bf16 and
// FMA for fp32, per-CTA partial statistics in an (m_tiles, N) scratch that
// the wrapper sums in a fixed order: no atomics, so the statistics repeat bit
// for bit, which the fused-vs-unfused checks rely on).
//
// matmul_epilogue's bf16 path (`epilogue_wgmma`) is a persistent TMA + wgmma
// GEMM on wgmma_sm90.cuh with the epilogue fused. One CTA per SM walks the
// (m-tile, n-tile) grid with the n-tile fastest, so the n-tiles of one
// m-tile run together and x is served from L2 after its first read; where
// N <= 256 one tile covers the whole of N and x is read once. A tile is 128
// rows (two consumer warpgroups of 64) by BN = 64, 128 or 256 columns, the
// least that covers N (256 above). x and wt are K-major 2-D TMA maps (a 3-D
// map with n = 1) read in 64-wide k-boxes with 128-byte swizzle through a
// ring that runs ahead across tiles, as deep as shared memory allows beside
// the tile buffers; the copy zero-fills rows past M and N and columns past
// K. Each k16 step is one wgmma with both operands from shared memory
// (m64nBNk16). Three threads of the producer warpgroup work apart: one fills
// the ring, one loads each tile's residual by TMA into a tile buffer while
// the ring runs, one stores finished tiles. Two tile buffers, except at
// 256-column tiles with K >= DEEP_K, where one buffer leaves room for a
// third ring stage (a 2-stage ring stalls there). The epilogue computes
// z * scale + shift (scale and shift read once per column per thread), adds
// the residual in fp32, applies the relu and rounds once to bf16 into the
// tile buffer in place, and the storer writes it with a TMA store, which
// clips rows past M and columns past N, while the consumers go on to the
// next tile.
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
// The statistics kernels are still the first, plain version: mma.sync
// rather than wgmma, cp.async rather than TMA, 4-byte stores, and the
// m-tile on blockIdx.x, so x is read from HBM once per n-tile where it
// outgrows L2. At stage 1 matmul_epilogue streams HBM: one CTA per SM keeps
// the ring's x, the next residual tile and the last tile's store in flight
// at once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_gemm_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace mxt::conv;

using Dense16 = DenseA<__nv_bfloat16, AROWS>;
using Dense32 = DenseA<float, 1>;

// ---------------------------------------------------------------------------
// matmul_epilogue, bf16: persistent TMA + wgmma GEMM with the epilogue fused
// ---------------------------------------------------------------------------

namespace wg {

using namespace mxt::sm90;

constexpr int WG = 128;       // threads of a warpgroup
constexpr int RB = 128;       // bytes of a 64-column bf16 tile row
constexpr int TM = 128;       // rows per tile: two consumer warpgroups
constexpr int CONSUMERS = 2 * WG, THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// 256-column tiles take one tile buffer and a deeper ring from this K on
// (4 k-boxes): there the k-loop is long enough to hide the residual's load,
// and a 2-stage ring would stall on every k-box.
constexpr int DEEP_K = 256;

// Shared memory of epilogue_wgmma<BN, NRB>, in bytes from a 1024-byte
// boundary: NST ring stages of (x k-box: 128 rows, wt k-box: BN rows), as
// many (up to 8) as fit beside NRB tile buffers (residual in, out; BN / 64
// chunks of 128 rows x 64 columns), then the barriers full[NST],
// empty[NST], tfull[NRB], tready[NRB], tfree[NRB].
template <int BN, int NRB>
struct EpiSmem {
  static constexpr int TX = TM * RB, TW = BN * RB, STAGE = TX + TW;
  static constexpr int TT = TM * BN * 2, NC = BN / 64;
  static constexpr int FIT = (227 * 1024 - NRB * TT - 1280) / STAGE;
  static constexpr int NST = FIT < 8 ? FIT : 8;
  static constexpr int TILE = NST * STAGE;
  static constexpr int BAR = TILE + NRB * TT;
  static constexpr int BYTES = BAR + (2 * NST + 3 * NRB) * 8 + 1024;
};

template <int BN, int NRB>
__global__ void __launch_bounds__(THREADS, 1)
    epilogue_wgmma(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap tres,
                   const __grid_constant__ CUtensorMap tout,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, int M, int N, int K,
                   int has_res, int relu) {
  using L = EpiSmem<BN, NRB>;
  constexpr int NST = L::NST, NC = L::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + NST;
  uint64_t* tfull = empty + NST;   // tile buffer b holds the residual
  uint64_t* tready = tfull + NRB;  // ... holds the output
  uint64_t* tfree = tready + NRB;  // ... has been read by its store

  const int n_nt = (N + BN - 1) / BN, n_kb = (K + 63) / 64;
  const int n_tiles = (M + TM - 1) / TM * n_nt;

  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMERS);
    }
    for (int b = 0; b < NRB; ++b) {
      mbar_init(&tfull[b], 1);
      mbar_init(&tready[b], CONSUMERS);
      mbar_init(&tfree[b], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / WG;
  if (wgi == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      // ring loads: every tile's k-boxes, running ahead across tiles. Where
      // one tile covers all of N and K, every stage holds the same wt box,
      // loaded on the stage's first fill only.
      const bool w_fixed = n_nt == 1 && n_kb == 1;
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m0 = t / n_nt * TM, n0 = t % n_nt * BN;
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int st = it % NST;
          const bool load_w = !w_fixed || it < NST;
          unsigned char* xs = sm + st * L::STAGE;
          mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], load_w ? L::STAGE : L::TX);
          tma_load_3d(xs, &tx, &full[st], 64 * kb, m0, 0);
          if (load_w) tma_load_3d(xs + L::TX, &tw, &full[st], 64 * kb, n0, 0);
        }
      }
    } else if (threadIdx.x == CONSUMERS + 64) {
      // residual loads: tile li's residual into tile buffer li % NRB once
      // that buffer's last store has read it
      for (int t = blockIdx.x, li = 0; t < n_tiles; t += gridDim.x, ++li) {
        const int m0 = t / n_nt * TM, n0 = t % n_nt * BN;
        const int b = li % NRB;
        unsigned char* tb = sm + L::TILE + b * L::TT;
        mbar_wait(&tfree[b], ((li / NRB) & 1) ^ 1);
        if (has_res) {
          mbar_arrive_expect_tx(&tfull[b], L::TT);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_3d(tb + c * TM * RB, &tres, &tfull[b], n0 + 64 * c, m0,
                        0);
        } else {
          mbar_arrive(&tfull[b]);
        }
      }
    } else if (threadIdx.x == CONSUMERS + 32) {
      // stores: each finished tile buffer, then it is free again
      for (int t = blockIdx.x, li = 0; t < n_tiles; t += gridDim.x, ++li) {
        const int m0 = t / n_nt * TM, n0 = t % n_nt * BN;
        const int b = li % NRB;
        unsigned char* tb = sm + L::TILE + b * L::TT;
        mbar_wait(&tready[b], (li / NRB) & 1);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_store_3d(&tout, tb + c * TM * RB, n0 + 64 * c, m0, 0);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(&tfree[b]);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int rl = wgi * 64 + warp * 16 + g;   // tile rows rl and rl + 8
    float acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x, li = 0; t < n_tiles; t += gridDim.x, ++li) {
      const int n0 = t % n_nt * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

      // z = x wt^T: the products of k-box kb run while the ring fills;
      // stage kb - 1 is released once they are known complete
      for (int kb = 0; kb < n_kb; ++kb, ++it) {
        const int st = it % NST;
        const unsigned char* xs = sm + st * L::STAGE + wgi * 64 * RB;
        const unsigned char* ws = sm + st * L::STAGE + L::TX;
        mbar_wait(&full[st], (it / NST) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(Op<__nv_bfloat16>(), acc, desc_k_major(xs + 32 * kk),
                      desc_k_major(ws + 32 * kk), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (kb > 0) mbar_arrive(&empty[(it - 1) % NST]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % NST]);

      // out = act(z * scale + shift [+ residual]), rounded once, in place
      const int b = li % NRB;
      unsigned char* tb = sm + L::TILE + b * L::TT;
      mbar_wait(&tfull[b], (li / NRB) & 1);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * c4;   // even; N % 8 == 0
        float2 sc = make_float2(0.f, 0.f), sh = sc;
        if (col < N) {
          sc = *reinterpret_cast<const float2*>(scale + col);
          sh = *reinterpret_cast<const float2*>(shift + col);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rl + 8 * i;
          unsigned char* p = tb + (j / 8) * TM * RB + r * RB +
                             (((j % 8) ^ (r % 8)) * 16) + 4 * c4;
          float v0 = fmaf(acc[4 * j + 2 * i], sc.x, sh.x);
          float v1 = fmaf(acc[4 * j + 2 * i + 1], sc.y, sh.y);
          if (has_res) {
            const float2 rv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p));
            v0 += rv.x;
            v1 += rv.y;
          }
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      fence_proxy_async();
      mbar_arrive(&tready[b]);
    }
  }
}

// Columns per tile for N output columns: the least of 64, 128 and 256 that
// covers N, and 256 for wider N.
inline int tile_n(int N) { return N <= 64 ? 64 : N <= 128 ? 128 : 256; }

template <int BN, int NRB>
cudaError_t launch(const void* x, const void* wt, const float* scale,
                   const float* shift, const void* res, void* out, int M,
                   int N, int K, int relu, cudaStream_t st) {
  using L = EpiSmem<BN, NRB>;
  const CUtensorMapDataType ty = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap m[4];
  cudaError_t err = encode_rows_map(&m[0], x, 1, M, K, TM, ty);
  if (err == cudaSuccess) err = encode_rows_map(&m[1], wt, 1, N, K, BN, ty);
  // without a residual its map is never read: it describes the output
  if (err == cudaSuccess)
    err = encode_rows_map(&m[2], res != nullptr ? res : out, 1, M, N, TM, ty);
  if (err == cudaSuccess) err = encode_rows_map(&m[3], out, 1, M, N, TM, ty);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(epilogue_wgmma<BN, NRB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((M + TM - 1) / TM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  epilogue_wgmma<BN, NRB><<<grid, THREADS, L::BYTES, st>>>(
      m[0], m[1], m[2], m[3], scale, shift, M, N, K, res != nullptr, relu);
  return cudaSuccess;
}

template <int BN, int NRB>
int config(int what) {
  using L = EpiSmem<BN, NRB>;
  return what == 0 ? L::BYTES : what == 1 ? L::NST : NRB;
}

}  // namespace wg

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
void launch_epilogue_fp32(const float* x, const float* wt, const float* scale,
                          const float* shift, const float* res, float* out,
                          int M, int N, int K, cudaStream_t st) {
  epilogue_fp32<RES, RELU><<<grid_of(M, N, 0), FNT, 0, st>>>(
      Dense32{x, M, K}, wt, scale, shift, res, out, N, K);
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
// cudaErrorInvalidValue for arguments the kernels do not take (or, for
// matmul_epilogue's bf16 path, a TMA map the driver refuses), else the
// first error of the launch, else cudaGetLastError() right after it.

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
  if (dtype == 1) {
    const int bn = wg::tile_n(N);
    cudaError_t err;
    if (bn == 64)
      err = wg::launch<64, 2>(x, wt, sc, sh, residual, out, M, N, K, relu, st);
    else if (bn == 128)
      err = wg::launch<128, 2>(x, wt, sc, sh, residual, out, M, N, K, relu,
                               st);
    else if (K < wg::DEEP_K)
      err = wg::launch<256, 2>(x, wt, sc, sh, residual, out, M, N, K, relu,
                               st);
    else
      err = wg::launch<256, 1>(x, wt, sc, sh, residual, out, M, N, K, relu,
                               st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
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

// Columns per tile of the bf16 matmul_epilogue kernel for N output columns.
extern "C" int mxt_matmul_epilogue_tile_n(int N) { return wg::tile_n(N); }

// Dynamic shared memory in bytes (what = 0), ring stages (1) or tile
// buffers (2) of the bf16 matmul_epilogue kernel for an (M, K) x (K, N)
// product.
extern "C" int mxt_matmul_epilogue_config(int N, int K, int what) {
  const int bn = wg::tile_n(N);
  return bn == 64         ? wg::config<64, 2>(what)
         : bn == 128      ? wg::config<128, 2>(what)
         : K < wg::DEEP_K ? wg::config<256, 2>(what)
                          : wg::config<256, 1>(what);
}

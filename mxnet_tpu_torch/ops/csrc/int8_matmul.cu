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
// 16 (a TMA map's row stride is a multiple of 16 bytes), K at most 131071
// (no s32 sum of |x w| <= 2^14 products can overflow); any M >= 1: rows
// past M and columns past K or N are zero-filled on load and clipped on
// store (the TPU's `int8_blocks` refuses an M that its tiles do not
// divide, such as 392 rows).
//
// Design: a persistent TMA + wgmma GEMM (`int8_wgmma`). One CTA per SM, R x
// n-tiles of them (R = min(m-tiles, SMs / n-tiles)), each keeping one
// 128-column n-tile and walking 128-row m-tiles; the TPU kernel carries
// the s32 sum across its sequential k grid axis in a VMEM scratch tile,
// here the k loop runs inside the CTA. x arrives in 128-byte k-boxes (128
// k of 128 rows, 128-byte swizzle) through a ring that runs ahead across
// tiles; each k-box is four k32 steps of wgmma m64n128k32 s8 x s8 -> s32
// per consumer warpgroup, both operands from shared memory. 8-bit wgmma
// takes B K-major only (its transpose bit is for 16-bit types), and w lies
// (K, N) with N contiguous. So where K <= KRES the CTA makes its own
// K-major copy once: its (K, 128) panel of w is loaded by TMA into the
// tile buffers' memory, the consumers transpose it 16 (k) x 4 (n) bytes at
// a time with byte permutes into a resident 128-byte-swizzled panel, and
// the ring carries x alone. For longer K the caller passes wt = w^T, (N,
// K) contiguous (`mxt_int8_matmul_needs_wt`), and the ring carries its
// k-boxes beside x's. The epilogue runs on the registers: as the reference,
// __int2float_rn(acc), then * scale and * out_scale as two separate fp32
// multiplies, __float2int_rn (half to even, as jnp.round; never roundf);
// the tile is written, in the store's 128-byte swizzle, into a tile buffer
// that a producer thread stores by TMA while the consumers go on.
//
// What bounds it on an H100 SXM (3.35 TB/s, 1979 TOP/s int8 dense): 2 M K N
// operations; x and w read once, the output written once. At the
// microbench shape (M, K, N) = (25088, 512, 128): 25.8 MB with the fp32
// output -> 7.7 us, 16.1 MB with the s8 output -> 4.8 us; 3.29 GOP ->
// 1.7 us. Byte-bound.

#include <climits>

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_wgmma_sm90.cuh"

namespace {

using namespace mxt::sm90;
// the GEMM core's warpgroups, 128-row tiles and shared-memory helpers
using mxt::gemm::align1024;
using mxt::gemm::consumer_sync;
using mxt::gemm::CONSUMERS;
using mxt::gemm::sm_count;
using mxt::gemm::THREADS;
using mxt::gemm::TM;
using mxt::gemm::WG;

constexpr int BN = 128;                   // columns per tile
constexpr int KB = 128;                   // k per k-box: one 128-byte row
constexpr int KRES = 512;                 // the CTA transposes w up to this K
constexpr int TILES = 64 * 1024;          // tile buffers; the panel's staging

// Shared memory of int8_wgmma<RES, REQUANT>, in bytes from a 1024-byte
// boundary: NST ring stages (x k-box, and without RES the wt k-box), as
// many (up to 8) as fit beside the tile buffers (NRB of one 128 x 128
// output tile: 1 in fp32, 4 in s8; each in 128-byte chunks of CCOLS
// columns) and, with RES, the transposed w panel of KRES / KB k-boxes;
// then the barriers full[NST], empty[NST], tready[NRB], tfree[NRB], wfull.
template <bool RES, bool REQUANT>
struct Smem {
  static constexpr int TX = TM * KB, TW = BN * KB;
  static constexpr int STAGE = RES ? TX : TX + TW;
  static constexpr int ESZ = REQUANT ? 1 : 4;       // output element bytes
  static constexpr int TT = TM * BN * ESZ, NRB = TILES / TT;
  static constexpr int CCOLS = 128 / ESZ, NCH = BN / CCOLS;
  static constexpr int PANEL = RES ? KRES / KB * TW : 0;
  static constexpr int FIT = (227 * 1024 - TILES - PANEL - 1280) / STAGE;
  static constexpr int NST = FIT < 8 ? FIT : 8;
  static constexpr int TOFF = NST * STAGE, POFF = TOFF + TILES;
  static constexpr int BAR = POFF + PANEL;
  static constexpr int BYTES = BAR + (2 * NST + 2 * NRB + 1) * 8 + 1024;
  static_assert(NST >= 2 && TT * NRB == TILES && KRES / KB * TW <= TILES,
                "shared memory plan");
};

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

// The CTA's w panel made K-major by the consumers. stage: row k of the
// panel, w[k][n0 .. n0 + 127], at 128 k bytes (as TMA loaded it, no
// swizzle); panel: k-box kb holds row n (128 bytes: k = 128 kb .. + 127)
// at kb * TW + 128 n, its 16-byte unit q at q ^ (n % 8) (the wgmma
// K-major layout). Each step takes 16 k x 4 n bytes: 16 loads of 4 bytes
// (lanes on neighbouring n: no bank conflict), four 4 x 4 byte
// transposes, 4 stores of 16 bytes in an order rotated by lane so that
// each 8 lanes cover the 8 unit positions.
template <int TW>
__device__ __forceinline__ void transpose_panel(const unsigned char* stage,
                                                unsigned char* panel,
                                                int n_kb) {
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(stage);
  for (int v = threadIdx.x; v < n_kb * 256; v += CONSUMERS) {
    const int ng = v % 32, q = v / 32 % 8, kb = v / 256;
    const uint32_t* src = s32 + (kb * KB + 16 * q) * 32 + ng;
    uint32_t r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) r[i] = src[32 * i];
    uint32_t o[4][4];   // o[j][h]: column 4 ng + j, k 16 q + 4 h .. + 3
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      uint32_t t[4];
      transpose4(t, r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j][h] = t[j];
    }
    const int rot = (ng >> 1) & 3;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = (s + rot) & 3, n = 4 * ng + j;
      uint32_t u[4];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        u[h] = j == 0   ? o[0][h]
               : j == 1 ? o[1][h]
               : j == 2 ? o[2][h]
                        : o[3][h];
      *reinterpret_cast<uint4*>(panel + kb * TW + n * 128 +
                                ((q ^ (n & 7)) * 16)) =
          make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
}

// The output pair of tile row r, columns col and col + 1 (col even), in a
// tile buffer laid out for the TMA store's 128-byte swizzle: chunks of
// CCOLS columns x 128 rows, 16-byte unit u of row r at u ^ (r % 8).
template <int ESZ>
__device__ __forceinline__ unsigned char* out_at(unsigned char* tb, int r,
                                                 int col) {
  constexpr int CCOLS = 128 / ESZ;
  const int byte = (col % CCOLS) * ESZ;
  return tb + (col / CCOLS) * TM * 128 + r * 128 +
         (((byte / 16) ^ (r % 8)) * 16) + byte % 16;
}

template <bool RES, bool REQUANT>
__global__ void __launch_bounds__(THREADS, 1)
    int8_wgmma(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tout, int M, int N, int K,
               float scale, float out_scale, int relu) {
  using L = Smem<RES, REQUANT>;
  constexpr int NST = L::NST, NRB = L::NRB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + NST;
  uint64_t* tready = empty + NST;   // tile buffer b holds a finished tile
  uint64_t* tfree = tready + NRB;   // ... has been read by its store
  uint64_t* wfull = tfree + NRB;    // the w panel's raw copy has landed
  unsigned char* tiles = sm + L::TOFF;
  unsigned char* panel = sm + L::POFF;

  const int n_nt = (N + BN - 1) / BN, n_kb = (K + KB - 1) / KB;
  const int n_tiles = (M + TM - 1) / TM * n_nt;
  const int n0 = blockIdx.x % n_nt * BN;   // the CTA's one n-tile

  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMERS);
    }
    for (int b = 0; b < NRB; ++b) {
      mbar_init(&tready[b], CONSUMERS);
      mbar_init(&tfree[b], 1);
    }
    mbar_init(wfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / WG;
  if (wgi == 2) {
    if (threadIdx.x == CONSUMERS) {
      // the raw w panel first (RES), then the ring, running ahead across
      // tiles
      if constexpr (RES) {
        mbar_arrive_expect_tx(wfull, n_kb * L::TW);
        for (int kb = 0; kb < n_kb; ++kb)
          tma_load_3d(tiles + kb * L::TW, &tw, wfull, n0, KB * kb, 0);
      }
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m0 = t / n_nt * TM;
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int st = it % NST;
          unsigned char* xs = sm + st * L::STAGE;
          mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], L::STAGE);
          tma_load_3d(xs, &tx, &full[st], KB * kb, m0, 0);
          if constexpr (!RES)
            tma_load_3d(xs + L::TX, &tw, &full[st], KB * kb, n0, 0);
        }
      }
    } else if (threadIdx.x == CONSUMERS + 32) {
      // stores: each finished tile buffer, then it is free again
      for (int t = blockIdx.x, li = 0; t < n_tiles; t += gridDim.x, ++li) {
        const int m0 = t / n_nt * TM, b = li % NRB;
        unsigned char* tb = tiles + b * L::TT;
        mbar_wait(&tready[b], (li / NRB) & 1);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c)
          if (n0 + c * L::CCOLS < N)
            tma_store_3d(&tout, tb + c * TM * 128, n0 + c * L::CCOLS, m0, 0);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(&tfree[b]);
      }
    }
  } else {
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int rl = wgi * 64 + warp * 16 + g;   // tile rows rl and rl + 8
    if constexpr (RES) {
      // the panel, K-major; its raw copy's memory then holds tile buffers
      mbar_wait(wfull, 0);
      transpose_panel<L::TW>(tiles, panel, n_kb);
      fence_proxy_async();
      consumer_sync();
    }
    int acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x, li = 0; t < n_tiles; t += gridDim.x, ++li) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      // the products of k-box kb run while the ring fills; stage kb - 1 is
      // released once they are known complete
      for (int kb = 0; kb < n_kb; ++kb, ++it) {
        const int st = it % NST;
        const unsigned char* xs = sm + st * L::STAGE + wgi * 64 * KB;
        const unsigned char* ws =
            RES ? panel + kb * L::TW : sm + st * L::STAGE + L::TX;
        mbar_wait(&full[st], (it / NST) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8(acc, desc_k_major(xs + 32 * kk),
                   desc_k_major(ws + 32 * kk), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (kb > 0) mbar_arrive(&empty[(it - 1) % NST]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % NST]);

      // the epilogue, into tile buffer li % NRB once its last store read it
      const int b = li % NRB;
      unsigned char* tb = tiles + b * L::TT;
      mbar_wait(&tfree[b], ((li / NRB) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rl + 8 * i, col = 8 * j + 2 * c4;
          float v0 = __int2float_rn(acc[4 * j + 2 * i]) * scale;
          float v1 = __int2float_rn(acc[4 * j + 2 * i + 1]) * scale;
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if constexpr (REQUANT) {
            const int q0 = min(max(__float2int_rn(v0 * out_scale), -127), 127);
            const int q1 = min(max(__float2int_rn(v1 * out_scale), -127), 127);
            *reinterpret_cast<char2*>(out_at<1>(tb, r, col)) =
                make_char2((signed char)q0, (signed char)q1);
          } else {
            *reinterpret_cast<float2*>(out_at<4>(tb, r, col)) =
                make_float2(v0, v1);
          }
        }
      fence_proxy_async();
      mbar_arrive(&tready[b]);
    }
  }
}

template <bool RES, bool REQUANT>
cudaError_t launch(const void* x, const void* w, void* out, int m, int n,
                   int k, float scale, int relu, float out_scale,
                   cudaStream_t st) {
  using L = Smem<RES, REQUANT>;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  const int n_nt = (n + BN - 1) / BN, m_nt = (m + TM - 1) / TM;
  const int per = sms / n_nt;
  const int rows = per < 1 ? 1 : per < m_nt ? per : m_nt;
  if ((long long)rows * n_nt > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap mx, mw, mo;
  if (err == cudaSuccess)
    err = encode_map_3d(&mx, x, 1, m, k, 1, KB, TM, 1, u8,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  // w: the raw (K, N) panel (RES, no swizzle), or wt (N, K) K-major
  if (err == cudaSuccess)
    err = RES ? encode_map_3d(&mw, w, 1, k, n, 1, BN, KB, 1, u8,
                              CU_TENSOR_MAP_SWIZZLE_NONE)
              : encode_map_3d(&mw, w, 1, n, k, 1, KB, BN, 1, u8,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = REQUANT ? encode_map_3d(&mo, out, 1, m, n, 1, L::CCOLS, TM, 1, u8,
                                  CU_TENSOR_MAP_SWIZZLE_128B)
                  : encode_map_3d(&mo, out, 1, m, n, 4, L::CCOLS, TM, 1,
                                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int8_wgmma<RES, REQUANT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::BYTES);
  if (err != cudaSuccess) return err;
  int8_wgmma<RES, REQUANT><<<rows * n_nt, THREADS, L::BYTES, st>>>(
      mx, mw, mo, m, n, k, scale, out_scale, relu);
  return cudaGetLastError();
}

template <bool RES>
cudaError_t launch_out(bool requant, const void* x, const void* w, void* out,
                       int m, int n, int k, float scale, int relu,
                       float out_scale, cudaStream_t st) {
  return requant
             ? launch<RES, true>(x, w, out, m, n, k, scale, relu, out_scale,
                                 st)
             : launch<RES, false>(x, w, out, m, n, k, scale, relu, out_scale,
                                  st);
}

}  // namespace

// Whether the kernel reads a K-major copy of w for an inner dimension k:
// 1 where the caller passes wt = w^T ((n, k) contiguous), 0 where the
// kernel transposes w itself (k <= KRES).
extern "C" int mxt_int8_matmul_needs_wt(int k) { return k > KRES ? 1 : 0; }

// out: (m, n) fp32, or s8 when requant != 0. wt: null, or w^T as (n, k)
// contiguous s8, which the kernel then reads in place of w (required where
// mxt_int8_matmul_needs_wt(k)). Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take (or a map
// cuTensorMapEncode* refuses), else the first error of the launch, else
// cudaGetLastError() right after it.
extern "C" int mxt_int8_matmul(const void* x, const void* w, const void* wt,
                               void* out, int m, int n, int k, float scale,
                               int relu, int requant, float out_scale,
                               void* stream) {
  if (m <= 0 || n < 16 || n % 16 != 0 || k < 16 || k % 16 != 0 ||
      (long long)k * 16384 > INT_MAX || (wt == nullptr && k > KRES))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(wt == nullptr
                   ? launch_out<true>(requant != 0, x, w, out, m, n, k, scale,
                                      relu, out_scale, st)
                   : launch_out<false>(requant != 0, x, wt, out, m, n, k,
                                       scale, relu, out_scale, st));
}

// Dynamic shared memory in bytes (what = 0), ring stages (1) or tile
// buffers (2) of int8_wgmma with the panel made by the CTA (resident) or
// wt through the ring, with the s8 (requant) or fp32 output.
extern "C" int mxt_int8_matmul_config(int resident, int requant, int what) {
  auto pick = [&](auto l) {
    using L = decltype(l);
    return what == 0 ? L::BYTES : what == 1 ? L::NST : L::NRB;
  };
  return resident ? (requant ? pick(Smem<true, true>{})
                             : pick(Smem<true, false>{}))
                  : (requant ? pick(Smem<false, true>{})
                             : pick(Smem<false, false>{}));
}

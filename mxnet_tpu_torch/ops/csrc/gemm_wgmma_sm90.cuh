// The persistent TMA + wgmma GEMM core of the conv / batch-norm kernels
// (sm_90a): `gemm_wgmma<BN, NRB, KIND>`, shared by conv_bn_epilogue.cu
// (matmul_epilogue, matmul_stats, matmul_bn_stats) and convkxk_bn_stats.cu
// (the KxK conv with its batch-norm statistics), which keep their own host
// code: tile rules, tensor maps, launches.
//
// z = A @ B^T for 16-bit A (M rows, K columns) and B (N rows, K columns),
// both K-major, fp32 accumulators. One CTA per SM walks the (m-tile,
// n-tile) grid statically, tile blockIdx.x + i * gridDim.x with the n-tile
// fastest. A tile is 128 rows (two consumer warpgroups of 64) by BN columns.
// A and B arrive through a ring of k-boxes (64 columns of K, 128-byte
// swizzle) loaded by TMA, which zero-fills what lies outside the tensors;
// each k16 step is one wgmma with both operands from shared memory
// (m64nBNk16). Three threads of the producer warpgroup work apart: one fills
// the ring, one hands each tile buffer to the consumers once its last store
// has read it (loading the residual into it by TMA for matmul_epilogue),
// one stores finished tiles by TMA, which clips rows past M and columns
// past N, while the consumers go on to the next tile.
//
// A and B by KIND:
//   the 1x1 kinds (kEpilogue, kStats, kStatsStore): A = x, a 2-D (M, K)
//     map; B = wt, a 2-D (N, K) map; k-box kb at column 64 kb of both;
//   kConvStats: A = the implicit im2col matrix of a stride-1 KxK NHWC conv
//     (row m = output pixel (image, oy, ox), column k = (dy, dx, ci) in the
//     OHWI weight's order), an im2col map (wgmma_sm90.cuh
//     `encode_im2col_4d`): k-box kb = (tap, channel block cb) is the 128
//     output pixels of the tile, channels 64 cb .. 64 cb + 63 of tap (dy,
//     dx), read by one im2col load at the tile's first pixel's corner with
//     offsets (dx, dy); the copy zero-fills the padding, the pixels past M
//     and the channels past Cin. B = the weight (Cout, kh kw, Cin) as a 3-D
//     map, box (64 channels, 1 tap, BN), zero past Cin, so a k-box's
//     columns past Cin meet zeros on both sides.
//
// After the product, by KIND:
//   kEpilogue: z * scale + shift, the residual added in fp32, the relu,
//     rounded once to bf16 into the tile buffer in place;
//   kStats: the column sums of z and z^2; nothing stored;
//   kStatsStore, kConvStats: act(z) (kConvStats: no relu) rounded into the
//     tile buffer, and the column sums of act(z) from the fp32 values.
// The statistics repeat bit for bit (no atomics on values, every sum in an
// order fixed by the static schedule): the CTAs of the grid, R x n-tiles of
// them (R = min(m-tiles, SMs / n-tiles), `stats_rows`), keep one n-tile
// throughout, and each consumer thread sums its own two rows of each
// column over all its tiles, in tile order. Only at the end are the sums
// taken over the warp's lanes (shuffles) and the 8 consumer warps (shared
// memory, in warp order), and one row per CTA written to a (2, R, N)
// scratch. The last CTA of each n-tile to finish (a counter behind a
// fence) sums its n-tile's R rows in row order into (s, ss), so no second
// launch adds them. The counters, one per n-tile, sit in the launch's own
// scratch after the rows and are zeroed by the launch, so launches may
// overlap (two CUDA graphs replayed at once on two streams). The 1x1
// statistics kernels take 64-column tiles for N <= 64 and 128-column tiles
// above (`stats_tile_n`): there a thread's 64 accumulators and 64 running
// sums fit the register budget; at the conv's 256-column tiles lanes split
// the running sums (`Cols`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace mxt {
namespace gemm {

using namespace mxt::sm90;

constexpr int WG = 128;       // threads of a warpgroup
constexpr int RB = 128;       // bytes of a 64-column bf16 tile row
constexpr int TM = 128;       // rows per tile: two consumer warpgroups
constexpr int CONSUMERS = 2 * WG, THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// What a kernel of the family does after the product.
enum Kind : int {
  kEpilogue = 0,     // matmul_epilogue
  kStats = 1,        // matmul_stats
  kStatsStore = 2,   // matmul_bn_stats
  kConvStats = 3,    // convkxk_bn_stats
};

// The geometry a kConvStats producer needs to place its loads: output
// pixels per image and per row, padding, kernel width, channel blocks of
// 64 per tap, and k-boxes per tile (taps x channel blocks). Unused by the
// other kinds.
struct ConvGeom {
  int hw, wo, ph, pw, kw, ncb, nkb;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// 256-column tiles take one tile buffer and a deeper ring from this K on
// (4 k-boxes): there the k-loop is long enough to hide the residual's load,
// and a 2-stage ring would stall on every k-box.
constexpr int DEEP_K = 256;

// Shared memory of gemm_wgmma<BN, NRB, .>, in bytes from a 1024-byte
// boundary: NST ring stages of (A k-box: 128 rows, B k-box: BN rows), as
// many (up to 8) as fit beside NRB tile buffers (residual in, out; BN / 64
// chunks of 128 rows x 64 columns), then the barriers full[NST],
// empty[NST], tfull[NRB], tready[NRB], tfree[NRB] and one int (the
// statistics' last-CTA flag). The statistics kernels reduce across warps
// in the ring's memory once the CTA's last product has read it.
template <int BN, int NRB>
struct Smem {
  static constexpr int TX = TM * RB, TW = BN * RB, STAGE = TX + TW;
  static constexpr int TT = TM * BN * 2, NC = BN / 64;
  static constexpr int NB = NRB > 0 ? NRB : 1;   // a divisor, also at 0
  static constexpr int FIT = (227 * 1024 - NRB * TT - 1280) / STAGE;
  static constexpr int NST = FIT < 8 ? FIT : 8;
  static constexpr int TILE = NST * STAGE;
  static constexpr int BAR = TILE + NRB * TT;
  static constexpr int BYTES = BAR + (2 * NST + 3 * NRB + 1) * 8 + 1024;
  static_assert(NST >= 1 && TILE >= 8 * 2 * BN * 4, "ring too small");
};

// Named barrier of the two consumer warpgroups.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Column statistics of the consumers. Thread (warp w, lane 4g + c) holds
// rows g and g + 8 of its warp's 16 rows and columns 8j + 2c + p (p = 0, 1)
// of every 8-column group j of the tile (the accumulator layout,
// wgmma_sm90.cuh). Its running sums cover its own two rows, tile after
// tile: z and z^2 of its 2 columns in each of the J groups. At 256 columns
// (SPLIT) those would not fit the registers beside the 128 accumulators,
// so lanes g and g ^ 4 split the groups: lanes g < 4 keep groups 0 ..
// J/2 - 1, the others J/2 .., each adding its partner's tile sums of its
// groups (one shuffle per value kept), so a running sum covers 4 rows.
template <int BN>
struct Cols {
  static constexpr int J = BN / 8;
  static constexpr bool SPLIT = BN == 256;
  static constexpr int KEEP = SPLIT ? J / 2 : J;   // groups a lane keeps
  static constexpr int NV = 2 * KEEP;   // running sums of z (and of z^2)
};

// Adds the tile's column sums over the thread's two rows to rs (z) and rq
// (z^2).
template <int BN>
__device__ __forceinline__ void add_tile(float (&rs)[Cols<BN>::NV],
                                         float (&rq)[Cols<BN>::NV],
                                         const float (&acc)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < Cols<BN>::KEEP; ++i)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float a0 = acc[4 * i + p], b0 = acc[4 * i + 2 + p];
      float s = a0 + b0, q = fmaf(a0, a0, b0 * b0);
      if constexpr (Cols<BN>::SPLIT) {
        // group i and group i + J/2: keep one, send the other to g ^ 4
        const bool hi = threadIdx.x & 16;
        const int o = 4 * (i + Cols<BN>::J / 2);
        const float a1 = acc[o + p], b1 = acc[o + 2 + p];
        const float s1 = a1 + b1, q1 = fmaf(a1, a1, b1 * b1);
        const float send_s = hi ? s : s1, send_q = hi ? q : q1;
        s = (hi ? s1 : s) + __shfl_xor_sync(mxt::kFull, send_s, 16);
        q = (hi ? q1 : q) + __shfl_xor_sync(mxt::kFull, send_q, 16);
      }
      rs[2 * i + p] += s;
      rq[2 * i + p] += q;
    }
}

// The warp's sums: each running sum added over the lanes of equal c (and,
// with SPLIT, of equal g & 4) by a butterfly, so that every such lane
// holds the same total.
template <int BN>
__device__ __forceinline__ void warp_rows(float (&rs)[Cols<BN>::NV],
                                          float (&rq)[Cols<BN>::NV]) {
#pragma unroll
  for (int i = 0; i < Cols<BN>::NV; ++i)
#pragma unroll
    for (int off = 4; off < (Cols<BN>::SPLIT ? 16 : 32); off <<= 1) {
      rs[i] += __shfl_xor_sync(mxt::kFull, rs[i], off);
      rq[i] += __shfl_xor_sync(mxt::kFull, rq[i], off);
    }
}

// The CTA's column sums, row `row` of parts (2, R, N): the 8 consumer
// warps' sums through shared memory `red` (8 x 2 x BN floats), added in
// warp order; columns past N are not written.
template <int BN>
__device__ __forceinline__ void write_row(float* red,
                                          const float (&rs)[Cols<BN>::NV],
                                          const float (&rq)[Cols<BN>::NV],
                                          float* __restrict__ parts, int R,
                                          int row, int n0, int N, int w8,
                                          int g, int c4) {
  if ((g & (Cols<BN>::SPLIT ? 3 : 7)) == 0) {
    const int j0 = Cols<BN>::SPLIT && (g & 4) ? Cols<BN>::J / 2 : 0;
#pragma unroll
    for (int i = 0; i < Cols<BN>::KEEP; ++i)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = 8 * (j0 + i) + 2 * c4 + p;
        red[2 * w8 * BN + col] = rs[2 * i + p];
        red[(2 * w8 + 1) * BN + col] = rq[2 * i + p];
      }
  }
  consumer_sync();
  for (int v = threadIdx.x; v < 2 * BN; v += CONSUMERS) {
    const int st = v / BN, col = v % BN;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) a += red[(2 * w + st) * BN + col];
    if (n0 + col < N) parts[((size_t)st * R + row) * N + n0 + col] = a;
  }
}

// The last of an n-tile's R CTAs to write its row sums the n-tile's rows of
// parts, in row order, into sums (2, N). Each CTA's row is fenced before it
// counts; the counters are the launch's own, zeroed before it. Only this
// CTA is left running, so its loads are issued FOLD rows at a time.
constexpr int FOLD = 16;

template <int BN>
__device__ __forceinline__ void fold_rows(const float* parts,
                                          float* __restrict__ sums,
                                          unsigned* counters, int* last,
                                          int R, int nt, int N) {
  __threadfence();
  consumer_sync();
  if (threadIdx.x == 0)
    *last = atomicAdd(&counters[nt], 1u) == (unsigned)(R - 1);
  consumer_sync();
  if (!*last) return;
  __threadfence();
  const int n0 = nt * BN;
  for (int v = threadIdx.x; v < 2 * BN; v += CONSUMERS) {
    const int st = v / BN, col = v % BN;
    if (n0 + col >= N) continue;
    const float* p = parts + (size_t)st * R * N + n0 + col;
    float a = 0.f;
    int r = 0;
    for (; r + FOLD <= R; r += FOLD) {   // FOLD loads in flight, then adds
      float t[FOLD];
#pragma unroll
      for (int u = 0; u < FOLD; ++u) t[u] = __ldcg(p + (size_t)(r + u) * N);
#pragma unroll
      for (int u = 0; u < FOLD; ++u) a += t[u];
    }
    for (; r < R; ++r) a += __ldcg(p + (size_t)r * N);
    sums[st * N + n0 + col] = a;
  }
}

// The bf16 pair (v0, v1) of tile row r, columns 8j + 2c4 and + 1, in a
// tile buffer in the 128-byte swizzle (64-column chunks of TM rows).
__device__ __forceinline__ unsigned char* pair_at(unsigned char* tb, int r,
                                                  int j, int c4) {
  return tb + (j / 8) * TM * RB + r * RB + (((j % 8) ^ (r % 8)) * 16) +
         4 * c4;
}

// The products of ring k-box `it` into acc once its stage is full: four
// k16 wgmma with both operands from shared memory, committed as one group.
template <int BN, class L>
__device__ __forceinline__ void kbox_products(float (&acc)[BN / 2],
                                              unsigned char* sm,
                                              uint64_t* full, int it,
                                              int wgi) {
  const int st = it % L::NST;
  const unsigned char* xs = sm + st * L::STAGE + wgi * 64 * RB;
  const unsigned char* ws = sm + st * L::STAGE + L::TX;
  mbar_wait(&full[st], (it / L::NST) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(Op<__nv_bfloat16>(), acc, desc_k_major(xs + 32 * kk),
                desc_k_major(ws + 32 * kk), 1);
  wgmma_commit();
}

// What the statistics consumers need to finish a tile: the tile buffers
// and their barriers (matmul_bn_stats, convkxk_bn_stats), the thread's rows
// and lane.
struct Finish {
  unsigned char* tbuf;
  uint64_t *tfull, *tready;
  int rl, c4, relu;
};

// A finished tile li of the statistics kernels: the relu; with STORE, y
// rounded once into tile buffer li % NRB for its TMA store; the column sums
// added to the running ones, from the fp32 values.
template <int BN, int NRB, bool STORE, class L>
__device__ __forceinline__ void finish_tile(float (&acc)[BN / 2],
                                            float (&rs)[Cols<BN>::NV],
                                            float (&rq)[Cols<BN>::NV],
                                            const Finish& f, int li) {
  if (f.relu) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = fmaxf(acc[i], 0.f);
  }
  if constexpr (STORE) {
    const int b = li % NRB;
    unsigned char* tb = f.tbuf + b * L::TT;
    mbar_wait(&f.tfull[b], (li / NRB) & 1);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<__nv_bfloat162*>(pair_at(tb, f.rl + 8 * i, j,
                                                   f.c4)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    fence_proxy_async();
    mbar_arrive(&f.tready[b]);
  }
  add_tile<BN>(rs, rq, acc);
}

template <int BN, int NRB, int KIND>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_wgmma(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw,
               const __grid_constant__ CUtensorMap tres,
               const __grid_constant__ CUtensorMap tout,
               const float* __restrict__ scale,
               const float* __restrict__ shift, float* __restrict__ parts,
               float* __restrict__ sums, unsigned* __restrict__ counters,
               int M, int N, int K, int has_res, int relu, ConvGeom cg) {
  static_assert((KIND == kStats) == (NRB == 0), "a store needs tile buffers");
  constexpr bool CONV = KIND == kConvStats;
  using L = Smem<BN, NRB>;
  constexpr int NST = L::NST, NC = L::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + NST;
  uint64_t* tfull = empty + NST;   // tile buffer b is the consumers'
  uint64_t* tready = tfull + NRB;  // ... holds the output
  uint64_t* tfree = tready + NRB;  // ... has been read by its store
  int* last = reinterpret_cast<int*>(tfree + NRB);

  // k-boxes per tile: (taps, channel blocks) for the conv, else K / 64
  const int n_nt = (N + BN - 1) / BN;
  const int n_kb = CONV ? cg.nkb : (K + 63) / 64;
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
      // the CTA keeps one n-tile (the grid a multiple of the n-tiles) and
      // there is one k-box, every stage holds the same B box, loaded on the
      // stage's first fill only.
      const bool w_fixed = n_kb == 1 && gridDim.x % n_nt == 0;
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m0 = t / n_nt * TM, n0 = t % n_nt * BN;
        // the tile's first output pixel (conv)
        int img = 0, oy = 0, ox = 0;
        if constexpr (CONV) {
          img = m0 / cg.hw;
          const int p = m0 - img * cg.hw;
          oy = p / cg.wo;
          ox = p - oy * cg.wo;
        }
        for (int kb = 0; kb < n_kb; ++kb, ++it) {
          const int st = it % NST;
          const bool load_w = !w_fixed || it < NST;
          unsigned char* xs = sm + st * L::STAGE;
          mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], load_w ? L::TX + L::TW : L::TX);
          if constexpr (CONV) {
            const int tap = kb / cg.ncb, cb = kb - tap * cg.ncb;
            const int dy = tap / cg.kw, dx = tap - dy * cg.kw;
            tma_load_im2col_4d(xs, &tx, &full[st], 64 * cb, ox - cg.pw,
                               oy - cg.ph, img, dx, dy);
            if (load_w)
              tma_load_3d(xs + L::TX, &tw, &full[st], 64 * cb, tap, n0);
          } else {
            tma_load_3d(xs, &tx, &full[st], 64 * kb, m0, 0);
            if (load_w)
              tma_load_3d(xs + L::TX, &tw, &full[st], 64 * kb, n0, 0);
          }
        }
      }
    } else if (NRB > 0 && threadIdx.x == CONSUMERS + 64) {
      // tile li goes to buffer li % NRB once that buffer's last store has
      // read it, with its residual loaded by TMA if there is one
      for (int t = blockIdx.x, li = 0; t < n_tiles; t += gridDim.x, ++li) {
        const int m0 = t / n_nt * TM, n0 = t % n_nt * BN;
        const int b = li % L::NB;
        unsigned char* tb = sm + L::TILE + b * L::TT;
        mbar_wait(&tfree[b], ((li / L::NB) & 1) ^ 1);
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
    } else if (NRB > 0 && threadIdx.x == CONSUMERS + 32) {
      // stores: each finished tile buffer, then it is free again
      for (int t = blockIdx.x, li = 0; t < n_tiles; t += gridDim.x, ++li) {
        const int m0 = t / n_nt * TM, n0 = t % n_nt * BN;
        const int b = li % L::NB;
        unsigned char* tb = sm + L::TILE + b * L::TT;
        mbar_wait(&tready[b], (li / L::NB) & 1);
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
    const Finish fin{sm + L::TILE, tfull, tready, rl, c4, relu};
    float acc[BN / 2];
    float rs[Cols<BN>::NV], rq[Cols<BN>::NV];   // the statistics' sums
    if constexpr (KIND != kEpilogue) {
#pragma unroll
      for (int i = 0; i < Cols<BN>::NV; ++i) rs[i] = rq[i] = 0.f;
    }
    int it = 0;
    for (int t = blockIdx.x, li = 0; t < n_tiles; t += gridDim.x, ++li) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

      // z = A B^T: the products of k-box kb run while the ring fills;
      // stage kb - 1 is released once they are known complete
      for (int kb = 0; kb < n_kb; ++kb, ++it) {
        kbox_products<BN, L>(acc, sm, full, it, wgi);
        wgmma_wait<1>();
        fence_regs(acc);
        if (kb > 0) mbar_arrive(&empty[(it - 1) % NST]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % NST]);

      if constexpr (KIND != kEpilogue) {
        finish_tile<BN, NRB, KIND != kStats, L>(acc, rs, rq, fin, li);
        continue;
      }
      // out = act(z * scale + shift [+ residual]), rounded once, in place
      const int n0 = t % n_nt * BN;
      const int b = li % L::NB;
      unsigned char* tb = sm + L::TILE + b * L::TT;
      mbar_wait(&tfull[b], (li / L::NB) & 1);
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
          unsigned char* p = pair_at(tb, rl + 8 * i, j, c4);
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

    if constexpr (KIND != kEpilogue) {
      // the thread's rows, then the warp's, then the CTA's in the ring's
      // memory, which every product has read once both warpgroups are here
      const int nt = blockIdx.x % n_nt, R = gridDim.x / n_nt;
      warp_rows<BN>(rs, rq);
      consumer_sync();
      write_row<BN>(reinterpret_cast<float*>(sm), rs, rq, parts, R,
                    blockIdx.x / n_nt, nt * BN, N, wgi * 4 + warp, g, c4);
      fold_rows<BN>(parts, sums, counters, last, R, nt, N);
    }
  }
}

// Columns per tile of the statistics kernels: 64 for N <= 64, else 128.
// With 256-column tiles the lanes must split the groups to keep their
// running sums in registers, and those measured slower at every 1x1 site
// of the ResNet-50 step, stage 1 and stage 4 included
// (tools/torch_stats_ablation.py).
inline int stats_tile_n(int N) { return N <= 64 ? 64 : 128; }

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// Rows of the statistics kernels' partial-sum scratch for bn-column tiles:
// the CTAs that share one n-tile, R = min(m-tiles, SMs / n-tiles), at
// least 1. The grid is R x n-tiles CTAs, so every CTA keeps one n-tile
// throughout its walk.
inline int stats_rows(int M, int N, int sms, int bn) {
  const int n_nt = (N + bn - 1) / bn, m_nt = (M + TM - 1) / TM;
  const int r = sms / n_nt;
  return r < 1 ? 1 : r < m_nt ? r : m_nt;
}

template <int BN_, int NRB_>
struct Tag {
  static constexpr int BN = BN_, NRB = NRB_;
};

}  // namespace gemm
}  // namespace mxt

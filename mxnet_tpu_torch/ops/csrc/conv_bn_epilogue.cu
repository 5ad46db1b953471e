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
// bf16: all three kernels are one persistent TMA + wgmma GEMM on
// wgmma_sm90.cuh (`gemm_wgmma<BN, NRB, KIND>`) that differ after the
// product. One CTA per SM walks the (m-tile, n-tile) grid statically, tile
// blockIdx.x + i * gridDim.x with the n-tile fastest, so the n-tiles of one
// m-tile run together: x is read from HBM once, even where it outgrows
// the 50 MB L2 (stage 1), and its other n-tiles' reads hit L2. A tile is
// 128 rows (two consumer warpgroups of 64) by BN columns: for
// matmul_epilogue 64, 128 or 256, the least that covers N (256 above); for
// the statistics kernels 64 or 128 (below). x and wt are K-major 2-D TMA
// maps (a 3-D map with n = 1) read in 64-wide k-boxes with 128-byte
// swizzle through a
// ring that runs ahead across tiles, as deep as shared memory allows beside
// the tile buffers; the copy zero-fills rows past M and N and columns past
// K. Each k16 step is one wgmma with both operands from shared memory
// (m64nBNk16). Three threads of the producer warpgroup work apart: one
// fills the ring, one hands each tile buffer to the consumers once its
// last store has read it (loading the residual into it by TMA for
// matmul_epilogue), one stores finished tiles by TMA, which clips rows past
// M and columns past N, while the consumers go on to the next tile. Two
// tile buffers, except at 256-column tiles with K >= DEEP_K, where one
// buffer leaves room for a third ring stage; matmul_stats stores nothing,
// has no tile buffer and takes the deepest ring.
//
// After the product:
//   matmul_epilogue computes z * scale + shift, adds the residual in fp32,
//   applies the relu and rounds once to bf16 into the tile buffer in place;
//   matmul_bn_stats applies the relu and rounds y into the tile buffer in
//   the same way, and both statistics kernels add the tile's column sums
//   into running sums. These repeat bit for bit (no atomics on values, and
//   every sum in an order fixed by the static schedule): the CTAs of the
//   grid, R x n-tiles of them (R = min(m-tiles, SMs / n-tiles)), keep one
//   n-tile throughout, and each consumer thread sums its own two rows of
//   each column over all its tiles, in tile order. Only at the end are the
//   sums taken over the warp's lanes (shuffles) and the 8 consumer warps
//   (shared memory, in warp order), and one row per CTA written to a
//   (2, R, N) scratch. The last CTA of each n-tile to finish (a counter
//   behind a fence) sums its n-tile's R rows in row order into (s, ss), so
//   no second launch adds them. The counters, one per n-tile, sit in the
//   launch's own scratch after the rows and are zeroed by the launch, so
//   launches may overlap (two CUDA graphs replayed at once on two streams,
//   each with its own memory pool). The statistics take 64-column
//   tiles for N <= 64 and 128-column tiles above: there a thread's 64
//   accumulators and 64 running sums fit the register budget, where 256
//   columns (lanes g and g ^ 4 splitting the column groups, one shuffle per
//   value kept) measured slower at every 1x1 site of the ResNet-50 step
//   (tools/torch_stats_ablation.py builds that variant).
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
#include "wgmma_sm90.cuh"

namespace {

using namespace mxt::conv;

using Dense32 = DenseA<float, 1>;

// ---------------------------------------------------------------------------
// bf16: persistent TMA + wgmma GEMM with the epilogue or the statistics
// ---------------------------------------------------------------------------

namespace wg {

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
// boundary: NST ring stages of (x k-box: 128 rows, wt k-box: BN rows), as
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
// tile: z and z^2 of its 2 columns in each of the J groups.
template <int BN>
struct Cols {
  static constexpr int J = BN / 8;
  static constexpr int NV = 2 * J;   // running sums of z (and of z^2)
};

// Adds the tile's column sums over the thread's two rows to rs (z) and rq
// (z^2).
template <int BN>
__device__ __forceinline__ void add_tile(float (&rs)[Cols<BN>::NV],
                                         float (&rq)[Cols<BN>::NV],
                                         const float (&acc)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < Cols<BN>::J; ++i)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float a0 = acc[4 * i + p], b0 = acc[4 * i + 2 + p];
      float s = a0 + b0, q = fmaf(a0, a0, b0 * b0);
      rs[2 * i + p] += s;
      rq[2 * i + p] += q;
    }
}

// The warp's sums: each running sum added over the lanes of equal c by a
// butterfly, so that every such lane holds the same total.
template <int BN>
__device__ __forceinline__ void warp_rows(float (&rs)[Cols<BN>::NV],
                                          float (&rq)[Cols<BN>::NV]) {
#pragma unroll
  for (int i = 0; i < Cols<BN>::NV; ++i)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
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
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < Cols<BN>::J; ++i)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = 8 * i + 2 * c4 + p;
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
// and their barriers (matmul_bn_stats), the thread's rows and lane.
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
               int M, int N, int K, int has_res, int relu) {
  static_assert((KIND == kStats) == (NRB == 0), "a store needs tile buffers");
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
      // the CTA keeps one n-tile (the grid a multiple of the n-tiles) and K
      // is one k-box, every stage holds the same wt box, loaded on the
      // stage's first fill only.
      const bool w_fixed = n_kb == 1 && gridDim.x % n_nt == 0;
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

      // z = x wt^T: the products of k-box kb run while the ring fills;
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
        finish_tile<BN, NRB, KIND == kStatsStore, L>(acc, rs, rq, fin, li);
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

// Columns per tile of matmul_epilogue for N output columns: the least of
// 64, 128 and 256 that covers N, and 256 for wider N.
inline int tile_n(int N) { return N <= 64 ? 64 : N <= 128 ? 128 : 256; }

// ... and of the statistics kernels: 64 for N <= 64, else 128. With
// 256-column tiles the lanes must split the groups to keep their running
// sums in registers, and those measured slower at every 1x1 site of the ResNet-50 step, stage 1 and
// stage 4 included (tools/torch_stats_ablation.py).
inline int stats_tile_n(int N) { return N <= 64 ? 64 : 128; }

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// Rows of the statistics kernels' partial-sum scratch: the CTAs that share
// one n-tile, R = min(m-tiles, SMs / n-tiles), at least 1. The grid is R x
// n-tiles CTAs, so every CTA keeps one n-tile throughout its walk.
inline int stats_rows(int M, int N, int sms) {
  const int bn = stats_tile_n(N);
  const int n_nt = (N + bn - 1) / bn, m_nt = (M + TM - 1) / TM;
  const int r = sms / n_nt;
  return r < 1 ? 1 : r < m_nt ? r : m_nt;
}

template <int BN_, int NRB_>
struct Tag {
  static constexpr int BN = BN_, NRB = NRB_;
};

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
      res != nullptr, relu);
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
  if (rows != stats_rows(M, N, sms) || (long long)rows * n_nt > 0x7fffffff)
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
         dtype > 1 || grid_of(M, N, dtype).y > 65535;
}

template <bool RES, bool RELU>
void launch_epilogue_fp32(const float* x, const float* wt, const float* scale,
                          const float* shift, const float* res, float* out,
                          int M, int N, int K, cudaStream_t st) {
  epilogue_fp32<RES, RELU><<<grid_of(M, N, 0), FNT, 0, st>>>(
      Dense32{x, M, K}, wt, scale, shift, res, out, N, K);
}

// The per-tile fp32 statistics kernels: y (STORE) and the partial sums of
// act(x @ w), one row per m-tile.
template <bool STORE, bool RELU>
void launch_stats_fp32(const float* x, const float* wt, float* y, float* ps,
                       float* pss, int M, int N, int K, cudaStream_t st) {
  stats_fp32<Dense32, STORE, RELU><<<grid_of(M, N, 0), FNT, 0, st>>>(
      Dense32{x, M, K}, wt, y, ps, pss, N, K);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry point returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernels do not take (or, for a
// TMA kernel, a map cuTensorMapEncodeTiled refuses), else the first error
// of the launch, else cudaGetLastError() right after it.

// Rows of x per CTA of the per-tile statistics kernels, hence rows of their
// partial-sum scratch per m-tile.
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
  return wg::stats_rows(M, N, sms);
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

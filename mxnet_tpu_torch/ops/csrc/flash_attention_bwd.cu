// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the two Pallas TPU kernels of the backward in
// mxnet_tpu/ops/pallas_kernels.py, both launched by `_bwd` through
// `pl.pallas_call`:
//   `_bwd_dq_kernel`  -> `dq_wgmma` / `dq_fp32`
//   `_bwd_dkv_kernel` -> `dkv_wgmma` / `dkv_fp32`
// With s = q k^T * sm_scale [+ causal mask], p = exp(s - lse) and
// delta = rowsum(do * o) in fp32:
//   dp = do v^T,  ds = p * (dp - delta) * sm_scale,
//   dq = ds k,    dk = ds^T q,    dv = p^T do,
// accumulated in fp32 and written in the input dtype. The dq kernels also
// compute delta for their rows and store it to a (bh, s) fp32 scratch that
// the dk/dv kernels read: the wrapper launches dq first, on the same stream.
// (The TPU reference computes delta outside its kernels, where XLA fuses
// it.)
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous (bh, s, d); lse and
// delta are (bh, s) fp32. Head dims: d % 8 == 0 and 8 <= d <= 128. Any
// s >= 1: rows past s are zero-filled on load, masked to p = 0, and never
// stored; their lse and delta are never read.
//
// Design, 16-bit inputs (bf16 and fp16, one template). Each CTA is two
// consumer warpgroups of 64 rows each and one producer warpgroup, whose
// first warp issues TMA loads (wgmma_sm90.cuh) and whose registers go to
// the consumers (setmaxnreg). Every (bh, s, d) operand is a 3-D TMA map
// (d, s, bh) with (64, rows, 1) boxes and 128-byte swizzle: d is padded to
// 64 or 128 and the rows past s to the tile by the copy's zero fill, inside
// each head, with no padded copy. All products are wgmma (fp32
// accumulate) with operands as they lie:
//   dq:   one CTA per (bh, 128-row q tile). Q, dO and O arrive once; the
//         consumers compute delta from the dO and O tiles, then K and V
//         stream through a 2-stage mbarrier ring in 64-key tiles.
//         S = Q K^T and dP = dO V^T take both operands from shared memory,
//         K-major; dS is formed in the accumulator registers and is the
//         register A operand of dQ += dS K, with K read MN-major through
//         the descriptor's transpose bit. With causal=True the k-tiles
//         wholly above the diagonal are not loaded (`num_kb_eff` in the TPU
//         kernel).
//   dk/dv: one CTA per (bh, 128-key tile). K and V arrive once and stay;
//         Q and dO (and lse, delta, copied by the producer warp) stream
//         through the ring in q-tiles of 64 rows (32 at d = 128, to keep
//         dK, dV, S^T and dP^T in registers), from the causal start
//         (`start_qb`). S^T = K Q^T and dP^T = V dO^T from shared memory;
//         P^T and dS^T, rounded to 16 bits, are the register A operands of
//         dV += P^T dO and dK += dS^T Q, with dO and Q read MN-major.
// No operand is copied transposed. Each output element is written by
// exactly one CTA, and no atomics are used, so the result is bitwise
// repeatable. p and ds are rounded to the input dtype where they enter a
// product (the TPU kernels keep them in fp32, a precision departure that
// chip_smoke.py holds to the gap it makes in a plain fp32 computation).
// fp32 inputs run FMA kernels in full fp32 (4 warps per 64-row tile).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), bf16,
// non-causal, at the LM train step's shapes. Bytes: dq reads q, k, v, o,
// do and writes dq (6 tensors), dk/dv reads q, k, v, do and writes dk, dv
// (6 tensors), each bh*s*d*2 bytes; each reads lse and reads or writes
// delta (bh*s*4 bytes each). Operations: 2*bh*s*s*d per product; dq has 3
// (q k^T, do v^T, ds k), dk/dv has 4 (k q^T, v do^T, p^T do, ds^T q).
//   (384, 128, 64), tokens (32, 128):
//     dq    38.1 MB, 2.42 GFLOP -> 11.4 us of memory, 2.4 us of tensor core
//     dk/dv 38.1 MB, 3.22 GFLOP -> 11.4 us of memory, 3.3 us: bound by bytes
//   (96, 512, 64), tokens (8, 512):
//     dq    38.1 MB,  9.66 GFLOP -> 11.4 us of memory,  9.8 us of tensor core
//     dk/dv 38.1 MB, 12.9 GFLOP  -> 11.4 us of memory, 13.0 us: bound by
//     operations
// Where the time goes (PERF.md has the measurements): the loads are hidden
// (a deeper ring, or two CTAs per SM, change nothing), and the softmax
// arithmetic between each tile's two batches of products sets the pace.
// So exp is one ex2.approx, and only a tile that touches the ragged edge or
// the diagonal evaluates the mask. One CTA per tile, no persistent schedule;
// each consumer waits for its products before the arithmetic that needs them
// (issuing the next tile's products early measured slower).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using mxt::kFull;
using mxt::kLog2e;
using mxt::Mma;
using namespace mxt::sm90;

// Whether (query row, key) takes part: both inside s and, with causal,
// key <= row.
__device__ __forceinline__ bool kept(int row, int key, int s, int causal) {
  return row < s && key < s && !(causal && key > row);
}

// ---------------------------------------------------------------------------
// 16-bit inputs: TMA ring + wgmma
// ---------------------------------------------------------------------------

constexpr int WG = 128;          // threads of a warpgroup
constexpr int NST = 2;           // stages of the streaming ring
constexpr int RB = 128;          // bytes of a 64-column 16-bit tile row
// A CTA is two consumer warpgroups (64 rows each), then one producer
// warpgroup whose registers go to the consumers: 24 + 2 x 240 per thread
// slot is 3 x 168, the launch's share.
constexpr int CONSUMERS = 2 * WG, THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// sum of the 8 products of two 16-byte vectors of T, in fp32
template <typename T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(to_f(x[i]), to_f(y[i]), acc);
  return acc;
}

// Shared memory of dq_wgmma, in bytes from a 1024-byte boundary: the Q, dO
// and O tiles (BM rows, NC 64-column chunks each), then NST stages of (K, V)
// (BN rows), then the barriers: resident, full[NST], empty[NST].
template <int HDP>
struct DqSmem {
  static constexpr int BM = 128, BN = 64, NC = HDP / 64;
  static constexpr int TQ = BM * HDP * 2, TK = BN * HDP * 2;
  static constexpr int Q = 0, DO = TQ, O = 2 * TQ, KV = 3 * TQ;
  static constexpr int BAR = KV + NST * 2 * TK;
  static constexpr int BYTES = BAR + (1 + 2 * NST) * 8 + 1024;
};

// Shared memory of dkv_wgmma: the K and V tiles (BK rows), then NST stages
// of (Q, dO, lse * log2 e, delta) (BQ rows), then the barriers.
template <int HDP>
struct DkvSmem {
  static constexpr int BK = 128, BQ = HDP >= 128 ? 32 : 64, NC = HDP / 64;
  static constexpr int TK = BK * HDP * 2, TQ = BQ * HDP * 2;
  static constexpr int K = 0, V = TK, STAGE = 2 * TK;
  static constexpr int SB = (2 * TQ + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int BAR = STAGE + NST * SB;
  static constexpr int BYTES = BAR + (1 + 2 * NST) * 8 + 1024;
};

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
dq_wgmma(const __grid_constant__ CUtensorMap tq,
         const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv,
         const __grid_constant__ CUtensorMap to,
         const __grid_constant__ CUtensorMap tdo,
         const float* __restrict__ lse, float* __restrict__ delta,
         T* __restrict__ dq, int s, int d, float sm_scale, int causal) {
  using L = DqSmem<HDP>;
  constexpr int BM = L::BM, BN = L::BN, NC = L::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* rbar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = rbar + 1;
  uint64_t* empty = full + NST;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal first
  int n_kt = (s + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / BN + 1);

  if (threadIdx.x == 0) {
    mbar_init(rbar, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    // producer: one thread issues every copy
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      mbar_arrive_expect_tx(rbar, 3 * L::TQ);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_3d(sm + L::Q + c * BM * RB, &tq, rbar, 64 * c, q0, bh);
        tma_load_3d(sm + L::DO + c * BM * RB, &tdo, rbar, 64 * c, q0, bh);
        tma_load_3d(sm + L::O + c * BM * RB, &to, rbar, 64 * c, q0, bh);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % NST;
        unsigned char* kb = sm + L::KV + st * 2 * L::TK;
        mbar_wait(&empty[st], ((kt / NST) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * L::TK);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(kb + c * BN * RB, &tk, &full[st], 64 * c, kt * BN, bh);
          tma_load_3d(kb + L::TK + c * BN * RB, &tv, &full[st], 64 * c,
                      kt * BN, bh);
        }
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int rl = wg * 64 + warp * 16 + g;  // tile rows rl and rl + 8
    const size_t rbase = (size_t)bh * s;
    const float scale_log2 = sm_scale * kLog2e;

    // delta = rowsum(dO * O) for this thread's two rows: each of the 4
    // threads of a quad sums every 4th 16-byte vector, then the quad adds
    mbar_wait(rbar, 0);
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rl + 8 * i, row = q0 + r;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < HDP / 32; ++jj) {
        const int j = 4 * jj + c4;
        const int off = (j / 8) * BM * RB + r * RB + (((j % 8) ^ (r % 8)) * 16);
        sum += dot8<T>(*reinterpret_cast<const uint4*>(sm + L::DO + off),
                       *reinterpret_cast<const uint4*>(sm + L::O + off));
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      dl[i] = sum;
      lse2[i] = row < s ? lse[rbase + row] * kLog2e : 0.f;
      if (c4 == 0 && row < s) delta[rbase + row] = sum;
    }

    float acc[NC][32], sc[32], dp[32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;

    const unsigned char* qa = sm + L::Q + wg * 64 * RB;
    const unsigned char* doa = sm + L::DO + wg * 64 * RB;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % NST, k0 = kt * BN;
      const unsigned char* kb = sm + L::KV + st * 2 * L::TK;
      const unsigned char* vb = kb + L::TK;
      mbar_wait(&full[st], (kt / NST) & 1);

      // S = Q K^T, dP = dO V^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const int co = kk / 4, o = (kk % 4) * 32;
        wgmma_ss<0>(Op<T>(), sc, desc_k_major(qa + co * BM * RB + o),
                       desc_k_major(kb + co * BN * RB + o), kk);
        wgmma_ss<0>(Op<T>(), dp, desc_k_major(doa + co * BM * RB + o),
                       desc_k_major(vb + co * BN * RB + o), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP - delta) scale, P = exp(S scale - lse), into A fragments;
      // only a tile on the ragged edge or the diagonal needs the mask
      const bool edge = q0 + BM > s || k0 + BN > s ||
                        (causal && k0 + BN - 1 > q0);
      auto form_ds = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, key = k0 + 8 * j + 2 * c4 + (e & 1);
            const float p =
                fast_exp2(fmaf(sc[4 * j + e], scale_log2, -lse2[i]));
            float ds = p * (dp[4 * j + e] - dl[i]) * sm_scale;
            if constexpr (decltype(masked)::value)
              if (!kept(q0 + rl + 8 * i, key, s, causal)) ds = 0.f;
            sc[4 * j + e] = ds;
          }
        }
      };
      if (edge)
        form_ds(std::true_type());
      else
        form_ds(std::false_type());
      uint32_t a[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        mxt::pack_a<T>(a[kk], &sc[8 * kk], &sc[8 * kk + 4]);

      // dQ += dS K
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wgmma_rs<1>(Op<T>(), acc[c], a[kk],
                      desc_mn_major(kb + c * BN * RB + kk * 16 * RB), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
      mbar_arrive(&empty[st]);
    }

    T* out = dq + (size_t)bh * s * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * c4;
        if (col >= d) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q0 + rl + 8 * i;
          if (row < s)
            *reinterpret_cast<uint32_t*>(out + (size_t)row * d + col) =
                Mma<T>::pack(acc[c][4 * j + 2 * i], acc[c][4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
dkv_wgmma(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dk, T* __restrict__ dv, int s, int d,
          float sm_scale, int causal) {
  using L = DkvSmem<HDP>;
  constexpr int BK = L::BK, BQ = L::BQ, NC = L::NC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* rbar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = rbar + 1;
  uint64_t* empty = full + NST;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // longest causal loop first
  const int n_qt = (s + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;
  const size_t rbase = (size_t)bh * s;

  if (threadIdx.x == 0) {
    mbar_init(rbar, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], 32);  // the producer warp's lanes
      mbar_init(&empty[st], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 2) {
    // producer: lane 0 of the first warp issues the copies, the warp's
    // lanes copy lse and delta of each q-tile
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < CONSUMERS + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_expect_tx(rbar, 2 * L::TK);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(sm + L::K + c * BK * RB, &tk, rbar, 64 * c, k0, bh);
          tma_load_3d(sm + L::V + c * BK * RB, &tv, rbar, 64 * c, k0, bh);
        }
      }
      for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
        const int st = it % NST;
        unsigned char* sb = sm + L::STAGE + st * L::SB;
        float* ls = reinterpret_cast<float*>(sb + 2 * L::TQ);
        float* dls = ls + BQ;
        mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * L::TQ);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            tma_load_3d(sb + c * BQ * RB, &tq, &full[st], 64 * c, qt * BQ, bh);
            tma_load_3d(sb + L::TQ + c * BQ * RB, &tdo, &full[st], 64 * c,
                        qt * BQ, bh);
          }
        }
        // while the tiles are in flight
        for (int i = lane; i < BQ; i += 32) {
          const int r = qt * BQ + i;
          ls[i] = r < s ? lse[rbase + r] * kLog2e : 0.f;
          dls[i] = r < s ? delta[rbase + r] : 0.f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int kl = wg * 64 + warp * 16 + g;  // tile keys kl and kl + 8
    const float scale_log2 = sm_scale * kLog2e;

    float dka[NC][32], dva[NC][32], sc[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[c][i] = dva[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;

    const unsigned char* ka = sm + L::K + wg * 64 * RB;
    const unsigned char* va = sm + L::V + wg * 64 * RB;
    mbar_wait(rbar, 0);
    for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
      const int st = it % NST, qq0 = qt * BQ;
      const unsigned char* qb = sm + L::STAGE + st * L::SB;
      const unsigned char* dob = qb + L::TQ;
      const float* ls = reinterpret_cast<const float*>(qb + 2 * L::TQ);
      const float* dls = ls + BQ;
      mbar_wait(&full[st], (it / NST) & 1);

      // S^T = K Q^T, dP^T = V dO^T
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const int co = kk / 4, o = (kk % 4) * 32;
        wgmma_ss<0>(Op<T>(), sc, desc_k_major(ka + co * BK * RB + o),
                       desc_k_major(qb + co * BQ * RB + o), kk);
        wgmma_ss<0>(Op<T>(), dp, desc_k_major(va + co * BK * RB + o),
                       desc_k_major(dob + co * BQ * RB + o), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // P^T into sc, dS^T into dp, then both into A fragments; only a tile
      // on the ragged edge or the diagonal needs the mask
      const bool edge = k0 + BK > s || qq0 + BQ > s ||
                        (causal && k0 + BK - 1 > qq0);
      auto form_p_ds = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int col0 = 8 * j + 2 * c4;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + col0);
          const float2 d2 = *reinterpret_cast<const float2*>(dls + col0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + kl + 8 * (e >> 1);
            float p = fast_exp2(
                fmaf(sc[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
            if constexpr (decltype(masked)::value)
              if (!kept(qq0 + col0 + (e & 1), key, s, causal)) p = 0.f;
            sc[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x)) *
                            sm_scale;
          }
        }
      };
      if (edge)
        form_p_ds(std::true_type());
      else
        form_p_ds(std::false_type());
      uint32_t ap[BQ / 16][4], ads[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        mxt::pack_a<T>(ap[kk], &sc[8 * kk], &sc[8 * kk + 4]);
        mxt::pack_a<T>(ads[kk], &dp[8 * kk], &dp[8 * kk + 4]);
      }

      // dV += P^T dO, dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          wgmma_rs<1>(Op<T>(), dva[c], ap[kk],
                      desc_mn_major(dob + c * BQ * RB + kk * 16 * RB), 1);
          wgmma_rs<1>(Op<T>(), dka[c], ads[kk],
                      desc_mn_major(qb + c * BQ * RB + kk * 16 * RB), 1);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        fence_regs(dka[c]);
        fence_regs(dva[c]);
      }
      mbar_arrive(&empty[st]);
    }

    T* dkb = dk + (size_t)bh * s * d;
    T* dvb = dv + (size_t)bh * s * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * c4;
        if (col >= d) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = k0 + kl + 8 * i;
          if (key >= s) continue;
          const size_t off = (size_t)key * d + col;
          *reinterpret_cast<uint32_t*>(dkb + off) =
              Mma<T>::pack(dka[c][4 * j + 2 * i], dka[c][4 * j + 2 * i + 1]);
          *reinterpret_cast<uint32_t*>(dvb + off) =
              Mma<T>::pack(dva[c][4 * j + 2 * i], dva[c][4 * j + 2 * i + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: FMA on the CUDA cores, full fp32 precision
// ---------------------------------------------------------------------------
//
// Thread t owns row t / 2 of the CTA's 64-row tile; the pair (h = t % 2)
// splits the streamed tile's 64 rows (2j + h) and the output columns
// (2c + h) between its two threads, as in the forward's fp32 kernel.
// Shared-memory rows are padded to an odd stride, so the 16 rows a warp
// reads at once fall in distinct banks.

constexpr int BM = 64;    // query rows per dq CTA
constexpr int BN = 64;    // keys per k-tile of dq, and per dk/dv CTA
constexpr int NT = 128;   // threads per CTA

// Number of k-tiles a q-tile starting at q0 reads.
__device__ __forceinline__ int num_k_tiles(int s, int q0, int causal) {
  int n = (s + BN - 1) / BN;
  if (causal) n = min(n, (q0 + BM - 1) / BN + 1);
  return n;
}

// Rows [r0, r0 + 64) of a contiguous (s, d) fp32 matrix into shared memory
// with row stride HDP + 1, zero-filled past row s and column d.
template <int HDP>
__device__ __forceinline__ void load_tile_fp32(const float* __restrict__ src,
                                               int r0, int s, int d,
                                               float* dst, int tid) {
  for (int i = tid; i < 64 * HDP; i += NT) {
    const int row = i / HDP, col = i % HDP, r = r0 + row;
    dst[row * (HDP + 1) + col] =
        (r < s && col < d) ? src[(size_t)r * d + col] : 0.f;
  }
}

template <int HDP>
constexpr int fp32_smem() {
  return (4 * 64 * (HDP + 1) + 2 * 64) * (int)sizeof(float);
}

template <int HDP>
__global__ void __launch_bounds__(NT)
dq_fp32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ o,
        const float* __restrict__ dout, const float* __restrict__ lse,
        float* __restrict__ delta, float* __restrict__ dq, int s, int d,
        float sm_scale, int causal) {
  constexpr int ST = HDP + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BM * ST;
  float* Ks = dOs + BM * ST;
  float* Vs = Ks + BN * ST;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int tid = threadIdx.x, r = tid >> 1, h = tid & 1;
  const int row = q0 + r;
  const size_t base = (size_t)bh * s * d;

  load_tile_fp32<HDP>(q + base, q0, s, d, Qs, tid);
  load_tile_fp32<HDP>(dout + base, q0, s, d, dOs, tid);
  const float lr = row < s ? lse[(size_t)bh * s + row] : 0.f;
  // delta = rowsum(do * o) of this row: the pair sums alternate columns
  float dlr = 0.f;
  if (row < s) {
    const float* dr = dout + base + (size_t)row * d;
    const float* orow = o + base + (size_t)row * d;
    for (int c = h; c < d; c += 2) dlr = fmaf(dr[c], orow[c], dlr);
  }
  dlr += __shfl_xor_sync(kFull, dlr, 1);
  if (h == 0 && row < s) delta[(size_t)bh * s + row] = dlr;

  float acc[HDP / 2];
#pragma unroll
  for (int c = 0; c < HDP / 2; ++c) acc[c] = 0.f;

  const int n_kt = num_k_tiles(s, q0, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile_fp32<HDP>(k + base, k0, s, d, Ks, tid);
    load_tile_fp32<HDP>(v + base, k0, s, d, Vs, tid);
    __syncthreads();

    float sc[BN / 2], dp[BN / 2];  // keys k0 + 2j + h
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sc[j] = dp[j] = 0.f;
    for (int c = 0; c < HDP; ++c) {
      const float qv = Qs[r * ST + c], ov = dOs[r * ST + c];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        sc[j] += qv * Ks[(2 * j + h) * ST + c];
        dp[j] += ov * Vs[(2 * j + h) * ST + c];
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      float ds = 0.f;
      if (kept(row, k0 + 2 * j + h, s, causal))
        ds = expf(sc[j] * sm_scale - lr) * (dp[j] - dlr) * sm_scale;
      sc[j] = ds;
    }
#pragma unroll 4
    for (int j = 0; j < BN / 2; ++j) {
      const float dm = sc[j];                              // key 2j + h
      const float dn = __shfl_xor_sync(kFull, sc[j], 1);   // key 2j + 1 - h
      const float* km = Ks + (2 * j + h) * ST + h;
      const float* kn = Ks + (2 * j + 1 - h) * ST + h;
#pragma unroll
      for (int c = 0; c < HDP / 2; ++c) acc[c] += dm * km[2 * c] + dn * kn[2 * c];
    }
  }

  if (row < s) {
    float* out = dq + base + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < HDP / 2; ++c)
      if (2 * c + h < d) out[2 * c + h] = acc[c];
  }
}

template <int HDP>
__global__ void __launch_bounds__(NT)
dkv_fp32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         float* __restrict__ dk, float* __restrict__ dv, int s, int d,
         float sm_scale, int causal) {
  constexpr int ST = HDP + 1, BQ = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BN * ST;
  float* Qs = Vs + BN * ST;
  float* dOs = Qs + BQ * ST;
  float* ls = dOs + BQ * ST;  // BQ
  float* dl = ls + BQ;        // BQ

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;
  const int tid = threadIdx.x, r = tid >> 1, h = tid & 1;
  const int key = k0 + r;
  const size_t base = (size_t)bh * s * d;

  load_tile_fp32<HDP>(k + base, k0, s, d, Ks, tid);
  load_tile_fp32<HDP>(v + base, k0, s, d, Vs, tid);

  float dka[HDP / 2], dva[HDP / 2];
#pragma unroll
  for (int c = 0; c < HDP / 2; ++c) dka[c] = dva[c] = 0.f;

  const int n_qt = (s + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int qq0 = qt * BQ;
    __syncthreads();
    load_tile_fp32<HDP>(q + base, qq0, s, d, Qs, tid);
    load_tile_fp32<HDP>(dout + base, qq0, s, d, dOs, tid);
    for (int i = tid; i < BQ; i += NT) {
      const int qr = qq0 + i;
      ls[i] = qr < s ? lse[(size_t)bh * s + qr] : 0.f;
      dl[i] = qr < s ? delta[(size_t)bh * s + qr] : 0.f;
    }
    __syncthreads();

    float sc[BQ / 2], dp[BQ / 2];  // queries qq0 + 2j + h
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) sc[j] = dp[j] = 0.f;
    for (int c = 0; c < HDP; ++c) {
      const float kv = Ks[r * ST + c], vv = Vs[r * ST + c];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        sc[j] += kv * Qs[(2 * j + h) * ST + c];
        dp[j] += vv * dOs[(2 * j + h) * ST + c];
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {
      const int col = 2 * j + h;
      float p = 0.f, ds = 0.f;
      if (kept(qq0 + col, key, s, causal)) {
        p = expf(sc[j] * sm_scale - ls[col]);
        ds = p * (dp[j] - dl[col]) * sm_scale;
      }
      sc[j] = p;
      dp[j] = ds;
    }
#pragma unroll 2
    for (int j = 0; j < BQ / 2; ++j) {
      const float pm = sc[j], pn = __shfl_xor_sync(kFull, sc[j], 1);
      const float dm = dp[j], dn = __shfl_xor_sync(kFull, dp[j], 1);
      const float* om = dOs + (2 * j + h) * ST + h;      // query 2j + h
      const float* on = dOs + (2 * j + 1 - h) * ST + h;  // query 2j + 1 - h
      const float* qm = Qs + (2 * j + h) * ST + h;
      const float* qn = Qs + (2 * j + 1 - h) * ST + h;
#pragma unroll
      for (int c = 0; c < HDP / 2; ++c) {
        dva[c] += pm * om[2 * c] + pn * on[2 * c];
        dka[c] += dm * qm[2 * c] + dn * qn[2 * c];
      }
    }
  }

  if (key < s) {
    const size_t off = base + (size_t)key * d;
#pragma unroll
    for (int c = 0; c < HDP / 2; ++c) {
      if (2 * c + h < d) {
        dk[off + 2 * c + h] = dka[c];
        dv[off + 2 * c + h] = dva[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;  // written by the dq kernels, read by the dk/dv kernels
  void *dq, *dk, *dv;
  int bh, s, d;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// TMA maps of n (bh, s, d) tensors with the given box rows.
template <typename T, int N>
cudaError_t encode_maps(CUtensorMap (&maps)[N], const void* const (&src)[N],
                        const int (&rows)[N], const Args& a) {
  const CUtensorMapDataType ty = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  for (int i = 0; i < N; ++i) {
    cudaError_t err =
        encode_rows_map(&maps[i], src[i], a.bh, a.s, a.d, rows[i], ty);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, int HDP>
cudaError_t launch_dq_wgmma(const Args& a) {
  using L = DqSmem<HDP>;
  CUtensorMap m[5];
  const void* const src[5] = {a.q, a.k, a.v, a.o, a.dout};
  const int rows[5] = {L::BM, L::BN, L::BN, L::BM, L::BM};
  cudaError_t err = encode_maps<T>(m, src, rows, a);
  if (err != cudaSuccess) return err;
  err = set_smem(dq_wgmma<T, HDP>, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s + L::BM - 1) / L::BM);
  dq_wgmma<T, HDP><<<grid, THREADS, L::BYTES, a.stream>>>(
      m[0], m[1], m[2], m[3], m[4], a.lse, a.delta, static_cast<T*>(a.dq),
      a.s, a.d, a.sm_scale, a.causal);
  return cudaSuccess;
}

template <typename T, int HDP>
cudaError_t launch_dkv_wgmma(const Args& a) {
  using L = DkvSmem<HDP>;
  CUtensorMap m[4];
  const void* const src[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {L::BQ, L::BK, L::BK, L::BQ};
  cudaError_t err = encode_maps<T>(m, src, rows, a);
  if (err != cudaSuccess) return err;
  err = set_smem(dkv_wgmma<T, HDP>, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s + L::BK - 1) / L::BK);
  dkv_wgmma<T, HDP><<<grid, THREADS, L::BYTES, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.s, a.d, a.sm_scale, a.causal);
  return cudaSuccess;
}

template <int HDP>
cudaError_t launch_dq_fp32(const Args& a) {
  constexpr int bytes = fp32_smem<HDP>();
  cudaError_t err = set_smem(dq_fp32<HDP>, bytes);
  if (err != cudaSuccess) return err;
  dq_fp32<HDP><<<dim3(a.bh, (a.s + BM - 1) / BM), NT, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), a.s, a.d, a.sm_scale, a.causal);
  return cudaSuccess;
}

template <int HDP>
cudaError_t launch_dkv_fp32(const Args& a) {
  constexpr int bytes = fp32_smem<HDP>();
  cudaError_t err = set_smem(dkv_fp32<HDP>, bytes);
  if (err != cudaSuccess) return err;
  dkv_fp32<HDP><<<dim3(a.bh, (a.s + BN - 1) / BN), NT, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.s, a.d, a.sm_scale, a.causal);
  return cudaSuccess;
}

// which: 0 = dq, 1 = dk/dv
template <int HDP>
cudaError_t launch_fp32(int which, const Args& a) {
  return which == 0 ? launch_dq_fp32<HDP>(a) : launch_dkv_fp32<HDP>(a);
}

template <typename T, int HDP>
cudaError_t launch_16(int which, const Args& a) {
  return which == 0 ? launch_dq_wgmma<T, HDP>(a)
                    : launch_dkv_wgmma<T, HDP>(a);
}

template <typename T>
cudaError_t launch_16bit(int which, const Args& a) {
  return a.d <= 64 ? launch_16<T, 64>(which, a) : launch_16<T, 128>(which, a);
}

int run(int which, const Args& a, int dtype) {
  if (a.bh <= 0 || a.s <= 0 || a.d < 8 || a.d > 128 || a.d % 8 != 0 ||
      dtype < 0 || dtype > 2 || (a.s + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 1)
    err = launch_16bit<__half>(which, a);
  else if (dtype == 2)
    err = launch_16bit<__nv_bfloat16>(which, a);
  else if (a.d <= 16)
    err = launch_fp32<16>(which, a);
  else if (a.d <= 32)
    err = launch_fp32<32>(which, a);
  else if (a.d <= 64)
    err = launch_fp32<64>(which, a);
  else
    err = launch_fp32<128>(which, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Each returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernels do not take (or a TMA map
// the driver refuses), else the first error of the launch, else
// cudaGetLastError() right after it.
// dq also writes delta = rowsum(do * o), (bh, s) fp32, which dkv then reads:
// launch dq first on the same stream.
extern "C" int mxt_flash_attention_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const void* lse,
                                          void* delta, void* dq, int bh,
                                          int s, int d, float sm_scale,
                                          int causal, int dtype,
                                          void* stream) {
  Args a{q, k, v, o, dout, static_cast<const float*>(lse),
         static_cast<float*>(delta), dq, nullptr, nullptr, bh, s, d,
         sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return run(0, a, dtype);
}

extern "C" int mxt_flash_attention_bwd_dkv(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dk, void* dv, int bh, int s,
                                           int d, float sm_scale, int causal,
                                           int dtype, void* stream) {
  Args a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
         const_cast<float*>(static_cast<const float*>(delta)), nullptr, dk,
         dv, bh, s, d, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return run(1, a, dtype);
}

// Dynamic shared memory, in bytes, of the 16-bit dq (which = 0) or dk/dv
// (which = 1) kernel for head dims up to hdp (64 or 128).
extern "C" int mxt_flash_attention_bwd_smem(int which, int hdp) {
  if (which == 0) return hdp <= 64 ? DqSmem<64>::BYTES : DqSmem<128>::BYTES;
  return hdp <= 64 ? DkvSmem<64>::BYTES : DkvSmem<128>::BYTES;
}

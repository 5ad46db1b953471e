// Flash-attention backward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the two Pallas TPU kernels of the backward in
// mxnet_tpu/ops/pallas_kernels.py, both launched by `_bwd` through
// `pl.pallas_call`:
//   `_bwd_dq_kernel`  -> `dq_mma` / `dq_fp32`
//   `_bwd_dkv_kernel` -> `dkv_mma` / `dkv_fp32`
// With s = q k^T * sm_scale [+ causal mask], p = exp(s - lse) and
// delta = rowsum(do * o) (fp32, computed by the caller):
//   dp = do v^T,  ds = p * (dp - delta) * sm_scale,
//   dq = ds k,    dk = ds^T q,    dv = p^T do,
// accumulated in fp32 and written in the input dtype.
//
// Layout: q, k, v, do, dq, dk, dv are contiguous (bh, s, d); lse and delta
// are (bh, s) fp32. Head dims: d % 8 == 0 and 8 <= d <= 128, padded to
// 16/32/64/128 with zeros in shared memory. Any s >= 1: rows past s are
// zero-filled on load, masked to p = 0, and never stored; their lse and
// delta are never read.
//
// Design. The TPU kernels hold the whole (s, d) row of the streamed operand
// resident and run the grid in order. Here the split is the reference's own,
// with the loop inside the CTA in place of the sequential grid axis:
//   dq:   one CTA of 4 warps per (bh, 64-row q-tile). Its q and do tiles sit
//         in shared memory; K and V stream through in 64-key tiles (K also
//         stored transposed, the B operand of ds k). With causal=True the
//         k-tiles wholly above the diagonal are skipped, as `num_kb_eff`
//         does in the TPU kernel.
//   dk/dv: one CTA of 4 warps per (bh, 64-key k-tile). Its K and V tiles sit
//         in shared memory and the fp32 dk, dv accumulators in registers;
//         Q and do stream through in q-tiles (also stored transposed, the
//         B operands of ds^T q and p^T do), from the causal start
//         (`start_qb` in the TPU kernel).
// Each output element is written by exactly one CTA, and no atomics are
// used, so the result is deterministic. Each warp owns 16 rows of its CTA's
// tile. 16-bit inputs run all products on the tensor cores (mma.sync
// m16n8k16, fp32 accumulate); p and ds are rounded to the input dtype where
// they enter a product (the TPU kernels keep them in fp32, a precision
// departure that chip_smoke.py holds to the gap it makes in a plain fp32
// computation). fp32 inputs run FMA kernels in full fp32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense), bf16,
// non-causal, at the LM train step's shapes:
//   bytes: dq reads q, k, v, do and writes dq (5 tensors), dk/dv reads q, k,
//   v, do and writes dk, dv (6 tensors), each bh*s*d*2 bytes, plus lse and
//   delta (bh*s*4 bytes each). Operations: 2*bh*s*s*d per product; dq has 3
//   (q k^T, do v^T, ds k), dk/dv has 4 (plus p^T do and ds^T q).
//   (384, 128, 64), tokens (32, 128):
//     dq    31.8 MB, 2.42 GFLOP ->  9.5 us of memory, 2.4 us of tensor core
//     dk/dv 38.1 MB, 3.22 GFLOP -> 11.4 us of memory, 3.3 us: bound by bytes
//   (96, 512, 64), tokens (8, 512):
//     dq    31.8 MB,  9.66 GFLOP -> 9.5 us of memory,  9.8 us of tensor core
//     dk/dv 38.1 MB, 12.9 GFLOP  -> 11.4 us of memory, 13.0 us: bound by
//     operations
// The caller's delta pass (rowsum of do * o in fp32) moves about 12.7 MB
// more at both shapes (about 3.8 us).
// This first version is plain: synchronous tile loads, no cp.async/TMA, no
// wgmma, so it is expected to sit well above those bounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using mxt::kFull;
using mxt::kLog2e;
using mxt::Mma;

constexpr int BM = 64;    // query rows per dq CTA (16 per warp)
constexpr int BN = 64;    // keys per k-tile of dq, and per dk/dv CTA
constexpr int NT = 128;   // threads per CTA

// Rows [r0, r0 + ROWS) of a contiguous (s, d) 16-bit matrix into shared
// memory, row major with row stride HDP + 8 (`rowm`) and/or transposed with
// row stride ROWS + 8 (`trans`), zero-filled past row s and column d. The
// strides make the 32-bit fragment reads of a warp fall in distinct banks.
template <typename T, int ROWS, int HDP>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int s, int d, T* rowm, T* trans,
                                          int tid) {
  constexpr int CH = HDP / 8, RS = HDP + 8, TS = ROWS + 8;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int row = i / CH, col = (i % CH) * 8, r = r0 + row;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < s && col < d)
      x = *reinterpret_cast<const uint4*>(src + (size_t)r * d + col);
    if (rowm != nullptr)
      *reinterpret_cast<uint4*>(&rowm[row * RS + col]) = x;
    if (trans != nullptr) {
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) trans[(col + j) * TS + row] = e[j];
    }
  }
}

// A fragment of rows row0..row0+15, cols col0..col0+15 of a row-major
// shared-memory tile with row stride st.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t* a, const T* tile, int st,
                                       int row0, int col0, int g, int c2) {
  const T* p0 = tile + (row0 + g) * st + col0 + c2;
  const T* p1 = p0 + 8 * st;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment (k x n = 16 x 8) whose n index is the tile row (row0 + g) and
// whose k index runs along the row (col0 + c2, + 8).
template <typename T>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const T* tile, int st, int row0,
                                       int col0, int g, int c2) {
  const T* p = tile + (row0 + g) * st + col0 + c2;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Number of k-tiles a q-tile starting at q0 reads.
__device__ __forceinline__ int num_k_tiles(int s, int q0, int causal) {
  int n = (s + BN - 1) / BN;
  if (causal) n = min(n, (q0 + BM - 1) / BN + 1);
  return n;
}

// Whether (query row, key) takes part: both inside s and, with causal,
// key <= row.
__device__ __forceinline__ bool kept(int row, int key, int s, int causal) {
  return row < s && key < s && !(causal && key > row);
}

template <typename T, int HDP>
constexpr int dq_mma_smem() {
  return (2 * BM * (HDP + 8) + 2 * BN * (HDP + 8) + HDP * (BN + 8)) *
         (int)sizeof(T);
}

template <typename T, int HDP, int BQ>
constexpr int dkv_mma_smem() {
  return (2 * BN * (HDP + 8) + 2 * BQ * (HDP + 8) + 2 * HDP * (BQ + 8)) *
             (int)sizeof(T) +
         2 * BQ * (int)sizeof(float);
}

// ---------------------------------------------------------------------------
// 16-bit inputs: tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
dq_mma(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ delta,
       T* __restrict__ dq, int s, int d, float sm_scale, int causal) {
  constexpr int RS = HDP + 8, TS = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // BM x RS
  T* dOs = Qs + BM * RS;               // BM x RS
  T* Ks = dOs + BM * RS;               // BN x RS
  T* Vs = Ks + BN * RS;                // BN x RS
  T* Kt = Vs + BN * RS;                // HDP x TS

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const size_t base = (size_t)bh * s * d;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int rows[2] = {r0, r0 + 8};
  const float scale_log2 = sm_scale * kLog2e;

  load_tile<T, BM, HDP>(q + base, q0, s, d, Qs, nullptr, tid);
  load_tile<T, BM, HDP>(dout + base, q0, s, d, dOs, nullptr, tid);
  float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] < s) {
      lse2[i] = lse[(size_t)bh * s + rows[i]] * kLog2e;
      dl[i] = delta[(size_t)bh * s + rows[i]];
    }
  }

  float acc[HDP / 8][4];
#pragma unroll
  for (int dt = 0; dt < HDP / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int n_kt = num_k_tiles(s, q0, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, BN, HDP>(k + base, k0, s, d, Ks, Kt, tid);
    load_tile<T, BN, HDP>(v + base, k0, s, d, Vs, nullptr, tid);
    __syncthreads();

    // sc = q k^T and dp = do v^T for rows (r0, r0+8) x keys k0 + nt*8 + c2
    float sc[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, Qs, RS, warp * 16, kk * 16, g, c2);
      load_a(ado, dOs, RS, warp * 16, kk * 16, g, c2);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, Ks, RS, nt * 8, kk * 16, g, c2);
        Mma<T>::run(sc[nt], aq, b0, b1);
        load_b(b0, b1, Vs, RS, nt * 8, kk * 16, g, c2);
        Mma<T>::run(dp[nt], ado, b0, b1);
      }
    }

    // ds = p * (dp - delta) * scale, p = exp(s * scale - lse), into sc
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, key = k0 + nt * 8 + c2 + (e & 1);
        float ds = 0.f;
        if (kept(rows[i], key, s, causal))
          ds = exp2f(sc[nt][e] * scale_log2 - lse2[i]) *
               (dp[nt][e] - dl[i]) * sm_scale;
        sc[nt][e] = ds;
      }
    }

    // dq += ds k
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      mxt::pack_a<T>(a, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < HDP / 8; ++dt) {
        uint32_t b0, b1;
        load_b(b0, b1, Kt, TS, dt * 8, kk * 16, g, c2);
        Mma<T>::run(acc[dt], a, b0, b1);
      }
    }
  }

  T* out = dq + base;
#pragma unroll
  for (int dt = 0; dt < HDP / 8; ++dt) {
    const int col = dt * 8 + c2;
    if (col >= d) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < s)
        *reinterpret_cast<uint32_t*>(out + (size_t)rows[i] * d + col) =
            Mma<T>::pack(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

template <typename T, int HDP, int BQ>
__global__ void __launch_bounds__(NT)
dkv_mma(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dk, T* __restrict__ dv, int s, int d,
        float sm_scale, int causal) {
  constexpr int RS = HDP + 8, TS = BQ + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // BN x RS
  T* Vs = Ks + BN * RS;                // BN x RS
  T* Qs = Vs + BN * RS;                // BQ x RS
  T* dOs = Qs + BQ * RS;               // BQ x RS
  T* Qt = dOs + BQ * RS;               // HDP x TS
  T* dOt = Qt + HDP * TS;              // HDP x TS
  float* lse2 = reinterpret_cast<float*>(dOt + HDP * TS);  // BQ
  float* dl = lse2 + BQ;                                   // BQ

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;  // longest causal loop first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const size_t base = (size_t)bh * s * d;
  const int kr0 = k0 + warp * 16 + g;  // this thread's keys: kr0, kr0 + 8
  const int keys[2] = {kr0, kr0 + 8};
  const float scale_log2 = sm_scale * kLog2e;

  load_tile<T, BN, HDP>(k + base, k0, s, d, Ks, nullptr, tid);
  load_tile<T, BN, HDP>(v + base, k0, s, d, Vs, nullptr, tid);

  float dka[HDP / 8][4], dva[HDP / 8][4];
#pragma unroll
  for (int dt = 0; dt < HDP / 8; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  const int n_qt = (s + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int qq0 = qt * BQ;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<T, BQ, HDP>(q + base, qq0, s, d, Qs, Qt, tid);
    load_tile<T, BQ, HDP>(dout + base, qq0, s, d, dOs, dOt, tid);
    for (int i = tid; i < BQ; i += NT) {
      const int r = qq0 + i;
      lse2[i] = r < s ? lse[(size_t)bh * s + r] * kLog2e : 0.f;
      dl[i] = r < s ? delta[(size_t)bh * s + r] : 0.f;
    }
    __syncthreads();

    // transposed: sc = k q^T and dp = v do^T for keys (kr0, kr0+8) x
    // queries qq0 + nt*8 + c2
    float sc[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, Ks, RS, warp * 16, kk * 16, g, c2);
      load_a(av, Vs, RS, warp * 16, kk * 16, g, c2);
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, Qs, RS, nt * 8, kk * 16, g, c2);
        Mma<T>::run(sc[nt], ak, b0, b1);
        load_b(b0, b1, dOs, RS, nt * 8, kk * 16, g, c2);
        Mma<T>::run(dp[nt], av, b0, b1);
      }
    }

    // p^T into sc, ds^T into dp
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + c2 + (e & 1);
        float p = 0.f, ds = 0.f;
        if (kept(qq0 + col, keys[e >> 1], s, causal)) {
          p = exp2f(sc[nt][e] * scale_log2 - lse2[col]);
          ds = p * (dp[nt][e] - dl[col]) * sm_scale;
        }
        sc[nt][e] = p;
        dp[nt][e] = ds;
      }
    }

    // dv += p^T do, dk += ds^T q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ads[4];
      mxt::pack_a<T>(ap, sc[2 * kk], sc[2 * kk + 1]);
      mxt::pack_a<T>(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < HDP / 8; ++dt) {
        uint32_t b0, b1;
        load_b(b0, b1, dOt, TS, dt * 8, kk * 16, g, c2);
        Mma<T>::run(dva[dt], ap, b0, b1);
        load_b(b0, b1, Qt, TS, dt * 8, kk * 16, g, c2);
        Mma<T>::run(dka[dt], ads, b0, b1);
      }
    }
  }

  T* dkb = dk + base;
  T* dvb = dv + base;
#pragma unroll
  for (int dt = 0; dt < HDP / 8; ++dt) {
    const int col = dt * 8 + c2;
    if (col >= d) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (keys[i] >= s) continue;
      const size_t off = (size_t)keys[i] * d + col;
      *reinterpret_cast<uint32_t*>(dkb + off) =
          Mma<T>::pack(dka[dt][2 * i], dka[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvb + off) =
          Mma<T>::pack(dva[dt][2 * i], dva[dt][2 * i + 1]);
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
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dq, int s, int d, float sm_scale, int causal) {
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
  const float dlr = row < s ? delta[(size_t)bh * s + row] : 0.f;

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
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int s, d;
  float sm_scale;
  int causal;
  dim3 grid;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int HDP>
cudaError_t launch_dq_mma(const Args& a) {
  constexpr int bytes = dq_mma_smem<T, HDP>();
  cudaError_t err = set_smem(dq_mma<T, HDP>, bytes);
  if (err != cudaSuccess) return err;
  dq_mma<T, HDP><<<a.grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.s, a.d, a.sm_scale, a.causal);
  return cudaSuccess;
}

template <typename T, int HDP>
cudaError_t launch_dkv_mma(const Args& a) {
  // at HDP 128 a 32-row q-tile keeps the dk, dv accumulators and the
  // score fragments inside the register file
  constexpr int BQ = HDP >= 128 ? 32 : 64;
  constexpr int bytes = dkv_mma_smem<T, HDP, BQ>();
  cudaError_t err = set_smem(dkv_mma<T, HDP, BQ>, bytes);
  if (err != cudaSuccess) return err;
  dkv_mma<T, HDP, BQ><<<a.grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s, a.d,
      a.sm_scale, a.causal);
  return cudaSuccess;
}

template <int HDP>
cudaError_t launch_dq_fp32(const Args& a) {
  constexpr int bytes = fp32_smem<HDP>();
  cudaError_t err = set_smem(dq_fp32<HDP>, bytes);
  if (err != cudaSuccess) return err;
  dq_fp32<HDP><<<a.grid, NT, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.s, a.d, a.sm_scale,
      a.causal);
  return cudaSuccess;
}

template <int HDP>
cudaError_t launch_dkv_fp32(const Args& a) {
  constexpr int bytes = fp32_smem<HDP>();
  cudaError_t err = set_smem(dkv_fp32<HDP>, bytes);
  if (err != cudaSuccess) return err;
  dkv_fp32<HDP><<<a.grid, NT, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.s, a.d, a.sm_scale, a.causal);
  return cudaSuccess;
}

// which: 0 = dq, 1 = dk/dv
template <int HDP>
cudaError_t launch(int which, int dtype, const Args& a) {
  if (which == 0) {
    if (dtype == 0) return launch_dq_fp32<HDP>(a);
    if (dtype == 1) return launch_dq_mma<__half, HDP>(a);
    return launch_dq_mma<__nv_bfloat16, HDP>(a);
  }
  if (dtype == 0) return launch_dkv_fp32<HDP>(a);
  if (dtype == 1) return launch_dkv_mma<__half, HDP>(a);
  return launch_dkv_mma<__nv_bfloat16, HDP>(a);
}

int run(int which, Args a, int bh, int dtype) {
  if (bh <= 0 || a.s <= 0 || a.d < 8 || a.d > 128 || a.d % 8 != 0 ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int tiles = (a.s + 63) / 64;  // BM == BN == 64
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  a.grid = dim3(bh, tiles);
  cudaError_t err;
  if (a.d <= 16)
    err = launch<16>(which, dtype, a);
  else if (a.d <= 32)
    err = launch<32>(which, dtype, a);
  else if (a.d <= 64)
    err = launch<64>(which, dtype, a);
  else
    err = launch<128>(which, dtype, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Each returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernels do not take, else the
// first error of the launch, else cudaGetLastError() right after it.
extern "C" int mxt_flash_attention_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dq, int bh, int s, int d,
                                          float sm_scale, int causal,
                                          int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr, s, d,
         sm_scale, causal, dim3(), static_cast<cudaStream_t>(stream)};
  return run(0, a, bh, dtype);
}

extern "C" int mxt_flash_attention_bwd_dkv(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dk, void* dv, int bh, int s,
                                           int d, float sm_scale, int causal,
                                           int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, dk, dv, s, d, sm_scale,
         causal, dim3(), static_cast<cudaStream_t>(stream)};
  return run(1, a, bh, dtype);
}

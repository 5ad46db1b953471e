// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// mxnet_tpu/ops/pallas_kernels.py (launched by `_fwd` through
// `pl.pallas_call`). For each (batch*head, q-tile) it computes
//     out = softmax(q k^T * sm_scale [+ causal mask]) v
//     lse = m + log(max(l, 1e-30))            (fp32, one per query row)
// with an online softmax over k-tiles, accumulating in fp32 and writing
// `out` in the input dtype. `lse` is what the backward kernels need.
//
// Layout: q, k, v, out are contiguous (bh, s, d); lse is (bh, s) fp32.
// Head dims: d % 8 == 0 and 8 <= d <= 128. Any s >= 1.
//
// Design, 16-bit inputs (bf16 and fp16, one template), on wgmma_sm90.cuh
// as the backward's dq kernel. A CTA is NWG consumer warpgroups of 64 query
// rows each and one producer warpgroup, whose registers go to the consumers
// (setmaxnreg). It is persistent: one CTA per SM walks the (head, q-tile)
// items, the longest first under causal, so that one item's loads and store
// overlap another's arithmetic (one CTA per item measured slower,
// PERF.md). q, k, v and out are 3-D TMA maps (d, s, bh) with 128-byte
// swizzle: d is padded to 64 or 128 and the rows past s to the tile by the
// copy's zero fill, inside each head, with no padded copy. In the producer
// warpgroup one thread loads each item's Q tile into one of two Q buffers
// and streams K and V through a 2-stage mbarrier ring of 128-key tiles that
// runs ahead across items; with causal=True the k-tiles wholly above the
// diagonal are not loaded (`num_kb_eff` in the TPU kernel), and a
// warpgroup skips a loaded tile that lies wholly above its own rows.
// Another thread stores each item's output. Per k-tile each consumer
// warpgroup computes S = Q K^T with both operands from shared memory
// (K-major), the online softmax in the accumulator registers, and
// O += P V with P rounded to 16 bits as the register A operand and V read
// MN-major through the transpose bit: no transposed copy of V. The running
// max is kept on the raw scores and sm_scale * log2 e is folded into one
// FMA before ex2.approx (a negative sm_scale negates the scores first);
// only a tile that touches the ragged end of s or the diagonal evaluates the
// mask. The row sum l is taken over the unrounded fp32 p. At the end O / l
// is rounded to the input dtype into the warpgroup's rows of its Q buffer
// and the storer writes it with a TMA store, which never writes past s or
// d. The q-tile per CTA: 128 rows (NWG = 2) where bh * ceil(s / 128) items
// fill every SM, else 64 rows (NWG = 1), so that a small request (bh = 48,
// s = 128) still spreads over 96 SMs (`q_rows`;
// mxt_flash_attention_fwd_q_tile reports it, cuda_kernels.flash_fwd_q_tile
// mirrors it).
// fp32 inputs run an FMA kernel that scales q in fp32 first, as the TPU
// kernel does, and keeps full fp32 precision throughout.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
// bytes = 4 * bh*s*d * 2 (q, k, v read once, out written once) + 4 * bh*s
// (lse); operations = 4 * bh*s*s*d (two products; about half with causal).
//   bh=48, s=128, d=64 (the 4 x 128 BERT-base request): 3.17 MB and
//     0.20 GFLOP -> 0.95 us of memory time against 0.20 us of tensor-core
//     time: memory- and launch-bound at about 1 us.
//   bh=96, s=512, d=64 (the 8 x 512 request): 25.4 MB and 6.44 GFLOP ->
//     7.6 us of memory time against 6.5 us of tensor-core time: a bound of
//     about 7.6 us, close to balanced. There, as in the backward, the
//     softmax arithmetic between a tile's two products sets the pace
//     (PERF.md): one exp per score, on the special-function unit, whose 16
//     a clock per SM take about 6.5 us for the 25 M exps. Issuing the next
//     tile's S with this tile's P V, to run the softmax under the P V,
//     measured no faster and is not done.
//   bh=384, s=128, d=64 (the train step's (32, 128)): 25.4 MB, 1.6 GFLOP:
//     bound by bytes, 7.6 us.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using mxt::kFull;
using mxt::kLn2;
using mxt::kLog2e;
using mxt::Mma;
using namespace mxt::sm90;

constexpr int BM = 64;    // query rows per fp32 CTA
constexpr int BN = 64;    // keys per fp32 k-tile
constexpr int NT = 128;   // threads per fp32 CTA

// Number of k-tiles of bn keys a q-tile of bm rows starting at q0 reads.
__device__ __forceinline__ int num_k_tiles(int s, int q0, int bm, int bn,
                                           int causal) {
  int n = (s + bn - 1) / bn;
  if (causal) n = min(n, (q0 + bm - 1) / bn + 1);
  return n;
}

// ---------------------------------------------------------------------------
// 16-bit inputs: TMA ring + wgmma
// ---------------------------------------------------------------------------

constexpr int WG = 128;   // threads of a warpgroup
constexpr int KT = 128;   // keys per k-tile
constexpr int RB = 128;   // bytes of a 64-column 16-bit tile row
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Shared memory of fwd_wgmma, in bytes from a 1024-byte boundary: two Q
// tiles (BM rows, NC 64-column chunks each; warpgroup w's rows at 64 w of
// each chunk, later its output), then NST stages of (K, V) (KT rows), then
// the barriers full[NST], empty[NST], qfull[2], ofull[2], qfree[2].
template <int NWG, int HDP>
struct FwdSmem {
  static constexpr int BM = 64 * NWG, NC = HDP / 64;
  static constexpr int NST = 2;   // stages of the K/V ring
  static constexpr int TQ = BM * HDP * 2, TK = KT * HDP * 2;
  static constexpr int Q = 0, KV = 2 * TQ;
  static constexpr int BAR = KV + NST * 2 * TK;
  static constexpr int BYTES = BAR + (2 * NST + 6) * 8 + 1024;
};

// Work item t of n_qt q-tiles per head: head t % bh, q-tiles from the last
// (the longest under causal) to the first.
struct Item {
  int bh, q0;
  __device__ __forceinline__ Item(int t, int nbh, int n_qt, int bm)
      : bh(t % nbh), q0((n_qt - 1 - t / nbh) * bm) {}
};

template <typename T, int NWG, int HDP>
__global__ void __launch_bounds__((NWG + 1) * WG, 1)
fwd_wgmma(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
          int nbh, int s, float scale_log2, int negate, int causal) {
  using L = FwdSmem<NWG, HDP>;
  constexpr int BMC = L::BM, NC = L::NC, NST = L::NST;
  constexpr int CONSUMERS = NWG * WG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* empty = full + NST;
  uint64_t* qfull = empty + NST;   // Q tile b has arrived
  uint64_t* ofull = qfull + 2;     // ... holds the output
  uint64_t* qfree = ofull + 2;     // ... has been read by its store
  const int n_qt = (s + BMC - 1) / BMC, items = nbh * n_qt;

  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMERS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&ofull[b], CONSUMERS);
      mbar_init(&qfree[b], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == NWG) {
    if constexpr (NWG > 1) reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      // loads: each item's Q tile into Q buffer li % 2 once that buffer's
      // last store has read it, then its k-tiles through the ring, which
      // runs ahead across items
      int it = 0;
      for (int t = blockIdx.x, li = 0; t < items; t += gridDim.x, ++li) {
        const Item w(t, nbh, n_qt, BMC);
        const int b = li & 1;
        unsigned char* qb = sm + L::Q + b * L::TQ;
        mbar_wait(&qfree[b], ((li >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&qfull[b], L::TQ);
#pragma unroll
        for (int g = 0; g < NWG; ++g)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_3d(qb + c * BMC * RB + g * 64 * RB, &tq, &qfull[b],
                        64 * c, w.q0 + 64 * g, w.bh);
        const int n_kt = num_k_tiles(s, w.q0, BMC, KT, causal);
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int st = it % NST;
          unsigned char* kb = sm + L::KV + st * 2 * L::TK;
          mbar_wait(&empty[st], ((it / NST) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], 2 * L::TK);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            tma_load_3d(kb + c * KT * RB, &tk, &full[st], 64 * c, kt * KT,
                        w.bh);
            tma_load_3d(kb + L::TK + c * KT * RB, &tv, &full[st], 64 * c,
                        kt * KT, w.bh);
          }
        }
      }
    } else if (threadIdx.x == CONSUMERS + 32) {
      // stores: each item's output from its Q buffer, then the buffer is
      // free again
      for (int t = blockIdx.x, li = 0; t < items; t += gridDim.x, ++li) {
        const Item w(t, nbh, n_qt, BMC);
        const int b = li & 1;
        unsigned char* qb = sm + L::Q + b * L::TQ;
        mbar_wait(&ofull[b], (li >> 1) & 1);
#pragma unroll
        for (int g = 0; g < NWG; ++g)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_store_3d(&to, qb + c * BMC * RB + g * 64 * RB, 64 * c,
                         w.q0 + 64 * g, w.bh);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(&qfree[b]);
      }
    }
  } else {
    if constexpr (NWG > 1) reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c4 = lane % 4;
    const int rl = warp * 16 + g;   // rows rl and rl + 8 of the slab
    float acc[NC][32], sc[KT / 2];
    int it = 0;
    for (int t = blockIdx.x, li = 0; t < items; t += gridDim.x, ++li) {
      const Item w(t, nbh, n_qt, BMC);
      const int qw = w.q0 + wg * 64;   // this warpgroup's first row
      const int rw = qw + warp * 16;   // this warp's first row
      const int n_kt = num_k_tiles(s, w.q0, BMC, KT, causal);
      // k-tiles these rows read: with causal, none wholly above their
      // diagonal
      const int n_w = causal ? min(n_kt, (qw + 63) / KT + 1) : n_kt;
      const int b = li & 1;
      unsigned char* qa = sm + L::Q + b * L::TQ + wg * 64 * RB;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
      // per row: running max of the raw scores (-inf: no key yet), and
      // this thread's part of the row sum
      float mr[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      mbar_wait(&qfull[b], (li >> 1) & 1);
      for (int kt = 0; kt < n_kt; ++kt, ++it) {
        const int st = it % NST, k0 = kt * KT;
        const unsigned char* kb = sm + L::KV + st * 2 * L::TK;
        const unsigned char* vb = kb + L::TK;
        mbar_wait(&full[st], (it / NST) & 1);
        if (kt >= n_w) {   // loaded for the other warpgroup's rows
          mbar_arrive(&empty[st]);
          continue;
        }

        // S = Q K^T
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const int co = kk / 4, o = (kk % 4) * 32;
          wgmma_ss<0>(Op<T>(), sc, desc_k_major(qa + co * BMC * RB + o),
                      desc_k_major(kb + co * KT * RB + o), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (negate) {
#pragma unroll
          for (int i = 0; i < KT / 2; ++i) sc[i] = -sc[i];
        }

        // online softmax on the raw scores; only a tile on the ragged edge
        // or the diagonal needs the mask
        auto softmax = [&](auto masked) {
          auto keep = [&](int j, int e) {
            const int key = k0 + 8 * j + 2 * c4 + (e & 1);
            return key < s && !(causal && key > rw + g + 8 * (e >> 1));
          };
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!decltype(masked)::value || keep(j, e))
                mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
          float ms[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
            const float mn = fmaxf(mr[i], mx[i]);
            ms[i] = mn == -INFINITY ? 0.f : mn * scale_log2;
            const float alpha = mr[i] == -INFINITY
                                    ? 0.f
                                    : fast_exp2(mr[i] * scale_log2 - ms[i]);
            mr[i] = mn;
            l[i] *= alpha;
#pragma unroll
            for (int c = 0; c < NC; ++c)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                acc[c][4 * j + 2 * i] *= alpha;
                acc[c][4 * j + 2 * i + 1] *= alpha;
              }
          }
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p =
                  fast_exp2(fmaf(sc[4 * j + e], scale_log2, -ms[e >> 1]));
              if (decltype(masked)::value && !keep(j, e)) p = 0.f;
              sc[4 * j + e] = p;
              l[e >> 1] += p;
            }
        };
        if (k0 + KT > s || (causal && k0 + KT - 1 > rw))
          softmax(std::true_type());
        else
          softmax(std::false_type());
        uint32_t a[KT / 16][4];
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          mxt::pack_a<T>(a[kk], &sc[8 * kk], &sc[8 * kk + 4]);

        // O += P V
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            wgmma_rs<1>(Op<T>(), acc[c], a[kk],
                        desc_mn_major(vb + c * KT * RB + kk * 16 * RB), 1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
        mbar_arrive(&empty[st]);
      }

      // out = O / l, rounded, into this warpgroup's slab of the Q tile (its
      // last reader was this warpgroup's last S product) for the storer;
      // lse per row
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(kFull, l[i], 1);
        l[i] += __shfl_xor_sync(kFull, l[i], 2);
        const float li2 = fmaxf(l[i], 1e-30f);
        inv[i] = 1.f / li2;
        const int row = rw + g + 8 * i;
        if (c4 == 0 && row < s) {
          const float ms = mr[i] == -INFINITY ? 0.f : mr[i] * scale_log2;
          lse[(size_t)w.bh * s + row] = ms * kLn2 + logf(li2);
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = rl + 8 * i;
            *reinterpret_cast<uint32_t*>(qa + c * BMC * RB + r * RB +
                                         ((j ^ (r % 8)) * 16) + 4 * c4) =
                Mma<T>::pack(acc[c][4 * j + 2 * i] * inv[i],
                             acc[c][4 * j + 2 * i + 1] * inv[i]);
          }
      fence_proxy_async();
      mbar_arrive(&ofull[b]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: FMA on the CUDA cores, full fp32 precision
// ---------------------------------------------------------------------------
//
// Thread t owns query row t / 2 of the tile; the pair (h = t % 2) splits the
// keys (2j + h) and the output columns (2c + h) between its two threads.
// Shared-memory rows are padded to an odd stride, so the 16 rows a warp
// reads at once fall in distinct banks.

template <int HDP>
__global__ void __launch_bounds__(NT)
fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ out,
         float* __restrict__ lse, int s, int d, float sm_scale, int causal) {
  constexpr int ST = HDP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * ST;
  float* Vs = Ks + BN * ST;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int tid = threadIdx.x, r = tid >> 1, h = tid & 1;
  const int row = q0 + r;
  const size_t base = (size_t)bh * s * d;

  for (int i = tid; i < BM * HDP; i += NT) {
    const int rr = i / HDP, cc = i % HDP, qr = q0 + rr;
    Qs[rr * ST + cc] =
        (qr < s && cc < d) ? q[base + (size_t)qr * d + cc] * sm_scale : 0.f;
  }

  float o[HDP / 2];
#pragma unroll
  for (int c = 0; c < HDP / 2; ++c) o[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_kt = num_k_tiles(s, q0, BM, BN, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    for (int i = tid; i < BN * HDP; i += NT) {
      const int rr = i / HDP, cc = i % HDP, key = k0 + rr;
      const bool ok = key < s && cc < d;
      const size_t off = base + (size_t)key * d + cc;
      Ks[rr * ST + cc] = ok ? k[off] : 0.f;
      Vs[rr * ST + cc] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    float sc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sc[j] = 0.f;
    for (int c = 0; c < HDP; ++c) {
      const float qv = Qs[r * ST + c];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) sc[j] += qv * Ks[(2 * j + h) * ST + c];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int key = k0 + 2 * j + h;
      float x = sc[j] * kLog2e;
      if (key >= s || (causal && key > row)) x = -INFINITY;
      sc[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float mn = fmaxf(m, mx);
    const float sub = (mn == -INFINITY) ? 0.f : mn;
    const float alpha = exp2f(m - sub);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < HDP / 2; ++c) o[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      sc[j] = exp2f(sc[j] - sub);
      l += sc[j];
    }
#pragma unroll 4
    for (int j = 0; j < BN / 2; ++j) {
      const float pm = sc[j];                              // key 2j + h
      const float po = __shfl_xor_sync(kFull, sc[j], 1);   // key 2j + 1 - h
      const float* vm = Vs + (2 * j + h) * ST + h;
      const float* vo = Vs + (2 * j + 1 - h) * ST + h;
#pragma unroll
      for (int c = 0; c < HDP / 2; ++c)
        o[c] += pm * vm[2 * c] + po * vo[2 * c];
    }
  }

  l += __shfl_xor_sync(kFull, l, 1);
  const float li = fmaxf(l, 1e-30f);
  if (row < s) {
    const float inv = 1.f / li;
    float* orow = out + base + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < HDP / 2; ++c)
      if (2 * c + h < d) orow[2 * c + h] = o[c] * inv;
    if (h == 0) lse[(size_t)bh * s + row] = m * kLn2 + logf(li);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int bh, s, d;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

// Query rows per CTA of the 16-bit kernel: 128 (two consumer warpgroups)
// where bh * ceil(s / 128) such CTAs fill every SM of the card, else 64.
int q_rows(int bh, int s, int sms) {
  return (long long)bh * ((s + 127) / 128) >= sms ? 128 : 64;
}

// SMs of the current device, or a negative cudaError_t.
int sm_count() {
  int dev = 0, n = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? n : -(int)err;
}

// One CTA per SM (or per item where there are fewer), each walking the
// items t = blockIdx.x + i * gridDim.x.
template <typename T, int NWG, int HDP>
cudaError_t launch_wgmma(const Args& a, int sms) {
  using L = FwdSmem<NWG, HDP>;
  const CUtensorMapDataType ty = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap m[4];
  const void* const src[4] = {a.q, a.k, a.v, a.out};
  const int rows[4] = {64, KT, KT, 64};
  for (int i = 0; i < 4; ++i) {
    cudaError_t err =
        encode_rows_map(&m[i], src[i], a.bh, a.s, a.d, rows[i], ty);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fwd_wgmma<T, NWG, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return err;
  const long long items = (long long)a.bh * ((a.s + L::BM - 1) / L::BM);
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  fwd_wgmma<T, NWG, HDP><<<grid, (NWG + 1) * WG, L::BYTES, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.bh, a.s, fabsf(a.sm_scale) * kLog2e,
      a.sm_scale < 0.f, a.causal);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_16bit(const Args& a, int sms) {
  if (q_rows(a.bh, a.s, sms) == 128)
    return a.d <= 64 ? launch_wgmma<T, 2, 64>(a, sms)
                     : launch_wgmma<T, 2, 128>(a, sms);
  return a.d <= 64 ? launch_wgmma<T, 1, 64>(a, sms)
                   : launch_wgmma<T, 1, 128>(a, sms);
}

template <int HDP>
cudaError_t launch_fp32(const Args& a) {
  const int bytes = (BM + 2 * BN) * (HDP + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_fp32<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  fwd_fp32<HDP><<<dim3(a.bh, (a.s + BM - 1) / BM), NT, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.s,
      a.d, a.sm_scale, a.causal);
  return cudaSuccess;
}

bool bad_args(int bh, int s, int d, int dtype) {
  return bh <= 0 || s <= 0 || d < 8 || d > 128 || d % 8 != 0 || dtype < 0 ||
         dtype > 2 || (s + BM - 1) / BM > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take (or a TMA map
// the driver refuses), else the first error of the launch, else
// cudaGetLastError() right after it.
extern "C" int mxt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int bh, int s, int d, float sm_scale,
                                       int causal, int dtype, void* stream) {
  if (bad_args(bh, s, d, dtype)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, static_cast<float*>(lse), bh, s, d, sm_scale,
               causal, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0) {
    if (d <= 16)
      err = launch_fp32<16>(a);
    else if (d <= 32)
      err = launch_fp32<32>(a);
    else if (d <= 64)
      err = launch_fp32<64>(a);
    else
      err = launch_fp32<128>(a);
  } else {
    const int sms = sm_count();
    if (sms < 0) return -sms;
    err = dtype == 1 ? launch_16bit<__half>(a, sms)
                     : launch_16bit<__nv_bfloat16>(a, sms);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Query rows per CTA that mxt_flash_attention_fwd takes for these arguments
// on the current device (64 for float32), or minus a cudaError_t.
extern "C" int mxt_flash_attention_fwd_q_tile(int bh, int s, int d,
                                              int dtype) {
  if (bad_args(bh, s, d, dtype)) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return BM;
  const int sms = sm_count();
  return sms < 0 ? sms : q_rows(bh, s, sms);
}

// Dynamic shared memory, in bytes, of the 16-bit kernel with `rows` query
// rows per CTA (64 or 128) for head dims up to hdp (64 or 128).
extern "C" int mxt_flash_attention_fwd_smem(int rows, int hdp) {
  if (rows == 128) return hdp <= 64 ? FwdSmem<2, 64>::BYTES
                                    : FwdSmem<2, 128>::BYTES;
  return hdp <= 64 ? FwdSmem<1, 64>::BYTES : FwdSmem<1, 128>::BYTES;
}

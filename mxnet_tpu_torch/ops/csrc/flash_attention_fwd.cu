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
// Head dims: d % 8 == 0 and 8 <= d <= 128 (rows are read as 16-byte
// vectors; the head dim is padded to 16/32/64/128 with zeros in registers
// and shared memory). Any s >= 1: the ragged last q- and k-tile are masked.
//
// Design: one CTA of 4 warps per (bh, 64-row q-tile); the k-loop runs
// inside the CTA. K and V stream through shared memory in 64-key tiles
// (V stored transposed, so both operands of both products are read as
// 32-bit pairs), instead of keeping the whole K/V row resident as the TPU
// BlockSpec (1, s, d) does. With causal=True, k-tiles wholly above the
// diagonal are never loaded. 16-bit inputs run both products on the
// tensor cores with mma.sync m16n8k16 (fp32 accumulate): each warp owns
// 16 query rows, keeps its Q fragments and output accumulator in
// registers, and re-packs the probabilities of q k^T straight into the A
// operand of p v. There sm_scale multiplies the fp32 scores rather than q:
// rounding q * sm_scale back to 16 bits would lose precision that the TPU
// kernel (which scales q in fp32) keeps. fp32 inputs run an FMA kernel
// that scales q in fp32 first, as the TPU kernel does, and keeps full fp32
// precision throughout.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
// bytes = 4 * bh*s*d * 2 (q, k, v read once, out written once) + 4 * bh*s
// (lse); operations = 4 * bh*s*s*d (two products; about half with causal).
//   bh=48, s=128, d=64 (the 4 x 128 BERT-base request): 3.17 MB and
//     0.20 GFLOP -> 0.95 us of memory time against 0.20 us of tensor-core
//     time: memory- and launch-bound at about 1 us.
//   bh=96, s=512, d=64 (the 8 x 512 request): 25.4 MB and 6.44 GFLOP ->
//     7.6 us of memory time against 6.5 us of tensor-core time: a bound of
//     about 7.6 us, close to balanced.
// This first version is plain: synchronous tile loads, no cp.async/TMA,
// no wgmma, so it is expected to sit well above those bounds.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // query rows per CTA (16 per warp)
constexpr int BN = 64;    // keys per k-tile
constexpr int NT = 128;   // threads per CTA
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Two consecutive 16-bit elements of row `row`, columns col and col + 1
// (col even, d % 8 == 0, so both lie inside or both outside the row).
template <typename T>
__device__ __forceinline__ uint32_t load_pair(const T* p, int row, int col,
                                              int s, int d) {
  if (row >= s || col >= d) return 0u;
  return *reinterpret_cast<const uint32_t*>(p + (size_t)row * d + col);
}

// Number of k-tiles a q-tile starting at q0 reads.
__device__ __forceinline__ int num_k_tiles(int s, int q0, int causal) {
  int n = (s + BN - 1) / BN;
  if (causal) n = min(n, (q0 + BM - 1) / BN + 1);
  return n;
}

// ---------------------------------------------------------------------------
// 16-bit inputs: tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

template <typename T, int HDP>
__global__ void __launch_bounds__(NT)
fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, T* __restrict__ out,
        float* __restrict__ lse, int s, int d, float scale_log2,
        int causal) {
  constexpr int KS = HDP + 8;  // K tile row stride: conflict-free pair reads
  constexpr int VS = BN + 8;   // transposed V tile row stride
  constexpr int CH = HDP / 8;  // 16-byte chunks per padded row
  __shared__ __align__(16) uint16_t ks_raw[BN * KS];
  __shared__ __align__(16) uint16_t vt_raw[HDP * VS];
  T* Ks = reinterpret_cast<T*>(ks_raw);
  T* Vt = reinterpret_cast<T*>(vt_raw);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest causal first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const size_t base = (size_t)bh * s * d;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;

  uint32_t qf[HDP / 16][4];  // A fragments of this warp's 16 x HDP q rows
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int c = kk * 16 + c2;
    qf[kk][0] = load_pair(qb, r0, c, s, d);
    qf[kk][1] = load_pair(qb, r1, c, s, d);
    qf[kk][2] = load_pair(qb, r0, c + 8, s, d);
    qf[kk][3] = load_pair(qb, r1, c + 8, s, d);
  }

  float o[HDP / 8][4];
#pragma unroll
  for (int dt = 0; dt < HDP / 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum

  const int n_kt = num_k_tiles(s, q0, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < BN * CH; i += NT) {
      const int row = i / CH, col = (i % CH) * 8, key = k0 + row;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < s && col < d) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)key * d + col);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)key * d + col);
      }
      *reinterpret_cast<uint4*>(&Ks[row * KS + col]) = kv;
      const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(col + e) * VS + row] = ve[e];
    }
    __syncthreads();

    // scores: sc[nt] holds rows (r0, r0+8) x keys k0 + nt*8 + c2 + {0, 1}
    float sc[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const T* kr = &Ks[(nt * 8 + g) * KS + c2];
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        Mma<T>::run(sc[nt], qf[kk], b0, b1);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + c2 + (e & 1);
        const int row = (e < 2) ? r0 : r1;
        float x = sc[nt][e] * scale_log2;
        if (key >= s || (causal && key > row)) x = -INFINITY;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float sub[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      sub[i] = (mn == -INFINITY) ? 0.f : mn;  // a row with nothing seen yet
      const float alpha = exp2f(m[i] - sub[i]);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int dt = 0; dt < HDP / 8; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[nt][e] - sub[e >> 1]);
        sc[nt][e] = p;
        l[e >> 1] += p;
      }
    }

    // out += p v: the C fragments of two score n-tiles form one A fragment
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = Mma<T>::pack(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = Mma<T>::pack(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = Mma<T>::pack(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = Mma<T>::pack(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < HDP / 8; ++dt) {
        const T* vr = &Vt[(dt * 8 + g) * VS + kk * 16 + c2];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vr + 8);
        Mma<T>::run(o[dt], a, b0, b1);
      }
    }
  }

  float inv[2], lrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const float li = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / li;
    lrow[i] = m[i] * kLn2 + logf(li);
  }
  T* ob = out + base;
#pragma unroll
  for (int dt = 0; dt < HDP / 8; ++dt) {
    const int col = dt * 8 + c2;
    if (col < d) {
      if (r0 < s)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * d + col) =
            Mma<T>::pack(o[dt][0] * inv[0], o[dt][1] * inv[0]);
      if (r1 < s)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * d + col) =
            Mma<T>::pack(o[dt][2] * inv[1], o[dt][3] * inv[1]);
    }
  }
  if ((lane & 3) == 0) {
    if (r0 < s) lse[(size_t)bh * s + r0] = lrow[0];
    if (r1 < s) lse[(size_t)bh * s + r1] = lrow[1];
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

  const int n_kt = num_k_tiles(s, q0, causal);
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

template <typename T, int HDP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       float* lse, dim3 grid, int s, int d, float sm_scale,
                       int causal, cudaStream_t stream) {
  fwd_mma<T, HDP><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, s, d,
      sm_scale * kLog2e, causal);
  return cudaSuccess;
}

template <int HDP>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        void* out, float* lse, dim3 grid, int s, int d,
                        float sm_scale, int causal, cudaStream_t stream) {
  const int bytes = (BM + 2 * BN) * (HDP + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_fp32<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  fwd_fp32<HDP><<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s, d,
      sm_scale, causal);
  return cudaSuccess;
}

template <int HDP>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* out, float* lse, dim3 grid, int s, int d,
                   float sm_scale, int causal, cudaStream_t stream) {
  if (dtype == 0)
    return launch_fp32<HDP>(q, k, v, out, lse, grid, s, d, sm_scale, causal,
                            stream);
  if (dtype == 1)
    return launch_mma<__half, HDP>(q, k, v, out, lse, grid, s, d, sm_scale,
                                   causal, stream);
  return launch_mma<__nv_bfloat16, HDP>(q, k, v, out, lse, grid, s, d,
                                        sm_scale, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take, else the
// first error of the launch, else cudaGetLastError() right after it.
extern "C" int mxt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int bh, int s, int d, float sm_scale,
                                       int causal, int dtype, void* stream) {
  if (bh <= 0 || s <= 0 || d < 8 || d > 128 || d % 8 != 0 || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int tiles = (s + BM - 1) / BM;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(bh, tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (d <= 16)
    err = launch<16>(dtype, q, k, v, out, l, grid, s, d, sm_scale, causal, st);
  else if (d <= 32)
    err = launch<32>(dtype, q, k, v, out, l, grid, s, d, sm_scale, causal, st);
  else if (d <= 64)
    err = launch<64>(dtype, q, k, v, out, l, grid, s, d, sm_scale, causal, st);
  else
    err = launch<128>(dtype, q, k, v, out, l, grid, s, d, sm_scale, causal,
                      st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

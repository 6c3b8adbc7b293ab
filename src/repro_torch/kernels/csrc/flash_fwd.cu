// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash.py (_flash_fwd_kernel,
// flash_attention_fwd): o = softmax(q k^T / sqrt(hd), masked) v over
// (BH, S, hd) with the heads already expanded, the causal mask qpos >= kpos
// counted from 0 (top-left aligned), masked scores at -1e30, f32 math, o in
// q's dtype. It also writes lse = m + log(l) (f32), which the backward needs.
//
// Bound on an H100: operations where S is long. At the serving path's
// shape (BH, S, hd) = (768, 1024, 112) in bf16 the causal work is ~180
// GFLOP against 0.70 GB of q/k/v/o; this kernel runs the products as
// FP32 FFMA (67 TFLOP/s, not the tensor cores), so its floor is ~2.7 ms.
// A wgmma/TMA version is later work.
//
// Design. The TPU kernel keeps one q block's running max, denominator and
// f32 accumulator in VMEM scratch while a sequential grid axis streams kv
// blocks. Here one block of 256 threads owns a 64-row q tile of one (b, h)
// and loops over 64-row kv tiles itself, so m, l and the accumulator stay in
// registers for the whole sweep. Each thread owns 4 q rows: a 4 x 4 tile of
// the scores (k-major panels of q and k in shared memory, read as float4)
// and 4 x HDP/16 columns of the output. A row's max and sum are reduced
// over the 16 threads that share it with xor shuffles. The probabilities go
// through shared memory (kv-major) into P V. hd may be any size up to 256
// (zamba2's is 112): the q and k panels are hd rows deep, V is padded to
// HDP (64, 128 or 256) columns with zeros, and nothing is padded in device
// memory. Causal q tiles skip the kv tiles past their last row (those would
// leave m, l and the accumulator unchanged) and run heaviest-first. Inputs
// are f32 or bf16, converted on load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BKV = 64;       // kv rows per step
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3
constexpr int PAD = 4;        // keeps rows 16-byte aligned, spreads banks
constexpr int QS = BQ + PAD;  // row stride of the q panel and of P
constexpr int KS = BKV + PAD; // row stride of the k panel
constexpr float NEG_INF = -1e30f;

static_assert((BQ / 4) * (BKV / 4) == THREADS, "one 4 x 4 score tile each");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ constexpr int v_stride(int hdp) { return hdp + PAD; }

size_t smem_bytes(int hd, int hdp) {
  return sizeof(float) * (static_cast<size_t>(hd) * QS +
                          static_cast<size_t>(hd) * KS +
                          static_cast<size_t>(BKV) * v_stride(hdp) +
                          static_cast<size_t>(BKV) * QS);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, (HDP <= 128 ? 2 : 1))
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int skv, int hd,
                     int causal, float scale) {
  constexpr int VS = v_stride(HDP);
  constexpr int OC = HDP / 64;  // float4 column groups of the output
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [hd][QS]  q panel, k-major
  float* Ks = Qs + hd * QS;      // [hd][KS]  k panel, k-major
  float* Vs = Ks + hd * KS;      // [BKV][VS] v tile, row-major, zero-padded
  float* Ps = Vs + BKV * VS;     // [BKV][QS] probabilities, kv-major

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = (sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * sq * hd;
  const T* kb = k + bh * skv * hd;
  const T* vb = v + bh * skv * hd;

  for (int idx = tid; idx < BQ * hd; idx += THREADS) {
    const int r = idx / hd, d = idx - r * hd;
    const int gr = q0 + r;
    Qs[d * QS + r] = gr < sq ? to_f32(qb[static_cast<size_t>(gr) * hd + d])
                             : 0.f;
  }
  for (int idx = tid; idx < BKV * (HDP - hd); idx += THREADS) {
    const int c = idx / (HDP - hd);
    Vs[c * VS + hd + (idx - c * (HDP - hd))] = 0.f;
  }

  float m[4], l[4], acc[4][OC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OC * 4; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous step is done with Ks, Vs and Ps
    for (int idx = tid; idx < BKV * hd; idx += THREADS) {
      const int c = idx / hd, d = idx - c * hd;
      const int gc = k0 + c;
      const bool in = gc < skv;
      const size_t off = static_cast<size_t>(gc) * hd + d;
      Ks[d * KS + c] = in ? to_f32(kb[off]) : 0.f;
      Vs[c * VS + d] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * QS + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Ks[d * KS + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool keep = kpos < skv && (!causal || qpos >= kpos);
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(tx * 4 + j) * QS + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OC * 4; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BKV; ++c) {
      const float4 pp = *reinterpret_cast<const float4*>(&Ps[c * QS + ty * 4]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int g = 0; g < OC; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[c * VS + g * 64 + tx * 4]);
        const float vvv[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(pv[i], vvv[e], acc[i][g * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * sq + r) * hd;
#pragma unroll
    for (int g = 0; g < OC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tx * 4 + e;
        if (col < hd) store(&orow[col], acc[i][g * 4 + e] / den);
      }
    if (tx == 0)
      lse[bh * sq + r] = l[i] > 0.f ? m[i] + logf(den) : NEG_INF;
  }
}

template <typename T, int HDP>
int launch_hdp(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int sq, int skv, int hd, int causal,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(hd, HDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, HDP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, skv, hd, causal, 1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int sq, int skv, int hd, int causal, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_hdp<T, 64>(q, k, v, o, lse, bh, sq, skv, hd, causal, s);
  if (hd <= 128) return launch_hdp<T, 128>(q, k, v, o, lse, bh, sq, skv, hd, causal, s);
  if (hd <= 256) return launch_hdp<T, 256>(q, k, v, o, lse, bh, sq, skv, hd, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface, loaded with ctypes. q, k, v, o: device pointers of
// contiguous (bh, s, hd) tensors (o in the inputs' type); lse: (bh, sq) f32.
// Returns the cudaError_t of the launch.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int sq, int skv,
                             int hd, int causal, int device, void* stream) {
  return launch<float>(q, k, v, o, lse, bh, sq, skv, hd, causal, device,
                       stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int sq, int skv,
                              int hd, int causal, int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, bh, sq, skv, hd, causal,
                               device, stream);
}

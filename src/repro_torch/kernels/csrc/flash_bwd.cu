// Flash-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/flash.py (_flash_bwd_dq_kernel,
// _flash_bwd_dkv_kernel, flash_attention_bwd): given q, k, v, the forward's
// o and per-row logsumexp lse (from csrc/flash_fwd.cu), the output gradient
// do and dsum = rowsum(do * o) (one torch reduction in the wrapper, outside
// the kernel as in the reference), it recomputes P = exp(q k^T * scale -
// lse) under the forward's mask (top-left causal qpos >= kpos from 0,
// masked P = 0) and writes
//   dq = dS k,  dk = dS^T q,  dv = P^T do,  dS = P * (do v^T - dsum) * scale
// with f32 arithmetic and the gradients in the inputs' type.
//
// Bound on an H100: operations where S is long. At smollm-135m's training
// shape (BH, S, hd) = (144, 2048, 64) in bf16 the function needs five
// products over the causal (q, k) pairs (S, dP, dv, dq, dk), ~193 GFLOP,
// against ~0.30 GB of q/k/v/o/do/dq/dk/dv: ~0.2 ms at the bf16 tensor-core
// peak. These kernels run the products as FP32 FFMA (67 TFLOP/s), and both
// recompute S and dP (seven products, ~271 GFLOP), so their floor is ~4 ms.
// A wgmma/TMA version is later work.
//
// Design. The TPU kernels carry a (block, hd) f32 accumulator in VMEM
// scratch across a sequential grid axis. Here there are two kernels, each
// with a loop inside the block in place of that axis, and neither uses
// atomics, so the result is the same from run to run:
//   dq:   one block per (bh, BQ-row q tile), sweeping kv tiles up to the
//         diagonal (causal); the tile's dq stays in registers;
//   dk/dv: one block per (bh, BKV-row kv tile), sweeping q tiles from the
//         diagonal on; its dk and dv stay in registers.
// Both use 256 threads as 16 x 16: a thread owns R x C scores of the
// (rows x swept) tile (k-major panels of both operands in shared memory,
// read as float4/float2), so S and dP = do v^T come from the same loop over
// hd. The tile of P or dS goes through shared memory into the second
// product, against a row-major copy of the swept operand whose columns are
// zero-padded to HDP (64, 128 or 256); each thread owns 4 columns of every
// 64 there. hd may be any size up to 256 and S any length: ragged rows are
// masked in the kernel, nothing is padded in device memory. Tiles: dq 64 x
// 64 and dk/dv 64 kv rows x 32 q rows up to HDP 128; 32 x 32 for both at
// HDP 256, where the f32 panels of 64-row tiles outgrow the 227 KB of
// shared memory a block may have. Inputs are f32 or bf16, converted on load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int PAD = 4;        // keeps rows 16-byte aligned, spreads banks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// R consecutive floats of shared memory (R = 2 or 4, aligned to R floats)
template <int R>
__device__ __forceinline__ void lds(const float* p, float (&out)[R]) {
  if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    static_assert(R == 2, "2 or 4 rows a thread");
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

__device__ __forceinline__ void lds4(const float* p, float (&out)[4]) {
  lds<4>(p, out);
}

template <int HDP, int BQ, int BKV>
size_t dq_smem_floats(int hd) {
  return 2 * static_cast<size_t>(hd) * (BQ + PAD) +
         2 * static_cast<size_t>(hd) * (BKV + PAD) +
         static_cast<size_t>(BKV) * (HDP + PAD) +
         static_cast<size_t>(BKV) * (BQ + PAD);
}

template <int HDP, int BKV, int BQ>
size_t dkv_smem_floats(int hd) {
  return 2 * static_cast<size_t>(hd) * (BKV + PAD) +
         2 * static_cast<size_t>(hd) * (BQ + PAD) +
         2 * static_cast<size_t>(BQ) * (HDP + PAD) +
         static_cast<size_t>(BQ) * (BKV + PAD) + 2 * BQ;
}

// ---------------------------------------------------------------------------
// dq: rows are q, the sweep is over kv
// ---------------------------------------------------------------------------

template <typename T, int HDP, int BQ, int BKV>
__global__ void __launch_bounds__(THREADS, (HDP <= 64 ? 2 : 1))
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, T* __restrict__ dq,
                        int sq, int skv, int hd, int causal, float scale) {
  constexpr int RQ = BQ / 16, RK = BKV / 16;
  constexpr int QS = BQ + PAD, KS = BKV + PAD, RS = HDP + PAD;
  constexpr int OC = HDP / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [hd][QS]   q panel, k-major
  float* dOs = Qs + hd * QS;    // [hd][QS]   do panel, k-major
  float* Ks = dOs + hd * QS;    // [hd][KS]   k panel, k-major
  float* Vs = Ks + hd * KS;     // [hd][KS]   v panel, k-major
  float* Kr = Vs + hd * KS;     // [BKV][RS]  k tile, row-major, zero-padded
  float* dSs = Kr + BKV * RS;   // [BKV][QS]  dS, kv-major

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = (sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * sq * hd;
  const T* dob = dout + bh * sq * hd;
  const T* kb = k + bh * skv * hd;
  const T* vb = v + bh * skv * hd;

  for (int idx = tid; idx < BQ * hd; idx += THREADS) {
    const int r = idx / hd, d = idx - r * hd;
    const int gr = q0 + r;
    const bool in = gr < sq;
    const size_t off = static_cast<size_t>(gr) * hd + d;
    Qs[d * QS + r] = in ? to_f32(qb[off]) : 0.f;
    dOs[d * QS + r] = in ? to_f32(dob[off]) : 0.f;
  }
  for (int idx = tid; idx < BKV * (HDP - hd); idx += THREADS) {
    const int c = idx / (HDP - hd);
    Kr[c * RS + hd + (idx - c * (HDP - hd))] = 0.f;
  }
  float row_lse[RQ], row_dsum[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    row_lse[i] = r < sq ? lse[bh * sq + r] : 0.f;
    row_dsum[i] = r < sq ? dsum[bh * sq + r] : 0.f;
  }

  float acc[RQ][OC * 4];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < OC * 4; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous step is done with Ks, Vs, Kr and dSs
    for (int idx = tid; idx < BKV * hd; idx += THREADS) {
      const int c = idx / hd, d = idx - c * hd;
      const int gc = k0 + c;
      const bool in = gc < skv;
      const size_t off = static_cast<size_t>(gc) * hd + d;
      const float kv = in ? to_f32(kb[off]) : 0.f;
      Ks[d * KS + c] = kv;
      Kr[c * RS + d] = kv;
      Vs[d * KS + c] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float a[RQ], b[RK], a2[RQ], b2[RK];
      lds<RQ>(&Qs[d * QS + ty * RQ], a);
      lds<RK>(&Ks[d * KS + tx * RK], b);
      lds<RQ>(&dOs[d * QS + ty * RQ], a2);
      lds<RK>(&Vs[d * KS + tx * RK], b2);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty * RQ + i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = k0 + tx * RK + j;
        const bool keep =
            kpos < skv && qpos < sq && (!causal || qpos >= kpos);
        const float p = keep ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        dSs[(tx * RK + j) * QS + ty * RQ + i] =
            p * (dp[i][j] - row_dsum[i]) * scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < BKV; ++c) {
      float a[RQ];
      lds<RQ>(&dSs[c * QS + ty * RQ], a);
#pragma unroll
      for (int g = 0; g < OC; ++g) {
        float kk[4];
        lds4(&Kr[c * RS + g * 64 + tx * 4], kk);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(a[i], kk[e], acc[i][g * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    if (r >= sq) continue;
    T* row = dq + (bh * sq + r) * hd;
#pragma unroll
    for (int g = 0; g < OC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tx * 4 + e;
        if (col < hd) store(&row[col], acc[i][g * 4 + e]);
      }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: rows are kv, the sweep is over q
// ---------------------------------------------------------------------------

template <typename T, int HDP, int BKV, int BQ>
__global__ void __launch_bounds__(THREADS, (HDP <= 64 ? 2 : 1))
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int skv, int hd,
                         int causal, float scale) {
  constexpr int RK = BKV / 16, RQ = BQ / 16;
  constexpr int KS = BKV + PAD, QS = BQ + PAD, RS = HDP + PAD;
  constexpr int OC = HDP / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;             // [hd][KS]  k panel, k-major (the block's)
  float* Vs = Ks + hd * KS;     // [hd][KS]  v panel, k-major (the block's)
  float* Qs = Vs + hd * KS;     // [hd][QS]  q panel, k-major
  float* dOs = Qs + hd * QS;    // [hd][QS]  do panel, k-major
  float* Qr = dOs + hd * QS;    // [BQ][RS]  q tile, row-major, zero-padded
  float* dOr = Qr + BQ * RS;    // [BQ][RS]  do tile, row-major, zero-padded
  float* Ps = dOr + BQ * RS;    // [BQ][KS]  P, then dS, q-major
  float* Ls = Ps + BQ * KS;     // [BQ]      lse of the q tile
  float* Ds = Ls + BQ;          // [BQ]      dsum of the q tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = static_cast<int>(blockIdx.y) * BKV;
  const size_t bh = blockIdx.x;
  const T* qb = q + bh * sq * hd;
  const T* dob = dout + bh * sq * hd;
  const T* kb = k + bh * skv * hd;
  const T* vb = v + bh * skv * hd;

  for (int idx = tid; idx < BKV * hd; idx += THREADS) {
    const int c = idx / hd, d = idx - c * hd;
    const int gc = k0 + c;
    const bool in = gc < skv;
    const size_t off = static_cast<size_t>(gc) * hd + d;
    Ks[d * KS + c] = in ? to_f32(kb[off]) : 0.f;
    Vs[d * KS + c] = in ? to_f32(vb[off]) : 0.f;
  }
  for (int idx = tid; idx < BQ * (HDP - hd); idx += THREADS) {
    const int r = idx / (HDP - hd);
    const int col = hd + (idx - r * (HDP - hd));
    Qr[r * RS + col] = 0.f;
    dOr[r * RS + col] = 0.f;
  }

  float acc_k[RK][OC * 4], acc_v[RK][OC * 4];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < OC * 4; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // causal: q rows before k0 see none of this tile's keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < sq; q0 += BQ) {
    __syncthreads();  // the previous step is done with the q-side buffers
    for (int idx = tid; idx < BQ * hd; idx += THREADS) {
      const int r = idx / hd, d = idx - r * hd;
      const int gr = q0 + r;
      const bool in = gr < sq;
      const size_t off = static_cast<size_t>(gr) * hd + d;
      const float qv = in ? to_f32(qb[off]) : 0.f;
      const float dov = in ? to_f32(dob[off]) : 0.f;
      Qs[d * QS + r] = qv;
      Qr[r * RS + d] = qv;
      dOs[d * QS + r] = dov;
      dOr[r * RS + d] = dov;
    }
    for (int r = tid; r < BQ; r += THREADS) {
      const int gr = q0 + r;
      Ls[r] = gr < sq ? lse[bh * sq + gr] : 0.f;
      Ds[r] = gr < sq ? dsum[bh * sq + gr] : 0.f;
    }
    __syncthreads();

    float s[RK][RQ], dp[RK][RQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float a[RK], b[RQ], a2[RK], b2[RQ];
      lds<RK>(&Ks[d * KS + ty * RK], a);
      lds<RQ>(&Qs[d * QS + tx * RQ], b);
      lds<RK>(&Vs[d * KS + ty * RK], a2);
      lds<RQ>(&dOs[d * QS + tx * RQ], b2);
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
        }
    }

    float ds[RK][RQ];
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int kpos = k0 + ty * RK + i;
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const int r = tx * RQ + j;
        const int qpos = q0 + r;
        const bool keep =
            kpos < skv && qpos < sq && (!causal || qpos >= kpos);
        const float p = keep ? expf(s[i][j] * scale - Ls[r]) : 0.f;
        ds[i][j] = p * (dp[i][j] - Ds[r]) * scale;
        Ps[r * KS + ty * RK + i] = p;
      }
    }
    __syncthreads();

    for (int r = 0; r < BQ; ++r) {  // dv += P^T do
      float a[RK];
      lds<RK>(&Ps[r * KS + ty * RK], a);
#pragma unroll
      for (int g = 0; g < OC; ++g) {
        float dd[4];
        lds4(&dOr[r * RS + g * 64 + tx * 4], dd);
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc_v[i][g * 4 + e] = fmaf(a[i], dd[e], acc_v[i][g * 4 + e]);
      }
    }
    __syncthreads();  // everyone is done reading P
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j)
        Ps[(tx * RQ + j) * KS + ty * RK + i] = ds[i][j];
    __syncthreads();

    for (int r = 0; r < BQ; ++r) {  // dk += dS^T q
      float a[RK];
      lds<RK>(&Ps[r * KS + ty * RK], a);
#pragma unroll
      for (int g = 0; g < OC; ++g) {
        float qq[4];
        lds4(&Qr[r * RS + g * 64 + tx * 4], qq);
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc_k[i][g * 4 + e] = fmaf(a[i], qq[e], acc_k[i][g * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int c = k0 + ty * RK + i;
    if (c >= skv) continue;
    T* krow = dk + (bh * skv + c) * hd;
    T* vrow = dv + (bh * skv + c) * hd;
#pragma unroll
    for (int g = 0; g < OC; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tx * 4 + e;
        if (col < hd) {
          store(&krow[col], acc_k[i][g * 4 + e]);
          store(&vrow[col], acc_v[i][g * 4 + e]);
        }
      }
  }
}

template <typename T, int HDP, int BQ, int BKV, int DKV_BKV, int DKV_BQ>
int launch_hdp(const void* q, const void* k, const void* v, const void* o_grad,
               const void* lse, const void* dsum, void* dq, void* dk,
               void* dv, int bh, int sq, int skv, int hd, int causal,
               cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(o_grad);
  const float* lt = static_cast<const float*>(lse);
  const float* dt = static_cast<const float*>(dsum);

  const size_t smem_q = sizeof(float) * dq_smem_floats<HDP, BQ, BKV>(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HDP, BQ, BKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, HDP, BQ, BKV>
      <<<dim3(bh, (sq + BQ - 1) / BQ), THREADS, smem_q, stream>>>(
          qt, kt, vt, dot, lt, dt, static_cast<T*>(dq), sq, skv, hd, causal,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_kv =
      sizeof(float) * dkv_smem_floats<HDP, DKV_BKV, DKV_BQ>(hd);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HDP, DKV_BKV, DKV_BQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<T, HDP, DKV_BKV, DKV_BQ>
      <<<dim3(bh, (skv + DKV_BKV - 1) / DKV_BKV), THREADS, smem_kv, stream>>>(
          qt, kt, vt, dot, lt, dt, static_cast<T*>(dk), static_cast<T*>(dv),
          sq, skv, hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o_grad,
           const void* lse, const void* dsum, void* dq, void* dk, void* dv,
           int bh, int sq, int skv, int hd, int causal, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch_hdp<T, 64, 64, 64, 64, 32>(q, k, v, o_grad, lse, dsum, dq,
                                             dk, dv, bh, sq, skv, hd, causal,
                                             s);
  if (hd <= 128)
    return launch_hdp<T, 128, 64, 64, 64, 32>(q, k, v, o_grad, lse, dsum, dq,
                                              dk, dv, bh, sq, skv, hd, causal,
                                              s);
  if (hd <= 256)
    return launch_hdp<T, 256, 32, 32, 32, 32>(q, k, v, o_grad, lse, dsum, dq,
                                              dk, dv, bh, sq, skv, hd, causal,
                                              s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface, loaded with ctypes. q, o_grad (the output gradient),
// dq: device pointers of contiguous (bh, sq, hd) tensors; k, v, dk, dv:
// (bh, skv, hd); all of one type. lse, dsum: (bh, sq) f32. Launches the dq
// kernel, then the dk/dv kernel, on ``stream``; returns the first
// cudaError_t that is not cudaSuccess, or 0.
extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v,
                             const void* o_grad, const void* lse,
                             const void* dsum, void* dq, void* dk, void* dv,
                             int bh, int sq, int skv, int hd, int causal,
                             int device, void* stream) {
  return launch<float>(q, k, v, o_grad, lse, dsum, dq, dk, dv, bh, sq, skv,
                       hd, causal, device, stream);
}

extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* o_grad, const void* lse,
                              const void* dsum, void* dq, void* dk, void* dv,
                              int bh, int sq, int skv, int hd, int causal,
                              int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o_grad, lse, dsum, dq, dk, dv, bh,
                               sq, skv, hd, causal, device, stream);
}

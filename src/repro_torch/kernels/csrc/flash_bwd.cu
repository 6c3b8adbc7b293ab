// Flash-attention backward for Hopper (sm_90a): K5.
//
// Replaces the TPU kernels repro/kernels/flash.py (_flash_bwd_dq_kernel
// :132, _flash_bwd_dkv_kernel :171, flash_attention_bwd :219): given q, k,
// v, the forward's per-row logsumexp lse (csrc/flash_fwd.cu), the output
// gradient do and dsum = rowsum(do * o) (one torch reduction in the
// wrapper, outside the kernel as in the reference), it recomputes
// P = exp(q k^T * scale - lse) under the forward's mask (top-left causal
// qpos >= kpos from 0, masked P = 0) and writes
//   dq = dS k,  dk = dS^T q,  dv = P^T do,  dS = P * (do v^T - dsum) * scale
// with f32 accumulation and the gradients in the inputs' type.
//
// Bound on an H100: operations. At smollm-135m's training shape (BH, S,
// hd) = (144, 2048, 64) in bf16 the function needs five products over the
// 302M causal (q, k) pairs (S, dP, dv, dq, dk), ~193 GFLOP, against ~0.30
// GB of q/k/v/o/do/dq/dk/dv: 0.196 ms at the bf16 tensor-core peak (989
// TFLOP/s), 0.09 ms to move the bytes. Both kernels below recompute S and
// dP (seven products, ~271 GFLOP).
//
// Structure, on both routes: two kernels, each with a loop inside the
// block in place of the TPU's sequential grid axis, and neither uses
// atomics, so the result is the same bits from run to run (the training
// path's resume and repeated-step checks rest on that):
//   dq:    one block per (bh, 64-row q tile), sweeping kv tiles up to the
//          diagonal (causal), heaviest tile first; its dq stays in
//          registers;
//   dk/dv: one block per (bh, 64-row kv tile), sweeping q tiles from the
//          diagonal on; it computes S^T = K Q^T and dP^T = V dO^T directly,
//          so P^T and dS^T come out in the accumulator layout of its own
//          rows, and its dk and dv stay in registers.
//
// Routing, an explicit branch in flash_bwd_bf16 below (nothing catches a
// failure of either kernel pair):
//   bf16 with hd % 8 == 0, hd <= 256 and 16-byte-aligned tensors: the
//     tensor-core kernels (flash_bwd_dq_tc_kernel, flash_bwd_dkv_tc_kernel);
//   f32, and bf16 at any other hd: the FFMA kernels, unchanged. An f32
//     route on the tensor cores would run TF32, which the f32 gates (1e-4,
//     and chip_smoke's 1e-3 relative-L2 gradient check) do not admit.
//
// Tensor-core design (csrc/hopper.cuh has the building blocks, as in
// csrc/flash_fwd.cu). Every product is wgmma m64n64k16 by one warpgroup
// (128 threads) a block: S and dP (or S^T and dP^T) with both operands
// K-major in shared memory over the 4 k-steps of each slab; the gradient
// products with dS, P^T or dS^T rounded to bf16 in registers as the A
// operand and k, do or q from shared memory MN-major, as they lie in
// memory. Tiles are 64 rows in 128-byte-swizzled 64-column slabs; the
// block's own q and do (dq) or k and v (dk/dv) tiles stay put and the swept
// operands come through a 2-stage cp.async ring with zero-fill, as in the
// forward (the header there says why cp.async and not TMA), and as there
// the blocks of one head are adjacent in the grid (x = bh * tiles + tile)
// so that the swept operands come from L2 after the first tile. A block
// writes one 64-column slab of its gradients (grid axis z): at hd <= 64
// that is all of them; at hd 112 or 128 two blocks share a tile and each
// recomputes S and dP, which keeps the dk/dv kernel's accumulators (S^T,
// dP^T, dk, dv: 128 f32 a thread) within the register file at every hd up
// to 256. At hd 64 the dq kernel takes 128 registers and 50 KB (four
// blocks an SM), the dk/dv kernel 168 and 50 KB (three). The dq kernel
// takes lse and dsum of its rows from device memory once; the dk/dv
// kernel stages those of each q tile in shared memory.
//
// Rounding: bf16 x bf16 products are exact in f32, so S and dP differ from
// the FFMA kernels only in summation order. P and dS are rounded to bf16
// only as operands of the three gradient products (relative error <= 2^-9
// an entry); the plain version keeps them f32.
//
// FFMA design (f32, and bf16 at other hd). Both kernels use 256 threads as
// 16 x 16: a thread owns R x C scores of the (rows x swept) tile (k-major
// panels of both operands in shared memory, read as float4/float2), so S
// and dP = do v^T come from the same loop over hd. The tile of P or dS goes
// through shared memory into the second product, against a row-major copy
// of the swept operand whose columns are zero-padded to HDP (64, 128 or
// 256); each thread owns 4 columns of every 64 there. hd may be any size up
// to 256 and S any length: ragged rows are masked in the kernel, nothing is
// padded in device memory. Tiles: dq 64 x 64 and dk/dv 64 kv rows x 32 q
// rows up to HDP 128; 32 x 32 for both at HDP 256, where the f32 panels of
// 64-row tiles outgrow the 227 KB of shared memory a block may have. Inputs
// are f32 or bf16, converted on load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core kernels (bf16, hd % 8 == 0, hd <= 256)
// ---------------------------------------------------------------------------

using hopper::LOG2E;
using hopper::TILE;  // rows of a block's tile = rows of a swept tile
using hopper::tile_bytes;

// two fixed tiles, two stages of two swept tiles, (dk/dv) lse and dsum of
// two q tiles, and 1 KB for the alignment
constexpr size_t tc_smem_bytes(int ns) {
  return static_cast<size_t>(6) * tile_bytes(ns) +
         4 * TILE * sizeof(float) + 1024;
}

// dq: rows are q, the sweep is over kv. Block (bh, q tile, output slab).
template <int NS>
__global__ void __launch_bounds__(hopper::WG, (NS == 1 ? 3 : 1))
    flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ dsum,
                           __nv_bfloat16* __restrict__ dq, int sq, int skv,
                           int hd, int causal, float scale,
                           float scale_log2) {
  using namespace hopper;
  constexpr int SB = tile_bytes(1);  // one 64-column slab of a tile
  constexpr int TB = tile_bytes(NS);  // one tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(aligned_smem(smem_raw));
  const uint32_t Qs = base;
  const uint32_t dOs = base + TB;
  const uint32_t Ks = base + 2 * TB;  // stage st at Ks + st * TB
  const uint32_t Vs = base + 4 * TB;  // stage st at Vs + st * TB

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int os = blockIdx.z;  // the slab of dq this block writes
  // block x = bh * nq + tile: the tiles of one head run side by side and
  // share its k and v through L2; heaviest tile first within a head
  const int nq = (sq + TILE - 1) / TILE;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * TILE;
  const size_t bh = blockIdx.x / nq;
  const __nv_bfloat16* kb = k + bh * skv * hd;
  const __nv_bfloat16* vb = v + bh * skv * hd;
  const size_t qoff = (bh * sq + q0) * hd;
  const int kv_end = causal ? min(skv, q0 + TILE) : skv;
  const int n_kv = (kv_end + TILE - 1) / TILE;

  load_tile<TILE, NS, WG>(Qs, q + qoff, sq - q0, hd, tid);
  load_tile<TILE, NS, WG>(dOs, dout + qoff, sq - q0, hd, tid);
  load_tile<TILE, NS, WG>(Ks, kb, skv, hd, tid);
  load_tile<TILE, NS, WG>(Vs, vb, skv, hd, tid);
  cp_async_commit();

  const int qrow = q0 + warp * 16 + (lane >> 2);
  const int qrows[2] = {qrow, qrow + 8};
  const int cbase = 2 * (lane & 3);
  float row_lse[2], row_dsum[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qrows[h] < sq;
    row_lse[h] = in ? lse[bh * sq + qrows[h]] * LOG2E : 0.f;
    row_dsum[h] = in ? dsum[bh * sq + qrows[h]] : 0.f;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    const int k0 = j * TILE;
    if (j + 1 < n_kv) {
      const size_t next = static_cast<size_t>(k0 + TILE) * hd;
      load_tile<TILE, NS, WG>(Ks + (st ^ 1) * TB, kb + next,
                              skv - k0 - TILE, hd, tid);
      load_tile<TILE, NS, WG>(Vs + (st ^ 1) * TB, vb + next,
                              skv - k0 - TILE, hd, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NS; ++kk) {
      const uint32_t off = (kk >> 2) * SB + (kk & 3) * 32;
      wgmma_ss(s, desc_b128(Qs + off), desc_b128(Ks + st * TB + off),
               kk > 0);
      wgmma_ss(dp, desc_b128(dOs + off), desc_b128(Vs + st * TB + off),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // only the diagonal tile (causal) and ragged tiles mask
    const bool edge = k0 + TILE > skv || q0 + TILE > sq ||
                      (causal && k0 + TILE - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int kpos = k0 + 8 * (i >> 2) + cbase + (i & 1);
      const int qpos = qrows[h];
      const bool keep =
          !edge || (kpos < skv && qpos < sq && (!causal || qpos >= kpos));
      const float p =
          keep ? exp2f(fmaf(s[i], scale_log2, -row_lse[h])) : 0.f;
      s[i] = p * (dp[i] - row_dsum[h]) * scale;  // dS
    }
    uint32_t a[4][4];
    pack_a(s, a);
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a[kk],
               desc_b128(Ks + st * TB + os * SB + kk * 16 * ROW_BYTES), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    __syncthreads();  // every thread is done with stage st
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qrows[h];
    if (r >= sq) continue;
    __nv_bfloat16* row = dq + (bh * sq + r) * hd;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = os * SLAB_COLS + 8 * n + cbase;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(&row[col]) =
            __floats2bfloat162_rn(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
    }
  }
}

// The lse (in log2 units) and dsum of q rows q0 .. q0 + 63 into shared
// memory; rows past sq get 0 (their P is masked to 0).
__device__ __forceinline__ void stage_rows(float* Ls, float* Ds,
                                           const float* lse,
                                           const float* dsum, size_t row0,
                                           int nrows, int tid) {
  if (tid < TILE) {
    const bool in = tid < nrows;
    Ls[tid] = in ? lse[row0 + tid] * LOG2E : 0.f;
    Ds[tid] = in ? dsum[row0 + tid] : 0.f;
  }
}

// dk, dv: rows are kv, the sweep is over q. Block (bh, kv tile, output
// slab).
template <int NS>
__global__ void __launch_bounds__(hopper::WG, (NS == 1 ? 2 : 1))
    flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dsum,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int sq, int skv,
                            int hd, int causal, float scale,
                            float scale_log2) {
  using namespace hopper;
  constexpr int SB = tile_bytes(1);
  constexpr int TB = tile_bytes(NS);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const smem = aligned_smem(smem_raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t Ks = base;
  const uint32_t Vs = base + TB;
  const uint32_t Qs = base + 2 * TB;   // stage st at Qs + st * TB
  const uint32_t dOs = base + 4 * TB;  // stage st at dOs + st * TB
  float* const Ls = reinterpret_cast<float*>(smem + 6 * TB);  // [2][64]
  float* const Ds = Ls + 2 * TILE;                          // [2][64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int os = blockIdx.z;  // the slab of dk and dv this block writes
  // block x = bh * nkv + tile: the tiles of one head run side by side and
  // share its q and do through L2; heaviest (first) tile first
  const int nkv = (skv + TILE - 1) / TILE;
  const int k0 = static_cast<int>(blockIdx.x % nkv) * TILE;
  const size_t bh = blockIdx.x / nkv;
  const __nv_bfloat16* qb = q + bh * sq * hd;
  const __nv_bfloat16* dob = dout + bh * sq * hd;
  const size_t koff = (bh * skv + k0) * hd;
  // causal: q rows before k0 see none of this tile's keys
  const int q_begin = causal ? k0 : 0;
  const int n_q = q_begin < sq ? (sq - q_begin + TILE - 1) / TILE : 0;

  const int krow = k0 + warp * 16 + (lane >> 2);
  const int krows[2] = {krow, krow + 8};
  const int cbase = 2 * (lane & 3);
  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;

  // at hd <= 64, k and v are the register A operands of S^T and dP^T, read
  // once
  if (n_q > 0) {
    load_tile<TILE, NS, WG>(Ks, k + koff, skv - k0, hd, tid);
    load_tile<TILE, NS, WG>(Vs, v + koff, skv - k0, hd, tid);
    const size_t qfirst = static_cast<size_t>(q_begin) * hd;
    load_tile<TILE, NS, WG>(Qs, qb + qfirst, sq - q_begin, hd, tid);
    load_tile<TILE, NS, WG>(dOs, dob + qfirst, sq - q_begin, hd, tid);
    cp_async_commit();
    stage_rows(Ls, Ds, lse, dsum, bh * sq + q_begin, sq - q_begin, tid);
  }
  for (int i = 0; i < n_q; ++i) {
    const int st = i & 1;
    const int q0 = q_begin + i * TILE;
    if (i + 1 < n_q) {
      const int q1 = q0 + TILE;
      const size_t next = static_cast<size_t>(q1) * hd;
      load_tile<TILE, NS, WG>(Qs + (st ^ 1) * TB, qb + next, sq - q1, hd,
                              tid);
      load_tile<TILE, NS, WG>(dOs + (st ^ 1) * TB, dob + next, sq - q1,
                              hd, tid);
      cp_async_commit();
      stage_rows(Ls + (st ^ 1) * TILE, Ds + (st ^ 1) * TILE, lse, dsum,
                 bh * sq + q1, sq - q1, tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    float s[32], dp[32];  // S^T and dP^T: rows kv, columns q
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NS; ++kk) {
      const uint32_t off = (kk >> 2) * SB + (kk & 3) * 32;
      wgmma_ss(s, desc_b128(Ks + off), desc_b128(Qs + st * TB + off),
               kk > 0);
      wgmma_ss(dp, desc_b128(Vs + off), desc_b128(dOs + st * TB + off),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const float* Lt = Ls + st * TILE;
    const float* Dt = Ds + st * TILE;
    // only the diagonal tile (causal) and ragged tiles mask
    const bool edge = k0 + TILE > skv || q0 + TILE > sq ||
                      (causal && k0 + TILE - 1 > q0);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = 8 * (e >> 2) + cbase + (e & 1);  // q row in the tile
      const int kpos = krows[(e >> 1) & 1];
      const int qpos = q0 + c;
      const bool keep =
          !edge || (kpos < skv && qpos < sq && (!causal || qpos >= kpos));
      const float p = keep ? exp2f(fmaf(s[e], scale_log2, -Lt[c])) : 0.f;
      dp[e] = p * (dp[e] - Dt[c]) * scale;  // dS^T
      s[e] = p;                             // P^T
    }
    uint32_t ap[4][4], ad[4][4];
    pack_a(s, ap);
    pack_a(dp, ad);
    fence_regs(acc_v);
    fence_regs(acc_k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ap[kk]);
      fence_regs(ad[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = st * TB + os * SB + kk * 16 * ROW_BYTES;
      wgmma_rs(acc_v, ap[kk], desc_b128(dOs + off), 1);
      wgmma_rs(acc_k, ad[kk], desc_b128(Qs + off), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_v);
    fence_regs(acc_k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ap[kk]);
      fence_regs(ad[kk]);
    }
    __syncthreads();  // every thread is done with stage st
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = krows[h];
    if (r >= skv) continue;
    __nv_bfloat16* krow_p = dk + (bh * skv + r) * hd;
    __nv_bfloat16* vrow_p = dv + (bh * skv + r) * hd;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = os * SLAB_COLS + 8 * n + cbase;
      if (col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(&krow_p[col]) =
            __floats2bfloat162_rn(acc_k[4 * n + 2 * h],
                                  acc_k[4 * n + 2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(&vrow_p[col]) =
            __floats2bfloat162_rn(acc_v[4 * n + 2 * h],
                                  acc_v[4 * n + 2 * h + 1]);
      }
    }
  }
}

template <int NS>
int launch_tc_ns(const void* q, const void* k, const void* v,
                 const void* o_grad, const void* lse, const void* dsum,
                 void* dq, void* dk, void* dv, int bh, int sq, int skv,
                 int hd, int causal, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const float scale_log2 = scale * LOG2E;
  const size_t smem = tc_smem_bytes(NS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_tc_kernel<NS>
      <<<dim3(bh * ((sq + TILE - 1) / TILE), 1, NS), hopper::WG, smem,
         stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v),
                   static_cast<const bf16*>(o_grad),
                   static_cast<const float*>(lse),
                   static_cast<const float*>(dsum), static_cast<bf16*>(dq),
                   sq, skv, hd, causal, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_tc_kernel<NS>
      <<<dim3(bh * ((skv + TILE - 1) / TILE), 1, NS), hopper::WG,
         smem,
         stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v),
                   static_cast<const bf16*>(o_grad),
                   static_cast<const float*>(lse),
                   static_cast<const float*>(dsum), static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), sq, skv, hd, causal, scale,
                   scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const void* q, const void* k, const void* v, const void* o_grad,
              const void* lse, const void* dsum, void* dq, void* dk, void* dv,
              int bh, int sq, int skv, int hd, int causal, int device,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch_tc_ns<1>(q, k, v, o_grad, lse, dsum, dq, dk, dv, bh, sq,
                           skv, hd, causal, s);
  if (hd <= 128)
    return launch_tc_ns<2>(q, k, v, o_grad, lse, dsum, dq, dk, dv, bh, sq,
                           skv, hd, causal, s);
  if (hd <= 192)
    return launch_tc_ns<3>(q, k, v, o_grad, lse, dsum, dq, dk, dv, bh, sq,
                           skv, hd, causal, s);
  return launch_tc_ns<4>(q, k, v, o_grad, lse, dsum, dq, dk, dv, bh, sq, skv,
                         hd, causal, s);
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

// The route flash_bwd_bf16 takes for these arguments: 1 for the tensor
// cores, 0 for FFMA (see the routing note at the top).
extern "C" int flash_bwd_bf16_route(int hd, const void* q, const void* k,
                                    const void* v, const void* o_grad,
                                    const void* dq, const void* dk,
                                    const void* dv) {
  return hopper::tc_route(hd, {q, k, v, o_grad, dq, dk, dv}) ? 1 : 0;
}

extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* o_grad, const void* lse,
                              const void* dsum, void* dq, void* dk, void* dv,
                              int bh, int sq, int skv, int hd, int causal,
                              int device, void* stream) {
  if (flash_bwd_bf16_route(hd, q, k, v, o_grad, dq, dk, dv))
    return launch_tc(q, k, v, o_grad, lse, dsum, dq, dk, dv, bh, sq, skv, hd,
                     causal, device, stream);
  return launch<__nv_bfloat16>(q, k, v, o_grad, lse, dsum, dq, dk, dv, bh,
                               sq, skv, hd, causal, device, stream);
}

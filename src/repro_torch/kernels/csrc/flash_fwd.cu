// Flash-attention forward for Hopper (sm_90a): K4.
//
// Replaces the TPU kernel repro/kernels/flash.py (_flash_fwd_kernel :30,
// flash_attention_fwd :75): o = softmax(q k^T / sqrt(hd), masked) v over
// (BH, S, hd) with the heads already expanded, the causal mask qpos >= kpos
// counted from 0 (top-left aligned), masked scores at -1e30, f32 running
// max, sum and accumulator, o in q's dtype. It also writes lse = m + log(l)
// (f32), which the backward (csrc/flash_bwd.cu) recomputes P from.
//
// Bound on an H100: operations. At the serving path's shape (BH, S, hd) =
// (768, 1024, 112) in bf16 the causal work is 2 products x 2 x hd FLOP over
// 403M (q, k) pairs, ~180 GFLOP, against 0.70 GB of q/k/v/o: 0.18 ms at the
// bf16 tensor-core peak (989 TFLOP/s), 0.21 ms to move the bytes. At the
// training shape (144, 2048, 64): ~77 GFLOP, 0.078 ms.
//
// Routing, an explicit branch in flash_fwd_bf16 below (nothing catches a
// failure of either kernel):
//   bf16 with hd % 8 == 0, hd <= 256 and 16-byte-aligned tensors: the
//     tensor-core kernel (flash_fwd_tc_kernel);
//   f32, and bf16 at any other hd: the FFMA kernel (flash_fwd_kernel),
//     unchanged. An f32 route on the tensor cores would run TF32, which the
//     f32 gates (1e-4) do not admit.
//
// Tensor-core design (csrc/hopper.cuh has the building blocks). One block
// is one warpgroup (128 threads) and owns a 64-row q tile of one (b, h): the
// m64 of wgmma. Occupancy decides this over two warpgroups on a 128-row
// tile: at hd 64 a block needs 41 KB of shared memory and 112 registers a
// thread, so four blocks share an SM and one block's softmax hides behind
// another's products (at hd 112: 81 KB and 184 registers, two blocks). The
// blocks of one head are adjacent in the grid (x = bh * tiles + tile), so
// the blocks on the card at one time are the q tiles of a few heads and
// read each head's k and v from device memory once, then from L2; with
// the heads side by side instead, every q tile re-reads its head's k and v
// from device memory (~1.2 GB a call at (144, 2048, 64): 0.35 ms at 3.35
// TB/s, four times the bound). The q tile and a 2-stage ring of 64-row k and
// v tiles sit in 128-byte-swizzled slabs of 64 columns (hd 112 -> two
// slabs, hd 8 -> one, zero-filled past hd). The ring is filled by cp.async
// with zero-fill rather than TMA: one instruction gives the swizzle, the
// ragged rows of Sq and Skv and the columns past hd without a driver-API
// tensor map per call (cuTensorMapEncodeTiled through a version-dependent
// entry point), and the loads are not what bounds the kernel; the next
// tile's copy overlaps this tile's products. Per kv tile:
//   S = Q K^T: wgmma m64n64k16, Q and K from shared memory (K-major), over
//     the 4 k-steps of each slab, unrolled (the zero columns past hd add
//     nothing; at hd 112 one step in 8 is such);
//   the online softmax on the accumulator fragments in registers: each
//     thread holds 2 rows x 16 columns, a row's max is reduced over the 4
//     threads of a quad with two xor shuffles, the sum stays per thread
//     until the end (its rescalings are the row's, the same in the quad);
//     exp2 with log2(e) folded into the score scale;
//   P rounded to bf16 in registers becomes the A operand of O += P V:
//     wgmma m64n64k16 from registers, V from shared memory MN-major (as it
//     lies in memory), one product a 64-column slab of o.
// The products are waited for before their results are read (no overlap of
// one tile's softmax with the next tile's S inside a block: later work).
// Q stays in shared memory as an operand of S: holding it in registers as
// the A operand (read once a block) was tried, and at hd <= 64 ptxas gave
// those registers to the P fragments within the sweep, so the second kv
// tile's S came out wrong; that is left for later work too. Causal q tiles
// skip the kv tiles past their last row and run heaviest-first within a
// head.
//
// Rounding: bf16 x bf16 products are exact in f32, so S differs from the
// FFMA kernel only in summation order. The one new rounding is P to bf16
// as the operand of P V (relative error <= 2^-9 an entry), as the JAX model
// does before its P V (repro/models/attention.py:56-58); l sums the f32 P.
//
// FFMA design (f32, and bf16 at other hd). The TPU kernel keeps one q
// block's running max, denominator and f32 accumulator in VMEM scratch
// while a sequential grid axis streams kv blocks. Here one block of 256
// threads owns a 64-row q tile of one (b, h) and loops over 64-row kv tiles
// itself, so m, l and the accumulator stay in registers for the whole
// sweep. Each thread owns 4 q rows: a 4 x 4 tile of the scores (k-major
// panels of q and k in shared memory, read as float4) and 4 x HDP/16
// columns of the output. A row's max and sum are reduced over the 16
// threads that share it with xor shuffles. The probabilities go through
// shared memory (kv-major) into P V. hd may be any size up to 256: the q
// and k panels are hd rows deep, V is padded to HDP (64, 128 or 256)
// columns with zeros, and nothing is padded in device memory. Inputs are
// f32 or bf16, converted on load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16, hd % 8 == 0, hd <= 256)
// ---------------------------------------------------------------------------

using hopper::LOG2E;
using hopper::TILE;  // q rows of a block = kv rows of a step
using hopper::tile_bytes;
constexpr float LN2 = 0.6931471805599453f;

// q, then k and v for each of the two stages, and 1 KB for the alignment
constexpr size_t tc_smem_bytes(int ns) {
  return static_cast<size_t>(5) * tile_bytes(ns) + 1024;
}

template <int NS>
__global__ void __launch_bounds__(hopper::WG, (NS == 1 ? 3 : 1))
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int sq, int skv, int hd,
                        int causal, float scale_log2) {
  using namespace hopper;
  constexpr int SB = tile_bytes(1);  // one 64-column slab of a tile
  constexpr int TB = tile_bytes(NS);  // one tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = smem_u32(aligned_smem(smem_raw));
  const uint32_t Qs = base;
  const uint32_t Ks = base + TB;      // stage st at Ks + st * TB
  const uint32_t Vs = base + 3 * TB;  // stage st at Vs + st * TB

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // block x = bh * nq + tile: the tiles of one head run side by side and
  // share its k and v through L2; heaviest tile first within a head
  const int nq = (sq + TILE - 1) / TILE;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x % nq)) * TILE;
  const size_t bh = blockIdx.x / nq;
  const __nv_bfloat16* qb = q + bh * sq * hd;
  const __nv_bfloat16* kb = k + bh * skv * hd;
  const __nv_bfloat16* vb = v + bh * skv * hd;
  const int kv_end = causal ? min(skv, q0 + TILE) : skv;
  const int n_kv = (kv_end + TILE - 1) / TILE;

  load_tile<TILE, NS, WG>(Qs, qb + static_cast<size_t>(q0) * hd, sq - q0,
                          hd, tid);
  load_tile<TILE, NS, WG>(Ks, kb, skv, hd, tid);
  load_tile<TILE, NS, WG>(Vs, vb, skv, hd, tid);
  cp_async_commit();

  // this thread's rows: r and r + 8 of the tile
  const int qrow = q0 + warp * 16 + (lane >> 2);
  const int qrows[2] = {qrow, qrow + 8};
  const int cbase = 2 * (lane & 3);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NS][32];
#pragma unroll
  for (int sl = 0; sl < NS; ++sl)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[sl][i] = 0.f;

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

    float s[32];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NS; ++kk) {
      const uint32_t off = (kk >> 2) * SB + (kk & 3) * 32;
      wgmma_ss(s, desc_b128(Qs + off), desc_b128(Ks + st * TB + off),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // only the diagonal tile (causal) and the last one (ragged Skv) mask
    if (k0 + TILE > skv || (causal && k0 + TILE - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + cbase + (i & 1);
        const int qpos = qrows[(i >> 1) & 1];
        if (!(kpos < skv && (!causal || qpos >= kpos))) s[i] = NEG_INF;
      }
    }
    // the max of the raw scores (scale > 0), scaled once; the scale folds
    // into one FFMA before exp2
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale_log2);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = exp2f(fmaf(s[i], scale_log2, -m[h]));
      l[h] += s[i];
    }
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[sl][i] *= corr[(i >> 1) & 1];

    uint32_t a[4][4];
    pack_a(s, a);
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) fence_regs(acc[sl]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
        wgmma_rs(acc[sl], a[kk],
                 desc_b128(Vs + st * TB + sl * SB + kk * 16 * ROW_BYTES),
                 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int sl = 0; sl < NS; ++sl) fence_regs(acc[sl]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
    __syncthreads();  // every thread is done with stage st
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qrows[h];
    if (r >= sq) continue;
    const float den = fmaxf(l[h], 1e-30f);
    const float inv = 1.f / den;
    __nv_bfloat16* orow = o + (bh * sq + r) * hd;
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = sl * SLAB_COLS + 8 * n + cbase;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(&orow[col]) =
              __floats2bfloat162_rn(acc[sl][4 * n + 2 * h] * inv,
                                    acc[sl][4 * n + 2 * h + 1] * inv);
      }
    if ((lane & 3) == 0)
      lse[bh * sq + r] = l[h] > 0.f ? m[h] * LN2 + logf(den) : NEG_INF;
  }
}

template <int NS>
int launch_tc_ns(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int sq, int skv, int hd, int causal,
                 cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(NS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh * ((sq + TILE - 1) / TILE));
  flash_fwd_tc_kernel<NS><<<grid, hopper::WG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), sq, skv, hd, causal,
      LOG2E / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const void* q, const void* k, const void* v, void* o,
              void* lse, int bh, int sq, int skv, int hd, int causal,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return launch_tc_ns<1>(q, k, v, o, lse, bh, sq, skv, hd, causal, s);
  if (hd <= 128) return launch_tc_ns<2>(q, k, v, o, lse, bh, sq, skv, hd, causal, s);
  if (hd <= 192) return launch_tc_ns<3>(q, k, v, o, lse, bh, sq, skv, hd, causal, s);
  return launch_tc_ns<4>(q, k, v, o, lse, bh, sq, skv, hd, causal, s);
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

// The route flash_fwd_bf16 takes for these arguments: 1 for the tensor
// cores, 0 for FFMA (see the routing note at the top).
extern "C" int flash_fwd_bf16_route(int hd, const void* q, const void* k,
                                    const void* v, const void* o) {
  return hopper::tc_route(hd, {q, k, v, o}) ? 1 : 0;
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int sq, int skv,
                              int hd, int causal, int device, void* stream) {
  if (flash_fwd_bf16_route(hd, q, k, v, o))
    return launch_tc(q, k, v, o, lse, bh, sq, skv, hd, causal, device,
                     stream);
  return launch<__nv_bfloat16>(q, k, v, o, lse, bh, sq, skv, hd, causal,
                               device, stream);
}

// Mamba2 SSD intra-chunk step for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd.py (_ssd_kernel,
// ssd_intra_chunk_batched). For each cell (one (batch, chunk, head)) with
// chunk length q, head dim p and state dim n, all f32:
//
//   cum   = cumsum(loga)                                  (q,)
//   L     = tril exp(cum[t] - cum[s])                     (q, q)
//   y     = (C B^T * L) xbar                              (q, p)
//   state = (B * exp(cum[q-1] - cum))^T xbar              (n, p)
//
// Bound on an H100: operations. At the serving path's shape (10,752 cells
// of q = 256, p = n = 64) the three products are ~19 MFLOP a cell (~9 with
// the causal half of C B^T and of the y product skipped) against ~0.2 MB
// of operands, run as FP32 FFMA (no TF32: the reference is IEEE f32).
//
// Design. The TPU kernel holds a whole cell in VMEM; a (256, 256) f32 L is
// 256 KB, more than a block's shared memory. Here one block of 256 threads
// owns a cell and walks it in 64-row tiles: for each t tile it keeps C_t
// (k-major) in shared memory and a 64 x p accumulator of y in registers
// (4 x 4 a thread), and for each s tile s <= t it loads B_s and xbar_s,
// forms the 64 x 64 block of C B^T * L in registers, stages it through
// shared memory and adds its product with xbar_s. cum lives in shared
// memory (one warp scans it), and the last t tile, which visits every s
// tile, also accumulates the state (n x p, 4 x 4 or 8 x 4 a thread).
// Nothing but the outputs goes to device memory. Every operand is read
// through strides: a cell is (i1, i2) of a (g1, g2) grid, and B and C may
// have stride 0 along i2, so the model's B and C, shared by all heads of a
// (batch, chunk), are never copied per head. p <= 64, n <= 128.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BT = 64;        // rows of a t or s tile
constexpr int THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3
constexpr int PMAX = 64;
constexpr int NMAX = 128;
constexpr int PAD = 4;
constexpr int TS = BT + PAD;    // row stride of the k-major panels and of M
constexpr int XS = PMAX + PAD;  // row stride of the xbar tile

struct Strides {
  long long s1, s2, st;  // cell (i1, i2), row t; the last axis is contiguous
};

size_t smem_bytes(int q, int n) {
  const size_t q4 = (static_cast<size_t>(q) + 3) / 4 * 4;
  return sizeof(float) * (q4 + 2 * static_cast<size_t>(n) * TS +
                          static_cast<size_t>(BT) * XS +
                          static_cast<size_t>(BT) * TS + BT);
}

__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const float* __restrict__ xbar, const float* __restrict__ loga,
               const float* __restrict__ B, const float* __restrict__ C,
               float* __restrict__ y, float* __restrict__ state, int g2,
               int q, int p, int n, Strides xs, Strides ls, Strides bs,
               Strides cs, Strides ys) {
  extern __shared__ __align__(16) float smem[];
  const int q4 = (q + 3) / 4 * 4;
  float* cum = smem;             // [q4]
  float* Cs = cum + q4;          // [n][TS]  C of the t tile, k-major
  float* Bs = Cs + n * TS;       // [n][TS]  B of the s tile, k-major
  float* Xs = Bs + n * TS;       // [BT][XS] xbar of the s tile
  float* Ms = Xs + BT * XS;      // [BT][TS] (C B^T * L) block, s-major
  float* w = Ms + BT * TS;       // [BT]     exp(cum[q-1] - cum[s])

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long i1 = blockIdx.x / g2;
  const long long i2 = blockIdx.x - i1 * g2;
  const float* xc = xbar + i1 * xs.s1 + i2 * xs.s2;
  const float* lc = loga + i1 * ls.s1 + i2 * ls.s2;
  const float* bc = B + i1 * bs.s1 + i2 * bs.s2;
  const float* cc = C + i1 * cs.s1 + i2 * cs.s2;
  float* yc = y + i1 * ys.s1 + i2 * ys.s2;
  float* sc = state + static_cast<size_t>(blockIdx.x) * n * p;

  // cum = cumsum(loga): each lane of warp 0 sums a run in order, then the
  // lanes' totals are scanned with shuffles
  for (int t = tid; t < q; t += THREADS) cum[t] = lc[t * ls.st];
  __syncthreads();
  if (tid < 32) {
    const int per = (q + 31) / 32;
    const int lo = min(q, tid * per), hi = min(q, lo + per);
    float run = 0.f;
    for (int t = lo; t < hi; ++t) {
      run += cum[t];
      cum[t] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += up;
    }
    const float base = incl - run;
    for (int t = lo; t < hi; ++t) cum[t] += base;
  }
  __syncthreads();
  const float cend = cum[q - 1];

  const int nt = (q + BT - 1) / BT;
  float sacc[2][4][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[r][i][j] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int t0 = it * BT;
    const bool last = it == nt - 1;
    const bool rows_live = t0 + ty * 4 < q;  // whole warps skip dead rows
    __syncthreads();
    for (int idx = tid; idx < BT * n; idx += THREADS) {
      const int tt = idx / n, kk = idx - tt * n;
      Cs[kk * TS + tt] = t0 + tt < q ? cc[(t0 + tt) * cs.st + kk] : 0.f;
    }
    float yacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int s0 = jt * BT;
      __syncthreads();
      for (int idx = tid; idx < BT * n; idx += THREADS) {
        const int ss = idx / n, kk = idx - ss * n;
        Bs[kk * TS + ss] = s0 + ss < q ? bc[(s0 + ss) * bs.st + kk] : 0.f;
      }
      for (int idx = tid; idx < BT * PMAX; idx += THREADS) {
        const int ss = idx / PMAX, pc = idx - ss * PMAX;
        Xs[ss * XS + pc] =
            (s0 + ss < q && pc < p) ? xc[(s0 + ss) * xs.st + pc] : 0.f;
      }
      if (last && tid < BT)
        w[tid] = s0 + tid < q ? expf(cend - cum[s0 + tid]) : 0.f;
      __syncthreads();

      if (rows_live) {
        float mm[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mm[i][j] = 0.f;
        for (int kk = 0; kk < n; ++kk) {
          const float4 a =
              *reinterpret_cast<const float4*>(&Cs[kk * TS + ty * 4]);
          const float4 b =
              *reinterpret_cast<const float4*>(&Bs[kk * TS + tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mm[i][j] = fmaf(av[i], bv[j], mm[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx * 4 + j;
            const float val =
                (s <= t && t < q) ? mm[i][j] * expf(cum[t] - cum[s]) : 0.f;
            Ms[(tx * 4 + j) * TS + ty * 4 + i] = val;
          }
        }
      }
      __syncthreads();

      if (rows_live) {
        for (int ss = 0; ss < BT; ++ss) {
          const float4 a =
              *reinterpret_cast<const float4*>(&Ms[ss * TS + ty * 4]);
          const float4 b =
              *reinterpret_cast<const float4*>(&Xs[ss * XS + tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              yacc[i][j] = fmaf(av[i], bv[j], yacc[i][j]);
        }
      }
      if (last) {
        const int smax = min(BT, q - s0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (r * 64 + ty * 4 >= n) continue;
          for (int ss = 0; ss < smax; ++ss) {
            const float4 b =
                *reinterpret_cast<const float4*>(&Xs[ss * XS + tx * 4]);
            const float bv[4] = {b.x, b.y, b.z, b.w};
            const float ws = w[ss];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int kk = r * 64 + ty * 4 + i;
              const float bw = kk < n ? Bs[kk * TS + ss] * ws : 0.f;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                sacc[r][i][j] = fmaf(bw, bv[j], sacc[r][i][j]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pc = tx * 4 + j;
        if (pc < p) yc[t * ys.st + pc] = yacc[i][j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = r * 64 + ty * 4 + i;
      if (kk >= n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pc = tx * 4 + j;
        if (pc < p) sc[static_cast<size_t>(kk) * p + pc] = sacc[r][i][j];
      }
    }
}

}  // namespace

// Plain C interface, loaded with ctypes. All tensors are f32 device
// pointers. The (g1, g2) cells of xbar (q, p), loga (q,), B and C (q, n)
// and y (q, p) are addressed by the strides given (elements; the last axis
// contiguous, loga's row stride is its st); state is a contiguous
// (g1 * g2, n, p). q >= 1, p <= 64, n <= 128. Returns the cudaError_t.
extern "C" int ssd_f32(const void* xbar, const void* loga, const void* B,
                       const void* C, void* y, void* state, int g1, int g2,
                       int q, int p, int n, long long xs1, long long xs2,
                       long long xst, long long ls1, long long ls2,
                       long long lst, long long bs1, long long bs2,
                       long long bst, long long cs1, long long cs2,
                       long long cst, long long ys1, long long ys2,
                       long long yst, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q < 1 || p < 1 || p > PMAX || n < 1 || n > NMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(q, n);
  err = cudaFuncSetAttribute(ssd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cells = static_cast<long long>(g1) * g2;
  if (cells == 0) return 0;
  ssd_kernel<<<static_cast<unsigned>(cells), THREADS, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xbar), static_cast<const float*>(loga),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(state), g2, q, p, n,
      Strides{xs1, xs2, xst}, Strides{ls1, ls2, lst},
      Strides{bs1, bs2, bst}, Strides{cs1, cs2, cst},
      Strides{ys1, ys2, yst});
  return static_cast<int>(cudaGetLastError());
}

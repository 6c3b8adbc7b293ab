// Blocked-scan center precheck (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/precheck.py (center_precheck_stats,
// body _precheck_kernel). For a block of B points x (B, d), a center buffer
// c (T, d) and its valid mask, it computes the f32 matmul-form distances
// d[r, t] = sqrt(max(||x_r||^2 + ||c_t||^2 - 2 x_r . c_t, 0)), with invalid
// centers at float32 max, and reduces each row to (dmin, z, second, z2,
// third): the three smallest distances and the first columns attaining the
// two smallest, exactly as repro/kernels/ref.py:_nearest_stats does.
//
// Bound on an H100: operations. At the main path's shape (B, T, d) =
// (128, 65, 5000) the product is 2 B T d = 83.2 MFLOP, 1.24 us at 67 TFLOP/s
// of non-tensor FP32, against 3.86 MB of operands, 1.15 us at 3.35 TB/s.
// Both are far below a kernel launch, so the kernel is launch-bound on the
// scan's path; it is written to be right and to fill the card, not tuned.
//
// Products stay in IEEE f32 FFMA (no TF32, no wgmma): the scan's error
// margin (repro_torch/kernels/ops.py:_pdist_e2, 1e-5 x the operand norms)
// assumes full f32 products.
//
// Design. The TPU kernel keeps a (bB, T_pad) accumulator in VMEM across a
// sequential d grid axis. At B = 128 one block per row tile would give the
// card only 4-8 blocks, so here d is split across blocks instead:
//
// 1. precheck_partial: grid (ceil(B / 32), ceil(T / 64), S). Each block owns
//    a 32 x 64 tile of (row, center) pairs and one chunk of d, stages 32 x 16
//    and 64 x 16 panels through shared memory and keeps a 2 x 4 register
//    sub-tile of dot products per thread (256 threads). Threads 0-31 and
//    32-95 also sum the chunk's ||x_r||^2 and ||c_t||^2 from the same
//    panels. Partial sums go to scratch that the wrapper allocates:
//    dot (S, B, T), xn (S, B), cn (S, T).
// 2. precheck_reduce: one warp per row. Each lane sums the S partials of its
//    columns in a fixed order (deterministic, no float atomics), forms the
//    distance, and inserts the columns lane, lane + 32, ... in ascending
//    order into a running top-3 with a strict <, which is the lexicographic
//    (value, column) order. The 32 lane lists merge by xor shuffles in that
//    same order, so any T tiles (T = 257 for tau = 256) and a column >= T is
//    never returned. The chunked sums also keep each serial FFMA chain short
//    (chunk <= a few hundred terms), well inside the 1e-5 relative margin.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int BM = 32;        // rows of x per block
constexpr int BN = 64;        // centers per block
constexpr int BK = 16;        // d step staged through shared memory
constexpr int TM = 2;         // rows of the per-thread sub-tile
constexpr int TN = 4;         // centers of the per-thread sub-tile
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)
constexpr int PAD = 4;        // keeps rows 16-byte aligned, spreads banks
constexpr int ROWS_PER_BLOCK = 8;  // reduce kernel: one warp per row

static_assert((BM / TM) * (BN / TN) == THREADS, "one sub-tile per thread");
static_assert(BM + BN <= THREADS, "one norm accumulator per row/center");
static_assert((BM * BK) % THREADS == 0 && (BN * BK) % THREADS == 0, "");

__global__ void __launch_bounds__(THREADS)
    precheck_partial(const float* __restrict__ x, const float* __restrict__ c,
                     float* __restrict__ dot, float* __restrict__ xn,
                     float* __restrict__ cn, int B, int T, int d, int chunk) {
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float cs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // center group of this thread
  const int ty = tid / (BN / TN);  // row group of this thread
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int s = blockIdx.z;
  const int k_begin = s * chunk;
  const int k_end = min(d, k_begin + chunk);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // tid < BM: ||x_{row0+tid}||^2; BM <= tid < BM+BN: ||c||^2

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < B && gk < k_end)
                      ? x[static_cast<size_t>(gr) * d + gk]
                      : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int t = idx / BK, kk = idx % BK;
      const int gt = col0 + t, gk = k0 + kk;
      cs[kk][t] = (gt < T && gk < k_end)
                      ? c[static_cast<size_t>(gt) * d + gk]
                      : 0.f;
    }
    __syncthreads();

    if (tid < BM) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) nrm = fmaf(xs[kk][tid], xs[kk][tid], nrm);
    } else if (tid < BM + BN) {
      const int t = tid - BM;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) nrm = fmaf(cs[kk][t], cs[kk][t], nrm);
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(&xs[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&cs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // each row's norm is written by the blocks of the first center tile, each
  // center's by the blocks of the first row tile
  if (tid < BM) {
    const int r = row0 + tid;
    if (blockIdx.y == 0 && r < B) xn[static_cast<size_t>(s) * B + r] = nrm;
  } else if (tid < BM + BN) {
    const int t = col0 + tid - BM;
    if (blockIdx.x == 0 && t < T) cn[static_cast<size_t>(s) * T + t] = nrm;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int t = col0 + tx * TN + j;
      if (t >= T) continue;
      dot[(static_cast<size_t>(s) * B + r) * T + t] = acc[i][j];
    }
  }
}

// Running top-3 in lexicographic (value, column) order.
struct Top3 {
  float v[3];
  int c[3];
};

__device__ __forceinline__ bool lex_less(float va, int ca, float vb, int cb) {
  return va < vb || (va == vb && ca < cb);
}

__device__ __forceinline__ void insert(Top3& t, float v, int c) {
  if (lex_less(v, c, t.v[2], t.c[2])) {
    if (lex_less(v, c, t.v[1], t.c[1])) {
      t.v[2] = t.v[1];
      t.c[2] = t.c[1];
      if (lex_less(v, c, t.v[0], t.c[0])) {
        t.v[1] = t.v[0];
        t.c[1] = t.c[0];
        t.v[0] = v;
        t.c[0] = c;
      } else {
        t.v[1] = v;
        t.c[1] = c;
      }
    } else {
      t.v[2] = v;
      t.c[2] = c;
    }
  }
}

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
    precheck_reduce(const float* __restrict__ dot, const float* __restrict__ xn,
                    const float* __restrict__ cn,
                    const uint8_t* __restrict__ valid, int B, int T, int S,
                    float* __restrict__ dmin, int* __restrict__ z,
                    float* __restrict__ second, int* __restrict__ z2,
                    float* __restrict__ third) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (r >= B) return;  // whole warps leave together

  float xr = 0.f;
  for (int s = 0; s < S; ++s) xr += xn[static_cast<size_t>(s) * B + r];

  // (+inf, T) is a sentinel below every real entry: real distances are at
  // most float32 max
  Top3 top;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    top.v[i] = __int_as_float(0x7f800000);
    top.c[i] = T;
  }
  for (int t = lane; t < T; t += 32) {
    float ct = 0.f, dt = 0.f;
    for (int s = 0; s < S; ++s) {
      ct += cn[static_cast<size_t>(s) * T + t];
      dt += dot[(static_cast<size_t>(s) * B + r) * T + t];
    }
    float v = sqrtf(fmaxf(xr + ct - 2.f * dt, 0.f));
    if (!valid[t]) v = FLT_MAX;
    insert(top, v, t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov[3];
    int oc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ov[i] = __shfl_xor_sync(0xffffffffu, top.v[i], off);
      oc[i] = __shfl_xor_sync(0xffffffffu, top.c[i], off);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) insert(top, ov[i], oc[i]);
  }
  if (lane == 0) {
    // _nearest_stats masks z's column to float32 max before taking the
    // second minimum: when nothing else is below max, the second minimum is
    // max at the first column (0), and the third is max as well
    const float sec = fminf(top.v[1], FLT_MAX);
    dmin[r] = top.v[0];
    z[r] = top.c[0];
    second[r] = sec;
    z2[r] = sec < FLT_MAX ? top.c[1] : 0;
    third[r] = sec < FLT_MAX ? fminf(top.v[2], FLT_MAX) : FLT_MAX;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors: x (B, d) f32, c (T, d) f32, valid (T,) bool, scratch
// dot (S, B, T), xn (S, B), cn (S, T) f32, and the five (B,) outputs.
// Launches both kernels on `stream`; returns the cudaError_t of the
// launches.
extern "C" int precheck_f32(const void* x, const void* c, const void* valid,
                            void* dot, void* xn, void* cn, void* dmin, void* z,
                            void* second, void* z2, void* third, int B, int T,
                            int d, int S, int chunk, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1((B + BM - 1) / BM, (T + BN - 1) / BN, S);
  precheck_partial<<<grid1, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<float*>(dot), static_cast<float*>(xn),
      static_cast<float*>(cn), B, T, d, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid2 = (B + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  precheck_reduce<<<grid2, ROWS_PER_BLOCK * 32, 0, st>>>(
      static_cast<const float*>(dot), static_cast<const float*>(xn),
      static_cast<const float*>(cn), static_cast<const uint8_t*>(valid), B, T,
      S, static_cast<float*>(dmin), static_cast<int*>(z),
      static_cast<float*>(second), static_cast<int*>(z2),
      static_cast<float*>(third));
  return static_cast<int>(cudaGetLastError());
}

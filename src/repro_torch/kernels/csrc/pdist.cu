// Tiled pairwise squared Euclidean distances for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pdist.py (_pdist_kernel,
// pairwise_sqdist): D2[i, j] = ||x_i||^2 + ||y_j||^2 - 2 x_i . y_j, f32
// accumulation, clamped at 0.
//
// Bound on an H100: operations. At the main path's shape (a coreset of
// m = 1408 rows of d = 5000) the product is 2 m^2 d = 19.8 GFLOP against
// 56 MB of operands, so the card's 67 TFLOP/s of non-tensor FP32 bounds it
// at about 0.3 ms. The products stay in IEEE f32 FFMA (no TF32): the port's
// parity contract with the reference needs full f32 products. A later
// wgmma redesign has to keep that, e.g. by 3xTF32 splitting.
//
// Design. The TPU kernel revisits one output tile over a sequential d grid
// axis; here the d loop runs inside the block instead. Each block owns one
// 64 x 64 tile of D and stages 64 x 16 panels of x and y through shared
// memory (stored k-major, so a thread reads its 4 rows / 4 columns as one
// float4). Each of the 256 threads keeps a 4 x 4 register sub-tile of dot
// products. While the panels sit in shared memory, warps 0-1 accumulate
// ||x_r||^2 for the tile's 64 rows and warps 2-3 ||y_c||^2 for its 64
// columns, so the operands are read from device memory once per tile row /
// column and the norms add ~6% to the FFMA count. The epilogue writes
// max(xn + yn - 2 dot, 0). Inputs are f32 or bf16 (converted with
// __bfloat162float on load); the output is f32. No wgmma, no TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;       // rows of x per block
constexpr int BN = 64;       // rows of y per block
constexpr int BK = 16;       // d step staged through shared memory
constexpr int TM = 4;        // rows of the per-thread sub-tile
constexpr int TN = 4;        // columns of the per-thread sub-tile
constexpr int THREADS = 256; // (BM / TM) * (BN / TN)
constexpr int PAD = 4;       // keeps rows 16-byte aligned, spreads banks

static_assert((BM / TM) * (BN / TN) == THREADS, "one sub-tile per thread");
static_assert(BM + BN <= THREADS, "one norm accumulator per row/column");
static_assert((BM * BK) % THREADS == 0 && (BN * BK) % THREADS == 0, "");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    pdist_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 float* __restrict__ out, int n, int m, int d) {
  __shared__ __align__(16) float xs[BK][BM + PAD];
  __shared__ __align__(16) float ys[BK][BN + PAD];
  __shared__ float xn_s[BM];
  __shared__ float yn_s[BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group of this thread
  const int ty = tid / (BN / TN);  // row group of this thread
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // tid < BM: ||x_{row0+tid}||^2; BM <= tid < BM+BN: ||y||^2

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < n && gk < d)
                      ? to_f32(x[static_cast<size_t>(gr) * d + gk])
                      : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int c = idx / BK, kk = idx % BK;
      const int gc = col0 + c, gk = k0 + kk;
      ys[kk][c] = (gc < m && gk < d)
                      ? to_f32(y[static_cast<size_t>(gc) * d + gk])
                      : 0.f;
    }
    __syncthreads();

    if (tid < BM) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) nrm = fmaf(xs[kk][tid], xs[kk][tid], nrm);
    } else if (tid < BM + BN) {
      const int c = tid - BM;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) nrm = fmaf(ys[kk][c], ys[kk][c], nrm);
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&ys[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BM) {
    xn_s[tid] = nrm;
  } else if (tid < BM + BN) {
    yn_s[tid - BM] = nrm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      if (c >= m) continue;
      const float v = xn_s[ty * TM + i] + yn_s[tx * TN + j] - 2.f * acc[i][j];
      out[static_cast<size_t>(r) * m + c] = fmaxf(v, 0.f);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, int n, int m, int d,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BM - 1) / BM, (m + BN - 1) / BN);
  pdist_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<float*>(out), n, m, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous row-major tensors; returns the cudaError_t of the launch.
extern "C" int pdist_f32(const void* x, const void* y, void* out, int n,
                         int m, int d, int device, void* stream) {
  return launch<float>(x, y, out, n, m, d, device, stream);
}

extern "C" int pdist_bf16(const void* x, const void* y, void* out, int n,
                          int m, int d, int device, void* stream) {
  return launch<__nv_bfloat16>(x, y, out, n, m, d, device, stream);
}


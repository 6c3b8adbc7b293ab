// Pairwise squared Euclidean distances for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/pdist.py (_pdist_kernel,
// pairwise_sqdist): D2[i, j] = ||x_i||^2 + ||y_j||^2 - 2 x_i . y_j, f32
// accumulation, clamped at 0. Inputs f32 or bf16, output f32.
//
// The main path. core/final_solve.coreset_distance_matrix calls it once per
// solve with x and y the same tensor: the coreset's rows against
// themselves. At the songs-sim solve (seed 0) that is 327 rows of d = 5000;
// 1,408 = k * tau rows is the largest coreset a partition EXTRACT keeps.
//
// Bound on an H100. At 327^2 x 5000, x against itself, the function reads
// x once and writes D: 7.0 MB (0.0021 ms at 3.35 TB/s). The upper triangle
// of dots is 0.54 GFLOP (0.008 ms at the 67 TFLOP/s of f32 FFMA, 0.001 ms
// at the 495 TFLOP/s of TF32): bytes bound it on paper, but what held the
// first kernel back was parallelism. One block per 64 x 64 output tile
// gave 36 blocks for 132 SMs, each walking all of d.
//
// Why FFMA and not the tensor cores. The products stay IEEE f32 FFMA: one
// TF32 product leaves ~6e-5 of error on a unit-norm distance, over the
// 1e-5 x (||x||^2 + ||c||^2) margin that the scan and the solver assume
// (kernels/ops.py:_pdist_e2); 3xTF32 would meet it, but at this shape the
// f32 work is ~8 us of FFMA, too small for the tensor cores to pay for
// three products and the splitting. A 3xTF32 route for k * tau rows is
// future work.
//
// Design.
// 1. The d axis is split across blocks (pdist_partial). grid.x walks the
//    output tiles, grid.y the splits of d; the launcher picks the split
//    count so that the grid holds about four blocks per SM (327 rows: 21
//    tiles x 23 splits). Each block stages 64 x 32 panels of x and y
//    through a 3-stage ring of 16-byte cp.async copies (zero-filled at
//    ragged rows and columns), so the next panels load while the FFMAs of
//    this one run. 256 threads each keep a 4 x 4 register sub-tile of dot
//    products (rows ty + 16 i, columns tx + 16 j: the float4 reads of a
//    quarter warp hit 8 distinct bank groups). Row norms are summed from the
//    same panels in the same FFMA order as the dots, so a norm partial
//    equals the diagonal dot partial bit for bit.
// 2. pdist_reduce sums the partials of a tile over the splits in a fixed
//    order, the norms likewise, and writes max(xn + yn - 2 dot, 0). No float
//    atomics: two calls give the same bits, and d(x, x) = 0 exactly.
// 3. Symmetry. When x and y are one tensor (the wrapper passes sym = 1),
//    only tiles I <= J are computed and the epilogue writes D[i, j] and
//    D[j, i] from one value, so D equals its transpose bit for bit. Any
//    other pair computes the full grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BT = 64;        // rows of a tile of x and of y
constexpr int BK = 32;        // d step of a panel
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 sub-tile each
constexpr int TILE_ELEMS = BT * BT;
constexpr int MIN_STEPS = 4;       // d steps a split walks at least
constexpr int BLOCKS_PER_SM = 4;   // the split count aims at this

template <typename T>
struct Panel;  // row stride (elements) of a staged panel
template <>
struct Panel<float> {
  static constexpr int LD = BK + 4;  // 144-byte rows: float4 reads spread
};
template <>
struct Panel<__nv_bfloat16> {
  static constexpr int LD = BK + 8;  // 80-byte rows
};

template <typename T>
constexpr size_t stage_bytes() {
  return 2ull * BT * Panel<T>::LD * sizeof(T);
}

// Four consecutive elements of a staged row as floats.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// 4-byte cp.async with zero-fill (the element path of unaligned rows).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Stages rows [r0, r0 + BT) x columns [k0, k0 + BK) of a (rows x d)
// row-major matrix into a BT x LD panel. VEC: 16-byte copies (rows 16-byte
// aligned); otherwise one cp.async per element (f32) or plain loads (bf16,
// whose 2-byte elements cp.async cannot copy).
template <typename T, bool VEC>
__device__ __forceinline__ void stage_panel(T* dst, const T* src, int r0,
                                            int rows, int k0, int d,
                                            int tid) {
  constexpr int LD = Panel<T>::LD;
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);  // elements a chunk
    constexpr int CPR = BK / EPC;        // chunks a row
    for (int i = tid; i < BT * CPR; i += THREADS) {
      const int r = i / CPR, c = i - r * CPR;
      const int gr = r0 + r, gk = k0 + c * EPC;
      const int left = d - gk;  // elements of this chunk inside the row
      const bool valid = gr < rows && left > 0;
      const int bytes = valid ? (left >= EPC ? 16 : left * int(sizeof(T))) : 0;
      const T* p = valid ? src + static_cast<size_t>(gr) * d + gk : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       hopper::smem_u32(dst + r * LD + c * EPC)),
                   "l"(p), "r"(bytes)
                   : "memory");
    }
  } else {
    for (int i = tid; i < BT * BK; i += THREADS) {
      const int r = i / BK, c = i - r * BK;
      const int gr = r0 + r, gk = k0 + c;
      const bool valid = gr < rows && gk < d;
      const T* p = valid ? src + static_cast<size_t>(gr) * d + gk : src;
      if constexpr (sizeof(T) == 4) {
        cp_async4(hopper::smem_u32(dst + r * LD + c), p, valid);
      } else {
        dst[r * LD + c] = valid ? *p : __float2bfloat16(0.f);
      }
    }
  }
}

// Tile t of the grid -> (I, J). sym: the upper triangle I <= J of a
// tiles x tiles grid, row by row; otherwise row-major over ti x tj.
__device__ __forceinline__ void tile_of(int t, int sym, int ti, int tj,
                                        int& I, int& J) {
  if (sym) {
    I = 0;
    while (t >= ti - I) {
      t -= ti - I;
      ++I;
    }
    J = I + t;
  } else {
    I = t / tj;
    J = t - I * tj;
  }
}

// Partial dots (and row norms) of one output tile over one split of d:
// dot partials to part[(tile * splits + s) * TILE_ELEMS + (4 i + j) *
// THREADS + tid], x-row norm partials to xn_part[s * n_pad + row] (written
// by the blocks of tile column J = (sym ? I : 0)) and y-row norms to
// yn_part[s * m_pad + row] (tile row I = 0; unused when sym).
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    pdist_partial(const T* __restrict__ x, const T* __restrict__ y,
                  float* __restrict__ part, float* __restrict__ xn_part,
                  float* __restrict__ yn_part, int n, int m, int d,
                  int sym, int ti, int tj, int steps_per_split, int n_pad,
                  int m_pad) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  constexpr int LD = Panel<T>::LD;
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int tile = blockIdx.x, split = blockIdx.y;
  int I, J;
  tile_of(tile, sym, ti, tj, I, J);
  const int row0 = I * BT, col0 = J * BT;
  const int ksteps = (d + BK - 1) / BK;
  const int s0 = split * steps_per_split;
  const int s1 = min(ksteps, s0 + steps_per_split);
  const int nsteps = max(0, s1 - s0);

  // the blocks that own a row's norm (one tile column for x, one tile row
  // for y) write it once for the reduce pass
  const bool want_xn = J == (sym ? I : 0);
  const bool want_yn = !sym && I == 0;

  auto xs = [&](int st) { return ring + st * 2 * BT * LD; };
  auto ys = [&](int st) { return ring + st * 2 * BT * LD + BT * LD; };
  auto issue = [&](int step) {
    if (step < nsteps) {
      const int st = step % STAGES;
      const int k0 = (s0 + step) * BK;
      stage_panel<T, VEC>(xs(st), x, row0, n, k0, d, tid);
      stage_panel<T, VEC>(ys(st), y, col0, m, k0, d, tid);
    }
    hopper::cp_async_commit();
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // tid < 64: ||x_{row0+tid}||^2; 64..127: ||y_{col0+..}||^2

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) issue(st);
  for (int step = 0; step < nsteps; ++step) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // panel `step` is in; the slot refilled next is free
    issue(step + STAGES - 1);
    const T* xp = xs(step % STAGES);
    const T* yp = ys(step % STAGES);
    if ((tid < BT && want_xn) || (tid >= BT && tid < 2 * BT && want_yn)) {
      const T* rp = tid < BT ? xp + tid * LD : yp + (tid - BT) * LD;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        float a[4];
        load4(rp + kk, a);
#pragma unroll
        for (int e = 0; e < 4; ++e) nrm = fmaf(a[e], a[e], nrm);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float a[4][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(xp + (ty + 16 * i) * LD + kk, a[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load4(yp + (tx + 16 * j) * LD + kk, b[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(a[i][e], b[j][e], acc[i][j]);
    }
  }
  hopper::cp_async_wait<0>();

  // (4 i + j) * THREADS + tid: each store of a warp is 128 contiguous bytes
  float* base = part +
                (static_cast<size_t>(tile) * gridDim.y + split) * TILE_ELEMS +
                tid;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) base[(4 * i + j) * THREADS] = acc[i][j];
  if (tid < BT && want_xn)
    xn_part[static_cast<size_t>(split) * n_pad + row0 + tid] = nrm;
  else if (tid >= BT && tid < 2 * BT && want_yn)
    yn_part[static_cast<size_t>(split) * m_pad + col0 + tid - BT] = nrm;
}

// Sums the partials over the splits, in split order, and writes D. Block
// (tile, slot) takes the 256 entries of slot 4 i + j of a tile, one a thread
// (rows ty + 16 i, columns tx + 16 j), so that 16 blocks share a tile. The
// norms are summed in the same order, so a diagonal entry is
// xn + xn - 2 xn = 0 exactly. sym: D[c, r] gets the same value.
__global__ void __launch_bounds__(THREADS)
    pdist_reduce(const float* __restrict__ part,
                 const float* __restrict__ xn_part,
                 const float* __restrict__ yn_part, float* __restrict__ out,
                 int n, int m, int sym, int ti, int tj, int splits,
                 int n_pad, int m_pad) {
  __shared__ float xn_s[16];
  __shared__ float yn_s[16];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int tile = blockIdx.x >> 4, slot = blockIdx.x & 15;
  const int i = slot >> 2, j = slot & 3;
  int I, J;
  tile_of(tile, sym, ti, tj, I, J);
  if (tid < 32) {  // rows ty + 16 i of tile I, columns tx + 16 j of tile J
    const bool is_x = tid < 16;
    const int k = tid & 15;
    const float* p = is_x ? xn_part + I * BT + k + 16 * i
                          : (sym ? xn_part : yn_part) + J * BT + k + 16 * j;
    const int ld = (is_x || sym) ? n_pad : m_pad;
    float acc = p[0];
    for (int sp = 1; sp < splits; ++sp) acc += p[static_cast<size_t>(sp) * ld];
    (is_x ? xn_s : yn_s)[k] = acc;
  }
  __syncthreads();
  const float* p =
      part + static_cast<size_t>(tile) * splits * TILE_ELEMS + slot * THREADS +
      tid;
  float acc = p[0];
#pragma unroll 8
  for (int sp = 1; sp < splits; ++sp)
    acc += p[static_cast<size_t>(sp) * TILE_ELEMS];
  const float v = fmaxf(xn_s[ty] + yn_s[tx] - 2.f * acc, 0.f);
  const int r = I * BT + ty + 16 * i, c = J * BT + tx + 16 * j;
  if (r >= n || c >= m) return;
  const bool diag = sym && I == J;
  if (!diag || r <= c) {
    out[static_cast<size_t>(r) * m + c] = v;
    if (sym && r != c) out[static_cast<size_t>(c) * m + r] = v;
  }
}

struct Plan {
  int ti, tj, tiles, ksteps, steps_per_split, splits;
};

Plan plan(int n, int m, int d, int sym, int sms) {
  Plan p;
  p.ti = (n + BT - 1) / BT;
  p.tj = (m + BT - 1) / BT;
  p.tiles = sym ? p.ti * (p.ti + 1) / 2 : p.ti * p.tj;
  p.ksteps = (d + BK - 1) / BK;
  const long long want = (static_cast<long long>(BLOCKS_PER_SM) * sms +
                          p.tiles - 1) / p.tiles;
  const int max_splits = (p.ksteps + MIN_STEPS - 1) / MIN_STEPS;
  int splits = static_cast<int>(want < max_splits ? want : max_splits);
  if (splits < 1) splits = 1;
  p.steps_per_split = (p.ksteps + splits - 1) / splits;
  p.splits = (p.ksteps + p.steps_per_split - 1) / p.steps_per_split;
  return p;
}

int sm_count(int device) {
  static int cached[64] = {};
  if (device >= 0 && device < 64 && cached[device] > 0) return cached[device];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 132;
  if (device >= 0 && device < 64) cached[device] = sms;
  return sms;
}

template <typename T, bool VEC>
cudaError_t launch_partial(const Plan& p, const void* x, const void* y,
                           float* part, float* xn_part, float* yn_part, int n,
                           int m, int d, int sym, int n_pad, int m_pad,
                           cudaStream_t stream) {
  const size_t smem = STAGES * stage_bytes<T>();
  auto kern = pdist_partial<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.tiles, p.splits);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), part, xn_part,
      yn_part, n, m, d, sym, p.ti, p.tj, p.steps_per_split, n_pad, m_pad);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* y, void* out, void* scratch, int n,
           int m, int d, int sym, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sym && (x != y || n != m)) return static_cast<int>(cudaErrorInvalidValue);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Plan p = plan(n, m, d, sym, sm_count(device));
  // pdist_reduce runs 16 blocks a tile on grid.x
  if (static_cast<long long>(p.tiles) * 16 > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_pad = p.ti * BT, m_pad = p.tj * BT;
  const bool vec =
      (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  float* part = static_cast<float*>(scratch);
  float* xn_part = part + static_cast<size_t>(p.tiles) * p.splits * TILE_ELEMS;
  float* yn_part = xn_part + static_cast<size_t>(p.splits) * n_pad;
  err = vec ? launch_partial<T, true>(p, x, y, part, xn_part, yn_part, n, m,
                                      d, sym, n_pad, m_pad, stream)
            : launch_partial<T, false>(p, x, y, part, xn_part, yn_part, n, m,
                                       d, sym, n_pad, m_pad, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  pdist_reduce<<<p.tiles * 16, THREADS, 0, stream>>>(
      part, xn_part, yn_part, static_cast<float*>(out), n, m, sym, p.ti, p.tj,
      p.splits, n_pad, m_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.
//
// pdist_plan: the split count the launch will use for (n, m, d, sym) on
// ``device``, and in *scratch_floats the f32 scratch it needs: the dot
// partials, then the x-row and y-row norm partials.
extern "C" int pdist_plan(int n, int m, int d, int sym, int device,
                          long long* scratch_floats) {
  const Plan p = plan(n, m, d, sym, sm_count(device));
  *scratch_floats = static_cast<long long>(p.tiles) * p.splits * TILE_ELEMS +
                    static_cast<long long>(p.splits) * (p.ti + p.tj) * BT;
  return p.splits;
}

// pdist_f32 / pdist_bf16: pointers are device pointers of contiguous
// row-major tensors; scratch holds pdist_plan's floats. sym = 1 when x and
// y are the same tensor: the branch that computes only tiles I <= J and
// mirrors them. Returns the cudaError_t of the launches.
extern "C" int pdist_f32(const void* x, const void* y, void* out,
                         void* scratch, int n, int m, int d, int sym,
                         int device, void* stream) {
  return launch<float>(x, y, out, scratch, n, m, d, sym, device, stream);
}

extern "C" int pdist_bf16(const void* x, const void* y, void* out,
                          void* scratch, int n, int m, int d, int sym,
                          int device, void* stream) {
  return launch<__nv_bfloat16>(x, y, out, scratch, n, m, d, sym, device,
                               stream);
}

// Backward of the Mamba2 SSD intra-chunk step (K6b) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates the jnp chunked
// form (repro/models/mamba.py ssd_chunked) with XLA's autodiff. This is the
// vector-Jacobian product of K6 (csrc/ssd.cu) that autograd reaches through
// models.mamba.SSDIntraChunk. For each cell (one (batch * chunk, head)),
// chunk length q, head dim p, state dim n, all f32, with cum, L, G = C B^T,
// M = G * L and w = exp(cum[q-1] - cum) of the forward, and the output
// gradients dy (q, p) and dstate (n, p):
//
//   dM    = dy xbar^T (only s <= t: L and M vanish above)      (q, q)
//   dxbar = M^T dy + (B * w) dstate                           (q, p)
//   dG    = dM * L;  dC = dG B;  dB = dG^T C + w * (xbar dstate^T)
//   dcum  = rowsum(dM * M) - colsum(dM * M) - w * u, plus sum(w * u) at
//           t = q - 1, where u = rowsum((xbar dstate^T) * B)
//   dloga = reverse cumsum of dcum                              (q,)
//
// Bound on an H100. At the training shape of mamba2-2.7b (batch 8 x 2,048:
// 64 batch * chunks x 80 heads of (q, p, n) = (256, 64, 128), B and C shared
// by the heads) it reads xbar, dy, dstate, loga, B and C and writes dxbar,
// dloga, dB and dC: 1.22 GB a layer (0.36 ms at 3.35 TB/s), and needs ~89
// GFLOP for the causal (q, q) products of each cell and the B and C
// products of each batch * chunk (0.18 ms at the TF32 rate): bytes bound
// it, by the reckoning of chip_smoke.py (_time_ssd_bwd).
//
// Design (a first, simple and exact kernel: FFMA in f32, no tensor cores).
// A cell's (q, q) block in f32 is 256 KB at q = 256, more than an SM holds,
// so the work is tiled over 64-row (t, s) tile pairs with s <= t. A group is
// the cells that share B and C: all heads of one batch * chunk on the
// shared_bc route (B and C of size 1 along the cells' second axis), one cell
// on the per_cell route. One block per (group, s tile j) walks the group's
// cells in order and, per cell, the t tiles i >= j: it owns dxbar[s tile]
// (summed over its t tiles in registers), the column sums of dM * M and
// w u for its s rows, and dB[s tile], summed over the cells in order (the
// state term per cell; the dG term once, from dG summed over the cells in
// registers, since B and C are the cells' common operands). What sums over
// s tiles (the row sums of dM * M, and dC = sum_j dG[:, j] B_j) goes to
// scratch per s tile, and two small kernels add it in j order: ssd_bwd_dloga
// (dcum and the reverse scan, one warp a cell) and ssd_bwd_dc. No float
// atomics: every sum has a fixed order, and two calls give the same bits.
// Shared memory ~189 KB a block (B_j, the G tiles of every i >= j, xbar,
// dy and dstate tiles, M), 256 threads, each owning a 4 x 4 (or 4 x 8)
// sub-tile of rows tr + 16 a and columns tc + 16 b. Odd row strides keep
// the operand reads free of bank conflicts. q <= 256, p <= 64, n <= 128.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BT = 64;       // rows of a tile
constexpr int NTH = 256;     // threads a block
constexpr int NT_MAX = 4;    // t tiles a cell: q <= 256
constexpr int PMAX = 64;
constexpr int NMAX = 128;
constexpr int PLD = PMAX + 1;  // row stride of p-wide tiles (floats)
constexpr int NLD = NMAX + 1;  // row stride of n-wide tiles
constexpr int TLD = BT + 1;    // row stride of 64 x 64 tiles

struct Strides {
  long long s1, s2, st;  // cell (i1, i2), row; the last axis is contiguous
};

struct Args {
  const float* xbar;
  const float* loga;
  const float* B;
  const float* C;
  const float* dy;
  const float* dstate;
  float* dxbar;
  float* dloga;    // (g1 * g2, q) contiguous
  float* dB;       // (groups, q, n) contiguous
  float* dC;       // (groups, q, n) contiguous
  float* rowpart;  // (g1 * g2, nt, q): row sums of dM * M, per s tile
  float* colwu;    // (g1 * g2, 2, q): -colsum(dM * M) - w u, then w u
  float* dcpart;   // (groups, nt, q, n): dG[:, j] B_j, per s tile j
  int g1, g2, q, p, n, nt;
  int shared;  // a group is the g2 cells of one i1 (else one cell)
  Strides xs, ls, bs, cs, ys, ds, dxs;  // ys: dy; ds: dstate (rows n)
};

// Shared-memory layout (floats from the base).
struct Smem {
  int bj, gs, xs, ys, ds, ms, cum, w, red, wu, total;
};

Smem smem_layout(int nt) {
  Smem s;
  int off = 0;
  s.bj = off;
  off += BT * NLD;
  s.gs = off;
  off += nt * BT * TLD;
  s.xs = off;
  off += BT * PLD;
  s.ys = off;
  off += BT * PLD;
  s.ds = off;  // dstate (n rows), or a C tile (64 rows of n)
  off += NMAX * PLD > BT * NLD ? NMAX * PLD : BT * NLD;
  s.ms = off;
  off += BT * TLD;
  s.cum = off;
  off += NT_MAX * BT;
  s.w = off;
  off += NT_MAX * BT;
  s.red = off;
  off += 16 * BT;
  s.wu = off;
  off += BT;
  s.total = off;
  return s;
}

// dst[r * ld + c] = src[r * rs + c] for r < rv, c < cv; zeros elsewhere in
// rows x cols.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      long long rs, int rv, int cv, int rows,
                                      int cols, int tid) {
  for (int i = tid; i < rows * cols; i += NTH) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] = (r < rv && c < cv) ? __ldg(src + r * rs + c) : 0.f;
  }
}

// acc[a][b] += sum_k A(tr + 16 a, k) Bm(k, tc + 16 b), with A(r, k) =
// A[r * ar + k * ak] and Bm(k, c) = Bm[k * bk + c * bc].
template <int NA, int NB>
__device__ __forceinline__ void mm(float (&acc)[NA][NB], const float* A,
                                   int ar, int ak, const float* Bm, int bk,
                                   int bc, int K, int tr, int tc) {
  for (int k = 0; k < K; ++k) {
    float av[NA], bv[NB];
#pragma unroll
    for (int a = 0; a < NA; ++a) av[a] = A[(tr + 16 * a) * ar + k * ak];
#pragma unroll
    for (int b = 0; b < NB; ++b) bv[b] = Bm[k * bk + (tc + 16 * b) * bc];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

template <int NA, int NB>
__device__ __forceinline__ void zero(float (&acc)[NA][NB]) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[a][b] = 0.f;
}

// Sum over the 16 lanes of a half warp (the tc of one tr), in a fixed
// butterfly order: every lane ends with the same bits.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// In-place inclusive scan of a[0, q) by one warp (csrc/ssd.cu's scan).
__device__ __forceinline__ void scan_warp(float* a, int q, int lane) {
  const int per = (q + 31) / 32;
  const int lo = min(q, lane * per), hi = min(q, lo + per);
  float run = 0.f;
  for (int t = lo; t < hi; ++t) {
    run += a[t];
    a[t] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float base = incl - run;
  for (int t = lo; t < hi; ++t) a[t] += base;
}

// The same scan from the end: a[t] = sum of a[t'] over t' >= t.
__device__ __forceinline__ void rev_scan_warp(float* a, int q, int lane) {
  const int per = (q + 31) / 32;
  const int lo = min(q, lane * per), hi = min(q, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += a[q - 1 - i];
    a[q - 1 - i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float base = incl - run;
  for (int i = lo; i < hi; ++i) a[q - 1 - i] += base;
}

__global__ void __launch_bounds__(NTH, 1) ssd_bwd_tiles(Args a, Smem sm) {
  extern __shared__ float smem[];
  float* bj = smem + sm.bj;    // B rows of s tile j (64 x n)
  float* gs = smem + sm.gs;    // G[i, j] = C_i B_j^T for i >= j
  float* xs = smem + sm.xs;    // xbar rows of s tile j (64 x p)
  float* ys = smem + sm.ys;    // dy rows of t tile i (64 x p)
  float* dsm = smem + sm.ds;   // dstate (n x p), or a C tile
  float* ms = smem + sm.ms;    // M, or a summed dG tile (64 x 64)
  float* cum = smem + sm.cum;  // cum of the cell (q)
  float* wv = smem + sm.w;     // w of the cell (q)
  float* red = smem + sm.red;  // column-sum partials (16 x 64)
  float* wus = smem + sm.wu;   // w u of the s rows (64)

  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int nt = a.nt, q = a.q, p = a.p, n = a.n;
  const long long grp = blockIdx.x / nt;
  const int j = static_cast<int>(blockIdx.x - grp * nt);
  const int s0 = j * BT, sv = min(BT, q - s0);
  const long long gi1 = a.shared ? grp : grp / a.g2;
  const int gi2 = a.shared ? 0 : static_cast<int>(grp - gi1 * a.g2);
  const int gsize = a.shared ? a.g2 : 1;
  const float* bg = a.B + gi1 * a.bs.s1 + gi2 * a.bs.s2;
  const float* cg = a.C + gi1 * a.cs.s1 + gi2 * a.cs.s2;

  // B_j, and G[i, j] for every t tile i >= j (C_i staged where dstate goes)
  stage(bj, NLD, bg + s0 * a.bs.st, a.bs.st, sv, n, BT, NMAX, tid);
  for (int i = j; i < nt; ++i) {
    __syncthreads();
    stage(dsm, NLD, cg + i * BT * a.cs.st, a.cs.st, min(BT, q - i * BT), n,
          BT, NMAX, tid);
    __syncthreads();
    float g[4][4];
    zero(g);
    mm(g, dsm, NLD, 1, bj, 1, NLD, n, tr, tc);
    float* gt = gs + (i - j) * BT * TLD;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y)
        gt[(tr + 16 * x) * TLD + tc + 16 * y] = g[x][y];
  }

  float sdg[NT_MAX][4][4];  // dG[i, j] summed over the group's cells
#pragma unroll
  for (int ii = 0; ii < NT_MAX; ++ii) zero(sdg[ii]);
  float dbacc[4][8];  // dB[s tile j] (s rows, n columns)
  zero(dbacc);

  for (int c = 0; c < gsize; ++c) {
    const long long i1 = gi1;
    const int i2 = a.shared ? c : gi2;
    const long long cell = i1 * a.g2 + i2;
    __syncthreads();  // the last cell's reads of every buffer are done
    const float* lg = a.loga + i1 * a.ls.s1 + i2 * a.ls.s2;
    for (int t = tid; t < nt * BT; t += NTH)
      cum[t] = t < q ? __ldg(lg + t * a.ls.st) : 0.f;
    stage(xs, PLD, a.xbar + i1 * a.xs.s1 + i2 * a.xs.s2 + s0 * a.xs.st,
          a.xs.st, sv, p, BT, PMAX, tid);
    stage(dsm, PLD, a.dstate + i1 * a.ds.s1 + i2 * a.ds.s2, a.ds.st, n, p,
          NMAX, PMAX, tid);
    __syncthreads();
    if (warp == 0) scan_warp(cum, q, lane);
    __syncthreads();
    for (int t = tid; t < nt * BT; t += NTH)
      wv[t] = t < q ? expf(cum[q - 1] - cum[t]) : 0.f;
    __syncthreads();

    // dxbar[s] starts at (B * w) dstate; xd = xbar dstate^T feeds dB's
    // state term and u
    float dx[4][4];
    zero(dx);
    mm(dx, bj, NLD, 1, dsm, PLD, 1, n, tr, tc);
    float wrow[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      wrow[x] = wv[s0 + tr + 16 * x];
#pragma unroll
      for (int y = 0; y < 4; ++y) dx[x][y] *= wrow[x];
    }
    {
      float xd[4][8];
      zero(xd);
      mm(xd, xs, PLD, 1, dsm, 1, PLD, p, tr, tc);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float u = 0.f;
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          u = fmaf(xd[x][y], bj[(tr + 16 * x) * NLD + tc + 16 * y], u);
          dbacc[x][y] = fmaf(wrow[x], xd[x][y], dbacc[x][y]);
        }
        u = half_warp_sum(u);
        if (tc == 0) wus[tr + 16 * x] = wrow[x] * u;
      }
    }

    float colp[4] = {0.f, 0.f, 0.f, 0.f};  // column sums of dM * M
#pragma unroll
    for (int ii = 0; ii < NT_MAX; ++ii) {
      if (j + ii >= nt) break;
      const int t0 = (j + ii) * BT;
      __syncthreads();  // ys and ms are free
      stage(ys, PLD, a.dy + i1 * a.ys.s1 + i2 * a.ys.s2 + t0 * a.ys.st,
            a.ys.st, min(BT, q - t0), p, BT, PMAX, tid);
      __syncthreads();
      float dm[4][4];
      zero(dm);
      mm(dm, ys, PLD, 1, xs, 1, PLD, p, tr, tc);
      const float* gt = gs + ii * BT * TLD;
      float rowp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int rt = tr + 16 * x, t = t0 + rt;
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int cs = tc + 16 * y, s = s0 + cs;
          const bool ok = t < q && s < q && (ii > 0 || cs <= rt);
          const float l = ok ? expf(cum[t] - cum[s]) : 0.f;
          const float gv = gt[rt * TLD + cs];
          const float m = gv * l;
          const float dml = dm[x][y] * l;
          const float dmm = dml * gv;
          sdg[ii][x][y] += dml;
          rowp[x] += dmm;
          colp[y] += dmm;
          ms[rt * TLD + cs] = m;
        }
      }
      float* rp = a.rowpart + (cell * nt + j) * q;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float v = half_warp_sum(rowp[x]);
        const int t = t0 + tr + 16 * x;
        if (tc == 0 && t < q) rp[t] = v;
      }
      __syncthreads();  // M is in
      mm(dx, ms, 1, TLD, ys, PLD, 1, BT, tr, tc);  // += M^T dy
    }

    // dxbar[s tile] of the cell, in xbar's layout
    float* dxo = a.dxbar + i1 * a.dxs.s1 + i2 * a.dxs.s2;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int s = s0 + tr + 16 * x;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int col = tc + 16 * y;
        if (s < q && col < p) dxo[s * a.dxs.st + col] = dx[x][y];
      }
    }
    // the column sums over the 16 row groups, in order
#pragma unroll
    for (int y = 0; y < 4; ++y) red[tr * BT + tc + 16 * y] = colp[y];
    __syncthreads();
    if (tid < BT && s0 + tid < q) {
      float cs = 0.f;
      for (int r = 0; r < 16; ++r) cs += red[r * BT + tid];
      float* cw = a.colwu + cell * 2 * q;
      cw[s0 + tid] = -cs - wus[tid];
      cw[q + s0 + tid] = wus[tid];
    }
  }

  // the dG terms: dB[s tile] += dG[i, j]^T C_i, and dC's part dG[i, j] B_j
#pragma unroll
  for (int ii = 0; ii < NT_MAX; ++ii) {
    if (j + ii >= nt) break;
    const int t0 = (j + ii) * BT, tv = min(BT, q - t0);
    __syncthreads();
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y)
        ms[(tr + 16 * x) * TLD + tc + 16 * y] = sdg[ii][x][y];
    stage(dsm, NLD, cg + t0 * a.cs.st, a.cs.st, tv, n, BT, NMAX, tid);
    __syncthreads();
    mm(dbacc, ms, 1, TLD, dsm, NLD, 1, BT, tr, tc);
    float dcp[4][8];
    zero(dcp);
    mm(dcp, ms, TLD, 1, bj, NLD, 1, BT, tr, tc);
    float* out = a.dcpart + ((grp * nt + j) * q + t0) * n;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = tr + 16 * x;
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        const int col = tc + 16 * y;
        if (r < tv && col < n) out[r * n + col] = dcp[x][y];
      }
    }
  }
  float* dbo = a.dB + (grp * q + s0) * n;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = tr + 16 * x;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const int col = tc + 16 * y;
      if (r < sv && col < n) dbo[r * n + col] = dbacc[x][y];
    }
  }
}

// dloga, one warp a cell: dcum[t] = -colsum - w u + the row sums of the s
// tiles j <= t / 64 (in j order), plus sum(w u) at t = q - 1; then the
// reverse scan.
__global__ void __launch_bounds__(128) ssd_bwd_dloga(Args a) {
  __shared__ float buf[4][NT_MAX * BT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cell = blockIdx.x * 4LL + warp;
  if (cell >= static_cast<long long>(a.g1) * a.g2) return;
  const int q = a.q;
  const float* rp = a.rowpart + cell * a.nt * q;
  const float* cw = a.colwu + cell * 2 * q;
  float tot = 0.f;
  for (int s = lane; s < q; s += 32) tot += cw[q + s];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    tot += __shfl_xor_sync(0xffffffffu, tot, off);
  float* d = buf[warp];
  for (int t = lane; t < q; t += 32) {
    float v = cw[t];
    for (int jj = 0; jj <= t / BT; ++jj) v += rp[jj * q + t];
    if (t == q - 1) v += tot;
    d[t] = v;
  }
  __syncwarp();
  rev_scan_warp(d, q, lane);
  __syncwarp();
  for (int t = lane; t < q; t += 32) a.dloga[cell * q + t] = d[t];
}

// dC[g, t] = sum over the s tiles j <= t / 64, in j order, of dcpart.
__global__ void ssd_bwd_dc(Args a, long long total) {
  const int q = a.q, n = a.n;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long gq = e / n;
    const int col = static_cast<int>(e - gq * n);
    const long long g = gq / q;
    const int t = static_cast<int>(gq - g * q);
    float v = 0.f;
    for (int jj = 0; jj <= t / BT; ++jj)
      v += a.dcpart[((g * a.nt + jj) * q + t) * n + col];
    a.dC[e] = v;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.
//
// ssd_bwd_plan: the f32 scratch floats of a call (row sums, column sums
// and w u, dC parts), for g1 x g2 cells of chunk q and state n; `shared`
// is 1 when B and C are shared by the g2 cells of each i1.
extern "C" long long ssd_bwd_plan(int g1, int g2, int q, int n, int shared) {
  const long long nt = (q + BT - 1) / BT;
  const long long cells = static_cast<long long>(g1) * g2;
  const long long groups = shared ? g1 : cells;
  return cells * nt * q + cells * 2 * q + groups * nt * q * n;
}

// ssd_bwd_f32: all tensors are f32 device pointers. The (g1, g2) cells of
// xbar, dy and dxbar (q, p), loga (q,), B and C (q, n) and dstate (n, p)
// are addressed by the strides given (elements; the last axis contiguous;
// loga's row stride is its st); dloga is a contiguous (g1 * g2, q); dB and
// dC are contiguous (groups, q, n), groups = g1 when `shared` (B and C the
// same for every i2: their i2 stride is ignored) and g1 * g2 otherwise;
// scratch holds ssd_bwd_plan's floats. 1 <= q <= 256, p <= 64, n <= 128.
// Returns the cudaError_t.
extern "C" int ssd_bwd_f32(
    const void* xbar, const void* loga, const void* B, const void* C,
    const void* dy, const void* dstate, void* dxbar, void* dloga, void* dB,
    void* dC, void* scratch, int g1, int g2, int q, int p, int n, int shared,
    long long xs1, long long xs2, long long xst, long long ls1, long long ls2,
    long long lst, long long bs1, long long bs2, long long bst, long long cs1,
    long long cs2, long long cst, long long ys1, long long ys2, long long yst,
    long long ds1, long long ds2, long long dst, long long dxs1,
    long long dxs2, long long dxst, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q < 1 || q > NT_MAX * BT || p < 1 || p > PMAX || n < 1 || n > NMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cells = static_cast<long long>(g1) * g2;
  if (cells == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a;
  a.xbar = static_cast<const float*>(xbar);
  a.loga = static_cast<const float*>(loga);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.dy = static_cast<const float*>(dy);
  a.dstate = static_cast<const float*>(dstate);
  a.dxbar = static_cast<float*>(dxbar);
  a.dloga = static_cast<float*>(dloga);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.g1 = g1;
  a.g2 = g2;
  a.q = q;
  a.p = p;
  a.n = n;
  a.nt = (q + BT - 1) / BT;
  a.shared = shared ? 1 : 0;
  const long long groups = shared ? g1 : cells;
  float* sc = static_cast<float*>(scratch);
  a.rowpart = sc;
  a.colwu = a.rowpart + cells * a.nt * q;
  a.dcpart = a.colwu + cells * 2 * q;
  a.xs = Strides{xs1, xs2, xst};
  a.ls = Strides{ls1, ls2, lst};
  a.bs = Strides{bs1, shared ? 0 : bs2, bst};
  a.cs = Strides{cs1, shared ? 0 : cs2, cst};
  a.ys = Strides{ys1, ys2, yst};
  a.ds = Strides{ds1, ds2, dst};
  a.dxs = Strides{dxs1, dxs2, dxst};

  const long long blocks = groups * a.nt;
  if (blocks > 0x7fffffffLL || (cells + 3) / 4 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Smem sm = smem_layout(a.nt);
  const int bytes = static_cast<int>(sizeof(float) * sm.total);
  err = cudaFuncSetAttribute(ssd_bwd_tiles,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_tiles<<<static_cast<unsigned>(blocks), NTH, bytes, stream>>>(a, sm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dloga<<<static_cast<unsigned>((cells + 3) / 4), 128, 0, stream>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = groups * q * n;
  const long long dc_blocks = (total + 255) / 256;
  ssd_bwd_dc<<<static_cast<unsigned>(dc_blocks < 65535 ? dc_blocks : 65535),
               256, 0, stream>>>(a, total);
  return static_cast<int>(cudaGetLastError());
}

// Mamba2 SSD intra-chunk step for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/ssd.py (_ssd_kernel,
// ssd_intra_chunk_batched). For each cell (one (batch * chunk, head)) with
// chunk length q, head dim p and state dim n, all f32:
//
//   cum   = cumsum(loga)                                  (q,)
//   L     = tril exp(cum[t] - cum[s])                     (q, q)
//   G     = C B^T                                         (q, q)
//   y     = (G * L) xbar                                  (q, p)
//   state = (B * exp(cum[q-1] - cum))^T xbar              (n, p)
//
// Bound on an H100. At the serving path's shape (96 x 112 cells of
// q = 256, p = n = 64, B and C shared by the 112 heads of a batch * chunk)
// the function moves 1.61 GB (xbar read, y and the states written: 0.48 ms
// at 3.35 TB/s) and needs 68.6 GFLOP with C B^T once per batch * chunk
// (0.14 ms at the 495 TFLOP/s of TF32): bytes bound it. At q = 16 (the
// embedding forward) each cell writes a 64 x 64 state for a 16-row chunk,
// and bytes bound it more.
//
// Products: 3xTF32 on wgmma. Each product runs as m64n64k8 tf32 wgmma with
// every operand split as hi = tf32(a), lo = tf32(a - hi), and accumulates
// lo.hi + hi.lo + hi.hi in f32 (hopper.cuh: split_tf32, wgmma_tf32_rs).
// One tf32 product would leave ~5e-4 of the largest value on y, over the
// 2e-4 gate; the three-product split lands at the level of f32 itself
// (tests/test_torch_tf32_numerics.py models both). wgmma reads a tf32
// operand from shared memory only K-major, so:
//   - G = C B^T: A = C rows from registers (K = n contiguous as C lies in
//     memory), B = B rows in shared memory, K-major as they lie.
//   - y = (G * L) xbar and state = (B * w)^T xbar contract over s, which is
//     not contiguous in xbar: each xbar tile is staged once, transposed (p
//     rows, s contiguous) and split into hi and lo, and serves both
//     products as the B operand. Their A operands come from registers: G's
//     accumulator, masked, scaled by L and split (y), and B * w read from
//     shared memory (state). A tf32 A fragment holds k columns l % 4 and
//     l % 4 + 4 where the accumulator holds columns 2 (l % 4) and
//     2 (l % 4) + 1, so the transposed xbar tile stores its s columns in
//     that order inside each group of 8 (split_xbar), and G's accumulator
//     becomes the A fragment with no data movement.
//
// Routes (an explicit branch in ssd_f32):
//   shared_bc: B and C have stride 0 along the cells' second axis (the
//     model passes them as stride-0 head views, ngroups = 1). A first kernel
//     (ssd_gram) computes each causal 64 x 64 tile of G once per first-axis
//     index (batch * chunk) into scratch, 25 MB at most at the prefill
//     shape, which stays in the 50 MB L2; the cell kernel reads its tiles
//     back. This is the second of the two ways the design allows; it was
//     chosen because it keeps the cell kernel's shared memory at ~70 KB
//     (three blocks an SM) where holding G tiles for a group of heads needs
//     ~150 KB.
//   per_cell: any other B and C. The cell kernel computes its G tiles itself
//     with the same products.
// Blocks: one warpgroup each. A cell (q >= 33) has 64-row t tiles; one
// block per t tile accumulates y over the s tiles s <= t, and one more
// block accumulates the state over every s tile. These light blocks (~70 KB
// of shared memory and <= 168 registers on shared_bc) keep three on an SM,
// so that one block's loads overlap another's products. q <= 32 packs
// 64 / qp cells of one first-axis index into one 64-row tile (qp = 8, 16
// or 32 rows a cell): G * L is then block-diagonal, y is one product, and
// each cell's state a product over its own k steps. Every
// operand is read through strides (row stride, and the cells' two axes),
// y comes back in xbar's layout, y and the states leave through shared
// memory as 16-byte stores. Nothing else goes to device memory. No float
// atomics: two calls give the same bits. p <= 64, n <= 128, any q >= 1
// (cum and the decays of a cell sit in shared memory).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::fence_regs;
using hopper::smem_u32;

constexpr int BT = 64;     // rows of a tile
constexpr int WG = 128;    // one warpgroup a block
constexpr int PMAX = 64;
constexpr int NMAX = 128;
constexpr int XLD = PMAX + 4;  // row stride of the raw xbar tile (floats),
                               // which is also the output staging tile
constexpr int SLAB = 8192;     // bytes of a 64-row x 32-f32 swizzled slab
constexpr int TILE_FLOATS = BT * BT;

struct Strides {
  long long s1, s2, st;  // cell (i1, i2), row t; the last axis is contiguous
};

struct Args {
  const float* xbar;
  const float* loga;
  const float* B;
  const float* C;
  const float* G;  // shared_bc: the G tiles of ssd_gram
  float* y;
  float* state;
  int g1, g2, q, p, n;
  int qp;   // rows a cell takes in a tile: 8, 16, 32 (packed) or 64
  int pk;   // cells a block: 64 / qp when packed, else 1
  int nt;   // t tiles of a cell (1 when packed)
  int groups;  // cell groups along the cells' second axis: ceil(g2 / pk)
  int vec;  // every row 16-byte aligned: 16-byte copies and stores
  Strides xs, ls, bs, cs, ys;
};

// Shared-memory geometry of a launch (bytes from a 1024-byte aligned base).
struct Smem {
  int n32;  // n rounded up to 32 (the staged columns of B and C)
  int nld;  // row stride of raw B and C (floats)
  int qc;   // floats of cum and of w
  size_t xhl, bhl, xraw, braw, craw, cum, w, total;
};

Smem smem_layout(int q, int n, bool packed, bool gram_in_block) {
  Smem s;
  s.n32 = (n + 31) / 32 * 32;
  s.nld = s.n32 + 4;
  s.qc = packed ? BT : (q + BT - 1) / BT * BT;
  size_t off = 0;
  s.xhl = off;
  off += 4 * SLAB;  // xbar^T hi (2 slabs) and lo (2 slabs)
  s.bhl = off;
  if (gram_in_block) off += 2 * (s.n32 / 32) * SLAB;  // B hi and lo
  s.xraw = off;
  off += sizeof(float) * BT * XLD;
  s.braw = off;
  off += sizeof(float) * BT * s.nld;
  s.craw = off;
  if (gram_in_block) off += sizeof(float) * BT * s.nld;
  s.cum = off;
  off += sizeof(float) * s.qc;
  s.w = off;
  off += sizeof(float) * s.qc;
  s.total = off + 1024;  // slack for the 1024-byte alignment
  return s;
}

__device__ __forceinline__ void cp_async16_bytes(uint32_t dst,
                                                 const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Stages 64 rows x ncopy columns (ncopy % 4 == 0) into dst (row stride ld
// floats): row r from row(r), or zeros where row(r) is null; columns >=
// ncols are zeros. `any` is a valid device address for the zero-fills.
template <class Row>
__device__ __forceinline__ void stage_rows(float* dst, int ld, Row row,
                                           const float* any, int ncols,
                                           int ncopy, bool vec, int tid) {
  // copy i = r * per + c walks i = tid, tid + WG, ...: one division here,
  // increments after it
  const int per = vec ? ncopy / 4 : ncopy;  // copies a row (<= WG)
  const int dr = WG / per, dc = WG - dr * per;
  int r = tid / per, c = tid - r * per;
  while (r < BT) {
    const float* src = row(r);
    if (vec) {
      const int left = ncols - 4 * c;
      const bool valid = src != nullptr && left > 0;
      cp_async16_bytes(smem_u32(dst + r * ld + 4 * c),
                       valid ? src + 4 * c : any,
                       valid ? (left >= 4 ? 16 : 4 * left) : 0);
    } else {
      const bool valid = src != nullptr && c < ncols;
      cp_async4(smem_u32(dst + r * ld + c), valid ? src + c : any,
                valid ? 4 : 0);
    }
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// Byte offset of element (r, k) in a K-major tile of 64 rows, kept as
// slabs of 32 f32 columns in the 128-byte swizzle of hopper.cuh.
__device__ __forceinline__ uint32_t swz(int r, int k) {
  return (k >> 5) * SLAB + r * 128 + ((((k >> 2) & 7) ^ (r & 7)) << 4) +
         (k & 3) * 4;
}

// The transposed xbar tile keeps the s columns of each group of 8 in the
// order a thread's f32 accumulator holds them (2 (l % 4), 2 (l % 4) + 1)
// against the k columns of its tf32 A fragment (l % 4, l % 4 + 4): even s
// at K position (s % 8) / 2, odd s at 4 + (s % 8) / 2.

// xbar tile (64 s rows x 64 p, raw, row stride XLD) -> transposed hi and lo
// tiles (p rows, s columns in that order), the B operand of the y and
// state products. A thread fills 16-byte chunks of one p row: chunk c holds
// K positions 4 c .. 4 c + 3, i.e. s = 8 (c / 2) + 2 e + c % 2 for e < 4. A warp takes
// 32 consecutive p of one chunk: its reads (one word of each of 32 rows)
// and its 16-byte writes (8 rows a quarter warp, swizzled apart) are free
// of bank conflicts.
__device__ __forceinline__ void split_xbar(const float* xraw, uint8_t* xhi,
                                           uint8_t* xlo, int tid) {
  const int p = tid & (BT - 1);
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int c = (tid >> 6) + 2 * it;
    const float* col = xraw + (8 * (c >> 1) + (c & 1)) * XLD + p;
    uint4 hi, lo;
    hopper::split_tf32(col[0], hi.x, lo.x);
    hopper::split_tf32(col[2 * XLD], hi.y, lo.y);
    hopper::split_tf32(col[4 * XLD], hi.z, lo.z);
    hopper::split_tf32(col[6 * XLD], hi.w, lo.w);
    const uint32_t off = swz(p, 4 * c);
    *reinterpret_cast<uint4*>(xhi + off) = hi;
    *reinterpret_cast<uint4*>(xlo + off) = lo;
  }
}

// B tile (64 s rows x n32 columns, raw, row stride nld) -> hi and lo tiles
// (s rows, n columns: K-major as it lies), the B operand of G = C B^T.
__device__ __forceinline__ void split_b(const float* braw, int nld, int n32,
                                        uint8_t* bhi, uint8_t* blo, int tid) {
  const int cpr = n32 / 4;
  for (int i = tid; i < BT * cpr; i += WG) {
    const int r = i / cpr, c = i - r * cpr;
    const float4 v = *reinterpret_cast<const float4*>(braw + r * nld + 4 * c);
    uint4 hi, lo;
    hopper::split_tf32(v.x, hi.x, lo.x);
    hopper::split_tf32(v.y, hi.y, lo.y);
    hopper::split_tf32(v.z, hi.z, lo.z);
    hopper::split_tf32(v.w, hi.w, lo.w);
    const uint32_t off = swz(r, 4 * c);
    *reinterpret_cast<uint4*>(bhi + off) = hi;
    *reinterpret_cast<uint4*>(blo + off) = lo;
  }
}

__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int kk) {
  return hopper::desc_b128(smem_u32(tile + (kk >> 2) * SLAB + (kk & 3) * 32));
}

// The three products of one k step into d: lo.hi + hi.lo + hi.hi.
__device__ __forceinline__ void mma3(float (&d)[32], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4],
                                     const uint8_t* bhi, const uint8_t* blo,
                                     int kk, int first) {
  hopper::wgmma_tf32_rs(d, lo, kdesc(bhi, kk), first ? 0 : 1);
  hopper::wgmma_tf32_rs(d, hi, kdesc(blo, kk), 1);
  hopper::wgmma_tf32_rs(d, hi, kdesc(bhi, kk), 1);
}

// The A fragments (hi and lo) of up to 8 k steps.
struct Frags {
  uint32_t hi[8][4];
  uint32_t lo[8][4];
};

__device__ __forceinline__ void frag_split(Frags& a, int k, int j, float v) {
  hopper::split_tf32(v, a.hi[k][j], a.lo[k][j]);
}

// d (+)= the products of k steps kk0 + k in [kk_lo, kk_hi), k < 8, with the
// B tile (bhi, blo); the first product overwrites d when `first`. Waits for
// the products, so the fragments can be refilled after it.
__device__ __forceinline__ void issue(float (&d)[32], Frags& a,
                                      const uint8_t* bhi, const uint8_t* blo,
                                      int kk0, int kk_lo, int kk_hi,
                                      bool first) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    fence_regs(a.hi[k]);
    fence_regs(a.lo[k]);
  }
  fence_regs(d);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int kk = kk0 + k;
    if (kk >= kk_lo && kk < kk_hi)
      mma3(d, a.hi[k], a.lo[k], bhi, blo, kk, first && kk == kk_lo);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs(d);
}

// G tile = C_t B_s^T over nk k steps of n: A = C rows from registers (craw,
// row stride nld), B = the split B tile. Overwrites g.
__device__ __forceinline__ void gram(float (&g)[32], Frags& a,
                                     const float* craw, int nld,
                                     const uint8_t* bhi, const uint8_t* blo,
                                     int nk, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int r = 16 * warp + (lane >> 2), tig = lane & 3;
  for (int k0 = 0; k0 < nk; k0 += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k0 + k >= nk) break;
      const float* row = craw + r * nld + 8 * (k0 + k) + tig;
      frag_split(a, k, 0, row[0]);
      frag_split(a, k, 1, row[8 * nld]);
      frag_split(a, k, 2, row[4]);
      frag_split(a, k, 3, row[8 * nld + 4]);
    }
    issue(g, a, bhi, blo, k0, 0, nk, k0 == 0);
  }
}

// A fragments of (B * w)^T for rows n0 + (16 warp + l / 4, + 8) and the k
// steps [kk_lo, kk_hi) of the transposed xbar tile: s = 8 kk + 2 (l % 4)
// and + 1.
__device__ __forceinline__ void state_frags(Frags& a, const float* braw,
                                            int nld, const float* wv, int n0,
                                            int n, int kk_lo, int kk_hi,
                                            int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int r = n0 + 16 * warp + (lane >> 2), tig = lane & 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < kk_lo || k >= kk_hi) continue;
    const int s = 8 * k + 2 * tig;
    const float w0 = wv[s], w1 = wv[s + 1];
    const float* b0 = braw + s * nld;
    const float* b1 = b0 + nld;
    frag_split(a, k, 0, r < n ? b0[r] * w0 : 0.f);
    frag_split(a, k, 1, r + 8 < n ? b0[r + 8] * w0 : 0.f);
    frag_split(a, k, 2, r < n ? b1[r] * w1 : 0.f);
    frag_split(a, k, 3, r + 8 < n ? b1[r + 8] * w1 : 0.f);
  }
}

// Writes a 64 x 64 accumulator to the staging tile (row stride XLD).
__device__ __forceinline__ void stage_acc(float* st, const float (&d)[32],
                                          int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int r = 16 * warp + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(st + r * XLD + 8 * j + c) =
        make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(st + (r + 8) * XLD + 8 * j + c) =
        make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

// Copies the staging tile's rows to row(r) (null: skipped), ncols columns.
template <class Row>
__device__ __forceinline__ void store_rows(const float* st, Row row,
                                           int ncols, bool vec, int tid) {
  if (vec) {
    const int cpr = (ncols + 3) / 4;
    for (int i = tid; i < BT * cpr; i += WG) {
      const int r = i / cpr, c = i - r * cpr;
      float* dst = row(r);
      if (dst == nullptr) continue;
      const float4 v = *reinterpret_cast<const float4*>(st + r * XLD + 4 * c);
      if (4 * c + 4 <= ncols) {
        *reinterpret_cast<float4*>(dst + 4 * c) = v;
      } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
        for (int j = 0; 4 * c + j < ncols; ++j) dst[4 * c + j] = e[j];
      }
    }
  } else {
    for (int i = tid; i < BT * ncols; i += WG) {
      const int r = i / ncols, c = i - r * ncols;
      float* dst = row(r);
      if (dst != nullptr) dst[c] = st[r * XLD + c];
    }
  }
}

// In-place inclusive scan of a[0, q) by one warp: each lane sums a run in
// order, then the lanes' totals are scanned with shuffles.
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

// First-axis tile index of causal tile (it, jt), jt <= it.
__device__ __forceinline__ int tri(int it, int jt) {
  return it * (it + 1) / 2 + jt;
}

// Fragment-order layout of a G tile in scratch: float4 (i4, thread) at
// (i4 * WG + thread) * 4, i.e. accumulator entries 4 i4 .. 4 i4 + 3.
__device__ __forceinline__ void load_g(float (&g)[32], const float* tile,
                                       int tid) {
#pragma unroll
  for (int i4 = 0; i4 < 8; ++i4) {
    const float4 v =
        __ldg(reinterpret_cast<const float4*>(tile) + i4 * WG + tid);
    g[4 * i4] = v.x;
    g[4 * i4 + 1] = v.y;
    g[4 * i4 + 2] = v.z;
    g[4 * i4 + 3] = v.w;
  }
}

// shared_bc, first pass: the causal G tiles of one first-axis index (grid
// g1 x tiles). Packed, the tile's rows are the chunk's rows repeated once
// a cell, so its diagonal blocks are the chunk's G.
__global__ void __launch_bounds__(WG, 1) ssd_gram(Args a, Smem sm) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = hopper::aligned_smem(smem_raw);
  uint8_t* bhi = base + sm.bhl;
  uint8_t* blo = bhi + (sm.n32 / 32) * SLAB;
  float* braw = reinterpret_cast<float*>(base + sm.braw);
  float* craw = reinterpret_cast<float*>(base + sm.craw);
  const int tid = threadIdx.x;
  const int ntri = a.nt * (a.nt + 1) / 2;
  const long long i1 = blockIdx.x / ntri;
  const int t = blockIdx.x - static_cast<int>(i1) * ntri;
  int it = 0;
  while (tri(it + 1, 0) <= t) ++it;
  const int jt = t - tri(it, 0);
  const float* bc = a.B + i1 * a.bs.s1;
  const float* cc = a.C + i1 * a.cs.s1;
  const int q = a.q, qp = a.qp;
  auto rows = [&](const float* base_, long long st, int r0) {
    return [=](int r) -> const float* {
      const int tt = qp < BT ? r % qp : r0 + r;
      return tt < q ? base_ + tt * st : nullptr;
    };
  };
  stage_rows(craw, sm.nld, rows(cc, a.cs.st, it * BT), a.C, a.n, sm.n32,
             a.vec, tid);
  stage_rows(braw, sm.nld, rows(bc, a.bs.st, jt * BT), a.B, a.n, sm.n32,
             a.vec, tid);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  split_b(braw, sm.nld, sm.n32, bhi, blo, tid);
  hopper::fence_proxy_async();
  __syncthreads();
  float g[32];
  Frags fr;
  gram(g, fr, craw, sm.nld, bhi, blo, (a.n + 7) / 8, tid);
  float4* out = reinterpret_cast<float4*>(
      const_cast<float*>(a.G) + (i1 * ntri + t) * TILE_FLOATS);
#pragma unroll
  for (int i4 = 0; i4 < 8; ++i4)
    out[i4 * WG + tid] =
        make_float4(g[4 * i4], g[4 * i4 + 1], g[4 * i4 + 2], g[4 * i4 + 3]);
}

// The cell kernel. A cell group is one cell, or a pack of 64 / QP cells
// (QP < 64); it has nt + 1 blocks, adjacent in the grid: block `role` < nt
// computes y of t tile `role` (the s tiles up to it), block nt the states
// (every s tile). Light blocks keep three of them on an SM, so that one's
// loads overlap another's products.
template <bool SHARED, int QP>
__global__ void __launch_bounds__(WG, 3) ssd_cells(Args a, Smem sm) {
  constexpr bool PACKED = QP < BT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = hopper::aligned_smem(smem_raw);
  uint8_t* xhi = base + sm.xhl;
  uint8_t* xlo = xhi + 2 * SLAB;
  uint8_t* bhi = base + sm.bhl;
  uint8_t* blo = bhi + (sm.n32 / 32) * SLAB;
  float* xraw = reinterpret_cast<float*>(base + sm.xraw);
  float* braw = reinterpret_cast<float*>(base + sm.braw);
  float* craw = reinterpret_cast<float*>(base + sm.craw);
  float* cum = reinterpret_cast<float*>(base + sm.cum);
  float* wv = reinterpret_cast<float*>(base + sm.w);
  float* stg = xraw;  // the output staging tile, free after split_xbar

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int roles = a.nt + 1;
  const long long grp = blockIdx.x / roles;
  const int role = static_cast<int>(blockIdx.x - grp * roles);
  const long long i1 = grp / a.groups;
  const int i20 = static_cast<int>(grp - i1 * a.groups) * a.pk;
  const int q = a.q, p = a.p, n = a.n;
  const int cells = min(a.pk, a.g2 - i20);  // cells of this block
  const bool states = role == a.nt;

  // row r of a tile of an operand: packed, cell r / QP at row r % QP;
  // otherwise row r0 + r of the block's cell. Null past q or past g2.
  auto rows = [&](const float* base_, Strides s, int r0) {
    const float* cell = base_ + i1 * s.s1 + static_cast<long long>(i20) * s.s2;
    return [=](int r) -> const float* {
      const int c = PACKED ? r / QP : 0;
      const int tt = PACKED ? r % QP : r0 + r;
      return (tt < q && c < cells) ? cell + c * s.s2 + tt * s.st : nullptr;
    };
  };
  auto out_rows = [&](float* base_, Strides s, int r0) {
    float* cell = base_ + i1 * s.s1 + static_cast<long long>(i20) * s.s2;
    return [=](int r) -> float* {
      const int c = PACKED ? r / QP : 0;
      const int tt = PACKED ? r % QP : r0 + r;
      return (tt < q && c < cells) ? cell + c * s.s2 + tt * s.st : nullptr;
    };
  };

  // cum and w = exp(cum_end - cum) of each cell; packed at r = c QP + t;
  // zeros up to the end of the last tile
  const int qlen = sm.qc;
  for (int r = tid; r < qlen; r += WG) {
    const int c = PACKED ? r / QP : 0;
    const int tt = PACKED ? r % QP : r;
    cum[r] = (tt < q && c < cells)
                 ? a.loga[i1 * a.ls.s1 + (i20 + c) * a.ls.s2 + tt * a.ls.st]
                 : 0.f;
  }
  __syncthreads();
  for (int c = warp; c < cells; c += WG / 32)
    scan_warp(cum + (PACKED ? c * QP : 0), q, lane);
  __syncthreads();
  for (int r = tid; r < qlen; r += WG) {
    const int c = PACKED ? r / QP : 0;
    const int tt = PACKED ? r % QP : r;
    wv[r] = (tt < q && c < cells)
                ? expf(cum[(PACKED ? c * QP : 0) + q - 1] - cum[r])
                : 0.f;
  }

  const int nh = (n + BT - 1) / BT;  // 64-row halves of the state
  Frags fr;

  if (states) {
    float sacc[2][32];
    for (int jt = 0; jt < a.nt; ++jt) {
      __syncthreads();  // the previous step's reads of every buffer are done
      stage_rows(xraw, XLD, rows(a.xbar, a.xs, jt * BT), a.xbar, p, PMAX,
                 a.vec, tid);
      stage_rows(braw, sm.nld, rows(a.B, a.bs, jt * BT), a.B, n, sm.n32,
                 a.vec, tid);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
      __syncthreads();
      split_xbar(xraw, xhi, xlo, tid);
      hopper::fence_proxy_async();
      __syncthreads();
      if (!PACKED) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h >= nh) break;
          state_frags(fr, braw, sm.nld, wv + jt * BT, 64 * h, n, 0, 8, tid);
          issue(sacc[h], fr, xhi, xlo, 0, 0, 8, jt == 0);
        }
      }
    }
    // per cell and 64-row half, through the staging tile; packed, each
    // cell's state is the product over its own k steps
    for (int c = 0; c < (PACKED ? cells : 1); ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= nh) break;
        if (PACKED) {
          const int kk_lo = c * (QP / 8), kk_hi = kk_lo + QP / 8;
          state_frags(fr, braw, sm.nld, wv, 64 * h, n, kk_lo, kk_hi, tid);
          issue(sacc[h], fr, xhi, xlo, 0, kk_lo, kk_hi, true);
        }
        __syncthreads();  // the staging tile of the last store is read
        stage_acc(stg, sacc[h], tid);
        __syncthreads();
        float* cell_state =
            a.state + ((i1 * a.g2 + i20 + c) * static_cast<long long>(n)) * p;
        const int nrows = min(BT, n - 64 * h);
        store_rows(
            stg,
            [=](int r) -> float* {
              return r < nrows ? cell_state + (64 * h + r) * p : nullptr;
            },
            p, a.vec, tid);
      }
    }
    return;
  }

  // y of t tile `role`
  const int it = role, t0 = it * BT;
  const int nk = (n + 7) / 8;  // k steps of G = C B^T
  const int ntri = a.nt * (a.nt + 1) / 2;
  const int r_lo = 16 * warp + (lane >> 2), tig = lane & 3;
  float yacc[32], g[32];
  // this thread's two rows of the t tile: row r_lo + 8 h
  float cum_t[2];
  bool live_t[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    cum_t[h] = cum[t0 + row];
    live_t[h] = PACKED ? (row % QP < q && row / QP < cells) : t0 + row < q;
  }
  // shared_bc: the next s tile's xbar loads (cp.async, into the second raw
  // buffer, which is braw's space) and its G tile (registers, after this
  // step's fragments are built) while this step's products run
  float* xbuf[2] = {xraw, SHARED ? braw : xraw};
  auto stage_x = [&](int jt) {
    stage_rows(xbuf[jt & 1], XLD, rows(a.xbar, a.xs, jt * BT), a.xbar, p,
               PMAX, a.vec, tid);
    if (!SHARED) {
      stage_rows(braw, sm.nld, rows(a.B, a.bs, jt * BT), a.B, n, sm.n32,
                 a.vec, tid);
      stage_rows(craw, sm.nld, rows(a.C, a.cs, t0), a.C, n, sm.n32, a.vec,
                 tid);
    }
    hopper::cp_async_commit();
  };
  const float* gtiles = a.G + i1 * ntri * TILE_FLOATS;
  stage_x(0);
  if constexpr (SHARED) load_g(g, gtiles + tri(it, 0) * TILE_FLOATS, tid);
  for (int jt = 0; jt <= it; ++jt) {
    if (SHARED && jt < it) {
      stage_x(jt + 1);  // its buffer was last read before the last barrier
      hopper::cp_async_wait<1>();
    } else {
      if (!SHARED && jt > 0) stage_x(jt);
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // tile jt is in; the last step's products are done
    split_xbar(xbuf[jt & 1], xhi, xlo, tid);
    if (!SHARED) split_b(braw, sm.nld, sm.n32, bhi, blo, tid);
    hopper::fence_proxy_async();
    __syncthreads();
    if (!SHARED) gram(g, fr, craw, sm.nld, bhi, blo, nk, tid);

    // M = G * L (causal, and block-diagonal when packed) -> A fragments
    const int s0 = jt * BT;
    const bool diag = jt == it;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1;
        const int row = r_lo + 8 * h;
        const int col = 8 * k + 2 * tig + (j & 1);
        bool ok = live_t[h];
        if (PACKED)
          ok = ok && row / QP == col / QP && col % QP <= row % QP;
        else if (diag)
          ok = ok && col <= row;
        float v = 0.f;
        if (ok) v = g[4 * k + j] * expf(cum_t[h] - cum[s0 + col]);
        // accumulator entries 0, 1, 2, 3 -> fragment slots 0, 2, 1, 3
        frag_split(fr, k, h | ((j & 1) << 1), v);
      }
    }
    if (SHARED && jt < it)
      load_g(g, gtiles + tri(it, jt + 1) * TILE_FLOATS, tid);
    issue(yacc, fr, xhi, xlo, 0, 0, 8, jt == 0);
    if (!SHARED) __syncthreads();  // raw B and C are restaged next step
  }
  // through the staging tile (all cells of a pack)
  __syncthreads();
  stage_acc(stg, yacc, tid);
  __syncthreads();
  store_rows(stg, out_rows(a.y, a.ys, t0), p, a.vec, tid);
}

// One launch of ssd_cells<SHARED, qp> for the qp of these arguments.
template <bool SHARED>
cudaError_t launch_cells(const Args& a, const Smem& sm, unsigned blocks,
                         cudaStream_t stream) {
  auto kern = a.qp == 8    ? ssd_cells<SHARED, 8>
              : a.qp == 16 ? ssd_cells<SHARED, 16>
              : a.qp == 32 ? ssd_cells<SHARED, 32>
                           : ssd_cells<SHARED, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm.total));
  if (err != cudaSuccess) return err;
  kern<<<blocks, WG, sm.total, stream>>>(a, sm);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.
//
// ssd_plan: 1 if (g2, bs2, cs2) takes the shared_bc route (B and C of
// stride 0 along the cells' second axis, more than one cell along it), 0
// for per_cell; *scratch_floats is the f32 scratch the route needs.
extern "C" int ssd_plan(int g1, int g2, int q, long long bs2, long long cs2,
                        long long* scratch_floats) {
  const bool shared = g2 > 1 && bs2 == 0 && cs2 == 0;
  const int nt = q <= 32 ? 1 : (q + BT - 1) / BT;
  *scratch_floats =
      shared ? static_cast<long long>(g1) * (nt * (nt + 1) / 2) * TILE_FLOATS
             : 0;
  return shared ? 1 : 0;
}

// ssd_f32: all tensors are f32 device pointers. The (g1, g2) cells of xbar
// (q, p), loga (q,), B and C (q, n) and y (q, p) are addressed by the
// strides given (elements; the last axis contiguous, loga's row stride is
// its st); state is a contiguous (g1 * g2, n, p); scratch holds
// ssd_plan's floats. q >= 1, p <= 64, n <= 128. Returns the cudaError_t.
extern "C" int ssd_f32(const void* xbar, const void* loga, const void* B,
                       const void* C, void* y, void* state, void* scratch,
                       int g1, int g2, int q, int p, int n, long long xs1,
                       long long xs2, long long xst, long long ls1,
                       long long ls2, long long lst, long long bs1,
                       long long bs2, long long bst, long long cs1,
                       long long cs2, long long cst, long long ys1,
                       long long ys2, long long yst, int device,
                       void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q < 1 || p < 1 || p > PMAX || n < 1 || n > NMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ncells = static_cast<long long>(g1) * g2;
  if (ncells == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  Args a;
  a.xbar = static_cast<const float*>(xbar);
  a.loga = static_cast<const float*>(loga);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.G = static_cast<const float*>(scratch);
  a.y = static_cast<float*>(y);
  a.state = static_cast<float*>(state);
  a.g1 = g1;
  a.g2 = g2;
  a.q = q;
  a.p = p;
  a.n = n;
  a.qp = q <= 8 ? 8 : q <= 16 ? 16 : q <= 32 ? 32 : BT;
  a.pk = BT / a.qp;
  a.nt = a.qp < BT ? 1 : (q + BT - 1) / BT;
  a.groups = (g2 + a.pk - 1) / a.pk;
  a.xs = Strides{xs1, xs2, xst};
  a.ls = Strides{ls1, ls2, lst};
  a.bs = Strides{bs1, bs2, bst};
  a.cs = Strides{cs1, cs2, cst};
  a.ys = Strides{ys1, ys2, yst};
  bool vec = true;
  const void* ptrs[] = {xbar, B, C, y, state};
  for (const void* ptr : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long s : {xs1, xs2, xst, bs1, bs2, bst, cs1, cs2, cst, ys1, ys2,
                      yst, static_cast<long long>(p)})
    vec = vec && s % 4 == 0;
  a.vec = vec ? 1 : 0;
  const bool packed = a.qp < BT;
  const long long blocks =
      static_cast<long long>(g1) * a.groups * (a.nt + 1);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);

  if (g2 > 1 && bs2 == 0 && cs2 == 0) {  // shared_bc
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const Smem gs = smem_layout(q, n, packed, true);
    const int ntri = a.nt * (a.nt + 1) / 2;
    err = cudaFuncSetAttribute(ssd_gram,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(gs.total));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_gram<<<static_cast<unsigned>(g1 * ntri), WG, gs.total, stream>>>(a,
                                                                         gs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_cells<true>(a, smem_layout(q, n, packed, false),
                             static_cast<unsigned>(blocks), stream);
  } else {  // per_cell
    err = launch_cells<false>(a, smem_layout(q, n, packed, true),
                              static_cast<unsigned>(blocks), stream);
  }
  return static_cast<int>(err);
}

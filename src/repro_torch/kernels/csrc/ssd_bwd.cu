// Backward of the Mamba2 SSD intra-chunk step (K6b) for Hopper (sm_90a), on
// the tensor cores.
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
// it, by the reckoning of chip_smoke.py (_time_ssd_bwd). As run here (whole
// 64 x 64 tiles, three tf32 products for each f32 one) the cells take ~290
// GFLOP of tf32 work, 0.59 ms at the 495 TFLOP/s peak.
//
// Products: 3xTF32 on wgmma, as in K6. Each product is m64n64k8 tf32 wgmma
// with both operands split as hi = tf32(a), lo = tf32(a - hi), accumulating
// lo.hi + hi.lo + hi.hi in f32 (one tf32 product would leave ~5e-4 of the
// largest value, over the 2e-4 gate; tests/test_torch_tf32_numerics.py
// models both, dloga included). wgmma reads a tf32 operand from shared
// memory only K-major, so a block that owns an s tile runs every product
// of a cell in s-row orientation, its A operand from registers:
//   dM^T[s, t] = xbar_s dy_t^T      A xbar rows, B = dy rows as they lie
//   xd[s, n]   = xbar_s dstate^T    A xbar rows, B = dstate rows as they lie
//   dxbar_s   += M^T[s, t] dy_t     A = G^T * L^T from the accumulator,
//                                   B = dy_t staged transposed (p rows)
//   dxbar_s   += (B_s * w) dstate   A = B rows * w, B = dstate transposed
// A tf32 A fragment holds k columns l % 4 and l % 4 + 4 where the f32
// accumulator holds columns 2 (l % 4) and 2 (l % 4) + 1, so every
// transposed tile stores its K columns in that order inside each group of
// 8 (split_t, K6's split_xbar), and an accumulator becomes an A fragment
// with no data movement. The two state products run as two more 64-row
// "tiles" of a cell beside its dy tiles (dstate rows 0-63 and 64-127): the
// same two products, the same two buffers. Per batch * chunk:
//   G^T[s, t] = B_s C_t^T           ssd_bwd_gram, a pre-pass: A = B rows,
//                                   B = C rows as they lie
//   dB_s += dG^T[s, t] C_t          ssd_bwd_bc: A = the head-summed dG^T
//                                   from its fragment order, B = C_t
//                                   transposed
//   dC_t += dG[t, s] B_s            ssd_bwd_bc: the summed dG^T tile goes
//                                   through shared memory transposed, B =
//                                   B_s transposed
// dC takes a finishing pass over the head-summed dG^T, not dG computed in
// t-row orientation beside dG^T, which would double the products of every
// cell for a term that is 1/80 of the work.
//
// Grid and head slices. A group is the cells that share B and C: the heads
// of one batch * chunk on shared_bc, one cell on per_cell. The heads of a
// group are cut into slices, and one block (one warpgroup) takes a (group,
// slice, s-tile pair): s tile j and s tile nt - 1 - j, so every block walks
// nt + 1 (t, s) tile pairs a cell whatever its j (the middle tile of an odd
// nt goes alone). The slice count is chosen at launch from the card's SM
// count and the kernel's blocks an SM: the fewest slices whose waves x
// (heads a slice + 1) is least, the + 1 standing for a block's own set-up.
// On 132 SMs x 2 blocks that is, at mamba2-2.7b's layer, 2 slices of 40
// heads, 256 blocks in one wave (the first kernel: 64 x 4 blocks of
// unequal work), and at zamba2-7b's (16 x 112 cells) 8 slices of 14, 256
// blocks (was 64). A block walks its cells in order and, in a cell, its two
// s tiles one after the other, so that the second reads the dy and dstate
// rows the first has just brought into L2.
//
// A tile, its copies and its barriers. Operands go in with cp.async (16-byte
// copies when every row is 16-byte aligned, else K6's 4-byte copies: the
// model passes permuted views without a copy). A tile's raw rows are split
// at its start both ways at once (hi / lo, K-major as they lie for the
// first product, transposed for the second: two 32 KB tiles), so that after
// one barrier the raw buffer takes the next tile's copy, which then runs
// under the whole of this tile; the next s tile's xbar_s (and the next
// cell's loga) go in after the last tile's first product, behind a third
// barrier. The G^T tile and the slice sum a tile adds to
// are read from L2 before the first product, and the sum written back
// after it. The split rounds with two integer operations a value (the same
// bits as cvt.rna.tf32.f32, which ptxas makes four). Two barriers a tile
// but the last.
// Shared memory 103,424 bytes a block and <= 255 registers: two blocks an
// SM, each filling the other's waits. cum is scanned in the block (one
// warp), w computed per row in registers.
//
// Fixed-order sums, no float atomics (two calls give the same bits):
//   - a block keeps dxbar and the column sums of dM * M of its s rows in
//     registers over the cell's t tiles; the row sums of dM * M go to
//     scratch per (cell, s tile), summed over the 4 warps in order;
//   - the head-summed dG^T tiles and w * xd (dB's state term) of a slice
//     are kept in scratch in accumulator order: each thread reads back and
//     adds only the entries it wrote, head after head;
//   - ssd_bwd_bc adds the slices in order, then the t (or s) tiles in
//     order inside the tensor-core accumulator; ssd_bwd_dloga adds the row
//     sums of the s tiles in order and runs the reverse scan.
// Scratch (f32): the G^T tiles (groups x nt (nt + 1) / 2 x 64 x 64), the
// slice sums of dG^T (x slices) and of w * xd (groups x slices x nt x n
// rounded to 64 x 64), the row sums (cells x nt (nt + 1) / 2 x 64) and
// four partial sums of w u a (cell, s tile); the column sums wait in the
// dloga output. 61.7 MB at mamba2-2.7b's layer on 132 SMs, under the first
// kernel's 65.0 MB, so that the training step's peak does not rise.
//
// What it answers of the first kernel's limits: (1) FFMA at 9.6 TFLOP/s ->
// 3xTF32 wgmma; (2) one block an SM and synchronous copies fenced on both
// sides -> two blocks an SM, cp.async a tile ahead, two barriers a tile;
// (3) too few blocks of unequal work -> head slices sized to the card and
// s-tile pairs of equal work; (4) the dB and dC products once a batch *
// chunk stay once a slice, in the pre- and finishing passes. What is left
// is latency: at two blocks (8 warps) an SM a block's barriers, splits and
// epilogue take most of a tile's time, and the tensor cores idle between
// products. 1 <= q <= 256, p <= 64, n <= 128.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::fence_regs;
using hopper::smem_u32;

constexpr int BT = 64;      // rows of a tile: the m64 of wgmma
constexpr int WG = 128;     // one warpgroup a block
constexpr int NT_MAX = 4;   // t tiles a cell: q <= 256
constexpr int PMAX = 64;
constexpr int NMAX = 128;
constexpr int XLD = PMAX + 4;  // row stride of raw p-wide tiles (floats)
constexpr int NLD = NMAX + 8;  // row stride of raw n-wide tiles
constexpr int GLD = BT + 8;    // row stride of ssd_bwd_bc's transposed dG
constexpr int SLAB = 8192;     // bytes of a 64-row x 32-f32 swizzled slab
constexpr int TILE_FLOATS = BT * BT;

// ssd_bwd_cells' shared memory (bytes from a 1024-byte aligned base): a
// tile split K-major as it lies and split transposed (hi: 2 slabs, lo: 2
// slabs each), raw xbar_s, raw dy / dstate rows, cum, the row-sum partials
// of the 4 warps
constexpr int SM_HK = 0;
constexpr int SM_HT = SM_HK + 4 * SLAB;
constexpr int SM_X = SM_HT + 4 * SLAB;
constexpr int SM_Y = SM_X + 4 * BT * XLD;
constexpr int SM_CUM = SM_Y + 4 * BT * XLD;
constexpr int SM_RED = SM_CUM + 4 * NT_MAX * BT;
constexpr int SM_CELLS = SM_RED + 4 * 4 * BT + 1024;
// ssd_bwd_gram: C_t split (4 + 4 slabs), raw B_s, raw C_t
constexpr int SM_GRAM = 8 * SLAB + 2 * 4 * BT * NLD + 1024;
// ssd_bwd_bc: two transposed 64-row halves (4 slabs each), one raw n-wide
// tile, the transposed dG tile
constexpr int SM_BC = 8 * SLAB + 4 * BT * NLD + 4 * BT * GLD + 1024;

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
  float* gt;       // (groups, ntri) G^T tiles, accumulator order
  float* dgs;      // (groups, ns, ntri) slice sums of dG^T tiles
  float* dbs;      // (groups, ns, nt, nh) slice sums of w * xbar dstate^T
  float* rowpart;  // (g1 * g2, ntri, 64): row sums of dM * M, per tile
                   // pair (t tile, s tile)
  float* wupart;   // (g1 * g2, nt, 4): sum(w u) over a warp's 16 s rows
  int g1, g2, q, p, n;
  int nt, ntri, nh, npairs;  // t tiles, causal tile pairs, 64-row n halves
  int shared;  // a group is the g2 cells of one i1 (else one cell)
  int ns, hs;  // slices of a group, cells a slice
  int vec;     // every row 16-byte aligned: 16-byte copies
  Strides xs, ls, bs, cs, ys, ds, dxs;  // ys: dy; ds: dstate (rows n)
};

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

// Stages 64 rows x ncopy columns (ncopy % 4 == 0, ncopy / 4 <= WG when
// vec) into dst (row stride ld floats): row r from row(r), or zeros where
// row(r) is null; columns >= ncols are zeros. `any` is a valid device
// address for the zero-fills. (csrc/ssd.cu's stage_rows.)
template <class Row>
__device__ __forceinline__ void stage_rows(float* dst, int ld, Row row,
                                           const float* any, int ncols,
                                           int ncopy, bool vec, int tid) {
  const int per = vec ? ncopy / 4 : ncopy;  // copies a row
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

// Row r0 + r of a (rows, .) operand at base with row stride st; null at and
// past `lim`.
struct Rows {
  const float* base;
  long long st;
  int r0, lim;
  __device__ const float* operator()(int r) const {
    return r0 + r < lim ? base + (r0 + r) * st : nullptr;
  }
};

// 3xTF32's split, x = hi + lo, both rounded to tf32 to nearest with ties
// away from zero: the rounding of cvt.rna.tf32.f32 (hopper.cuh's
// split_tf32) in two integer operations a value, where ptxas makes the
// conversion four (a check for infinity and a select besides). The split
// is most of the cell kernel's own instructions: every operand value is
// split once a tile.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Byte offset of element (r, k) in a K-major tile of 64 rows, kept as
// slabs of 32 f32 columns in the 128-byte swizzle of hopper.cuh.
__device__ __forceinline__ uint32_t swz(int r, int k) {
  return (k >> 5) * SLAB + r * 128 + ((((k >> 2) & 7) ^ (r & 7)) << 4) +
         (k & 3) * 4;
}

// raw tile (64 rows, ncols32 columns, row stride ld) -> hi and lo tiles
// K-major as it lies (rows stay rows, columns are K).
__device__ __forceinline__ void split_k(const float* raw, int ld, int ncols32,
                                        uint8_t* hi, uint8_t* lo, int tid) {
  const int cpr = ncols32 / 4;
  for (int i = tid; i < BT * cpr; i += WG) {
    const int r = i / cpr, c = i - r * cpr;
    const float4 v = *reinterpret_cast<const float4*>(raw + r * ld + 4 * c);
    uint4 h, l;
    split3(v.x, h.x, l.x);
    split3(v.y, h.y, l.y);
    split3(v.z, h.z, l.z);
    split3(v.w, h.w, l.w);
    const uint32_t off = swz(r, 4 * c);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// raw tile (64 rows x 64 columns from raw, row stride ld) -> transposed hi
// and lo tiles: 64 rows (the raw columns), K = the raw rows, stored inside
// each group of 8 in accumulator order (even rows at K position (r % 8) /
// 2, odd at 4 + (r % 8) / 2), so that an accumulator is an A fragment. A
// warp reads 32 consecutive columns of one raw row and writes 16-byte
// chunks swizzled apart: no bank conflicts. (csrc/ssd.cu's split_xbar.)
__device__ __forceinline__ void split_t(const float* raw, int ld, uint8_t* hi,
                                        uint8_t* lo, int tid) {
  const int col = tid & (BT - 1);
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int c = (tid >> 6) + 2 * it;
    const float* src = raw + (8 * (c >> 1) + (c & 1)) * ld + col;
    uint4 h, l;
    split3(src[0], h.x, l.x);
    split3(src[2 * ld], h.y, l.y);
    split3(src[4 * ld], h.z, l.z);
    split3(src[6 * ld], h.w, l.w);
    const uint32_t off = swz(col, 4 * c);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
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

// The A fragments (hi and lo) of 8 k steps.
struct Frags {
  uint32_t hi[8][4];
  uint32_t lo[8][4];
};

__device__ __forceinline__ void frag_split(Frags& a, int k, int j, float v) {
  split3(v, a.hi[k][j], a.lo[k][j]);
}

// d (+)= the products of the k steps kk in [0, nk), nk <= 8, with the B
// tile (bhi, blo); the first overwrites d when `first`. Waits for the
// products, so the fragments can be refilled after it.
__device__ __forceinline__ void issue(float (&d)[32], Frags& a,
                                      const uint8_t* bhi, const uint8_t* blo,
                                      int nk, bool first) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    fence_regs(a.hi[k]);
    fence_regs(a.lo[k]);
  }
  fence_regs(d);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < nk) mma3(d, a.hi[k], a.lo[k], bhi, blo, k, first && k == 0);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  fence_regs(d);
}

// A fragments of k steps [k0, k0 + 8) of a raw K-major operand (row stride
// ld), in natural K order: rows r, r + 8; columns 8 k + l % 4 (+ 4).
__device__ __forceinline__ void frags_natural(Frags& a, const float* raw,
                                              int ld, int k0, int r,
                                              int tig) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float* row = raw + r * ld + 8 * (k0 + k) + tig;
    frag_split(a, k, 0, row[0]);
    frag_split(a, k, 1, row[8 * ld]);
    frag_split(a, k, 2, row[4]);
    frag_split(a, k, 3, row[8 * ld + 4]);
  }
}

// A fragments from a 64 x 64 accumulator (or values in its layout): entries
// 0, 1, 2, 3 of each group of 4 -> fragment slots 0, 2, 1, 3 (the K order
// of split_t).
__device__ __forceinline__ void frags_acc(Frags& a, const float (&d)[32]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    frag_split(a, k, 0, d[4 * k]);
    frag_split(a, k, 2, d[4 * k + 1]);
    frag_split(a, k, 1, d[4 * k + 2]);
    frag_split(a, k, 3, d[4 * k + 3]);
  }
}

// Accumulator-order layout of a 64 x 64 tile in scratch: float4 (i4,
// thread) at (i4 * WG + thread) * 4, i.e. entries 4 i4 .. 4 i4 + 3.
__device__ __forceinline__ void load_acc(float (&g)[32], const float* tile,
                                         int tid) {
#pragma unroll
  for (int i4 = 0; i4 < 8; ++i4) {
    const float4 v = reinterpret_cast<const float4*>(tile)[i4 * WG + tid];
    g[4 * i4] = v.x;
    g[4 * i4 + 1] = v.y;
    g[4 * i4 + 2] = v.z;
    g[4 * i4 + 3] = v.w;
  }
}

__device__ __forceinline__ void store_acc(float* tile, const float (&g)[32],
                                          int tid) {
#pragma unroll
  for (int i4 = 0; i4 < 8; ++i4)
    reinterpret_cast<float4*>(tile)[i4 * WG + tid] =
        make_float4(g[4 * i4], g[4 * i4 + 1], g[4 * i4 + 2], g[4 * i4 + 3]);
}

// g = the sum over ns slices (tile stride `stride` floats), in slice order.
__device__ __forceinline__ void sum_slices(float (&g)[32], const float* tile,
                                           long long stride, int ns,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < 32; ++i) g[i] = 0.f;
  for (int sl = 0; sl < ns; ++sl) {
    const float4* t = reinterpret_cast<const float4*>(tile + sl * stride);
#pragma unroll
    for (int i4 = 0; i4 < 8; ++i4) {
      const float4 v = __ldg(t + i4 * WG + tid);
      g[4 * i4] += v.x;
      g[4 * i4 + 1] += v.y;
      g[4 * i4 + 2] += v.z;
      g[4 * i4 + 3] += v.w;
    }
  }
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

// Index of causal tile pair (t tile it, s tile jt), jt <= it.
__device__ __forceinline__ int tri(int it, int jt) {
  return it * (it + 1) / 2 + jt;
}

// (i1, i2 of its first cell) of group grp.
__device__ __forceinline__ void group_cell(const Args& a, long long grp,
                                           long long& i1, int& i2) {
  i1 = a.shared ? grp : grp / a.g2;
  i2 = a.shared ? 0 : static_cast<int>(grp - i1 * a.g2);
}

// Pre-pass: G^T[s tile jt, t tile it] = B_jt C_it^T for every causal pair
// of a group, into scratch in accumulator order (grid groups x ntri).
__global__ void __launch_bounds__(WG, 1) ssd_bwd_gram(Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = hopper::aligned_smem(smem_raw);
  uint8_t* chi = base;
  uint8_t* clo = chi + 4 * SLAB;
  float* braw = reinterpret_cast<float*>(base + 8 * SLAB);
  float* craw = braw + BT * NLD;
  const int tid = threadIdx.x;
  const long long grp = blockIdx.x / a.ntri;
  const int t = static_cast<int>(blockIdx.x - grp * a.ntri);
  int it = 0;
  while (tri(it + 1, 0) <= t) ++it;
  const int jt = t - tri(it, 0);
  long long i1;
  int i2;
  group_cell(a, grp, i1, i2);
  const int n32 = (a.n + 31) / 32 * 32;
  stage_rows(braw, NLD,
             Rows{a.B + i1 * a.bs.s1 + i2 * a.bs.s2, a.bs.st, jt * BT, a.q},
             a.B, a.n, n32, a.vec, tid);
  stage_rows(craw, NLD,
             Rows{a.C + i1 * a.cs.s1 + i2 * a.cs.s2, a.cs.st, it * BT, a.q},
             a.C, a.n, n32, a.vec, tid);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  split_k(craw, NLD, n32, chi, clo, tid);
  hopper::fence_proxy_async();
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  const int r = 16 * warp + (lane >> 2), tig = lane & 3;
  const int nk = (a.n + 7) / 8;
  float g[32];
  Frags fr;
  for (int k0 = 0; k0 < nk; k0 += 8) {
    frags_natural(fr, braw, NLD, k0, r, tig);
    // k steps past nk read zero columns of braw (ld 136 >= 8 k0 + 64)
    issue(g, fr, chi + (k0 / 4) * SLAB, clo + (k0 / 4) * SLAB,
          min(8, nk - k0), k0 == 0);
  }
  store_acc(a.gt + (grp * a.ntri + t) * TILE_FLOATS, g, tid);
}

// The cell kernel: one block a (group, slice, s-tile pair); per s tile of
// the pair and per cell of the slice, the nh dstate tiles then the dy
// tiles t >= s (see the file header). A tile's raw rows are split both ways
// at its start, so its raw buffer takes the next tile's copy at once.
__global__ void __launch_bounds__(WG, 2) ssd_bwd_cells(Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = hopper::aligned_smem(smem_raw);
  uint8_t* khi = base + SM_HK;  // the tile K-major as it lies
  uint8_t* klo = khi + 2 * SLAB;
  uint8_t* thi = base + SM_HT;  // the tile transposed
  uint8_t* tlo = thi + 2 * SLAB;
  float* xraw = reinterpret_cast<float*>(base + SM_X);
  float* yraw = reinterpret_cast<float*>(base + SM_Y);
  float* cum = reinterpret_cast<float*>(base + SM_CUM);
  float* red = reinterpret_cast<float*>(base + SM_RED);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r_lo = 16 * warp + (lane >> 2), tig = lane & 3;
  const int q = a.q, p = a.p, n = a.n, nt = a.nt, nh = a.nh;
  const long long per_grp = static_cast<long long>(a.ns) * a.npairs;
  const long long grp = blockIdx.x / per_grp;
  const int rem = static_cast<int>(blockIdx.x - grp * per_grp);
  const int slice = rem / a.npairs, pair = rem - slice * a.npairs;
  long long i1;
  int i2_0;
  group_cell(a, grp, i1, i2_0);
  if (a.shared) i2_0 = slice * a.hs;
  const int cnt = a.shared ? min(a.hs, a.g2 - i2_0) : 1;
  // s tile jj of the pair
  auto j_of = [&](int jj) { return jj == 0 ? pair : nt - 1 - pair; };
  const int nj = nt - 1 - pair == pair ? 1 : 2;
  const float* bg = a.B + i1 * a.bs.s1 + i2_0 * a.bs.s2;
  const float* gtiles = a.gt + grp * a.ntri * TILE_FLOATS;
  float* dgs = a.dgs + (grp * a.ns + slice) * a.ntri * TILE_FLOATS;
  float* dbs = a.dbs + (grp * a.ns + slice) * nt * nh * TILE_FLOATS;
  const bool vec = a.vec;

  // the copies of a cell's loga, of its xbar_s, and of its tile k at s
  // tile j (dstate rows for k < nh, else dy rows of t tile j + k - nh)
  auto stage_cum = [&](int i2) {
    const float* lg = a.loga + i1 * a.ls.s1 + i2 * a.ls.s2;
    for (int t = tid; t < nt * BT; t += WG)
      cp_async4(smem_u32(cum + t), t < q ? lg + t * a.ls.st : a.loga,
                t < q ? 4 : 0);
  };
  auto stage_x = [&](int j, int i2) {
    stage_rows(xraw, XLD,
               Rows{a.xbar + i1 * a.xs.s1 + i2 * a.xs.s2, a.xs.st, j * BT, q},
               a.xbar, p, PMAX, vec, tid);
  };
  auto stage_tile = [&](int j, int i2, int k) {
    if (k < nh)
      stage_rows(yraw, XLD,
                 Rows{a.dstate + i1 * a.ds.s1 + i2 * a.ds.s2, a.ds.st,
                      k * BT, n},
                 a.dstate, p, PMAX, vec, tid);
    else
      stage_rows(yraw, XLD,
                 Rows{a.dy + i1 * a.ys.s1 + i2 * a.ys.s2, a.ys.st,
                      (j + k - nh) * BT, q},
                 a.dy, p, PMAX, vec, tid);
  };

  // the row sums of the last dy tile, summed over the 4 warps in order
  // once a barrier has passed
  long long pend_row = -1;  // rowpart offset of the tile pair, or -1
  int pend_tv = 0;          // its valid t
  auto flush_rows = [&]() {
    if (pend_row >= 0 && tid < pend_tv)
      a.rowpart[pend_row + tid] =
          ((red[tid] + red[BT + tid]) + red[2 * BT + tid]) + red[3 * BT + tid];
    pend_row = -1;
  };

  stage_cum(i2_0);
  stage_x(j_of(0), i2_0);
  stage_tile(j_of(0), i2_0, 0);
  hopper::cp_async_commit();
  // cell by cell, and in a cell the pair's s tiles one after the other,
  // so that the second reads the dy and dstate rows the first has just
  // brought into L2
  for (int c = 0; c < cnt; ++c) {
    const int i2 = i2_0 + c;
    const long long cell = i1 * a.g2 + i2;
    for (int jj = 0; jj < nj; ++jj) {
      const int j = j_of(jj), s0 = j * BT;
      const int ntiles = nh + nt - j;
      float dx[32];
      float cum_s[2], w_s[2], colp[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
      bool live_s[2];
      Frags fr;
      for (int k = 0; k < ntiles; ++k) {
        // the task after this one
        int nj_ = jj, nc = c, nk = k + 1;
        bool more = true;
        if (nk == ntiles) {
          nk = 0;
          if (++nj_ == nj) {
            nj_ = 0;
            more = ++nc < cnt;
          }
        }
        hopper::cp_async_wait<0>();
        __syncthreads();  // this tile is in; the last products are done
        flush_rows();
        split_k(yraw, XLD, PMAX, khi, klo, tid);
        split_t(yraw, XLD, thi, tlo, tid);
        if (k == 0 && jj == 0 && warp == 0) scan_warp(cum, q, lane);
        hopper::fence_proxy_async();
        __syncthreads();
        if (more) {  // the next tile's rows run under this tile's work
          stage_tile(j_of(nj_), i2_0 + nc, nk);
          hopper::cp_async_commit();
        }
        if (k == 0) {
          const float last = cum[q - 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int s = s0 + r_lo + 8 * h;
            live_s[h] = s < q;
            cum_s[h] = cum[s];
            w_s[h] = live_s[h] ? expf(last - cum_s[h]) : 0.f;
          }
        }
        // this tile's operands from L2, in flight under the first product:
        // the G^T tile (a dy tile) or B_s's columns (a dstate tile), and
        // the slice sum it adds to
        const int tt = k - nh;
        const int i = j + tt;
        float* sum_tile = k < nh ? dbs + (j * nh + k) * TILE_FLOATS
                                 : dgs + tri(i, j) * TILE_FLOATS;
        float g[32], old[32];
        if (k < nh) {
          const int ncol = n - k * BT;  // B columns left in this tile
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int h = (e >> 1) & 1;
            const int col = 8 * (e >> 2) + 2 * tig + (e & 1);
            g[e] = live_s[h] && col < ncol
                       ? __ldg(bg + (s0 + r_lo + 8 * h) * a.bs.st + k * BT +
                               col)
                       : 0.f;
          }
        } else {
          load_acc(g, gtiles + tri(i, j) * TILE_FLOATS, tid);
        }
        if (c > 0) load_acc(old, sum_tile, tid);

        // first product: xbar_s Y^T (dM^T, or xd for a dstate tile)
        float acc[32];
        frags_natural(fr, xraw, XLD, 0, r_lo, tig);
        issue(acc, fr, khi, klo, 8, true);
        if (k < nh) {
          // a dstate tile (g = B_s's columns): u += rowsum(xd * B), dB's
          // state term w * xd into the slice sum, A of the second product
          // = B_s * w
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int h = (e >> 1) & 1;
            u[h] = fmaf(acc[e], g[e], u[h]);
            acc[e] *= w_s[h];
            g[e] *= w_s[h];
          }
        } else {
          // a dy tile: M^T = G^T * L^T (A of the second product), dG^T =
          // dM^T * L^T into the slice sum, the row and column sums of
          // dM * M
          const int t0 = i * BT;
          const bool diag = i == j;
#pragma unroll
          for (int i4 = 0; i4 < 8; ++i4) {
            const int c0 = 8 * i4 + 2 * tig;
            const float ct[2] = {cum[t0 + c0], cum[t0 + c0 + 1]};
            float rowp[2] = {0.f, 0.f};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1, cc = c0 + (e & 1);
              const int row = r_lo + 8 * h;
              const bool ok = live_s[h] && t0 + cc < q && (!diag || cc >= row);
              const float l = ok ? expf(ct[e & 1] - cum_s[h]) : 0.f;
              const float gv = g[4 * i4 + e];
              const float dg = acc[4 * i4 + e] * l;
              const float dmm = dg * gv;
              colp[h] += dmm;
              rowp[e & 1] += dmm;
              acc[4 * i4 + e] = dg;
              g[4 * i4 + e] = gv * l;
            }
            // row sums over this warp's 16 rows (then the 4 warps)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float r = rowp[e];
              r += __shfl_xor_sync(0xffffffffu, r, 4);
              r += __shfl_xor_sync(0xffffffffu, r, 8);
              r += __shfl_xor_sync(0xffffffffu, r, 16);
              if (lane < 4) red[warp * BT + c0 + e] = r;
            }
          }
          pend_row = (cell * a.ntri + tri(i, j)) * BT;
          pend_tv = min(BT, q - t0);
        }
        if (c > 0) {
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[e] += old[e];
        }
        store_acc(sum_tile, acc, tid);
        frags_acc(fr, g);
        if (more && nk == 0) {  // the next xbar_s, and the next cell's loga
          __syncthreads();  // every read of xraw and cum is done
          stage_x(j_of(nj_), i2_0 + nc);
          if (nj_ == 0) stage_cum(i2_0 + nc);
          hopper::cp_async_commit();
        }
        // second product: dxbar_s (+)= A Y (Y transposed)
        issue(dx, fr, thi, tlo, 8, k == 0);
      }
      // dxbar_s of the cell, in xbar's layout
      float* dxo = a.dxbar + i1 * a.dxs.s1 + i2 * a.dxs.s2;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int s = s0 + r_lo + 8 * ((e >> 1) & 1);
        const int col = 8 * (e >> 2) + 2 * tig + (e & 1);
        if (s < q && col < p) dxo[s * a.dxs.st + col] = dx[e];
      }
      // the column sums of dM * M and w u of the s rows, over the quad:
      // -colsum - w u goes where dloga will be (ssd_bwd_dloga reads it
      // back first), and sum(w u) over the warp's rows to wupart
      float wus = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cs = colp[h], uu = u[h];
        cs += __shfl_xor_sync(0xffffffffu, cs, 1);
        cs += __shfl_xor_sync(0xffffffffu, cs, 2);
        uu += __shfl_xor_sync(0xffffffffu, uu, 1);
        uu += __shfl_xor_sync(0xffffffffu, uu, 2);
        const int s = s0 + r_lo + 8 * h;
        const float wu = w_s[h] * uu;  // 0 past q
        wus += wu;
        if (tig == 0 && s < q) a.dloga[cell * q + s] = -cs - wu;
      }
      wus += __shfl_xor_sync(0xffffffffu, wus, 4);
      wus += __shfl_xor_sync(0xffffffffu, wus, 8);
      wus += __shfl_xor_sync(0xffffffffu, wus, 16);
      if (lane == 0) a.wupart[(cell * nt + j) * 4 + warp] = wus;
    }
  }
  __syncthreads();
  flush_rows();
}

// Finishing pass, one block a (group, tile k): dB of s tile k = the slice
// sums of w * xd + sum over t tiles i >= k of dG^T[k, i] C_i, and dC of t
// tile k = sum over s tiles jj <= k of dG[k, jj] B_jj, dG summed over the
// slices first; every sum in order.
__global__ void __launch_bounds__(WG, 1) ssd_bwd_bc(Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = hopper::aligned_smem(smem_raw);
  uint8_t* thi[2] = {base, base + 4 * SLAB};
  uint8_t* tlo[2] = {base + 2 * SLAB, base + 6 * SLAB};
  float* raw = reinterpret_cast<float*>(base + 8 * SLAB);
  float* graw = raw + BT * NLD;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r_lo = 16 * warp + (lane >> 2), tig = lane & 3;
  const int q = a.q, n = a.n, nt = a.nt, nh = a.nh;
  const long long grp = blockIdx.x / nt;
  const int k = static_cast<int>(blockIdx.x - grp * nt);
  long long i1;
  int i2;
  group_cell(a, grp, i1, i2);
  const float* bg = a.B + i1 * a.bs.s1 + i2 * a.bs.s2;
  const float* cg = a.C + i1 * a.cs.s1 + i2 * a.cs.s2;
  const float* dgs = a.dgs + grp * a.ns * a.ntri * TILE_FLOATS;
  const float* dbs = a.dbs + grp * a.ns * nt * nh * TILE_FLOATS;
  const long long dg_stride = static_cast<long long>(a.ntri) * TILE_FLOATS;
  const long long db_stride = static_cast<long long>(nt) * nh * TILE_FLOATS;
  float acc[2][32];
  float g[32];
  Frags fr;

  auto store_out = [&](float* out, int r0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= nh) break;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = r0 + r_lo + 8 * ((e >> 1) & 1);
        const int col = BT * h + 8 * (e >> 2) + 2 * tig + (e & 1);
        if (r < q && col < n) out[(grp * q + r) * n + col] = acc[h][e];
      }
    }
  };
  // raw (64 rows of an n-wide operand) -> its transposed 64-row halves
  auto split_halves = [&]() {
    for (int h = 0; h < nh; ++h)
      split_t(raw + BT * h, NLD, thi[h], tlo[h], tid);
    hopper::fence_proxy_async();
  };

  // dB of s tile k
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (h < nh) sum_slices(acc[h], dbs + (k * nh + h) * TILE_FLOATS,
                           db_stride, a.ns, tid);
  for (int i = k; i < nt; ++i) {
    __syncthreads();  // the last products' reads are done
    stage_rows(raw, NLD, Rows{cg, a.cs.st, i * BT, q}, a.C, n, BT * nh,
               a.vec, tid);
    hopper::cp_async_commit();
    sum_slices(g, dgs + tri(i, k) * TILE_FLOATS, dg_stride, a.ns, tid);
    frags_acc(fr, g);
    hopper::cp_async_wait<0>();
    __syncthreads();
    split_halves();
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < nh) issue(acc[h], fr, thi[h], tlo[h], 8, false);
  }
  store_out(a.dB, k * BT);

  // dC of t tile k
  for (int jj = 0; jj <= k; ++jj) {
    __syncthreads();
    stage_rows(raw, NLD, Rows{bg, a.bs.st, jj * BT, q}, a.B, n, BT * nh,
               a.vec, tid);
    hopper::cp_async_commit();
    // dG^T[s, t] (accumulator layout) -> graw[t][s]
    sum_slices(g, dgs + tri(k, jj) * TILE_FLOATS, dg_stride, a.ns, tid);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int s = r_lo + 8 * ((e >> 1) & 1);
      const int t = 8 * (e >> 2) + 2 * tig + (e & 1);
      graw[t * GLD + s] = g[e];
    }
    hopper::cp_async_wait<0>();
    __syncthreads();
    split_halves();
    __syncthreads();
    // A = dG rows t, K = s in split_t's order: columns 8 kk + 2 (l % 4)
    // and + 1 in slots 0 and 2 (rows r), 1 and 3 (rows r + 8)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float2 v0 = *reinterpret_cast<const float2*>(
          graw + r_lo * GLD + 8 * kk + 2 * tig);
      const float2 v1 = *reinterpret_cast<const float2*>(
          graw + (r_lo + 8) * GLD + 8 * kk + 2 * tig);
      frag_split(fr, kk, 0, v0.x);
      frag_split(fr, kk, 2, v0.y);
      frag_split(fr, kk, 1, v1.x);
      frag_split(fr, kk, 3, v1.y);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < nh) issue(acc[h], fr, thi[h], tlo[h], 8, jj == 0);
  }
  store_out(a.dC, k * BT);
}

// dloga, one warp a cell: dcum[t] = -colsum - w u (left in dloga by the
// cell kernel) + the row sums of the s tiles j <= t / 64 (in j order),
// plus sum(w u) at t = q - 1 (its parts in (s tile, warp) order); then the
// reverse scan, written over its input.
__global__ void __launch_bounds__(128) ssd_bwd_dloga(Args a) {
  __shared__ float buf[4][NT_MAX * BT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cell = blockIdx.x * 4LL + warp;
  if (cell >= static_cast<long long>(a.g1) * a.g2) return;
  const int q = a.q;
  const float* rp = a.rowpart + cell * a.ntri * BT;
  float tot = 0.f;
  for (int e = 0; e < a.nt * 4; ++e) tot += a.wupart[cell * a.nt * 4 + e];
  float* d = buf[warp];
  for (int t = lane; t < q; t += 32) {
    const int i = t / BT, tl = t - i * BT;
    float v = a.dloga[cell * q + t];
    for (int jj = 0; jj <= i; ++jj) v += rp[tri(i, jj) * BT + tl];
    if (t == q - 1) v += tot;
    d[t] = v;
  }
  __syncwarp();
  rev_scan_warp(d, q, lane);
  __syncwarp();
  for (int t = lane; t < q; t += 32) a.dloga[cell * q + t] = d[t];
}

// A call's geometry and scratch (floats from the scratch base).
struct Plan {
  long long cells, groups;
  int nt, ntri, nh, npairs, ns, hs, occ;
  long long gt, dgs, dbs, rowpart, wupart, total;
};

// The slices: the fewest whose waves (of sms x occ blocks) x (cells a
// slice + 1) is least.
cudaError_t make_plan(int g1, int g2, int q, int n, int shared, int device,
                      Plan* pl) {
  pl->nt = (q + BT - 1) / BT;
  pl->ntri = pl->nt * (pl->nt + 1) / 2;
  pl->nh = (n + BT - 1) / BT;
  pl->npairs = (pl->nt + 1) / 2;
  pl->cells = static_cast<long long>(g1) * g2;
  pl->groups = shared ? g1 : pl->cells;
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_bwd_cells, cudaFuncAttributeMaxDynamicSharedMemorySize, SM_CELLS);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl->occ, ssd_bwd_cells,
                                                      WG, SM_CELLS);
  if (err != cudaSuccess) return err;
  const long long slots =
      static_cast<long long>(sms) * (pl->occ > 0 ? pl->occ : 1);
  pl->ns = 1;
  pl->hs = 1;
  if (shared && g2 > 0) {
    long long best = -1;
    const int top = g2 < 4096 ? g2 : 4096;
    for (int ns = 1; ns <= top; ++ns) {
      const int hs = (g2 + ns - 1) / ns;
      const int nse = (g2 + hs - 1) / hs;
      if (nse != ns) continue;  // the same slices as a smaller count
      const long long blocks = pl->groups * ns * pl->npairs;
      const long long cost = (blocks + slots - 1) / slots * (hs + 1);
      if (best < 0 || cost < best) {
        best = cost;
        pl->ns = ns;
        pl->hs = hs;
      }
    }
  }
  const long long tile = TILE_FLOATS;
  long long off = 0;
  pl->gt = off;
  off += pl->groups * pl->ntri * tile;
  pl->dgs = off;
  off += pl->groups * pl->ns * pl->ntri * tile;
  pl->dbs = off;
  off += pl->groups * pl->ns * pl->nt * pl->nh * tile;
  pl->rowpart = off;
  off += pl->cells * pl->ntri * BT;
  pl->wupart = off;
  off += pl->cells * pl->nt * 4;
  pl->total = off;
  return cudaSuccess;
}

template <class K>
cudaError_t launch(K kern, long long blocks, int smem, const Args& a,
                   cudaStream_t stream) {
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<static_cast<unsigned>(blocks), WG, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.
//
// ssd_bwd_plan: the f32 scratch floats of a call for g1 x g2 cells of chunk
// q and state n on `device` (the head slices follow its SM count); `shared`
// is 1 when B and C are shared by the g2 cells of each i1. -1 on a CUDA
// error.
extern "C" long long ssd_bwd_plan(int g1, int g2, int q, int n, int shared,
                                  int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  Plan pl;
  if (make_plan(g1, g2, q, n, shared, device, &pl) != cudaSuccess) return -1;
  return pl.total;
}

// ssd_bwd_describe: the design as launched for these cells, into out[9]:
// cell-kernel blocks, slices a group, cells a slice, its shared memory
// bytes, its blocks an SM, its registers a thread, its local (spill) bytes,
// the blocks of ssd_bwd_bc and of ssd_bwd_gram. Returns the cudaError_t.
extern "C" int ssd_bwd_describe(int g1, int g2, int q, int n, int shared,
                                int device, long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan pl;
  err = make_plan(g1, g2, q, n, shared, device, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, ssd_bwd_cells);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = pl.groups * pl.ns * pl.npairs;
  out[1] = pl.ns;
  out[2] = pl.hs;
  out[3] = SM_CELLS;
  out[4] = pl.occ;
  out[5] = fa.numRegs;
  out[6] = static_cast<long long>(fa.localSizeBytes);
  out[7] = pl.groups * pl.nt;
  out[8] = pl.groups * pl.ntri;
  return 0;
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
  Plan pl;
  err = make_plan(g1, g2, q, n, shared, device, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  float* sc = static_cast<float*>(scratch);
  a.gt = sc + pl.gt;
  a.dgs = sc + pl.dgs;
  a.dbs = sc + pl.dbs;
  a.rowpart = sc + pl.rowpart;
  a.wupart = sc + pl.wupart;
  a.g1 = g1;
  a.g2 = g2;
  a.q = q;
  a.p = p;
  a.n = n;
  a.nt = pl.nt;
  a.ntri = pl.ntri;
  a.nh = pl.nh;
  a.npairs = pl.npairs;
  a.shared = shared ? 1 : 0;
  a.ns = pl.ns;
  a.hs = pl.hs;
  a.xs = Strides{xs1, xs2, xst};
  a.ls = Strides{ls1, ls2, lst};
  a.bs = Strides{bs1, shared ? 0 : bs2, bst};
  a.cs = Strides{cs1, shared ? 0 : cs2, cst};
  a.ys = Strides{ys1, ys2, yst};
  a.ds = Strides{ds1, ds2, dst};
  a.dxs = Strides{dxs1, dxs2, dxst};
  bool vec = true;
  for (const void* ptr : {xbar, B, C, dy, dstate})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long s : {xs1, xs2, xst, bs1, a.bs.s2, bst, cs1, a.cs.s2, cst,
                      ys1, ys2, yst, ds1, ds2, dst})
    vec = vec && s % 4 == 0;
  a.vec = vec ? 1 : 0;

  err = launch(ssd_bwd_gram, pl.groups * pl.ntri, SM_GRAM, a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(ssd_bwd_cells, pl.groups * pl.ns * pl.npairs, SM_CELLS, a,
               stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch(ssd_bwd_bc, pl.groups * pl.nt, SM_BC, a, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch(ssd_bwd_dloga, (cells + 3) / 4, 0, a, stream));
}

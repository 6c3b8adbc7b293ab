// Blocked-scan center precheck (K3) for Hopper (sm_90a): one clustered
// launch a call, no global scratch.
//
// Replaces the TPU kernel repro/kernels/precheck.py (center_precheck_stats,
// body _precheck_kernel). For a block of B points x (B, d), a center buffer
// c (T, d) and its valid mask, it computes the f32 matmul-form distances
// d[r, t] = sqrt(max(||x_r||^2 + ||c_t||^2 - 2 x_r . c_t, 0)), with invalid
// centers at float32 max, and reduces each row to (dmin, z, second, z2,
// third): the three smallest distances and the first columns attaining the
// two smallest, exactly as repro/kernels/ref.py:_nearest_stats does.
//
// Two epilogues, one template flag:
//  (a) stats: the five (B,) outputs above, the TPU kernel's function
//      (ops.center_precheck adds the error margin in torch);
//  (b) fused: the device half of the reference's _block_precheck
//      (repro/core/streaming.py), which XLA fuses around the Pallas call:
//      the _pdist_e2 margin of each row, the exact difference-form
//      distances of the two candidate centers (and, for the diameter
//      variant, of the first stream point x1), and the replay flag of
//      repro_torch/kernels/ref.py:block_precheck. Output: one (2, B) int32
//      tensor, z then the flag (0 or 1).
//
// Bound on an H100: bytes, and far below a launch. At the streaming main
// path's shape (B, T, d) = (128, 65, 5000) with every center valid, the
// products are 2 B T d = 83 MFLOP against 3.9 MB of operands; songs-sim
// keeps 3 of the 65 slots valid, and then x (2.6 MB, 0.8 us at 3.35 TB/s)
// is the work. The scan calls it once a block, so what it costs the pass
// is one launch and the latency of a few dependent steps, not FLOPs: the
// design keeps those steps few (two cluster barriers) and keeps every
// step's loads in flight together.
//
// Products stay in IEEE f32 FFMA (no TF32, no wgmma): the scan's error
// margin (repro_torch/kernels/ops.py:_pdist_e2, 1e-5 x the operand norms)
// assumes full f32 products.
//
// Design. A thread-block cluster per 16-row tile of x, along d: grid
// (S, ceil(B / 16)), cluster (S, 1, 1), S <= 16 blocks (non-portable above
// 8). At most 128 registers a thread and 112 KB of shared memory a block
// keep two blocks an SM, so the main path's eight clusters of 16 run in
// one wave on 128 SMs. Block `rank` of a cluster owns d columns
// [rank * chunk, (rank + 1) * chunk) (empty past d: it contributes zeros).
//  1. Every block compacts the valid centers into a list in shared memory
//     (ascending, so the first-index rule survives) and keeps the first
//     three invalid columns: with fewer than three valid centers those are
//     the float32-max entries of _nearest_stats. Invalid centers are never
//     read, so the work follows the valid count.
//  2. Panels of up to 127 valid centers (and, fused with the diameter
//     variant, x1 as one more column of the first panel). Each block
//     streams its chunk of the 16 x rows and of the panel's columns, 32 d
//     columns a stage, through cp.async copies (16 bytes where d % 4 == 0,
//     else 4; zero-filled past d and B) into the two halves of a ring, a
//     round of stages a half, one group a round; the stages are as wide as
//     the panel, so with few valid centers the whole chunk is one round.
//     A lane keeps a 2- or 4-row x 4-column tile of dot products and,
//     fused, of exact sums of (x - c)^2, plus ||x||^2 and ||c||^2 from the
//     same tiles; a warp's lanes split between columns and d (with few
//     centers they spread over d instead of idling), and a fixed xor tree
//     sums the d lanes (see panel_loop). The exact sums are taken per
//     stage, then across stages, then over the tree: chains of at most
//     32 + chunk / 32 terms, then S, far inside the scan's 2^-16 band. The
//     dots and norms run on, at most chunk / 2 terms, which the matmul
//     form's margin covers (the split-d kernel this one replaced summed
//     whole chunks serially).
//     Partials go to the block's own shared memory, into the ring.
//  3. cluster.sync(); in one round over DSMEM (cluster.map_shared_rank,
//     the S loads in flight together), every block sums, in rank order,
//     its 1/S share of the (row, column) pairs with the two norms each
//     needs, forms the matmul-form distance and stores it, with the exact
//     sum, in the leader's (rank 0) ring; the leader also keeps the norm
//     totals. Fixed orders, no float atomics: two calls are bit-identical.
//  4. cluster.sync(); the leader runs the lexicographic (value, column)
//     top-3 of the old kernel, carrying each entry's exact sum: one warp a
//     row, lanes over the panel's columns, merged by xor shuffles, then
//     into the row's running top-3 across panels; the first invalid
//     columns join at float32 max. After the last panel it writes the
//     stats, or forms the margin and the flag and writes (z, flag). No
//     block reads another's shared memory after the second barrier, so
//     the others may leave; a later panel opens with a block barrier, as
//     the leader's distance tiles live in the ring its stages refill.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BR = 16;            // rows of x a cluster
constexpr int THREADS = 256;      // 8 warps, two rows each
constexpr int NC_MAX = 4;         // columns a lane, per panel
constexpr int PANEL = 32 * NC_MAX - 1;  // valid centers a panel (+ x1)
constexpr int BK = 32;            // d columns a ring stage
constexpr int XS = BK + 4;        // stage row stride, words
constexpr int MAX_SPLIT = 16;     // blocks a cluster
constexpr int RING_MAX = 104 * 1024 / 4;   // words
constexpr int SMEM_PAIR = 112 * 1024 / 4;  // words a block, two an SM
constexpr int SMEM_MAX = 232448 / 4;       // words a block can have
constexpr int STAGE_MAX = XS * (BR + PANEL + 1);
constexpr float SLACK = 1.0f / 65536.0f;   // ref.SLACK, 2^-16

static_assert(THREADS / 32 * 2 == BR, "two rows a warp");

// Shared-memory layout, in 4-byte words; the same on host and device. The
// ring comes first (16-byte aligned) and takes up to RING_MAX of what the
// rest leaves of SMEM_PAIR (two blocks an SM), or, for a very long center
// list, of SMEM_MAX; ok is false when not even two of the widest stages
// fit. The partial tiles (dotp, exp) and the leader's tiles (dist, ex) live
// inside the ring: they are written after a panel's last stage is read, and
// a block barrier at the top of every later panel keeps the next panel's
// first stage from landing on them while the leader's warps still read.
struct Layout {
  int ring_words, dotp, exp, dist, ex, xnp, cnp, xnt, cnt, misc, list, words;
  bool ok;
};

__host__ __device__ inline Layout layout(int T) {
  const int pws = (T < PANEL ? T : PANEL) + 1;  // columns a panel, + x1
  const int need = 2 * STAGE_MAX > 4 * BR * pws ? 2 * STAGE_MAX : 4 * BR * pws;
  Layout L;
  const int fixed = 2 * BR + 2 * pws + 24 + T;
  const int room = SMEM_PAIR - fixed >= need ? SMEM_PAIR - fixed
                                              : SMEM_MAX - fixed;
  L.ring_words = room < RING_MAX ? room : RING_MAX;
  L.ring_words -= L.ring_words % 4;
  L.ok = L.ring_words >= need;
  L.dotp = 0;                  // BR x pws partial dots
  L.exp = L.dotp + BR * pws;   // BR x pws partial exact sums
  L.dist = L.exp + BR * pws;   // BR x pws distances (leader)
  L.ex = L.dist + BR * pws;    // BR x pws exact sums (leader)
  L.xnp = L.ring_words;        // BR partial ||x||^2
  L.cnp = L.xnp + BR;          // pws partial ||c||^2
  L.xnt = L.cnp + pws;         // BR total ||x||^2
  L.cnt = L.xnt + BR;          // pws total ||c||^2
  L.misc = L.cnt + pws;        // 24: -, -, ninv, inv[3], -, -, counts
  L.list = L.misc + 24;        // T valid center indices
  L.words = L.list + T;
  return L;
}

struct Args {
  const float* x;         // (B, d)
  const float* c;         // (T, d)
  const uint8_t* valid;   // (T,)
  const float* x1;        // (d,) or null (radius variant, and stats)
  int B, T, d, chunk;
  float thr, slack_thr, r2, slack_r2;  // fused route's thresholds
  float* dmin;  // stats route: five (B,) outputs
  int* z;
  float* second;
  int* z2;
  float* third;
  int* out;     // fused route: (2, B) int32, z then the flag
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 or 16 bytes global -> shared; zeros (nothing read) if !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The sum of one word of every cluster block's shared memory, in rank
// order, with the S loads in flight together.
__device__ __forceinline__ float sum_over_cluster(cg::cluster_group& cluster,
                                                  float* word, int S) {
  float v[MAX_SPLIT];
#pragma unroll
  for (int k = 0; k < MAX_SPLIT; ++k)
    v[k] = k < S ? *cluster.map_shared_rank(word, k) : 0.f;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_SPLIT; ++k)
    if (k < S) s += v[k];
  return s;
}

// Running top-3 in lexicographic (value, column) order; e rides along (the
// exact sum of a valid center, -1 for an invalid column or the sentinel).
struct Top3 {
  float v[3];
  int c[3];
  float e[3];
};

__device__ __forceinline__ bool lex_less(float va, int ca, float vb, int cb) {
  return va < vb || (va == vb && ca < cb);
}

__device__ __forceinline__ void insert(Top3& t, float v, int c, float e) {
  if (!lex_less(v, c, t.v[2], t.c[2])) return;
  if (lex_less(v, c, t.v[1], t.c[1])) {
    t.v[2] = t.v[1];
    t.c[2] = t.c[1];
    t.e[2] = t.e[1];
    if (lex_less(v, c, t.v[0], t.c[0])) {
      t.v[1] = t.v[0];
      t.c[1] = t.c[0];
      t.e[1] = t.e[0];
      t.v[0] = v;
      t.c[0] = c;
      t.e[0] = e;
    } else {
      t.v[1] = v;
      t.c[1] = c;
      t.e[1] = e;
    }
  } else {
    t.v[2] = v;
    t.c[2] = c;
    t.e[2] = e;
  }
}

// (+inf, T) is a sentinel below every real entry: real distances are at
// most float32 max.
__device__ __forceinline__ Top3 sentinel(int T) {
  Top3 t;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t.v[i] = __int_as_float(0x7f800000);
    t.c[i] = T;
    t.e[i] = -1.f;
  }
  return t;
}

// The valid centers' indices, ascending, into `list`; the first three
// invalid columns into misc[3..5]. Every thread of the block calls it and
// gets the valid count; misc[2] is the invalid count (capped at 3).
__device__ int compact(const uint8_t* __restrict__ valid, int T, int* list,
                       int* misc) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int* wcnt = misc + 8;  // [0, 8): valid a warp; [8, 16): invalid a warp
  int nv = 0, ni = 0;
  for (int b = 0; b < T; b += THREADS) {
    const int t = b + tid;
    const bool in = t < T;
    const bool v = in && valid[t] != 0;
    const unsigned mv = __ballot_sync(0xffffffffu, v);
    const unsigned mi = __ballot_sync(0xffffffffu, in && !v);
    if (lane == 0) {
      wcnt[warp] = __popc(mv);
      wcnt[8 + warp] = __popc(mi);
    }
    __syncthreads();
    int pv = nv, pi = ni, tv = nv, ti = ni;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      if (w < warp) {
        pv += wcnt[w];
        pi += wcnt[8 + w];
      }
      tv += wcnt[w];
      ti += wcnt[8 + w];
    }
    const unsigned lt = (1u << lane) - 1u;
    if (v) list[pv + __popc(mv & lt)] = t;
    if (in && !v) {
      const int k = pi + __popc(mi & lt);
      if (k < 3) misc[3 + k] = t;
    }
    nv = tv;
    ni = ti;
    __syncthreads();  // wcnt is reused
  }
  if (tid == 0) misc[2] = ni < 3 ? ni : 3;
  __syncthreads();
  return nv;
}

// Loads `n` floats (1, 2 or 4) of shared memory at p into v.
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// One panel over this block's chunk: columns [0, pw) are the valid centers
// list[t0, t0 + pw), column pw (if has_x1) is x1. Partial dots into dotp,
// partial exact sums into exs (FUSED), partial ||c||^2 into cnp, and, if
// want_xn, partial ||x||^2 into xnp; dotp and exs are BR x pws.
//
// A stage holds the chunk's next 32 d columns of the 16 x rows and of the
// pwl columns, row-major with a 36-word row stride (16-byte rows, and the
// 16-byte reads of 8 lanes hit 8 distinct bank groups). A lane keeps an
// RW-row x NC_MAX-column tile: RW = 2 (each warp its own 2 rows) up to
// 32 columns, RW = 4 (warp pairs share 4 rows and split the columns)
// above, so that a center value read feeds 4 rows. Within a warp, lane l
// takes columns cl + CL (h + RW / 2 j), h the warp's half of the pair and
// cl = l % CL, and the CL consecutive d
// columns (l / CL) * CL .. of each stage: CL is the smallest power of two
// that covers the panel, so with few columns (songs-sim keeps 3 centers)
// the lanes spread over d instead of idling, and a fixed xor tree over
// them sums the d lanes at the end.
template <int CL, int RW, bool FUSED>
__device__ void panel_loop(const Args& a, const int* list, int t0, int pw,
                           bool has_x1, int pws, int row0, int k_begin,
                           int k_end, bool want_xn, bool vec, float* ring,
                           int ring_words, float* dotp, float* exs,
                           float* xnp, float* cnp) {
  constexpr int V = CL < 4 ? CL : 4;   // floats a shared-memory read
  constexpr int CH = RW / 2;           // warps that share a row group
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = warp / CH, ch = warp % CH;  // row group, column half
  const int cl = lane % CL, kk0 = (lane / CL) * CL;
  const int pwl = pw + (has_x1 ? 1 : 0);  // columns loaded
  const int rows = BR + pwl;              // rows of a stage
  const int stage = XS * rows;            // words; a multiple of 4
  const int nsteps = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  // double-buffered rounds: the ring's two halves take R stages each, one
  // cp.async group a round (songs-sim's whole chunk is one round)
  const int R = max(1, min(ring_words / stage / 2, nsteps));
  const int rounds = (nsteps + R - 1) / R;

  float dot[RW][NC_MAX], ex[RW][NC_MAX], cn[NC_MAX], xn[RW];
#pragma unroll
  for (int j = 0; j < NC_MAX; ++j) {
    cn[j] = 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r) dot[r][j] = ex[r][j] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < RW; ++r) xn[r] = 0.f;
  int col[NC_MAX];
  bool has[NC_MAX];
#pragma unroll
  for (int j = 0; j < NC_MAX; ++j) {
    col[j] = cl + CL * (ch + CH * j);  // a warp's lanes: adjacent columns
    has[j] = col[j] < pwl;
  }

  // the source row of stage row i: x rows, then the panel's columns
  auto src_row = [&](int i) -> const float* {
    if (i < BR) return a.x + static_cast<size_t>(row0 + i) * a.d;
    return i - BR < pw ? a.c + static_cast<size_t>(list[t0 + i - BR]) * a.d
                       : a.x1;
  };
  // round r: each thread takes the same stage rows and column offsets in
  // every stage of the round, so their addresses are formed once
  auto issue = [&](int r) {
    const int s0 = r * R, s1 = min(nsteps, s0 + R);
    const int per = vec ? 4 : 1, n = rows * (BK / per);
    for (int idx = tid; idx < n; idx += THREADS) {
      const int i = idx / (BK / per), kk = per * (idx % (BK / per));
      const bool row_ok = i >= BR || row0 + i < a.B;
      const float* src = row_ok ? src_row(i) + k_begin + kk : a.c;
      float* dst = ring + i * XS + kk;
      for (int s = s0; s < s1; ++s) {
        const bool ok = row_ok && k_begin + s * BK + kk < k_end;
        float* st = dst + (s / R % 2 * R + s % R) * stage;
        // 16 bytes where d % 4 == 0: no copy straddles k_end
        if (vec)
          cp_async16(st, ok ? src + s * BK : a.c, ok);
        else
          cp_async4(st, ok ? src + s * BK : a.c, ok);
      }
    }
    cp_async_commit();
  };
  if (rounds > 0) issue(0);
  for (int s = 0; s < nsteps; ++s) {
    if (s % R == 0) {  // a new round: start the next one, wait for this one
      if (s / R + 1 < rounds) {
        issue(s / R + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    const float* st = ring + ((s / R) % 2 * R + s % R) * stage;
    const float* xs = st + rg * RW * XS + kk0;
    const float* cs = st + BR * XS + kk0;
    // the exact sums of this stage are taken apart and added to the
    // running ones below (chains of CL + nsteps terms, far inside the
    // scan's 2^-16 band); dots and norms run on (CL nsteps terms, the
    // margin's business)
    float ex_s[RW][NC_MAX];
#pragma unroll
    for (int j = 0; j < NC_MAX; ++j)
#pragma unroll
      for (int r = 0; r < RW; ++r) ex_s[r][j] = 0.f;
#pragma unroll
    for (int u = 0; u < CL; u += V) {
      float xv[RW][V];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        lds<V>(xs + r * XS + u, xv[r]);
        if (ch == 0) {
#pragma unroll
          for (int e = 0; e < V; ++e) xn[r] = fmaf(xv[r][e], xv[r][e], xn[r]);
        }
      }
#pragma unroll
      for (int j = 0; j < NC_MAX; ++j) {
        if (!has[j]) continue;
        float cv[V];
        lds<V>(cs + col[j] * XS + u, cv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            dot[r][j] = fmaf(xv[r][e], cv[e], dot[r][j]);
            if (FUSED) {
              const float df = xv[r][e] - cv[e];
              ex_s[r][j] = fmaf(df, df, ex_s[r][j]);
            }
          }
          if (rg == 0) cn[j] = fmaf(cv[e], cv[e], cn[j]);
        }
      }
    }
    if (FUSED) {
#pragma unroll
      for (int j = 0; j < NC_MAX; ++j)
#pragma unroll
        for (int r = 0; r < RW; ++r) ex[r][j] += ex_s[r][j];
    }
    // a round's half is refilled two rounds on, once every warp is done
    // with it (and the partial tiles below overwrite the ring)
    if (s % R == R - 1 || s == nsteps - 1) __syncthreads();
  }

  // the lanes along d, summed by a fixed xor tree
#pragma unroll
  for (int off = CL; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < NC_MAX; ++j) {
      cn[j] += __shfl_xor_sync(0xffffffffu, cn[j], off);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        dot[r][j] += __shfl_xor_sync(0xffffffffu, dot[r][j], off);
        if (FUSED) ex[r][j] += __shfl_xor_sync(0xffffffffu, ex[r][j], off);
      }
    }
#pragma unroll
    for (int r = 0; r < RW; ++r)
      xn[r] += __shfl_xor_sync(0xffffffffu, xn[r], off);
  }
  if (lane >= CL) return;  // the lanes of the first d slice hold the sums
#pragma unroll
  for (int j = 0; j < NC_MAX; ++j) {
    if (!has[j]) continue;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      dotp[(rg * RW + r) * pws + col[j]] = dot[r][j];
      if (FUSED) exs[(rg * RW + r) * pws + col[j]] = ex[r][j];
    }
    if (rg == 0) cnp[col[j]] = cn[j];
  }
  if (want_xn && ch == 0 && lane == 0) {
#pragma unroll
    for (int r = 0; r < RW; ++r) xnp[rg * RW + r] = xn[r];
  }
}

template <bool FUSED>
__global__ void __launch_bounds__(THREADS, 2) precheck_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(a.T);
  const int pws = (a.T < PANEL ? a.T : PANEL) + 1;
  float* ring = smem;
  float* dotp = smem + L.dotp;
  float* exs = smem + L.exp;
  float* dist = smem + L.dist;
  float* ex = smem + L.ex;
  float* xnp = smem + L.xnp;
  float* cnp = smem + L.cnp;
  float* xnt = smem + L.xnt;
  float* cnt = smem + L.cnt;
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  int* list = reinterpret_cast<int*>(smem + L.list);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.y * BR;
  const int k_begin = rank * a.chunk;
  const int k_end = min(a.d, k_begin + a.chunk);
  const bool diameter = FUSED && a.x1 != nullptr;
  // 16-byte copies need 16-byte rows: d % 4 == 0 and aligned bases
  const bool vec = a.d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.x) |
                     reinterpret_cast<uintptr_t>(a.c) |
                     reinterpret_cast<uintptr_t>(a.x1)) % 16) == 0;

  const int nvalid = compact(a.valid, a.T, list, misc);
  const int npanels = nvalid > 0 ? (nvalid + PANEL - 1) / PANEL : 1;

  Top3 run[2] = {sentinel(a.T), sentinel(a.T)};  // leader: rows warp, warp + 8
  float d1sq[2] = {0.f, 0.f};  // leader, diameter: sum of (x - x1)^2
  float maxcn = 0.f;  // leader, fused: the largest valid ||c||^2 so far
  for (int p = 0; p < npanels; ++p) {
    // the leader's warps have read the last panel's distances, which live
    // in the ring that this panel's first stage overwrites
    if (p > 0) __syncthreads();
    const int t0 = p * PANEL;
    const int pw = min(PANEL, nvalid - t0);  // 0 with no valid center
    const bool has_x1 = diameter && p == 0;
    const int pwl = pw + (has_x1 ? 1 : 0);
    const bool want_xn = p == 0;
#define PRECHECK_PANEL(CL, RW)                                    \
  panel_loop<CL, RW, FUSED>(a, list, t0, pw, has_x1, pws, row0, k_begin, \
                            k_end, want_xn, vec, ring, L.ring_words, dotp, \
                            exs, xnp, cnp)
    if (pwl <= NC_MAX)
      PRECHECK_PANEL(1, 2);
    else if (pwl <= 2 * NC_MAX)
      PRECHECK_PANEL(2, 2);
    else if (pwl <= 4 * NC_MAX)
      PRECHECK_PANEL(4, 2);
    else if (pwl <= 8 * NC_MAX)
      PRECHECK_PANEL(8, 2);
    else if (pwl <= 16 * NC_MAX)
      PRECHECK_PANEL(8, 4);
    else
      PRECHECK_PANEL(16, 4);
#undef PRECHECK_PANEL
    cluster.sync();  // every block's partials of this panel are in place

    // one round over DSMEM, every sum in rank order: this block's share of
    // the (row, column) pairs, with the two norms each needs, into the
    // leader; the leader also keeps the row norms (for the margin) and
    // the column norms (for the largest valid one)
    const int P = BR * pwl, per = (P + S - 1) / S;
    const int q1 = min(P, (rank + 1) * per);
    float* dist0 = cluster.map_shared_rank(dist, 0);
    float* ex0 = cluster.map_shared_rank(ex, 0);
    for (int q = rank * per + tid; q < q1; q += THREADS) {
      const int r = q / pwl, t = q % pwl, i = r * pws + t;
      if (t < pw) {
        const float s = sum_over_cluster(cluster, dotp + i, S);
        const float xr = sum_over_cluster(cluster, xnp + r, S);
        const float ct = sum_over_cluster(cluster, cnp + t, S);
        dist0[i] = sqrtf(fmaxf(xr + ct - 2.f * s, 0.f));
      }
      if (FUSED) ex0[i] = sum_over_cluster(cluster, exs + i, S);
    }
    if (rank == 0) {
      const int nx = want_xn ? BR : 0;
      for (int q = tid; q < nx + pw; q += THREADS) {
        if (q < nx)
          xnt[q] = sum_over_cluster(cluster, xnp + q, S);
        else
          cnt[q - nx] = sum_over_cluster(cluster, cnp + q - nx, S);
      }
    }
    cluster.sync();  // the leader holds the panel's distances

    if (rank == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp + 8 * h;
        Top3 top = sentinel(a.T);
        for (int t = lane; t < pw; t += 32)
          insert(top, dist[r * pws + t], list[t0 + t],
                 FUSED ? ex[r * pws + t] : 0.f);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          Top3 o;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            o.v[i] = __shfl_xor_sync(0xffffffffu, top.v[i], off);
            o.c[i] = __shfl_xor_sync(0xffffffffu, top.c[i], off);
            o.e[i] = __shfl_xor_sync(0xffffffffu, top.e[i], off);
          }
#pragma unroll
          for (int i = 0; i < 3; ++i) insert(top, o.v[i], o.c[i], o.e[i]);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
          insert(run[h], top.v[i], top.c[i], top.e[i]);
        if (has_x1) d1sq[h] = ex[r * pws + pw];
      }
      if (FUSED) {  // every warp: the largest valid ||c||^2, for the margin
        float m = 0.f;
        for (int t = lane; t < pw; t += 32) m = fmaxf(m, cnt[t]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        maxcn = fmaxf(maxcn, m);
      }
    }
  }
  if (rank != 0 || lane != 0) return;  // no more shared memory across blocks

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp + 8 * h, gr = row0 + r;
    if (gr >= a.B) continue;
    Top3& t = run[h];
    for (int i = 0; i < misc[2]; ++i) insert(t, FLT_MAX, misc[3 + i], -1.f);
    // _nearest_stats masks z's column to float32 max before taking the
    // second minimum: when nothing else is below max, the second minimum
    // is max at the first column (0), and the third is max as well
    const float sec = fminf(t.v[1], FLT_MAX);
    const int z1 = t.c[0];
    const int z2 = sec < FLT_MAX ? t.c[1] : 0;
    const float third = sec < FLT_MAX ? fminf(t.v[2], FLT_MAX) : FLT_MAX;
    if (!FUSED) {
      a.dmin[gr] = t.v[0];
      a.z[gr] = z1;
      a.second[gr] = sec;
      a.z2[gr] = z2;
      a.third[gr] = third;
      continue;
    }
    // the exact distances of the two candidates, float32 max where the
    // column is invalid; with second = max, z2 is column 0, which is valid
    // only as the one valid center, z1
    const float d1e = t.e[0] >= 0.f ? sqrtf(t.e[0]) : FLT_MAX;
    const float d2e = sec < FLT_MAX ? (t.e[1] >= 0.f ? sqrtf(t.e[1]) : FLT_MAX)
                                    : (z1 == 0 ? d1e : FLT_MAX);
    const int z = d2e < d1e ? z2 : z1;
    const float dm = fminf(d1e, d2e);
    const float e2 = 1e-5f * fmaxf(xnt[r] + maxcn, 1e-12f);
    const float margin = e2 / fmaxf(t.v[0], sqrtf(e2));
    bool flag = d1e == d2e || (third - t.v[0]) <= 2.f * margin ||
                dm > a.thr || fabsf(d1e - d2e) <= SLACK * dm ||
                fabsf(dm - a.thr) <= a.slack_thr;
    if (diameter) {
      const float d1 = sqrtf(fmaxf(d1sq[h], 0.f));
      flag = flag || d1 > a.r2 || fabsf(d1 - a.r2) <= a.slack_r2;
    }
    a.out[gr] = z;
    a.out[a.B + gr] = flag ? 1 : 0;
  }
}

// Sets the kernel's attributes once per device: clusters of more than 8
// blocks (the non-portable sizes), and dynamic shared memory above 48 KB.
template <bool FUSED>
cudaError_t configure(int device, int smem) {
  constexpr int MAX_DEVICES = 64;
  static int smem_set[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem <= smem_set[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      precheck_kernel<FUSED>, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(precheck_kernel<FUSED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) smem_set[device] = smem;
  return err;
}

cudaLaunchConfig_t config(int B, int S, int smem, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (B + BR - 1) / BR, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool FUSED>
int launch(const Args& a, int S, int device, void* stream) {
  const Layout L = layout(a.T);
  if (S < 1 || S > MAX_SPLIT || a.B < 1 || a.T < 1 || a.chunk < 1 || !L.ok)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = configure<FUSED>(device, L.words * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(
      a.B, S, L.words * 4, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, precheck_kernel<FUSED>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors: x (B, d) f32, c (T, d) f32, valid (T,) bool. The
// split (S blocks a cluster, chunk d columns each) comes from the wrapper
// (kernels/precheck.py:cluster_split). Each launches one kernel on
// `stream` and returns the cudaError_t of the launch.

// Dynamic shared memory of one block, in bytes, for T centers; 0 if T
// centers do not fit.
extern "C" int precheck_smem_bytes(int T) {
  const Layout L = layout(T);
  return L.ok ? L.words * 4 : 0;
}

// How many clusters of S blocks fit on the card at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t.
extern "C" int precheck_max_clusters(int B, int T, int S, int fused,
                                     int device) {
  const Layout L = layout(T);
  if (!L.ok || S < 1 || S > MAX_SPLIT)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int smem = L.words * 4;
  err = fused ? configure<true>(device, smem) : configure<false>(device, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(B, S, smem, nullptr, &attr);
  int n = 0;
  err = fused ? cudaOccupancyMaxActiveClusters(&n, precheck_kernel<true>, &cfg)
              : cudaOccupancyMaxActiveClusters(&n, precheck_kernel<false>,
                                               &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return n;
}

// Route (a): the five (B,) stats outputs.
extern "C" int precheck_stats_f32(const void* x, const void* c,
                                  const void* valid, void* dmin, void* z,
                                  void* second, void* z2, void* third, int B,
                                  int T, int d, int S, int chunk, int device,
                                  void* stream) {
  Args a = {};
  a.x = static_cast<const float*>(x);
  a.c = static_cast<const float*>(c);
  a.valid = static_cast<const uint8_t*>(valid);
  a.B = B;
  a.T = T;
  a.d = d;
  a.chunk = chunk;
  a.dmin = static_cast<float*>(dmin);
  a.z = static_cast<int*>(z);
  a.second = static_cast<float*>(second);
  a.z2 = static_cast<int*>(z2);
  a.third = static_cast<float*>(third);
  return launch<false>(a, S, device, stream);
}

// Route (b): out (2, B) int32, z then the replay flag. x1 is null for the
// radius variant (r2 and slack_r2 are then unused).
extern "C" int precheck_block_f32(const void* x, const void* c,
                                  const void* valid, const void* x1, void* out,
                                  int B, int T, int d, int S, int chunk,
                                  float thr, float slack_thr, float r2,
                                  float slack_r2, int device, void* stream) {
  Args a = {};
  a.x = static_cast<const float*>(x);
  a.c = static_cast<const float*>(c);
  a.valid = static_cast<const uint8_t*>(valid);
  a.x1 = static_cast<const float*>(x1);
  a.B = B;
  a.T = T;
  a.d = d;
  a.chunk = chunk;
  a.thr = thr;
  a.slack_thr = slack_thr;
  a.r2 = r2;
  a.slack_r2 = slack_r2;
  a.out = static_cast<int*>(out);
  return launch<true>(a, S, device, stream);
}

// Hopper (sm_90a) building blocks of the tensor-core kernels: the bf16
// flash-attention kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu) and the
// 3xTF32 SSD kernel (csrc/ssd.cu); csrc/pdist.cu takes the cp.async helpers.
//
// Shared-memory tiles. A tile of R rows x hd bf16 columns (hd % 8 == 0,
// hd <= 256) is kept as NS = ceil(hd / 64) slabs of R rows x 64 columns:
// each slab row is 128 bytes, the slabs sit one after the other and every
// slab starts on a 1024-byte boundary. Inside a slab the 16-byte chunks of
// row r are stored in the 128-byte swizzle that wgmma's B128 layout reads:
// chunk g of row r at r * 128 + ((g ^ (r % 8)) * 16). Columns past hd and
// rows past the tensor's end are zero-filled by the copy itself (cp.async
// with a source size of 0), so nothing is padded in device memory.
//
// wgmma. All products are m64n64k16, bf16 x bf16 -> f32, one warpgroup:
//   wgmma_ss: A and B from shared memory, both K-major (the contraction
//             dimension contiguous in a slab row), e.g. S = Q K^T;
//   wgmma_rs: A from registers (the f32 accumulator layout of an earlier
//             product, rounded to bf16), B from shared memory MN-major
//             (N contiguous in a slab row, the contraction over rows),
//             e.g. O += P V with V as it lies in memory.
// The accumulator layout (PTX ISA, wgmma .f32 D fragment): thread t of the
// warpgroup, warp w = t / 32, lane l = t % 32, holds d[i] at row
// 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
// The register A fragment of one k16 step is the same layout over 16
// columns: a[r] packs d-columns 2r, 2r + 1 of that step's two 8-column
// groups (see pack_a).
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <initializer_list>

namespace hopper {

constexpr int SLAB_COLS = 64;   // bf16 columns of one slab
constexpr int ROW_BYTES = 128;  // bytes of one slab row
constexpr int WG = 128;         // threads of one warpgroup
constexpr int TILE = 64;        // rows of every tile: the m64 of wgmma
constexpr float LOG2E = 1.4426950408889634f;

// Bytes of a TILE-row tile of ns slabs.
__host__ __device__ constexpr int tile_bytes(int ns) {
  return TILE * ROW_BYTES * ns;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros (nothing read) if !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

// Makes this thread's shared-memory writes (cp.async included) visible to
// the async proxy that wgmma reads through; a barrier follows it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copies rows [0, R) of a (rows x hd) row-major bf16 matrix starting at
// ``src`` into the slabs at ``dst`` (see the file header). Rows >= nrows
// and columns >= hd are zeros. Every thread of the block calls it.
template <int R, int NS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int nrows, int hd, int tid) {
  constexpr int CPR = NS * 8;  // 16-byte chunks a row
  constexpr int CHUNKS = R * CPR;
  static_assert(CHUNKS % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < CHUNKS / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / CPR;
    const int c = i - r * CPR;  // chunk column over all slabs
    const int slab = c >> 3, g = c & 7;
    const bool valid = r < nrows && c * 8 < hd;
    const __nv_bfloat16* p =
        valid ? src + static_cast<size_t>(r) * hd + c * 8 : src;
    cp_async16(dst + slab * (R * ROW_BYTES) + r * ROW_BYTES +
                   ((g ^ (r & 7)) << 4),
               p, valid);
  }
}

// wgmma matrix descriptor of a 128-byte-swizzled operand at shared address
// ``addr``: start address, leading and stride byte offsets in 16-byte
// units, layout type 1 (B128). The stride between 8-row groups is 1024
// bytes; the leading offset is unused by the K-major operands and, for the
// MN-major ones, steps between 64-column slabs, which a 64-wide product
// never does, so it is set to 1024 bytes as well.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the wgmma issue and wait (the products run asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define HOPPER_D32_REGS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_D32_OUT(d)                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (+)= A B: A 64 x 16 and B 16 x 64, both K-major in shared memory.
// scale_d = 0 overwrites d, 1 accumulates.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32_OUT(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B: A 64 x 16 bf16 in registers (a, see pack_a), B 16 x 64
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B in TF32: A 64 x 8 in registers, B 8 x 64 K-major in shared
// memory (wgmma transposes only 16-bit operands, so a tf32 operand read
// from shared memory is always K-major). The A fragment of thread t (warp
// w, lane l), as for mma.m16n8k8.tf32: a[0] at (row 16 w + l / 4, k l % 4),
// a[1] at row + 8, a[2] and a[3] at k l % 4 + 4. Each register holds a
// tf32 value in an f32 container (see split_tf32).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HOPPER_D32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : HOPPER_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef HOPPER_D32_REGS
#undef HOPPER_D32_OUT

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of the four k16 steps of a 64 x 64 f32 accumulator,
// each value rounded to bf16: a[kk] covers columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void pack_a(const float (&d)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded
// to nearest (cvt.rna); hi_a hi_b + hi_a lo_b + lo_a hi_b then carries
// about the precision of an f32 product (the lo_a lo_b term left out is
// ~2^-22 of it).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The 1024-byte-aligned start of the dynamic shared memory (the launch
// asks for 1024 bytes more than the tiles need).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// The tensor-core route takes hd % 8 == 0 (16-byte rows), hd <= 256, and
// 16-byte-aligned tensors.
inline bool tc_route(int hd, std::initializer_list<const void*> ptrs) {
  if (hd <= 0 || hd % 8 != 0 || hd > 256) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace hopper

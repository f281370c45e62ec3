// Hopper (sm_90a) building blocks of the warp-specialised row-major
// flex-attention kernels (the forward walk of flex_fwd_sm90.cuh, the
// backward walks of flex_bwd_sm90.cuh): mbarriers, TMA tile loads and 1-D
// bulk copies into shared memory, wgmma descriptors and instructions,
// register rebalancing between warpgroups (setmaxnreg), named barriers, the
// shape of a warp-specialised block (two consumer warpgroups and a producer
// warpgroup around a ring of shared-memory stages) with the pieces its
// consumers share, and the host-side tensor-map encoding.
//
// Tiles are 64 rows of a head-major [rows, d] bf16 array, d in {64, 128},
// loaded by TMA with 128-byte swizzle as d / 64 "chunks" of 64 rows x 128
// bytes (64 bf16), one 8 KB box each, every chunk 1024-byte aligned. wgmma
// reads such a tile through a shared-memory descriptor in one of two
// orientations:
// - K-major (the reduction dimension runs along the 128-byte rows): the
//   operands of S = Q K^T-type products. The 16-wide k slice kk starts at
//   chunk kk / 4, byte 32 (kk % 4) of the swizzled row; 8-row groups are
//   1024 bytes apart (SBO).
// - MN-major (the tile's rows are the reduction dimension, transposed B):
//   the B operand of dQ += dS K-type products. The 16-row k slice kk
//   starts 2048 bytes (16 rows) into the tile; 8-row groups are 1024 bytes
//   apart (SBO), and the second 64-column chunk (d = 128) 8192 bytes (LBO).
//
// The accumulator of wgmma m64nNk16 (f32) gives thread (warp w of the
// warpgroup, lane 4 g + t4) rows 16 w + g and 16 w + g + 8 of the tile and
// columns 8 j + 2 t4 (+1), as d[j][0..1] and d[j][2..3]: mma.sync's C
// layout, one 16-row slab per warp. Its A fragment from registers is
// mma.sync's A layout, so a 16-column slice of an accumulator, rounded to
// bf16 in pairs, is the A operand of the next product as it stands.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flex_tile.cuh"

namespace flex {
namespace sm90 {

constexpr int WG_THREADS = 128;  // a warpgroup: the unit that issues wgmma
constexpr int CHUNK_BYTES = 64 * 128;  // one TMA box: 64 rows x 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// After the barriers are initialised, before any other thread uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` of asynchronous copies on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed. A barrier starts
// in phase 0: waiting on parity 1 passes at once (the producer's first pass
// over an empty ring), waiting on parity 0 blocks until the first phase ends.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA -------------------------------------------------------------------------

// One box of a 2-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on the barrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Rows row0 .. row0+63 of a [rows, D] bf16 tensor map: D / 64 boxes.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row0) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) tma_load_2d(dst + c * CHUNK_BYTES, map, bar, c * 64, row0);
}

// A contiguous run of global memory (16-byte aligned, a multiple of 16
// bytes) into shared memory, completion counted on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Orders this thread's generic-proxy shared-memory accesses with the async
// proxy's (TMA writes, wgmma reads) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- warpgroups --------------------------------------------------------------------

template <int REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// A barrier over `threads` threads (a multiple of 32) under id 1..15; id 0 is
// __syncthreads'.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at named barrier `id` without waiting: the writes before it are
// seen by the threads that wait there with named_sync (same count).
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- wgmma -----------------------------------------------------------------------

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

// Registers that an in-flight wgmma writes (accumulators) or reads (A
// fragments): redefined here for the compiler, so that no access is moved
// across the wait before it and no register is reused while a product runs.
template <int J>
__device__ __forceinline__ void fence_regs(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[j][c])::"memory");
}

template <int J>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+r"(a[j][c])::"memory");
}

// A shared-memory matrix descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// The 16-wide k slice kk of a 64-row tile, K-major (see the top).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  return smem_desc(tile + (kk >> 2) * CHUNK_BYTES + (kk & 3) * 32, 16, 1024);
}

// Rows 16 kk .. 16 kk + 15 of a 64-row tile as the k slice of an MN-major B
// operand whose N is the tile's width (see the top).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 2048, CHUNK_BYTES, 1024);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory, both
// K-major (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (the A
// fragment), B from shared memory, K-major (128-byte swizzle); scale_d = 0
// overwrites D.
__device__ __forceinline__ void wgmma_rs_k(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The A fragments of a warpgroup's 64-row tile, K-major in shared memory
// with 128-byte swizzle (see the top): warp w's 16 rows, the 16-wide k
// slice kk, by ldmatrix (lanes 0-15 rows 0-15 of the slice's first 8
// columns, lanes 16-31 of its second 8).
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], uint32_t tile, int kk, int warp,
                                            int lane) {
  const int r = warp * 16 + (lane & 15);
  const int unit = (kk & 3) * 2 + (lane >> 4);  // 16-byte unit of the 128-byte row
  const uint32_t addr = tile + (kk >> 2) * CHUNK_BYTES + r * 128 + ((unit ^ (r & 7)) << 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the A fragment),
// B from shared memory, MN-major (transposed; 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the A fragment),
// B from shared memory, MN-major (transposed; 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// -- warp-specialised blocks ---------------------------------------------------------

// A block is three warpgroups: two consumers, then the producer. After giving
// up its registers (setmaxnreg) one producer thread issues every TMA load of
// the block — its resident tiles, then the streamed tiles of the walk
// through a ring of STAGES stages, each gated by a "full" mbarrier (the TMA
// bytes landed) and an "empty" one (its readers are done).
constexpr int CONSUMERS = 2;  // consumer warpgroups a block
constexpr int WS_THREADS = (CONSUMERS + 1) * WG_THREADS;  // and one producer warpgroup
constexpr int STAGES = 4;  // ring depth: two stages in flight per consumer warpgroup
// 128 x 24 + 256 x 240 registers: the 64 K of an SM, one block per SM
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int BAR_CONSUMERS = 1;  // named barrier over both consumer warpgroups

template <int D>
constexpr int tile_bytes() {
  return BQ * D * 2;  // 64 rows of D bf16
}

// A consumer warp is done with a stage: its lanes' reads (and, after a
// wgmma wait, its products') are complete; one lane arrives for the warp.
__device__ __forceinline__ void release_stage(uint32_t empty_bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <int J>
__device__ __forceinline__ void zero(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
}

// A 64 x 64 accumulator tile, rounded to bf16, as the A fragments of its
// four 16-column k slices.
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&x)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// acc[64 x D] += A[64 x 64] tile[64 rows x D]: A from registers, the tile
// as an MN-major B operand. Issued, not waited for.
template <int J>
__device__ __forceinline__ void acc_product(float (&acc)[J][4], const uint32_t (&a)[4][4],
                                            uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], desc_mn_major(tile, kk));
}

// Accumulator columns J0 .. J0+N-1 into a thread-major shared-memory
// buffer: the hand-over of a partial between the two consumer warpgroups,
// whose threads hold the same (row, column) places.
template <int J0, int N, int J>
__device__ __forceinline__ void stash(float* buf, const float (&acc)[J][4], int tid) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) buf[(j * 4 + c) * WG_THREADS + tid] = acc[J0 + j][c];
}

// -- persistent blocks' items ---------------------------------------------------------

// A persistent block's producer thread claims the items of a work list
// (ops/block_sparse.py::work_list, longest walk first) and hands each to
// the block's other warps through a ring of ITEM_SLOTS slots in shared
// memory, ITEM_INTS ints each, slot x guarded by the mbarriers full0 + 8 x
// (the producer's one arrival) and empty0 + 8 x (one arrival from each warp
// that takes items). No __syncthreads: the warpgroups have split their
// registers.
constexpr int ITEM_SLOTS = 2;  // items handed over in flight
constexpr int ITEM_INTS = 8;

// One work item as the producer decoded it: its index in the work list
// (>= the list's length: no item left, the block stops), its first head,
// its block and its walk's entries.
struct Item {
  int idx, head, i, e_begin, e_end;
};

// The producer's next item: group * nb + block, the group's first head
// group * heads.
__device__ __forceinline__ Item claim_item(int* counter, const int* __restrict__ work,
                                           const int* __restrict__ rs,
                                           const int* __restrict__ rc, int n_items, int nb,
                                           int heads) {
  Item it{atomicAdd(counter, 1), 0, 0, 0, 0};
  if (it.idx < n_items) {
    const int w = work[it.idx];
    it.head = w / nb * heads;
    it.i = w % nb;
    it.e_begin = rs[it.i];
    it.e_end = it.e_begin + rc[it.i];
  }
  return it;
}

// The producer hands the block's n-th item over.
__device__ __forceinline__ void publish_item(uint32_t full0, uint32_t empty0, int* slots, int n,
                                             const Item& it) {
  const int x = n % ITEM_SLOTS;
  mbar_wait(empty0 + 8 * x, ((n / ITEM_SLOTS) & 1) ^ 1);
  volatile int* s = slots + x * ITEM_INTS;
  s[0] = it.idx;
  s[1] = it.head;
  s[2] = it.i;
  s[3] = it.e_begin;
  s[4] = it.e_end;
  mbar_arrive(full0 + 8 * x);  // release: the warps that acquire it see the writes
}

// A warp takes the block's n-th item.
__device__ __forceinline__ Item take_item(uint32_t full0, uint32_t empty0, const int* slots,
                                          int n) {
  const int x = n % ITEM_SLOTS;
  mbar_wait(full0 + 8 * x, (n / ITEM_SLOTS) & 1);
  const volatile int* s = slots + x * ITEM_INTS;
  const Item it{s[0], s[1], s[2], s[3], s[4]};
  release_stage(empty0 + 8 * x);
  return it;
}

// -- host ---------------------------------------------------------------------------

// A 2-D tensor map over a head-major [rows, d] bf16 array (d in {64, 128},
// row stride d) with 64 x 64 boxes and 128-byte swizzle. The driver's
// encoder is reached through the runtime's entry-point query, so the library
// does not link libcuda. The base must be 16-byte aligned.
inline cudaError_t encode_tile_map(CUtensorMap* map, const void* base, int rows, int d) {
  typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static EncodeTiled encode = []() -> EncodeTiled {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};  // bytes, rows
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace flex

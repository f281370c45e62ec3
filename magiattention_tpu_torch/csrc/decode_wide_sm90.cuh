// paged_decode's wide walk on Hopper (sm_90a): the flat-mode bf16 walk of a
// GQA group of more than decode_sm90::MAX_ROWS = 32 q heads over one kv
// head (StarCoder-15B's 48 q heads over 1 kv head at d 128, Falcon-7B's 71
// over 1 at d 64), through TMA and wgmma.
//
// Replaces, for those groups, the TPU kernel magiattention_tpu/serving/
// decode_attn.py::_decode_pallas (kernel body _decode_kernel) and computes
// what it computes for each (sequence, split): scores q.k^T * scale, the
// optional softcap cap * tanh(z / cap), positions >= seq_len masked, a
// natural-exp online softmax, p rounded to bf16 before P.V with the sum l
// taken over the unrounded p, and the f32 partial (out, lse) of the split,
// (0, -inf) where the split has no coverage. The splits merge outside the
// kernel (ops/correction.py::merge_partials), as on the TPU.
//
// What bounds it on the card: bytes. Each cached K/V byte feeds one
// multiply-add per q head of its group, 48 at G 48: some 24 FLOP a byte,
// far below the ~295 an H100 needs before its tensor cores are the limit.
// The serving batch's 8 sequences (36,298 tokens of d 128) read 18.6 MB of
// K/V: 5.5 us at 3.35 TB/s. What the walk before this one (decode_wide_mma
// .cuh, kept as chip_smoke.py's yardstick) lost was parallelism and
// overlap: a block of one warp an m16 tile, every warp loading each chunk
// and waiting at a block barrier, too few blocks for 132 SMs, and every
// walk cut into as many blocks as the longest one needed.
//
// What this design does about it:
// - Producer and consumers. A block is one producer warpgroup (its
//   registers given to the consumers by setmaxnreg) and two consumer
//   warpgroups. One producer thread fills a ring of STG stages by TMA, each
//   stage one 64-token box of K and one of V from the cache's 3-D tensor map
//   [pages * page_size, kv heads, D] (128-byte swizzle at d 64 / 128,
//   64-byte at d 32, as flex_sm90.cuh's tiles), and each walk's q rows (its
//   Q tile, two buffers so that the next segment's Q lands while this one
//   runs). A consumer warpgroup computes S = Q K^T for 64 q rows by wgmma
//   m64n64k16 with Q and K from shared memory, the online softmax in
//   registers, and O += P V by wgmma with P from registers and V as the
//   MN-major B operand (flex_fwd_sm90.cuh's products). Up to 64 rows a
//   slice (SPLIT: G 48 is 48 rows and 16 of padding) the two warpgroups
//   hold the same rows and take a segment's chunks in turn, each with its
//   own max, sum and accumulator, merged once through shared memory at the
//   segment's end: one warpgroup alone leaves the SM idle while it waits
//   on its products' and its softmax's latency. Past 64 rows
//   (G 71: 64 + 7) each warpgroup holds 64 of them and both read every
//   stage. No block barrier stands in the walk, so the producer runs STG
//   chunks ahead.
// - Balance across the card. Each (sequence, kv head, split, row slice)
//   walk is cut into segments of ``seg`` 64-token chunks, numbered walk by
//   walk (a walk with no live token is one empty segment). Persistent
//   blocks (one per SM, ``blocks`` of them) take the segments in that fixed
//   order, block i the i-th, i + blocks-th, ...: a walk's segments go to
//   neighbouring blocks and run at once, and since every segment but a
//   walk's last has the same length, the blocks' loads differ by at most one
//   segment without any device-side sort (the order of the walks does not
//   matter then, and none is sorted longest first). ``seg`` and ``blocks``
//   come from the host (serving/decode_attn.py::wide_schedule), from the
//   batch, the kv-head count the launch stands for (``cluster_heads``), the
//   table width, the page size, the splits and the row slices: quantities a
//   tensor-parallel head slice shares with the full launch, so the slice
//   cuts its walks as the full launch does and gives its bits, and a batch
//   launched in row blocks gives the one launch's.
// - Deterministic merge, no extra launch. A segment's (max, sum,
//   accumulator) per row goes to a scratch slot in device memory; the
//   segments of a walk then merge as a fixed tree of MERGE_RADIX children a
//   node, the last child to finish (an atomic count a node, put back to 0 by
//   that child, so the counts stay zero between launches and need no
//   memset) merging its siblings' slots in order, the root's merge writing
//   the split's partial. The tree's shape depends on the walk's segment
//   count alone, so the bits do not depend on which block took which
//   segment, or on timing; a walk of one segment writes its partial from
//   registers. Eight children a node keep the serial tail at two merges for
//   the serving batch's longest walk (32 segments), where pairs took five
//   and the last block merging all 32 would read them alone.
// - Ragged tails and pages. A box never straddles two pages: it has
//   gcd(page_size, 64) rows, so a chunk is 1, 2, 4 or 8 boxes of K and of V
//   (page_size is a multiple of 8). Boxes wholly past the split's live
//   tokens are not issued; rows past them in the last chunk hold what the
//   page (or an earlier chunk) left there, NaN included. Their scores are
//   masked to -inf by select, and their V rows are zeroed in shared memory
//   (then fence.proxy.async, then a barrier of the warpgroups that read the
//   stage) before P V, where p is 0 but 0 * NaN would not be.
// - Padding rows. A slice's Q tile rows past its q heads (16 at G 48) are
//   zeroed after they land; they are never written out.
//
// Launches stand for at most MAX_WALKS walks (the segment numbering lives
// in shared memory); serving/decode_attn.py::kernel_row_blocks launches a
// larger batch in row blocks, each with the same ``seg``.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flex_sm90.cuh"

namespace decode_wide {

using flex::sm90::acc_product;
using flex::sm90::chunk_bytes;
using flex::sm90::chunk_cols;
using flex::sm90::desc_k_major;
using flex::sm90::fence_barrier_init;
using flex::sm90::fence_proxy_async;
using flex::sm90::fence_regs;
using flex::sm90::mbar_expect_tx;
using flex::sm90::mbar_init;
using flex::sm90::mbar_wait;
using flex::sm90::named_sync;
using flex::sm90::release_stage;
using flex::sm90::row_bytes;
using flex::sm90::smem_u32;
using flex::sm90::tma_load_tile;
using flex::sm90::to_a_frags;
using flex::sm90::wgmma_commit;
using flex::sm90::wgmma_fence;
using flex::sm90::wgmma_ss;
using flex::sm90::wgmma_wait;
using flex::sm90::zero;

constexpr int CH = 64;          // tokens a chunk: the n of S = Q K^T, the k of P V
constexpr int WG = 128;         // threads of a warpgroup
constexpr int MAX_WALKS = 2048;  // walks a launch (its segment numbering in shared memory)
constexpr int NC = 2 * WG;       // consumer threads: two warpgroups (a third is the producer's)
constexpr int MERGE_RADIX = 8;   // children a node of a walk's merge tree
constexpr int BAR_CONSUMERS = 1;  // named barrier of the consumer warpgroups; 2 + wg: one's own
// the producer warpgroup's registers, and the consumers' (setmaxnreg): 128 x
// 40 + 256 x 232 within an SM's 64 K
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr unsigned FULL = 0xffffffffu;

// The shared memory of a block, from a 1024-byte aligned base: two Q
// buffers (one tile each where the two consumer warpgroups split a walk's
// chunks, SPLIT; two where they split its rows), the ring's STG stages of K
// and V, under SPLIT the hand-over of a warpgroup's partial, the barriers,
// the merge's per-row weights and flag, the segment numbering (the first
// segment of each walk, and the total) and the scan's warp sums.
template <int D, bool SPLIT>
struct Layout {
  static constexpr int TB = CH * D * 2;  // a 64-row tile of D bf16
  static constexpr int QT = SPLIT ? 1 : 2;  // Q tiles a buffer
  static constexpr int STG = D == 128 ? 4 : 8;
  static constexpr int RING = 2 * QT * TB;
  static constexpr int STASH = RING + STG * 2 * TB;
  static constexpr int STASH_FLOATS = (4 + D / 2) * WG;  // m[2], l[2], o[D / 8][4] a thread
  static constexpr int BARS = STASH + (SPLIT ? 4 * STASH_FLOATS : 0);
  static constexpr int MERGE = BARS + 8 * (4 + 2 * STG);
  static constexpr int PREFIX = MERGE + 4 * ((MERGE_RADIX + 2) * 2 * CH + 4);
  static constexpr int SUMS = PREFIX + 4 * (MAX_WALKS + 1);
  static constexpr int BYTES = SUMS + 4 * 32;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(ALLOC <= 232448, "a block's shared memory");
};

// q_full[2] q_empty[2] full[STG] empty[STG], 8 bytes each
struct Bars {
  uint32_t base;
  int stg;
  __device__ __forceinline__ uint32_t q_full(int b) const { return base + 8 * b; }
  __device__ __forceinline__ uint32_t q_empty(int b) const { return base + 16 + 8 * b; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + 32 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + 32 + 8 * (stg + s); }
};

struct Args {
  const int* __restrict__ bt;  // [b, mpp]
  const int* __restrict__ sl;  // [b]
  float* out_parts;            // [b, splits, hq, D]
  float* lse_parts;            // [b, splits, hq]
  float* scratch;              // a slot per segment (wide_slot_floats)
  int* counters;               // a count per merge node: 0 on entry, left 0 on exit
  int hq, hk, group, slices, slice_rows, ps, mpp, splits, seg, box_rows, walks;
  float scale, softcap;
};

// A segment's scratch slot: the rows' max and sum, each padded to
// slot_rows (a multiple of 4, so that the accumulator after them is 16-byte
// aligned), then the accumulator [slice_rows][D].
__host__ __device__ inline int slot_rows(int slice_rows) { return (slice_rows + 3) / 4 * 4; }
__host__ __device__ inline size_t wide_slot_floats(int slice_rows, int d) {
  return 2 * (size_t)slot_rows(slice_rows) + (size_t)slice_rows * d;
}

// One walk: sequence m, kv head h, split s, row slice z; its live tokens,
// chunks and segments.
struct Walk {
  int m, h, s, z, n, chunks, nseg;
};

__device__ __forceinline__ Walk walk_of(const Args& a, int w) {
  Walk k;
  k.z = w % a.slices;
  int t = w / a.slices;
  k.s = t % a.splits;
  t /= a.splits;
  k.h = t % a.hk;
  k.m = t / a.hk;
  const int span = a.mpp / a.splits * a.ps;  // a split's table positions
  k.n = max(0, min(span, __ldg(a.sl + k.m) - k.s * span));
  k.chunks = (k.n + CH - 1) / CH;
  k.nseg = max(1, (k.chunks + a.seg - 1) / a.seg);
  return k;
}

// The walk holding segment ``it``: pre[w] <= it < pre[w + 1] (every walk
// has a segment, so pre rises strictly).
__device__ __forceinline__ int find_walk(const int* pre, int walks, int it) {
  int lo = 0, hi = walks;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= it) lo = mid;
    else hi = mid;
  }
  return lo;
}

// pre[w] = the first segment of walk w, pre[walks] = the launch's segments:
// an exclusive scan by the whole block, each thread a run of walks.
template <int NT>
__device__ __forceinline__ void number_segments(const Args& a, int* pre, int* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (a.walks + NT - 1) / NT;
  const int lo = min(tid * per, a.walks), hi = min(lo + per, a.walks);
  int local = 0;
  for (int w = lo; w < hi; ++w) {
    const int c = walk_of(a, w).nseg;
    pre[w] = c;
    local += c;
  }
  int x = local;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < NT / 32 ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += y;
    }
    if (lane < NT / 32) sums[lane] = v;
  }
  __syncthreads();
  int run = x - local + (warp > 0 ? sums[warp - 1] : 0);
  for (int w = lo; w < hi; ++w) {
    const int c = pre[w];
    pre[w] = run;
    run += c;
  }
  if (tid == NT - 1) pre[a.walks] = run;
  __syncthreads();
}

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on the barrier.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Rows [r_begin, 64) of a 64-row tile of width D set to zero by the nt
// threads numbered t. A row is whole 16-byte units in each of the tile's
// column chunks, so the swizzle (a permutation within a row) does not
// matter.
template <int D>
__device__ __forceinline__ void zero_rows(unsigned char* tile, int r_begin, int t, int nt) {
  constexpr int RB = row_bytes<D>(), UNITS = RB / 16, CHUNKS = 2 * D / RB;
  const int n = (CH - r_begin) * UNITS * CHUNKS;
  for (int x = t; x < n; x += nt) {
    const int u = x % UNITS, rest = x / UNITS;
    const int r = r_begin + rest / CHUNKS;
    *reinterpret_cast<uint4*>(tile + (rest % CHUNKS) * chunk_bytes<D>() + r * RB + u * 16) =
        make_uint4(0, 0, 0, 0);
  }
}

// The producer thread's lane of the producer warp: per segment, the Q
// tile(s) of its walk, then each chunk's K and V boxes into the ring. The
// warp's lanes look up the chunk's page ids, one box each, a chunk ahead.
template <int D, bool SPLIT>
__device__ __forceinline__ void producer(const Args& a, const CUtensorMap* tm_q,
                                         const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                         const int* pre, const Bars& bars, uint32_t base) {
  using L = Layout<D, SPLIT>;
  constexpr int COLS = chunk_cols<D>();
  const int lane = threadIdx.x & 31;
  const int R = a.box_rows, per_chunk = CH / R;
  const int total = pre[a.walks];
  int fill = 0, qn = 0;
  for (int it = blockIdx.x; it < total; it += gridDim.x) {
    const int w = find_walk(pre, a.walks, it);
    const Walk wk = walk_of(a, w);
    if (wk.chunks == 0) continue;
    const int c0 = (it - pre[w]) * a.seg, c1 = min(c0 + a.seg, wk.chunks);
    const int* row = a.bt + (size_t)wk.m * a.mpp + wk.s * (a.mpp / a.splits);
    // this lane's box of chunk c: the token row it starts at
    auto token = [&](int c) {
      const int pos = c * CH + lane * R;
      return lane < per_chunk && pos < wk.n ? __ldg(row + pos / a.ps) * a.ps + pos % a.ps : 0;
    };
    int next = token(c0);
    if (lane == 0) {
      const int qb = qn & 1;
      mbar_wait(bars.q_empty(qb), ((qn >> 1) & 1) ^ 1);
      mbar_expect_tx(bars.q_full(qb), L::QT * L::TB);
      const int qrow = wk.m * a.hq + wk.h * a.group + wk.z * a.slice_rows;
      for (int t = 0; t < L::QT; ++t)
        tma_load_tile<D>(base + (qb * L::QT + t) * L::TB, tm_q, bars.q_full(qb), qrow + 64 * t);
    }
    ++qn;
    for (int c = c0; c < c1; ++c, ++fill) {
      const int cur = next;
      if (c + 1 < c1) next = token(c + 1);
      const int st = fill % L::STG;
      const int boxes = (min(CH, wk.n - c * CH) + R - 1) / R;  // those holding a live token
      const uint32_t sk = base + L::RING + st * 2 * L::TB, sv = sk + L::TB;
      if (lane == 0) {
        mbar_wait(bars.empty(st), ((fill / L::STG) & 1) ^ 1);
        mbar_expect_tx(bars.full(st), 2 * boxes * R * D * 2);
      }
      for (int p = 0; p < boxes; ++p) {
        const int tok = __shfl_sync(FULL, cur, p);
        if (lane == 0) {
#pragma unroll
          for (int cc = 0; cc < D / COLS; ++cc) {
            const uint32_t off = cc * chunk_bytes<D>() + p * R * row_bytes<D>();
            tma_load_3d(sk + off, tm_k, bars.full(st), cc * COLS, wk.h, tok);
            tma_load_3d(sv + off, tm_v, bars.full(st), cc * COLS, wk.h, tok);
          }
        }
      }
    }
  }
}

// The nc slots of a merge node, child i at slot0 + i * stride (each the
// partial of its subtree), merged into the first, by the block's NC consumer
// threads; the root's merge (final) writes the split's partial instead.
// Each row's weights first (through shared memory), then the accumulator,
// an element's nc loads issued together and each element read and written
// by one thread, then the row's max and sum. The children add up in their
// order, so the bits depend on the tree alone.
template <int D>
__device__ __forceinline__ void merge_slots(const Args& a, float* slot0, size_t stride, int nc,
                                            int rows, bool final, size_t orow0, float* mrg,
                                            int ctid) {
  const int sr = slot_rows(a.slice_rows);
  float* wts = mrg;                       // [MERGE_RADIX][2 * CH]: each child's row weights
  float* mx = mrg + MERGE_RADIX * 2 * CH;  // the merged rows' max and sum
  float* sum = mx + 2 * CH;
  for (int r = ctid; r < rows; r += NC) {
    float mc[MERGE_RADIX], m = -INFINITY;
#pragma unroll
    for (int i = 0; i < MERGE_RADIX; ++i) {
      mc[i] = i < nc ? __ldcg(slot0 + i * stride + r) : -INFINITY;
      m = fmaxf(m, mc[i]);
    }
    const float ms = m == -INFINITY ? 0.f : m;
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < MERGE_RADIX; ++i) {
      const float wi = mc[i] == -INFINITY ? 0.f : __expf(mc[i] - ms);
      wts[i * 2 * CH + r] = wi;
      if (i < nc) l += __ldcg(slot0 + i * stride + sr + r) * wi;
    }
    mx[r] = m;
    sum[r] = l;
  }
  named_sync(BAR_CONSUMERS, NC);
  const int n = rows * (D / 4);
  for (int x = ctid; x < n; x += NC) {
    const int r = x / (D / 4);
    float4 u[MERGE_RADIX];
#pragma unroll
    for (int i = 0; i < MERGE_RADIX; ++i)
      if (i < nc) u[i] = __ldcg(reinterpret_cast<const float4*>(slot0 + i * stride + 2 * sr) + x);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < MERGE_RADIX; ++i) {
      if (i >= nc) break;
      const float wi = wts[i * 2 * CH + r];
      o = make_float4(o.x + u[i].x * wi, o.y + u[i].y * wi, o.z + u[i].z * wi, o.w + u[i].w * wi);
    }
    if (final) {
      const float l = sum[r], inv = l > 0.f ? 1.f / l : 0.f;
      o = make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
      reinterpret_cast<float4*>(a.out_parts + (orow0 + r) * D)[x % (D / 4)] = o;
    } else {
      reinterpret_cast<float4*>(slot0 + 2 * sr)[x] = o;
    }
  }
  for (int r = ctid; r < rows; r += NC) {
    const float l = sum[r];
    if (final) {
      a.lse_parts[orow0 + r] = l > 0.f ? (mx[r] == -INFINITY ? 0.f : mx[r]) + logf(l) : -INFINITY;
    } else {
      slot0[r] = mx[r];
      slot0[sr + r] = l;
    }
  }
}

// The two consumer warpgroups (wg 0, 1): per segment of the block, the walk
// over the segment's chunks, then the segment's partial: the split's result
// from registers where the walk is one segment, else a scratch slot and the
// walk's merge tree. SPLIT (a slice of at most 64 rows): both warpgroups
// hold the slice's 64 rows and take the segment's chunks in turn, each with
// its own max, sum and accumulator, merged once through shared memory at
// the segment's end (warpgroup 0 keeps the result): two chunks in flight an
// SM where one warpgroup alone would wait on its products' latency. Else
// each warpgroup holds 64 of the slice's rows and takes every chunk.
template <int D, bool SPLIT>
__device__ __forceinline__ void consumer(const Args& a, unsigned char* smem, uint32_t base,
                                         const int* pre, const Bars& bars) {
  using L = Layout<D, SPLIT>;
  constexpr int J = D / 8;
  const int ctid = threadIdx.x, wg = ctid / WG, tid = ctid % WG;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const bool holds = !SPLIT || wg == 0;  // this thread's rows leave with the segment
  const int r0 = (SPLIT ? 0 : wg * CH) + warp * 16 + g;  // its rows of the slice: r0, r0 + 8
  float* mrg = reinterpret_cast<float*>(smem + L::MERGE);
  float* stash = reinterpret_cast<float*>(smem + L::STASH);
  volatile int* flag = reinterpret_cast<int*>(mrg + (MERGE_RADIX + 2) * 2 * CH);
  const int total = pre[a.walks];
  const size_t slot_floats = wide_slot_floats(a.slice_rows, D);
  const int sr = slot_rows(a.slice_rows);
  int fill = 0, qn = 0;
  for (int it = blockIdx.x; it < total; it += gridDim.x) {
    const int w = find_walk(pre, a.walks, it);
    const Walk wk = walk_of(a, w);
    const int k = it - pre[w];
    const int rows = min(a.slice_rows, a.group - wk.z * a.slice_rows);
    const size_t orow0 =
        ((size_t)wk.m * a.splits + wk.s) * a.hq + wk.h * a.group + wk.z * a.slice_rows;
    float o[J][4];
    zero(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if (wk.chunks > 0) {
      const int qb = qn & 1;
      mbar_wait(bars.q_full(qb), (qn >> 1) & 1);
      const int q_off = (qb * L::QT + (SPLIT ? 0 : wg)) * L::TB;
      // padding rows read zeros
      if (SPLIT) {
        if (rows < CH) zero_rows<D>(smem + q_off, rows, ctid, NC);
      } else {
        const int real = min(max(rows - wg * CH, 0), CH);  // this tile's rows of the slice
        if (real < CH) zero_rows<D>(smem + q_off, real, tid, WG);
      }
      fence_proxy_async();
      named_sync(BAR_CONSUMERS, NC);
      const uint32_t sq = base + q_off;
      const int c0 = k * a.seg, c1 = min(c0 + a.seg, wk.chunks);
      for (int c = c0; c < c1; ++c, ++fill) {
        if (SPLIT && ((c - c0) & 1) != wg) continue;  // the other warpgroup's chunk
        const int st = fill % L::STG;
        const int ring_off = L::RING + st * 2 * L::TB;
        const uint32_t sk = base + ring_off;
        const int live = min(CH, wk.n - c * CH);
        mbar_wait(bars.full(st), (fill / L::STG) & 1);
        // S = Q K^T: 64 rows x 64 tokens
        float x[8][4];
        fence_regs(x);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(x, desc_k_major<D>(sq, kk), desc_k_major<D>(sk, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(x);
        // the online softmax of this thread's rows r0 (c = 0, 1) and r0 + 8
        // (c = 2, 3) over tokens 8 j + 2 t4 (+1)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float z = x[j][e] * a.scale;
            if (a.softcap > 0.f) z = a.softcap * tanhf(z / a.softcap);
            x[j][e] = 8 * j + 2 * t4 + (e & 1) < live ? z : -INFINITY;
          }
        float alpha[2];
        bool grew = false;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(x[j][2 * rr], x[j][2 * rr + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
          const float mnew = fmaxf(m[rr], mx);
          const float msafe = mnew == -INFINITY ? 0.f : mnew;
          alpha[rr] = m[rr] == -INFINITY ? 0.f : __expf(m[rr] - msafe);
          grew |= mnew != m[rr];  // alpha is exactly 1 where the max held
          m[rr] = mnew;
          float ls = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
              const float p = x[j][e] == -INFINITY ? 0.f : __expf(x[j][e] - msafe);
              ls += p;  // l over the unrounded p
              x[j][e] = p;
            }
          l[rr] = l[rr] * alpha[rr] + ls;  // this thread's share; the quad sums at the end
        }
        uint32_t pp[4][4];
        to_a_frags(pp, x);  // p rounded to bf16: P V's A fragments
        if (live < CH) {  // V's rows past the live tokens: zeros, whatever the page held
          if (SPLIT) {  // this warpgroup alone reads the stage
            zero_rows<D>(smem + ring_off + L::TB, live, tid, WG);
            fence_proxy_async();
            named_sync(2 + wg, WG);
          } else {
            zero_rows<D>(smem + ring_off + L::TB, live, ctid, NC);
            fence_proxy_async();
            named_sync(BAR_CONSUMERS, NC);
          }
        }
        if (__any_sync(FULL, grew)) {
#pragma unroll
          for (int jj = 0; jj < J; ++jj) {
            o[jj][0] *= alpha[0];
            o[jj][1] *= alpha[0];
            o[jj][2] *= alpha[1];
            o[jj][3] *= alpha[1];
          }
        }
        fence_regs(o);
        fence_regs(pp);
        wgmma_fence();
        acc_product(o, pp, sk + L::TB);  // O += P V
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pp);
        release_stage(bars.empty(st));
      }
      release_stage(bars.q_empty(qb));  // every product that read Q is done
      ++qn;
    }
    if (SPLIT) {  // warpgroup 1's partial into warpgroup 0's, through shared memory
      if (wg == 1) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          stash[rr * WG + tid] = m[rr];
          stash[(2 + rr) * WG + tid] = l[rr];
        }
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) stash[(4 + 4 * j + e) * WG + tid] = o[j][e];
      }
      named_sync(BAR_CONSUMERS, NC);
      if (wg == 0) {
        float w0[2], w1[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float m1 = stash[rr * WG + tid];
          const float mt = fmaxf(m[rr], m1);
          const float ms = mt == -INFINITY ? 0.f : mt;
          w0[rr] = m[rr] == -INFINITY ? 0.f : __expf(m[rr] - ms);
          w1[rr] = m1 == -INFINITY ? 0.f : __expf(m1 - ms);
          l[rr] = l[rr] * w0[rr] + stash[(2 + rr) * WG + tid] * w1[rr];
          m[rr] = mt;
        }
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[j][e] = o[j][e] * w0[e >> 1] + stash[(4 + 4 * j + e) * WG + tid] * w1[e >> 1];
      }
      named_sync(BAR_CONSUMERS, NC);  // the stash is read before the next segment's
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // the rows' sums over the quad
      l[rr] += __shfl_xor_sync(FULL, l[rr], 1);
      l[rr] += __shfl_xor_sync(FULL, l[rr], 2);
    }
    if (wk.nseg == 1) {  // the walk is this segment: the split's partial from registers
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + 8 * rr;
        if (!holds || r >= rows) continue;
        const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
        float* po = a.out_parts + (orow0 + r) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < J; ++j)
          *reinterpret_cast<float2*>(po + 8 * j) =
              make_float2(o[j][2 * rr] * inv, o[j][2 * rr + 1] * inv);
        if (t4 == 0)
          a.lse_parts[orow0 + r] =
              l[rr] > 0.f ? (m[rr] == -INFINITY ? 0.f : m[rr]) + logf(l[rr]) : -INFINITY;
      }
      continue;
    }
    // the segment's slot
    float* walk0 = a.scratch + (size_t)pre[w] * slot_floats;
    float* slot = walk0 + (size_t)k * slot_floats;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      if (!holds || r >= rows) continue;
      if (t4 == 0) {
        slot[r] = m[rr];
        slot[sr + r] = l[rr];
      }
      float* po = slot + 2 * sr + r * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < J; ++j)
        *reinterpret_cast<float2*>(po + 8 * j) = make_float2(o[j][2 * rr], o[j][2 * rr + 1]);
    }
    // the merge tree: at level L a node of up to MERGE_RADIX children of
    // span = MERGE_RADIX^L segments each, their partials in the slots of their
    // first segments; the last child to arrive merges them into the first
    // one's slot (its count back to 0 for the next launch), the root's
    // merge writes the split's partial
    __threadfence();
    named_sync(BAR_CONSUMERS, NC);
    for (int span = 1; span < wk.nseg; span *= MERGE_RADIX) {
      const int left = k - k % (span * MERGE_RADIX);
      const int nc = min(MERGE_RADIX, (wk.nseg - left + span - 1) / span);
      if (nc == 1) continue;  // a lone child goes up as it is
      if (ctid == 0) {
        int* count = a.counters + pre[w] + left + span - 1;  // a node's own count
        const int before = atomicAdd(count, 1);
        if (before == nc - 1) *count = 0;
        *flag = before == nc - 1;
        __threadfence();
      }
      named_sync(BAR_CONSUMERS, NC);
      if (!*flag) break;  // a sibling is still running: the last one merges
      merge_slots<D>(a, walk0 + (size_t)left * slot_floats, span * slot_floats, nc, rows,
                     span * MERGE_RADIX >= wk.nseg, orow0, mrg, ctid);
      __threadfence();
      named_sync(BAR_CONSUMERS, NC);
    }
  }
}

// One persistent block: the segment numbering, then the producer thread
// (its warpgroup's registers given to the consumers) and the two consumer
// warpgroups.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(3 * WG, 1)
paged_decode_wide(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ Args a) {
  using L = Layout<D, SPLIT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = flex::sm90::align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const Bars bars{base + L::BARS, L::STG};
  int* pre = reinterpret_cast<int*>(smem + L::PREFIX);
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bars.q_full(b), 1);
      mbar_init(bars.q_empty(b), NC / 32);  // every consumer warp reads Q
    }
    for (int s = 0; s < L::STG; ++s) {
      mbar_init(bars.full(s), 1);
      mbar_init(bars.empty(s), (SPLIT ? WG : NC) / 32);  // the warps that read the stage
    }
    fence_barrier_init();
  }
  number_segments<3 * WG>(a, pre, reinterpret_cast<int*>(smem + L::SUMS));
  if (threadIdx.x >= NC) {
    flex::sm90::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < NC + 32) producer<D, SPLIT>(a, &tm_q, &tm_k, &tm_v, pre, bars, base);
  } else {
    flex::sm90::reg_alloc<CONSUMER_REGS>();
    consumer<D, SPLIT>(a, smem, base, pre, bars);
  }
}

// -- host -----------------------------------------------------------------------------

inline int gcd(int x, int y) {
  while (y) {
    const int t = x % y;
    x = y;
    y = t;
  }
  return x;
}

// A 3-D tensor map over a paged cache [pages * page_size, hk, d] bf16: boxes
// of box_rows tokens of one kv head, d / 64 boxes of 64 columns across (one
// of 32 at d = 32), swizzled as flex_sm90.cuh's tiles.
inline cudaError_t encode_cache_map(CUtensorMap* map, const void* base, long long tokens, int hk,
                                    int d, int box_rows) {
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
  const bool narrow = d == 32;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)hk, (cuuint64_t)tokens};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)hk * d * 2};  // bytes
  const cuuint32_t box[3] = {narrow ? 32u : 64u, 1u, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              narrow ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The walk's row slices of a group, as decode_sm90's: one up to 128 rows,
// else the fewest of at most 128.
constexpr int SLICE_MAX_ROWS = 128;
__host__ __device__ inline int slices_of(int group) {
  return (group + SLICE_MAX_ROWS - 1) / SLICE_MAX_ROWS;
}

// A segment's slots and counts in scratch: the wrapper allocates
// walks * max_segments of each (serving/decode_attn.py::wide_schedule).
inline int max_segments(int mpp, int splits, int ps, int seg) {
  const int chunks = (mpp / splits * ps + CH - 1) / CH;
  return chunks > 0 ? (chunks + seg - 1) / seg : 1;
}

template <int D, bool SPLIT>
cudaError_t launch_mode(const void* q, const void* kp, const void* vp, const Args& a, int b,
                        int num_pages, int blocks, cudaStream_t stream) {
  using L = Layout<D, SPLIT>;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = flex::sm90::encode_tile_map(&tm_q, q, b * a.hq, D);
  if (err == cudaSuccess)
    err = encode_cache_map(&tm_k, kp, (long long)num_pages * a.ps, a.hk, D, a.box_rows);
  if (err == cudaSuccess)
    err = encode_cache_map(&tm_v, vp, (long long)num_pages * a.ps, a.hk, D, a.box_rows);
  if (err != cudaSuccess) return err;
  auto kernel = paged_decode_wide<D, SPLIT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 3 * WG, L::ALLOC, stream>>>(tm_q, tm_k, tm_v, a);
  return cudaGetLastError();
}

// b sequences of q [b, hq, D] bf16 over the cache's num_pages pages;
// scratch and counters of walks * max_segments slots (wide_slot_floats f32
// each) and ints; seg chunks a segment and ``blocks`` persistent blocks
// (serving/decode_attn.py::wide_schedule).
template <int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* bt, const void* sl,
                   void* out_parts, void* lse_parts, void* scratch, void* counters, int b, int hq,
                   int hk, int ps, int num_pages, int mpp, int splits, int seg, int blocks,
                   float scale, float softcap, cudaStream_t stream) {
  const int group = hq / hk, slices = slices_of(group);
  Args a{(const int*)bt, (const int*)sl, (float*)out_parts,
         (float*)lse_parts, (float*)scratch, (int*)counters,
         hq, hk, group, slices, (group + slices - 1) / slices, ps, mpp, splits, seg,
         gcd(ps, CH), b * hk * splits * slices, scale, softcap};
  if (ps % 8 != 0 || seg < 1 || blocks < 1 || a.walks > MAX_WALKS ||
      ((scratch == nullptr || counters == nullptr) && max_segments(mpp, splits, ps, seg) > 1))
    return cudaErrorInvalidValue;
  return a.slice_rows > CH ? launch_mode<D, false>(q, kp, vp, a, b, num_pages, blocks, stream)
                           : launch_mode<D, true>(q, kp, vp, a, b, num_pages, blocks, stream);
}

}  // namespace decode_wide

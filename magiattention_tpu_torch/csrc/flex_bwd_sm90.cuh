// The warp-specialised walks of the flex-attention backward for Hopper
// (sm_90a): dq over the forward (q-major) entry table and dk, dv over the
// backward (k-major) one. The math is the reference's, step for step (see
// flex_dq.cu and flex_dkv.cu); this header is how a thread block runs it,
// for one item at a time. Four kernels call it: the row-major flex_dq.cu and
// flex_dkv.cu (one item a block, the grid in the host's launch order) and
// the sparse-grid flex_dq_sparse.cu and flex_dkv_sparse.cu (persistent
// blocks taking item after item from a work list). The per-item functions
// are the same code for both grids; a block passes in where it stands in its
// sequence of items (n: the items it computed before this one, 0 for the
// row-major kernels) and the running count of its ring fills.
//
// A block is three warpgroups. The third is the producer: after giving up
// its registers (setmaxnreg) one of its threads issues every TMA load of the
// block — each item's resident tiles into a resident buffer, then the
// streamed tiles of the item's walk through a ring of STAGES shared-memory
// stages, each gated by a "full" mbarrier (the TMA bytes landed) and an
// "empty" one (its readers are done). The first two are consumer
// warpgroups with the producer's registers: they wait on a stage, run the
// products on wgmma (the score-type products from two shared-memory tiles,
// the accumulating ones with the rounded P or dS tile from registers as the
// A operand) and the per-logit core of flex_tile.cuh between them, and
// release the stage. A consumer works out a tile's mask while its score
// products run and waits for each group of products before it touches their
// registers; two consumers per block, so that one's products overlap the
// other's softmax core. (Issuing a tile's accumulating products together
// with the next tile's score products instead does not pay here: ptxas
// serialises that wgmma chain, notice C7515.)
//
// A persistent block pipelines its items. The producer takes the next item
// from the work list's counter as soon as it has issued the current item's
// last load, and hands it to the consumers through an item slot in shared
// memory guarded by a full / empty mbarrier pair (no __syncthreads: the
// warpgroups have split their registers). It then issues the next item's
// loads as soon as there is room, so that they land while the consumers
// finish the current walk and write its outputs:
// - Resident buffers. A resident buffer has its own full / empty barrier
//   pair, released by the consumers once nothing reads it any more; the
//   phase of each alternates with the items that use the buffer (item n uses
//   buffer n % RES at parity (n / RES) & 1), never a fixed phase. With two
//   buffers (RES = 2) the next item's resident tiles load during the whole
//   current walk. dq at a head pair (64 KB of Q and dO at d = 128) has room
//   for one buffer beside the 128 KB ring, so there (RES = 1) the next
//   item's Q and dO go out once the current walk is done and land while the
//   consumers write the current dq, its K/V stages right behind them. (Its
//   first K/V stages issued before its Q and dO, or a three-stage ring with
//   two buffers, measured no faster on the card.)
// - Ring counters. The ring runs on across items: a fill's stage and phase
//   come from the block's running count of fills, never from a count that
//   restarts at each item (that would hang or read a stale stage). The walk's
//   own order — which warpgroup takes which tile — comes from the item-local
//   count, so each item sums in the row-major kernels' order.
// - Hand-overs. Where the two warpgroups add their partials at the end of an
//   item (dq at odd G, dk and dv always) they do it through the item's own
//   resident buffer, free once both walks are done, and never through the
//   ring, which the producer is already refilling with the next item's
//   tiles; the buffer is released after the hand-over. (A row-major dk/dv
//   block, whose one item leaves the ring free, hands both partials over at
//   once through the ring.)
//
// d = 80 and 96: the d <= 128 layouts and walks, over d = 128's shared tiles
// (flex_sm90.cuh's padded_d: zeros past d); the products at the true d, the
// accumulators d / 8 column groups, the stores d columns.
//
// d = 256 (Gemma's width): a 64-row tile is 32 KB. The layouts keep what
// fits an SM's 227 KB: dq one or two ring stages beside its resident Q and
// dO (DqLayout::STG), dk/dv two stages beside one resident K/V buffer or one
// beside two. dK and dV of a 64-key tile at d = 256 would take 256
// registers a thread in one warpgroup, past the 255 a thread can have, so
// the dk/dv walk changes shape (dkv_consumer_halves): both warpgroups take
// every (entry, q head) step, each computes S^T and dP^T over the whole d
// and accumulates dK and dV over its own half of the columns (128 + 128
// registers' worth split as 64 + 64 a thread), and nothing is handed over at
// the end. The score products are computed twice (1.5x the tensor-core work
// of a step), and no register holds more than a warpgroup's half.
//
// Determinism: no atomics on data. Each item is computed whole by one block
// and writes its own output rows; where the two warpgroups split a walk, the
// split is fixed by the walk's order and their two partial sums are added
// once, at the end. The same inputs give the same bits on every run,
// whichever block took which item, and the sparse-grid kernels give the
// row-major kernels' bits on the same tables.
#pragma once

#include "flex_tile.cuh"
#include "flex_sm90.cuh"

namespace flex {
namespace sm90 {

constexpr int BAR_WG = 2;  // + wg: one consumer warpgroup alone
constexpr int BAR_HANDOFF = 4, BAR_HANDOFF_BACK = 5;  // dk, dv: one warpgroup to the other
constexpr int CONSUMER_WARPS = CONSUMERS * WG_THREADS / 32;

// The barriers, from an 8-byte aligned offset: full[STAGES] and
// empty[STAGES] for the ring, res_full[2] and res_empty[2] for the resident
// buffers, item_full[2] and item_empty[2] for the item slots
// (flex_sm90.cuh's ITEM_SLOTS); then the item slots themselves.
constexpr int BAR_BYTES = 8 * (2 * STAGES + 2 * 2 + 2 * ITEM_SLOTS);
constexpr int SCHED_BYTES = BAR_BYTES + ITEM_SLOTS * ITEM_INTS * 4;

struct Bars {
  uint32_t base;
  __device__ __forceinline__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + 8 * (STAGES + s); }
  __device__ __forceinline__ uint32_t res_full(int r) const { return base + 8 * (2 * STAGES + r); }
  __device__ __forceinline__ uint32_t res_empty(int r) const {
    return base + 8 * (2 * STAGES + 2 + r);
  }
  __device__ __forceinline__ uint32_t item_full(int x) const {
    return base + 8 * (2 * STAGES + 4 + x);
  }
  __device__ __forceinline__ uint32_t item_empty(int x) const {
    return base + 8 * (2 * STAGES + 4 + ITEM_SLOTS + x);
  }
};

// dq's shared memory, from a 1024-byte aligned base: RES resident buffers of
// the Q and dO tiles of NH q heads, then K and V per ring stage (STG of
// them: STAGES, or at d = 256 what fits beside the resident buffers), then
// the barriers and item slots.
template <int D, int NH, int RES>
struct DqLayout {
  static constexpr int TB = tile_bytes<D>();
  static constexpr int RESIDENT = 2 * NH * TB;  // one resident buffer
  static constexpr int RING = RES * RESIDENT;
  static constexpr int STG = D <= 128 ? STAGES : RES * NH == 1 ? 2 : 1;
  static constexpr int BARS = RING + STG * 2 * TB;
  static constexpr int BYTES = BARS + SCHED_BYTES;
  static constexpr int ALLOC = BYTES + 1024;  // the dynamic allocation, with room to align
  static_assert(ALLOC <= 232448, "a block's shared memory fits an SM");
  // NH = 1: the warpgroups take every other fill, each from stages of its
  // own; on one stage a warpgroup's wait would pass on a phase two behind
  static_assert(NH == 2 || STG >= 2, "a split walk needs two ring stages");
};

// dk/dv's: RES resident buffers of the K and V tiles, then Q and dO per
// ring stage (STG of them, as dq's), then each stage's 64 lse and 64
// delta_eff values, then each consumer warpgroup's two buffers of per-row
// k-intervals [lo | hi], then the barriers and item slots.
template <int D, int RES>
struct DkvLayout {
  static constexpr int TB = tile_bytes<D>();
  static constexpr int RESIDENT = 2 * TB;
  static constexpr int RING = RES * RESIDENT;
  static constexpr int STG = D <= 128 ? STAGES : RES == 1 ? 2 : 1;
  static constexpr int VEC = RING + STG * 2 * TB;
  static constexpr int IV = VEC + STG * 2 * BQ * 4;
  static constexpr int BARS = IV + CONSUMERS * 2 * 2 * BQ * 4;
  static constexpr int BYTES = BARS + SCHED_BYTES;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(ALLOC <= 232448, "a block's shared memory fits an SM");
};

// The dK and dV columns (in 8s) a consumer warpgroup of a dk/dv item
// accumulates: all d of them, or at d = 256 its half (dkv_consumer_halves).
template <int D>
constexpr int DKV_J = D <= 128 ? D / 8 : D / 16;

// The warps that read a dk/dv ring stage: one warpgroup's, or at d = 256
// both warpgroups' (each takes every step).
template <int D>
constexpr int DKV_STAGE_READERS = D <= 128 ? WG_THREADS / 32 : CONSUMER_WARPS;

// By one thread, before the roles split. A full barrier completes on the
// producer's one arrival and its bytes; a ring stage's empty one on one
// arrival from each warp that reads the stage (release_stage); a resident
// buffer's or an item slot's empty one on one arrival from every consumer
// warp.
__device__ __forceinline__ void init_bars(const Bars& b, int empty_arrivals) {
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(b.full(s), 1);
    mbar_init(b.empty(s), empty_arrivals);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mbar_init(b.res_full(r), 1);
    mbar_init(b.res_empty(r), CONSUMER_WARPS);
  }
#pragma unroll
  for (int x = 0; x < ITEM_SLOTS; ++x) {
    mbar_init(b.item_full(x), 1);
    mbar_init(b.item_empty(x), CONSUMER_WARPS);
  }
  fence_barrier_init();
}

// -- the persistent kernels' items ------------------------------------------------------

// The producer hands the block's n-th item to the consumers.
__device__ __forceinline__ void publish_item(const Bars& bars, int* slots, int n,
                                             const Item& it) {
  publish_item(bars.item_full(0), bars.item_empty(0), slots, n, it);
}

// A consumer warp takes the block's n-th item.
__device__ __forceinline__ Item take_item(const Bars& bars, const int* slots, int n) {
  return take_item(bars.item_full(0), bars.item_empty(0), slots, n);
}

// s = A B^T and t = C E^T over the D columns of four 64-row tiles at
// shared-memory addresses a, b, c, e. Issued, not committed or waited for.
template <int D>
__device__ __forceinline__ void two_scores(float (&s)[BK / 8][4], float (&t)[BK / 8][4],
                                           uint32_t a, uint32_t b, uint32_t c, uint32_t e) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss(s, desc_k_major<D>(a, kk), desc_k_major<D>(b, kk), kk > 0);
    wgmma_ss(t, desc_k_major<D>(c, kk), desc_k_major<D>(e, kk), kk > 0);
  }
}

// Accumulator columns J0 .. J0+N-1 plus the same columns that the other
// warpgroup stashed (flex_sm90.cuh's stash).
template <int J0, int N, int J>
__device__ __forceinline__ void add_stashed(float (&acc)[J][4], const float* buf, int tid) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[J0 + j][c] += buf[(j * 4 + c) * WG_THREADS + tid];
}

// Columns 8 J0 .. 8 (J0+N) - 1 of this thread's two rows, row and row + 8,
// of a [rows, 8 J] f32 array, times scale.
template <int J0, int N, int J>
__device__ __forceinline__ void store_cols(float* out, const float (&acc)[J][4], int row, int t4,
                                           float scale) {
  float* p0 = out + (size_t)row * (8 * J) + 2 * t4;
  float* p1 = p0 + 8 * (8 * J);
#pragma unroll
  for (int j = J0; j < J0 + N; ++j) {
    store2(p0 + 8 * j, acc[j][0] * scale, acc[j][1] * scale);
    store2(p1 + 8 * j, acc[j][2] * scale, acc[j][3] * scale);
  }
}

// -- dq ---------------------------------------------------------------------------------

// The next entry of the q-major walk after e that this consumer warpgroup
// computes, keeping the item-local distinct-k-block count (step) and the k
// block (kb) up to date; false past the end, with step at the walk's
// distinct k blocks - 1. SPLIT: the warpgroups split the walk by k block,
// step % 2 == wg.
template <bool SPLIT>
__device__ __forceinline__ bool next_entry(const int* __restrict__ kblk, int& e, int e_end,
                                           int& step, int& kb, int wg) {
  while (++e < e_end) {
    const int k = kblk[e];
    if (k != kb) {
      kb = k;
      ++step;
    }
    if (!SPLIT || (step & 1) == wg) return true;
  }
  return false;
}

// The producer's resident tiles of the block's n-th dq item: the Q and dO
// tiles of its NH q heads into buffer n % RES, once the consumers of the
// buffer's previous item are done with it.
template <int D, int NH, int RES>
__device__ __forceinline__ void dq_resident(const Bars& bars, uint32_t base,
                                            const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            int h0, int i, int tqp, int n) {
  using L = DqLayout<D, NH, RES>;
  const int r = n % RES;
  mbar_wait(bars.res_empty(r), ((n / RES) & 1) ^ 1);
  mbar_expect_tx(bars.res_full(r), L::RESIDENT);
  for (int hh = 0; hh < NH; ++hh) {
    const int row = (h0 + hh) * tqp + i * BQ;
    const uint32_t dst = base + r * L::RESIDENT + 2 * hh * L::TB;
    tma_load_tile<D>(dst, tm_q, bars.res_full(r), row);
    tma_load_tile<D>(dst + L::TB, tm_do, bars.res_full(r), row);
  }
}

// The producer of a dq item (one thread): the resident Q and dO tiles of
// the item's NH q heads (h0 ..), then K and V once per distinct k block of
// the walk (consecutive entries may share one: the slices of one tile),
// stage after stage from the block's running fill count `ring`. Returns the
// running fill count after the item.
template <int D, int NH, int RES>
__device__ __forceinline__ int dq_producer(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                           const int* __restrict__ kblk, int e_begin, int e_end,
                                           int h0, int kvh, int i, int tqp, int tkp,
                                           uint32_t base, int n, int ring) {
  using L = DqLayout<D, NH, RES>;
  const Bars bars{base + L::BARS};
  dq_resident<D, NH, RES>(bars, base, tm_q, tm_do, h0, i, tqp, n);
  int fills = 0, loaded = -1;
  for (int e = e_begin; e < e_end; ++e) {
    const int kb = kblk[e];
    if (kb == loaded) continue;
    loaded = kb;
    const int f = ring + fills;
    const int st = f % L::STG;
    mbar_wait(bars.empty(st), ((f / L::STG) & 1) ^ 1);
    mbar_expect_tx(bars.full(st), 2 * L::TB);
    const uint32_t dst = base + L::RING + st * 2 * L::TB;
    const int row = kvh * tkp + kb * BK;
    tma_load_tile<D>(dst, tm_k, bars.full(st), row);
    tma_load_tile<D>(dst + L::TB, tm_v, bars.full(st), row);
    ++fills;
  }
  return ring + fills;
}

// A consumer warpgroup of a dq item. NH = 2: warpgroup wg owns q head
// h0 + wg and walks every entry (both read each stage: G > 1 heads of one kv
// head have identical walks). NH = 1: both own q head h0 and split its walk
// by k block — the s-th distinct k block of the item to warpgroup s % 2 —
// and each keeps half of the columns of the sum of their two partials,
// handed over through the item's resident buffer. Returns the running fill
// count after the item.
template <int D, int NH, int RES>
__device__ __forceinline__ int dq_consumer(
    int wg, unsigned char* smem, uint32_t base, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ kblk, const int* __restrict__ sid,
    const int* __restrict__ runs, const int* __restrict__ bounds, int e_begin, int e_end,
    float* __restrict__ dq, int h0, int i, int tqp, float scale, float softcap, int n,
    int ring) {
  using L = DqLayout<D, NH, RES>;
  constexpr int J = D / 8;
  const Bars bars{base + L::BARS};
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int slot = NH == 2 ? wg : 0;  // the resident head
  const int h = h0 + slot;
  const int r = n % RES;  // the resident buffer
  const uint32_t sq = base + r * L::RESIDENT + 2 * slot * L::TB, sdo = sq + L::TB;

  const int r0 = warp * 16 + g;  // this thread's rows of the tile: r0 and r0 + 8
  const int row[2] = {i * BQ + r0, i * BQ + r0 + 8};
  float lse_safe[2], dlt[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float x = lse[(size_t)h * tqp + row[rr]];
    lse_safe[rr] = x == -INFINITY ? 0.f : x;
    dlt[rr] = delta[(size_t)h * tqp + row[rr]];
  }
  float acc[J][4];
  zero(acc);

  mbar_wait(bars.res_full(r), (n / RES) & 1);
  // the walk: entry e of k block kb, the step-th distinct k block of the
  // item, in ring fill ring + step
  int e = e_begin - 1, step = -1, kb = -1, held = -1;
  while (next_entry<NH == 1>(kblk, e, e_end, step, kb, wg)) {
    const int f = ring + step;
    const uint32_t sk = base + L::RING + (f % L::STG) * 2 * L::TB, sv = sk + L::TB;
    if (step != held) {  // a new k block: done with the last one's K and V
      if (held >= 0) release_stage(bars.empty((ring + held) % L::STG));
      held = step;
      mbar_wait(bars.full(f % L::STG), (f / L::STG) & 1);
    }

    // S = Q K^T and dP = dO V^T, 64 rows x 64 keys; the entry's mask
    // worked out while they run
    float s[BK / 8][4], dp[BK / 8][4];
    wgmma_fence();
    two_scores<D>(s, dp, sq, sk, sdo, sv);
    wgmma_commit();
    int lo[2], hi[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      entry_interval(runs, bounds, sid[e], e, row[rr], lo[rr], hi[rr]);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS in place of S
    const int col0 = kb * BK + 2 * t4;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        const int col = col0 + j * 8 + (c & 1);
        float p, ds;
        p_ds(logit(s[j][c], scale, softcap), col >= lo[rr] && col < hi[rr], lse_safe[rr],
             dp[j][c], dlt[rr], softcap, p, ds);
        s[j][c] = ds;
      }
    }

    // dQ += dS K, dS rounded to bf16 (K's type)
    uint32_t a[4][4];
    to_a_frags(a, s);
    wgmma_fence();
    acc_product(acc, a, sk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
  }
  if (held >= 0) release_stage(bars.empty((ring + held) % L::STG));  // the last K and V

  float* out = dq + (size_t)h * tqp * D;
  const int row0 = i * BQ + r0;
  if constexpr (NH == 1) {
    constexpr int HALF = J / 2;
    static_assert(CONSUMERS * HALF * 4 * WG_THREADS * 4 <= L::RESIDENT, "hand-over size");
    named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);  // both walks done: Q and dO are free
    fence_proxy_async();
    float* handoff = reinterpret_cast<float*>(smem + r * L::RESIDENT);  // [wg][HALF * 4][128]
    float* from_wg0 = handoff;
    float* from_wg1 = handoff + HALF * 4 * WG_THREADS;
    if (wg == 0)
      stash<HALF, HALF>(from_wg0, acc, tid);  // warpgroup 0 keeps the first half
    else
      stash<0, HALF>(from_wg1, acc, tid);
    named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);
    if (wg == 0)
      add_stashed<0, HALF>(acc, from_wg1, tid);
    else
      add_stashed<HALF, HALF>(acc, from_wg0, tid);
    fence_proxy_async();
    release_stage(bars.res_empty(r));  // the buffer to the producer's next load
    if (wg == 0)
      store_cols<0, HALF>(out, acc, row0, t4, scale);
    else
      store_cols<HALF, HALF>(out, acc, row0, t4, scale);
  } else {
    release_stage(bars.res_empty(r));  // every product that read Q and dO is done
    store_cols<0, J>(out, acc, row0, t4, scale);
  }
  return ring + step + 1;
}

// -- dk, dv -----------------------------------------------------------------------------

// The producer of a dk/dv item (one thread): the resident K and V tiles of
// the item's kv head and k block into buffer n % RES, then per (entry, q
// head) of the walk — entry outer, the G q heads of the kv head inner — the
// Q and dO tiles with their 64 lse and delta_eff values, stage after stage
// from the block's running fill count `ring`. Returns the running fill
// count after the item.
template <int D, int RES>
__device__ __forceinline__ int dkv_producer(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qblk, int e_begin, int e_end, int group, int hk, int i, int tqp,
    int tkp, uint32_t base, int n, int ring) {
  using L = DkvLayout<D, RES>;
  const Bars bars{base + L::BARS};
  const int r = n % RES;
  mbar_wait(bars.res_empty(r), ((n / RES) & 1) ^ 1);
  mbar_expect_tx(bars.res_full(r), 2 * L::TB);
  const int krow = hk * tkp + i * BK;
  tma_load_tile<D>(base + r * L::RESIDENT, tm_k, bars.res_full(r), krow);
  tma_load_tile<D>(base + r * L::RESIDENT + L::TB, tm_v, bars.res_full(r), krow);
  int f = ring;
  for (int e = e_begin; e < e_end; ++e) {
    const int qb = qblk[e];
    for (int gi = 0; gi < group; ++gi, ++f) {
      const int st = f % L::STG;
      mbar_wait(bars.empty(st), ((f / L::STG) & 1) ^ 1);
      mbar_expect_tx(bars.full(st), 2 * L::TB + 2 * BQ * 4);
      const int q0 = (hk * group + gi) * tqp + qb * BQ;
      const uint32_t dst = base + L::RING + st * 2 * L::TB;
      tma_load_tile<D>(dst, tm_q, bars.full(st), q0);
      tma_load_tile<D>(dst + L::TB, tm_do, bars.full(st), q0);
      const uint32_t vec = base + L::VEC + st * 2 * BQ * 4;
      bulk_load(vec, lse + q0, BQ * 4, bars.full(st));
      bulk_load(vec + BQ * 4, delta + q0, BQ * 4, bars.full(st));
    }
  }
  return f;
}

// A consumer warpgroup of a dk/dv item: the (entry, q head) steps of the
// walk alternate between the two warpgroups (step m to warpgroup m % 2),
// each accumulating its own dK and dV partials (dka, dva: zero on entry)
// over the block's 64 keys; at the end warpgroup 1 hands its dK partial to
// warpgroup 0, which adds it to its own and stores dK, and warpgroup 0 its
// dV partial to warpgroup 1, which stores dV: both at once through the ring
// where the block has one item (RES = 1), else one after the other through
// the item's resident buffer. Returns the running fill count after the item.
template <int D, int RES>
__device__ __forceinline__ int dkv_consumer(
    int wg, unsigned char* smem, uint32_t base, const int* __restrict__ qblk,
    const int* __restrict__ sid, const int* __restrict__ runs, const int* __restrict__ bounds,
    int e_begin, int e_end, float* __restrict__ dk, float* __restrict__ dv, int group, int hk,
    int i, int tkp, float scale, float softcap, int n, int ring, float (&dka)[D / 8][4],
    float (&dva)[D / 8][4]) {
  using L = DkvLayout<D, RES>;
  constexpr int J = D / 8;
  // the hand-over of one partial fits the resident buffer (d = 80, 96: with
  // room to spare, the buffer being d = 128's), and of both the ring
  static_assert(J * 4 * WG_THREADS * 4 <= L::RESIDENT, "hand-over size");
  static_assert(2 * J * 4 * WG_THREADS * 4 <= L::STG * 2 * L::TB, "hand-over size");
  const Bars bars{base + L::BARS};
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's key rows of the tile: r0 and r0 + 8
  const int key[2] = {i * BK + r0, i * BK + r0 + 8};
  const float* vec = reinterpret_cast<const float*>(smem + L::VEC);
  int* iv = reinterpret_cast<int*>(smem + L::IV) + wg * 2 * 2 * BQ;  // [buffer][lo | hi][row]
  const int r = n % RES;  // the resident buffer
  const uint32_t sk = base + r * L::RESIDENT, sv = sk + L::TB;

  mbar_wait(bars.res_full(r), (n / RES) & 1);
  // step m = (entry e_begin + m / group, q head m % group) in ring fill
  // ring + m; this warpgroup's are m = wg, wg + 2, ...
  const int steps = (e_end - e_begin) * group;
  int buf = 0, last = -1;
  for (int m = wg; m < steps; m += CONSUMERS) {
    const int e = e_begin + m / group;
    const int f = ring + m;
    const int stage = f % L::STG;
    const uint32_t sq = base + L::RING + stage * 2 * L::TB, sdo = sq + L::TB;
    mbar_wait(bars.full(stage), (f / L::STG) & 1);

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 query rows
    float st[BQ / 8][4], dpt[BQ / 8][4];
    wgmma_fence();
    two_scores<D>(st, dpt, sk, sq, sv, sdo);
    wgmma_commit();
    if (e != last) {
      // the entry's k-interval per query row, worked out while the products
      // run, into the buffer not read since this warpgroup's last barrier
      last = e;
      buf ^= 1;
      if (tid < BQ)
        entry_interval(runs, bounds, sid[e], e, qblk[e] * BQ + tid, iv[buf * 2 * BQ + tid],
                       iv[buf * 2 * BQ + BQ + tid]);
      named_sync(BAR_WG + wg, WG_THREADS);
    }
    const int* lo = iv + buf * 2 * BQ;
    const int* hi = lo + BQ;
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const float* s_lse = vec + stage * 2 * BQ;
    const float* s_delta = s_lse + BQ;

    // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int t = j * 8 + 2 * t4;  // query rows t and t + 1 of the tile
      const float2 lse2 = *reinterpret_cast<const float2*>(s_lse + t);
      const float2 dlt2 = *reinterpret_cast<const float2*>(s_delta + t);
      const int2 lo2 = *reinterpret_cast<const int2*>(lo + t);
      const int2 hi2 = *reinterpret_cast<const int2*>(hi + t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool odd = c & 1;
        const float x = odd ? lse2.y : lse2.x;
        const int k = key[c >> 1];
        const bool on = k >= (odd ? lo2.y : lo2.x) && k < (odd ? hi2.y : hi2.x);
        float p, ds;
        p_ds(logit(st[j][c], scale, softcap), on, x == -INFINITY ? 0.f : x, dpt[j][c],
             odd ? dlt2.y : dlt2.x, softcap, p, ds);
        st[j][c] = p;
        dpt[j][c] = ds;
      }
    }

    // dV += P^T dO (P rounded to bf16, dO's type); dK += dS^T Q (dS
    // rounded to bf16, Q's type)
    uint32_t ap[4][4], ads[4][4];
    to_a_frags(ap, st);
    to_a_frags(ads, dpt);
    wgmma_fence();
    acc_product(dva, ap, sdo);
    acc_product(dka, ads, sq);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(ap);
    fence_regs(ads);
    release_stage(bars.empty(stage));
  }

  named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);  // both walks done
  fence_proxy_async();
  const size_t k0 = (size_t)hk * tkp;
  if constexpr (RES == 1) {
    // one item a block (the row-major kernel): the ring is free, and holds
    // both partials at once
    float* sib_k = reinterpret_cast<float*>(smem + L::RING);  // warpgroup 1's dK partial
    float* sib_v = sib_k + J * 4 * WG_THREADS;                // warpgroup 0's dV partial
    if (wg == 1)
      stash<0, J>(sib_k, dka, tid);
    else
      stash<0, J>(sib_v, dva, tid);
    named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);
    if (wg == 0) {
      add_stashed<0, J>(dka, sib_k, tid);
      store_cols<0, J>(dk + k0 * D, dka, i * BK + r0, t4, scale);
    } else {
      add_stashed<0, J>(dva, sib_v, tid);
      store_cols<0, J>(dv + k0 * D, dva, i * BK + r0, t4, 1.f);
    }
  } else {
    // the producer is refilling the ring with the next item's tiles: one
    // partial after the other through this item's resident K/V buffer, then
    // the buffer back to the producer
    float* partial = reinterpret_cast<float*>(smem + r * L::RESIDENT);  // [J * 4][128]
    if (wg == 1) {
      stash<0, J>(partial, dka, tid);  // warpgroup 1's dK partial to warpgroup 0
      named_arrive(BAR_HANDOFF, CONSUMERS * WG_THREADS);
      named_sync(BAR_HANDOFF_BACK, CONSUMERS * WG_THREADS);  // warpgroup 0's dV partial is in
      add_stashed<0, J>(dva, partial, tid);
      fence_proxy_async();
      release_stage(bars.res_empty(r));
      store_cols<0, J>(dv + k0 * D, dva, i * BK + r0, t4, 1.f);
    } else {
      named_sync(BAR_HANDOFF, CONSUMERS * WG_THREADS);
      add_stashed<0, J>(dka, partial, tid);
      stash<0, J>(partial, dva, tid);  // into the places this thread just read
      named_arrive(BAR_HANDOFF_BACK, CONSUMERS * WG_THREADS);
      fence_proxy_async();
      release_stage(bars.res_empty(r));
      store_cols<0, J>(dk + k0 * D, dka, i * BK + r0, t4, scale);
    }
  }
  return ring + steps;
}

// Columns c0 .. c0 + 8 N - 1 of this thread's two rows, row and row + 8, of
// a [rows, W] f32 array, from acc's N column groups, times scale.
template <int W, int N>
__device__ __forceinline__ void store_cols_at(float* out, const float (&acc)[N][4], int row,
                                              int c0, int t4, float scale) {
  float* p0 = out + (size_t)row * W + c0 + 2 * t4;
  float* p1 = p0 + 8 * W;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    store2(p0 + 8 * j, acc[j][0] * scale, acc[j][1] * scale);
    store2(p1 + 8 * j, acc[j][2] * scale, acc[j][3] * scale);
  }
}

// A consumer warpgroup of a dk/dv item at d = 256: every (entry, q head)
// step of the walk in order, the two warpgroups each computing S^T and dP^T
// over the whole d and accumulating dK and dV over its own half of the
// columns (warpgroup wg: columns 128 wg ..), each held in registers alone
// (dka, dva: zero on entry) and stored by it; nothing is handed over.
// Returns the running fill count after the item.
template <int D, int RES>
__device__ __forceinline__ int dkv_consumer_halves(
    int wg, unsigned char* smem, uint32_t base, const int* __restrict__ qblk,
    const int* __restrict__ sid, const int* __restrict__ runs, const int* __restrict__ bounds,
    int e_begin, int e_end, float* __restrict__ dk, float* __restrict__ dv, int group, int hk,
    int i, int tkp, float scale, float softcap, int n, int ring, float (&dka)[D / 16][4],
    float (&dva)[D / 16][4]) {
  using L = DkvLayout<D, RES>;
  static_assert(D == 256, "the halves walk is d = 256's: two halves of two chunks each");
  const Bars bars{base + L::BARS};
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's key rows of the tile: r0 and r0 + 8
  const int key[2] = {i * BK + r0, i * BK + r0 + 8};
  const float* vec = reinterpret_cast<const float*>(smem + L::VEC);
  int* iv = reinterpret_cast<int*>(smem + L::IV) + wg * 2 * 2 * BQ;  // [buffer][lo | hi][row]
  const int r = n % RES;  // the resident buffer
  const uint32_t sk = base + r * L::RESIDENT, sv = sk + L::TB;
  const uint32_t half = wg * 2 * CHUNK_BYTES;  // this warpgroup's columns within a tile

  mbar_wait(bars.res_full(r), (n / RES) & 1);
  // step m = (entry e_begin + m / group, q head m % group) in ring fill ring + m
  const int steps = (e_end - e_begin) * group;
  int buf = 0, last = -1;
  for (int m = 0; m < steps; ++m) {
    const int e = e_begin + m / group;
    const int f = ring + m;
    const int stage = f % L::STG;
    const uint32_t sq = base + L::RING + stage * 2 * L::TB, sdo = sq + L::TB;
    mbar_wait(bars.full(stage), (f / L::STG) & 1);

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 query rows, over all of d
    float st[BQ / 8][4], dpt[BQ / 8][4];
    wgmma_fence();
    two_scores<D>(st, dpt, sk, sq, sv, sdo);
    wgmma_commit();
    if (e != last) {
      // the entry's k-interval per query row, worked out while the products
      // run, into the buffer not read since this warpgroup's last barrier
      last = e;
      buf ^= 1;
      if (tid < BQ)
        entry_interval(runs, bounds, sid[e], e, qblk[e] * BQ + tid, iv[buf * 2 * BQ + tid],
                       iv[buf * 2 * BQ + BQ + tid]);
      named_sync(BAR_WG + wg, WG_THREADS);
    }
    const int* lo = iv + buf * 2 * BQ;
    const int* hi = lo + BQ;
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    const float* s_lse = vec + stage * 2 * BQ;
    const float* s_delta = s_lse + BQ;

    // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int t = j * 8 + 2 * t4;  // query rows t and t + 1 of the tile
      const float2 lse2 = *reinterpret_cast<const float2*>(s_lse + t);
      const float2 dlt2 = *reinterpret_cast<const float2*>(s_delta + t);
      const int2 lo2 = *reinterpret_cast<const int2*>(lo + t);
      const int2 hi2 = *reinterpret_cast<const int2*>(hi + t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool odd = c & 1;
        const float x = odd ? lse2.y : lse2.x;
        const int k = key[c >> 1];
        const bool on = k >= (odd ? lo2.y : lo2.x) && k < (odd ? hi2.y : hi2.x);
        float p, ds;
        p_ds(logit(st[j][c], scale, softcap), on, x == -INFINITY ? 0.f : x, dpt[j][c],
             odd ? dlt2.y : dlt2.x, softcap, p, ds);
        st[j][c] = p;
        dpt[j][c] = ds;
      }
    }

    // this warpgroup's half of dV += P^T dO (P rounded to bf16, dO's type)
    // and of dK += dS^T Q (dS rounded to bf16, Q's type)
    uint32_t ap[4][4], ads[4][4];
    to_a_frags(ap, st);
    to_a_frags(ads, dpt);
    wgmma_fence();
    acc_product(dva, ap, sdo + half);
    acc_product(dka, ads, sq + half);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(ap);
    fence_regs(ads);
    release_stage(bars.empty(stage));
  }
  release_stage(bars.res_empty(r));  // every product that read K and V is done
  const size_t k0 = (size_t)hk * tkp;
  store_cols_at<D>(dk + k0 * D, dka, i * BK + r0, wg * (D / 2), t4, scale);
  store_cols_at<D>(dv + k0 * D, dva, i * BK + r0, wg * (D / 2), t4, 1.f);
  return ring + steps;
}

// A consumer warpgroup's dk/dv item at any d: dkv_consumer's split walk, or
// at d = 256 dkv_consumer_halves. dka, dva hold DKV_J<D> column groups.
template <int D, int RES>
__device__ __forceinline__ int dkv_item(
    int wg, unsigned char* smem, uint32_t base, const int* __restrict__ qblk,
    const int* __restrict__ sid, const int* __restrict__ runs, const int* __restrict__ bounds,
    int e_begin, int e_end, float* __restrict__ dk, float* __restrict__ dv, int group, int hk,
    int i, int tkp, float scale, float softcap, int n, int ring, float (&dka)[DKV_J<D>][4],
    float (&dva)[DKV_J<D>][4]) {
  if constexpr (D <= 128)
    return dkv_consumer<D, RES>(wg, smem, base, qblk, sid, runs, bounds, e_begin, e_end, dk, dv,
                                group, hk, i, tkp, scale, softcap, n, ring, dka, dva);
  else
    return dkv_consumer_halves<D, RES>(wg, smem, base, qblk, sid, runs, bounds, e_begin, e_end,
                                       dk, dv, group, hk, i, tkp, scale, softcap, n, ring, dka,
                                       dva);
}

}  // namespace sm90
}  // namespace flex

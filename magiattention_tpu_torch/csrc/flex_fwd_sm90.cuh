// The warp-specialised walk of the flex-attention forward for Hopper
// (sm_90a), the one walk of the row-major flex_fwd.cu (the launch shape of
// magiattention_tpu/ops/flex_attn.py::_fwd_pallas) and flex_fwd_hb.cu
// (_fwd_pallas_hb), and of the sparse-grid flex_fwd_sparse.cu
// (_fwd_pallas_sparse) and flex_fwd_sparse_hb.cu (_fwd_pallas_hb_sparse).
//
// What it computes, as the TPU kernels _fwd_kernel and _fwd_kernel_hb do:
// for one q block i and the q heads of a work item it walks that block's
// entries rs[i] .. rs[i]+rc[i]-1 — (k block, slice, run window) tiles from
// ops/block_meta.py — and runs scores -> scale -> softcap -> the entry's
// per-row k-interval mask -> the natural-exp online softmax, P rounded to
// bf16 (V's type) before P V, then folds in the optional per-head sink.
// Outputs: out [hq, tqp, d] (bf16 or f32), lse and rowmax [hq, tqp] f32
// (lse -inf on an uncovered row, or the sink if one is set; rowmax without
// the sink).
//
// d = 80 and 96 (Phi-2's and Phi-3-mini's widths) run d = 128's layout:
// each tile is loaded as d = 128's two boxes, zeros past d (flex_sm90.cuh's
// padded_d), and the walk's products run at the true d (S = Q K^T over d / 16
// k slices, P V at N = d), its O accumulator d / 8 column groups; Q stays in
// shared memory there, as at d = 64.
//
// d = 256 (Gemma's width): a 64-row tile is 32 KB, so the d <= 128 layout
// (two Q buffers of a head pair, four K/V stages: 384 KB) does not fit an
// SM's 227 KB. FwdLayout keeps one Q buffer and two ring stages a block
// (one for each stream of its own on the sparse grid), and each consumer
// warpgroup holds one stage at a time: an entry's S = Q K^T, softmax and
// P V run one after the other (PIPELINE off), and the stage goes back to
// the producer when the walk moves to the next k block, so the producer
// loads the next k block while the consumers compute this one. O (64 x 256
// f32) takes 128 of a consumer thread's registers, S 32 and P 16; Q stays
// in shared memory. The SPLIT hand-over of partials (odd G) goes in two
// rounds of a quarter of O's columns each.
//
// What bounds it on the card: ~4 d FLOPs per unmasked (q, k) pair and q
// head (S = Q K^T and O += P V) against 2 bytes of K/V per key that a q
// block re-reads from L2, so a causal prefill is bound by tensor-core
// operations (989 TFLOP/s bf16 dense on an H100 SXM).
//
// How a block runs it (the shape of flex_sm90.cuh's warp-specialised
// blocks, as flex_bwd_sm90.cuh's flex_dq). A producer warpgroup: one thread
// TMA-loads the Q tiles of each step of the item (double-buffered, so the
// next step's Q lands while this one's walk runs) and streams the walk's K
// and V tiles, once per distinct k block, through a ring of STAGES stages;
// one warp works out each entry's k block and per-row k-intervals into a
// ring of entry slots, so that no global load sits on the consumers' path.
// Two consumer warpgroups at 232 registers: each holds its Q tile in
// registers (d = 128) and runs S = Q K^T on wgmma with K from shared memory
// (K-major), the softmax core in registers, and O += P V on wgmma with P
// from registers and V as the MN-major B operand. The score tile and the
// softmax state never leave registers. The walk is software-pipelined as
// in FlashAttention-3: an entry's score products are issued together with
// the previous entry's P V, which runs under this entry's softmax, and each
// group of products has its own wgmma fence, so that ptxas keeps them
// asynchronous (with one fence, or the P V issued conditionally inside the
// loop, it serialised them: notices C7514, C7515, C7520). O is rescaled
// only when a row's max passes its reference by more than 2^8
// (FlashAttention-4's conditional rescale). Tried and not kept, as no
// faster on the card: the two consumers taking turns to issue their
// products (a named-barrier ping pong), and, for the row-major grid (whose
// blocks already go out longest walk first), persistent blocks walking a
// list of items.
//
// The work split, fixed and without atomics, so the same inputs give the
// same bits on every run: at even G a step is a head pair of one kv head,
// one head per consumer warpgroup, both reading each K/V stage; at odd G a
// step is one head whose walk the two consumers split by k block (the s-th
// distinct k block to warpgroup s % 2), and whose (reference, l, O)
// partials they merge once through shared memory, each keeping half of the
// columns. A work item of head_block q heads walks its steps in turn. A
// row's arithmetic depends on G only, not on the kernel or the head_block,
// so flex_fwd and flex_fwd_hb give the same bits.
//
// The sparse grid (AMLA = true). The TPU's sparse kernels run another
// online softmax, AMLA's, and so do their Hopper counterparts: the
// reference is an integer in base 2, ceil(max z log2 e), moved (as the
// row-major reference is) only when a row's max passes it by more than 2^8
// in P; P = exp2(z log2 e - ref); l and O are rescaled by
// 2^(ref_old - ref_new), an integer add on the exponent bits
// (flex_tile.cuh's amla_rescale, skipped where no row of a warp moved);
// the exact natural max m is kept for rowmax, and the epilogue takes the
// reference as ref ln 2 (the JAX _amla_finalize). The kernels are
// persistent (fwd_persistent): one block per SM takes items from the
// longest-walk-first work list, the producer thread claiming the next item
// as soon as it has issued the current item's last K/V load and handing it
// to the entry warp and the consumers through flex_sm90.cuh's item slots,
// then loading its Q tiles and first K/V stages while the consumers finish
// the current walk and store it. At even G a step is the row-major head
// pair. Where a step is one head (odd G, or head_block 1) the two
// consumer warpgroups do not split its walk: each takes items of its own,
// with a stream of its own (half the ring, half the entry slots, its own
// producer thread and entry warp), so that two short walks run at once
// with no merge; on the 16k varlen mask, whose walks are mostly 1-3
// tiles, that was faster than the split walk on the card. The counts that
// run on across items (ring fills, entry slots, Q steps: FwdPos) come from
// the caller; a row-major block starts them at 0 for its one item. Each
// item is computed whole by one warpgroup pair or one warpgroup, so the
// bits do not depend on which block took which item.
#pragma once

#include "flex_tile.cuh"
#include "flex_sm90.cuh"

namespace flex {
namespace sm90 {

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22; 0 for -inf).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The producer warpgroup gives up registers to the consumers (setmaxnreg);
// 128 x 40 + 256 x 232 is within an SM's 64 K.
constexpr int FWD_PRODUCER_REGS = 40, FWD_CONSUMER_REGS = 232;
constexpr int META_SLOTS = 8;   // entry slots in flight
// AMLA's integer reference moves only when a row's max passes it by more
// than this, in base 2. Moving it on every rise, as the TPU kernel does,
// gives results within the same tolerances but is slower on the card (an
// exponent add costs some five integer operations an element of O):
// chip_smoke.py's hetero phase times the two in turns.
constexpr float AMLA_MOVE_AT = 8.f;
constexpr int SLOT_INTS = 2 * BQ + 4;  // a slot: lo[64], hi[64], the k block, padding

// A stream's barriers: q_full[2] and q_empty[2] for the Q buffers,
// full[STG] and empty[STG] for the ring, meta_full[SLOTS] and
// meta_empty[SLOTS] for the entry slots, item_full[ITEM_SLOTS] and
// item_empty[ITEM_SLOTS] for the item slots.
template <int STG, int SLOTS>
struct FwdBars {
  static constexpr int N_STG = STG, N_SLOTS = SLOTS;
  uint32_t base;
  __device__ __forceinline__ uint32_t q_full(int b) const { return base + 8 * b; }
  __device__ __forceinline__ uint32_t q_empty(int b) const { return base + 16 + 8 * b; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + 32 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + 32 + 8 * (STG + s); }
  __device__ __forceinline__ uint32_t meta_full(int s) const {
    return base + 32 + 8 * (2 * STG + s);
  }
  __device__ __forceinline__ uint32_t meta_empty(int s) const {
    return base + 32 + 8 * (2 * STG + SLOTS + s);
  }
  __device__ __forceinline__ uint32_t item_full(int x) const {
    return base + 32 + 8 * (2 * STG + 2 * SLOTS + x);
  }
  __device__ __forceinline__ uint32_t item_empty(int x) const {
    return base + 32 + 8 * (2 * STG + 2 * SLOTS + ITEM_SLOTS + x);
  }
};

// The shared memory of a stream, the tiles and slots that one producer
// thread and one entry warp fill for the WGS consumer warpgroups that read
// them, from a 1024-byte aligned base: QBUF Q buffers of NH tiles, K and V
// per ring stage, the entry slots, where the two warpgroups split a
// head's walk (SPLIT) their hand-over of partials (each: ref, l and m of
// its two rows, and the part of its O columns the other keeps that one
// round hands over), then the barriers and the item slots of a persistent
// block. A block holds one stream (WGS = 2) or one per consumer warpgroup
// (WGS = 1, each with half the ring and half the entry slots). d = 256
// (WIDE, see the top): one Q buffer, two ring stages a block, the walk
// unpipelined, the hand-over in two rounds.
template <int D, int NH, int WGS = CONSUMERS>
struct FwdLayout {
  static constexpr bool WIDE = D > 128;
  static constexpr bool PIPELINE = !WIDE;  // an entry's S = Q K^T beside the last one's P V
  static constexpr int QBUF = WIDE ? 1 : 2;
  static constexpr int STG = (WIDE ? 2 : STAGES) * WGS / CONSUMERS;
  static constexpr int SLOTS = META_SLOTS * WGS / CONSUMERS;
  static constexpr bool SPLIT = NH == 1 && WGS == CONSUMERS;
  static constexpr int TB = tile_bytes<D>();
  static constexpr int RING = QBUF * NH * TB;
  static constexpr int META = RING + STG * 2 * TB;
  static constexpr int STASH = META + SLOTS * SLOT_INTS * 4;
  static constexpr int ROUNDS = WIDE ? 2 : 1;  // the hand-over's rounds
  static constexpr int STASH_WG = (6 + D / 4 / ROUNDS) * WG_THREADS;  // floats a round hands over
  static constexpr int BARS = STASH + (SPLIT ? CONSUMERS * STASH_WG * 4 : 0);
  static constexpr int ITEMS = BARS + 8 * (4 + 2 * STG + 2 * SLOTS + 2 * ITEM_SLOTS);
  static constexpr int BYTES = ITEMS + ITEM_SLOTS * ITEM_INTS * 4;
  static constexpr int STREAM = (BYTES + 1023) / 1024 * 1024;
  static constexpr int ALLOC = CONSUMERS / WGS * STREAM + 1024;
  static_assert(ALLOC <= 232448, "a block's shared memory fits an SM");
  // SPLIT: the warpgroups take every other k block, each from stages of its
  // own, and hold two of them at once where the walk is pipelined; with
  // fewer a warpgroup's wait could pass on a phase two behind
  static_assert(!SPLIT || STG >= (PIPELINE ? 4 : 2), "a split walk's ring stages");
  using Bars = FwdBars<STG, SLOTS>;
};

// The sparse grid's streams: a head pair shares one (both warpgroups read
// each K/V stage); a single head's walk is one warpgroup's alone.
template <int D, int NH>
using SparseLayout = FwdLayout<D, NH, NH == 2 ? CONSUMERS : 1>;

// Where a role stands in its stream's sequence of items: the counts that
// run on from one item to the next (all 0 before the first item).
struct FwdPos {
  int ring;   // K/V ring fills: fill f is stage f % STG at parity (f / STG) & 1
  int slot;   // entry slots: slot j is j % SLOTS at parity (j / SLOTS) & 1
  int qstep;  // steps begun: step s reads Q buffer s % QBUF at parity (s / QBUF) & 1
};

// The pointers and sizes of one launch.
template <typename OutT>
struct FwdArgs {
  const float* sink;
  const int *kblk, *sid, *runs, *bounds, *rs, *rc, *order;
  OutT* out;
  float *lse, *rowmax;
  int group, tqp, tkp;
  float scale, softcap;
  int has_sink;
};

// The producer (one thread) of an item: per step, the Q tiles of its NH q
// heads, then the K and V tiles of its kv head once per distinct k block of
// the walk (consecutive entries may share one: the slices of one tile).
template <int D, int NH, int WGS>
__device__ __forceinline__ void fwd_producer(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v,
                                             const int* __restrict__ kblk, int e_begin,
                                             int e_end, int h_item, int steps, int group, int i,
                                             int tqp, int tkp, uint32_t base, FwdPos& pos) {
  using L = FwdLayout<D, NH, WGS>;
  const typename L::Bars bars{base + L::BARS};
  for (int s = 0; s < steps; ++s) {
    const int h0 = h_item + s * NH;  // the step's first q head
    const int kvh = h0 / group;
    const int qs = pos.qstep + s;
    const int b = qs % L::QBUF;  // its Q buffer
    mbar_wait(bars.q_empty(b), ((qs / L::QBUF) & 1) ^ 1);
    mbar_expect_tx(bars.q_full(b), NH * L::TB);
    for (int hh = 0; hh < NH; ++hh)
      tma_load_tile<D>(base + (b * NH + hh) * L::TB, tm_q, bars.q_full(b),
                       (h0 + hh) * tqp + i * BQ);
    int loaded = -1;
    for (int e = e_begin; e < e_end; ++e) {
      const int kb = kblk[e];
      if (kb == loaded) continue;
      loaded = kb;
      const int n = pos.ring++;
      const int st = n % L::STG;
      mbar_wait(bars.empty(st), ((n / L::STG) & 1) ^ 1);
      mbar_expect_tx(bars.full(st), 2 * L::TB);
      const uint32_t dst = base + L::RING + st * 2 * L::TB;
      const int row = kvh * tkp + kb * BK;
      tma_load_tile<D>(dst, tm_k, bars.full(st), row);
      tma_load_tile<D>(dst + L::TB, tm_v, bars.full(st), row);
    }
  }
  pos.qstep += steps;
}

// The entry warp of an item: per step, per entry of the walk in order, the
// entry's k block and the k-interval [lo, hi) of each of the q block's 64
// rows (flex_tile.cuh's entry_interval, two rows a lane) into the next
// entry slot. The consumers read their rows' intervals from there.
template <typename Bars>
__device__ __forceinline__ void fwd_entries(const int* __restrict__ kblk,
                                            const int* __restrict__ sid,
                                            const int* __restrict__ runs,
                                            const int* __restrict__ bounds, int e_begin,
                                            int e_end, int steps, int i, int* meta,
                                            const Bars& bars, FwdPos& pos) {
  const int lane = threadIdx.x & 31;
  for (int s = 0; s < steps; ++s) {
    for (int e = e_begin; e < e_end; ++e) {
      const int j = pos.slot++;
      const int slot = j % Bars::N_SLOTS;
      mbar_wait(bars.meta_empty(slot), ((j / Bars::N_SLOTS) & 1) ^ 1);
      int* m = meta + slot * SLOT_INTS;
      const int sd = sid[e];
#pragma unroll
      for (int k = 0; k < BQ / 32; ++k) {
        const int r = lane + 32 * k;
        entry_interval(runs, bounds, sd, e, i * BQ + r, m[r], m[BQ + r]);
      }
      if (lane == 0) m[2 * BQ] = kblk[e];
      mbar_arrive(bars.meta_full(slot));  // one arrival a lane, after its writes
    }
  }
}

// One tile of the online softmax on this thread's two rows. x holds the
// tile's scores (the wgmma accumulator) and leaves as P = exp(z - ref); m
// (the rows' exact running max logit, natural scale), ref (the reference
// the exponents are taken against), l (this thread's share of the rows'
// sums against ref) and alpha (the factor the O accumulator is to be
// rescaled by) are updated. The reference moves to the max only when the
// max passes it by more than 2^8 in P (FlashAttention-4's conditional
// rescale): P then stays below 256, which f32 sums and bf16 P take
// without loss, and most tiles skip the rescale of O. Without a softcap
// (and with a positive scale) x stays the raw product and z = scale x:
// rounding is monotonic, so the max of the logits is the scaled max of x,
// and the exponent folds the scale in one multiply-add.
//
// AMLA: ref is an integer in base 2, ceil(max z log2 e) (= ceil(max(z
// log2 e)): rounding is monotonic), moved only when that passes it by more
// than AMLA_MOVE_AT (the conditional rescale again: P = exp2(z log2 e -
// ref) stays below 2^8); delta (not alpha) gives the rescale of l and O,
// 2^delta, an exponent add; a row that meets its first live key carries
// zero state and takes delta 0.
template <bool AMLA>
__device__ __forceinline__ void softmax_tile(float (&x)[BK / 8][4], float (&m)[2],
                                             float (&ref)[2], float (&l)[2], float (&alpha)[2],
                                             int (&delta)[2], const int (&lo)[2],
                                             const int (&hi)[2], int c0, int t4, float scale,
                                             float softcap) {
  constexpr float RESCALE_AT = 8.f * 0.6931471805599453f;  // ln 2^8
  const bool raw = !(softcap > 0.f) && scale > 0.f;
  const float zs = raw ? scale : 1.f;  // z = zs x
  if (!raw) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[j][c] = logit(x[j][c], scale, softcap);
  }
  // the entry's mask; a tile it covers whole for all of a warp's rows (most
  // of a causal walk) skips it
  const bool whole = lo[0] <= c0 && hi[0] >= c0 + BK && lo[1] <= c0 && hi[1] >= c0 + BK;
  if (!__all_sync(0xffffffffu, whole)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        const int col = c0 + j * 8 + 2 * t4 + (c & 1);
        x[j][c] = (col >= lo[rr] && col < hi[rr]) ? x[j][c] : -INFINITY;
      }
  }
  // the rows' maxima over this thread's 16 columns each, as trees
  float mx[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float v[BK / 8];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) v[j] = fmaxf(x[j][2 * rr], x[j][2 * rr + 1]);
#pragma unroll
    for (int w = BK / 16; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) v[j] = fmaxf(v[j], v[j + w]);
    mx[rr] = v[0];
  }
  float neg_ref2[2];  // -ref in base 2
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    // a row's 16 columns of the tile are spread over the 4 lanes of a quad
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    const float tile_max = mx[rr] * zs;  // the rows' max logit over the tile
    m[rr] = fmaxf(m[rr], tile_max);
    if constexpr (AMLA) {
      const float top = ceilf(tile_max * LOG2E_F);
      const bool move = ref[rr] == -INFINITY ? top != -INFINITY : top > ref[rr] + AMLA_MOVE_AT;
      delta[rr] = move && ref[rr] != -INFINITY ? (int)(ref[rr] - top) : 0;
      ref[rr] = move ? top : ref[rr];
      neg_ref2[rr] = ref[rr] == -INFINITY ? 0.f : -ref[rr];  // empty rows: no -inf - -inf
    } else {
      // a row that meets its first live key takes its max as the reference
      const bool move =
          ref[rr] == -INFINITY ? m[rr] != -INFINITY : m[rr] > ref[rr] + RESCALE_AT;
      alpha[rr] =
          !move ? 1.f : ref[rr] == -INFINITY ? 0.f : exp2_approx((ref[rr] - m[rr]) * LOG2E);
      ref[rr] = move ? m[rr] : ref[rr];
      neg_ref2[rr] = ref[rr] == -INFINITY ? 0.f : -ref[rr] * LOG2E;
    }
  }
  const float zs2 = zs * LOG2E;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[j][c] = exp2_approx(fmaf(x[j][c], zs2, neg_ref2[c >> 1]));
  float sum[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float v[BK / 8];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) v[j] = x[j][2 * rr] + x[j][2 * rr + 1];
#pragma unroll
    for (int w = BK / 16; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) v[j] += v[j + w];
    sum[rr] = v[0];
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    l[rr] = (AMLA ? amla_rescale(l[rr], delta[rr]) : l[rr] * alpha[rr]) + sum[rr];
}

// The epilogue of this thread's two rows, row0 and row0 + 8, of q head h,
// for O columns 8 J0 .. 8 (J0+N) - 1: the sink folded in, lse and rowmax
// (where ``stats``; rowmax is the exact max m), out = O / l, an uncovered
// row out = 0 and lse = -inf (or the sink). l and O are against ref (AMLA:
// against 2^ref, the natural reference ref ln 2, as _amla_finalize takes it).
template <bool AMLA, int J0, int N, int J, typename OutT>
__device__ __forceinline__ void fwd_store(const float (&o)[J][4], const float (&m)[2],
                                          const float (&ref)[2], const float (&l)[2],
                                          const FwdArgs<OutT>& a, int h, int row0, int t4,
                                          bool stats) {
  constexpr int D = 8 * J;
  float osc[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float mu = AMLA ? ref[rr] * LN2_F : ref[rr];  // -inf stays -inf
    float mt_safe, ltot, resc = 1.f;
    if (a.has_sink) {
      const float sk = a.sink[h];
      const float mtot = fmaxf(mu, sk);
      mt_safe = mtot == -INFINITY ? 0.f : mtot;
      resc = mu == -INFINITY ? 0.f : expf(mu - mt_safe);
      ltot = l[rr] * resc + expf(sk - mt_safe);
    } else {
      mt_safe = mu == -INFINITY ? 0.f : mu;
      ltot = l[rr];
    }
    const bool covered = ltot > 0.f;
    osc[rr] = covered ? resc / ltot : 0.f;
    if (stats && t4 == 0) {
      const size_t idx = (size_t)h * a.tqp + row0 + 8 * rr;
      a.lse[idx] = covered ? mt_safe + logf(ltot) : -INFINITY;
      a.rowmax[idx] = m[rr];
    }
  }
  OutT* p0 = a.out + ((size_t)h * a.tqp + row0) * D + 2 * t4;
  OutT* p1 = p0 + 8 * D;
#pragma unroll
  for (int j = J0; j < J0 + N; ++j) {
    store2(p0 + 8 * j, o[j][0] * osc[0], o[j][1] * osc[0]);
    store2(p1 + 8 * j, o[j][2] * osc[1], o[j][3] * osc[1]);
  }
}

// Merged back from a hand-over buffer (stash's layout): o = o w_mine +
// buf w_theirs, per row, for O columns 8 J0 .. 8 (J0+N) - 1.
template <int J0, int N, int J>
__device__ __forceinline__ void take_cols(float (&o)[J][4], const float* buf,
                                          const float (&w_mine)[2], const float (&w_theirs)[2],
                                          int tid) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[J0 + j][c] = __fadd_rn(__fmul_rn(o[J0 + j][c], w_mine[c >> 1]),
                               __fmul_rn(buf[(j * 4 + c) * WG_THREADS + tid], w_theirs[c >> 1]));
}

// NH = 1: the two consumer warpgroups' (ref, l, O) partials of one head's
// rows merged once, through shared memory, with their exact maxima m: each
// hands over ref, l, m and the O columns the other keeps (warpgroup 0 keeps
// the first half), then both form the same merged ref, l and m, and each
// its half of O, in a fixed order. ROUNDS = 2 (d = 256): the columns go
// over in two rounds through a buffer half the size.
template <int J, int ROUNDS>
__device__ __forceinline__ void merge_partials(float (&o)[J][4], float (&m)[2], float (&ref)[2],
                                               float (&l)[2], float* handover, int wg,
                                               int tid) {
  static_assert(ROUNDS == 1 || ROUNDS == 2, "one or two rounds");
  constexpr int HALF = J / 2;
  constexpr int PART = HALF / ROUNDS;  // the columns (in 8s) a round hands over
  constexpr int PER_WG = (6 + 4 * PART) * WG_THREADS;
  float* mine = handover + wg * PER_WG;
  const float* theirs = handover + (wg ^ 1) * PER_WG;
  named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);  // both walks done
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mine[rr * WG_THREADS + tid] = ref[rr];
    mine[(2 + rr) * WG_THREADS + tid] = l[rr];
    mine[(4 + rr) * WG_THREADS + tid] = m[rr];
  }
  if (wg == 0)
    stash<HALF, PART>(mine + 6 * WG_THREADS, o, tid);
  else
    stash<0, PART>(mine + 6 * WG_THREADS, o, tid);
  named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);
  float w_mine[2], w_theirs[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float ref_t = theirs[rr * WG_THREADS + tid], l_t = theirs[(2 + rr) * WG_THREADS + tid];
    const float ref0 = wg == 0 ? ref[rr] : ref_t, ref1 = wg == 0 ? ref_t : ref[rr];
    const float l0 = wg == 0 ? l[rr] : l_t, l1 = wg == 0 ? l_t : l[rr];
    const float rt = fmaxf(ref0, ref1);
    const float rs = rt == -INFINITY ? 0.f : rt;
    const float w0 = ref0 == -INFINITY ? 0.f : expf(ref0 - rs);
    const float w1 = ref1 == -INFINITY ? 0.f : expf(ref1 - rs);
    // no contraction into an fma: both warpgroups form the same bits
    l[rr] = __fadd_rn(__fmul_rn(l0, w0), __fmul_rn(l1, w1));
    ref[rr] = rt;
    m[rr] = fmaxf(m[rr], theirs[(4 + rr) * WG_THREADS + tid]);
    w_mine[rr] = wg == 0 ? w0 : w1;
    w_theirs[rr] = wg == 0 ? w1 : w0;
  }
  if (wg == 0)
    take_cols<0, PART>(o, theirs + 6 * WG_THREADS, w_mine, w_theirs, tid);
  else
    take_cols<HALF, PART>(o, theirs + 6 * WG_THREADS, w_mine, w_theirs, tid);
  if constexpr (ROUNDS == 2) {  // the second part of the columns, through the same places
    named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);  // the first part read
    if (wg == 0)
      stash<HALF + PART, PART>(mine + 6 * WG_THREADS, o, tid);
    else
      stash<PART, PART>(mine + 6 * WG_THREADS, o, tid);
    named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);
    if (wg == 0)
      take_cols<PART, PART>(o, theirs + 6 * WG_THREADS, w_mine, w_theirs, tid);
    else
      take_cols<HALF + PART, PART>(o, theirs + 6 * WG_THREADS, w_mine, w_theirs, tid);
  }
}

// A consumer warpgroup: per step of the item, its q head's walk (NH = 2:
// head h0 + wg, every entry; NH = 1 and SPLIT: head h0, the entries of
// every other distinct k block; NH = 1 on a stream of its own: head h0,
// every entry), then the epilogue. Every consumer warp of the stream reads
// every entry slot (the k block tells the split), and releases it.
template <int D, int NH, int WGS, bool AMLA, typename OutT>
__device__ __forceinline__ void fwd_consumer(int wg, unsigned char* smem, uint32_t base,
                                             const FwdArgs<OutT>& a, int e_begin, int e_end,
                                             int h_item, int steps, int i, FwdPos& pos) {
  using L = FwdLayout<D, NH, WGS>;
  static_assert(!(AMLA && L::SPLIT), "the partials' merge is the natural softmax's");
  constexpr int J = D / 8;
  // at d = 128 Q lives in registers for the walk; at d = 64 such fragments
  // did not survive the walk on the card, so the product reads Q from
  // shared memory there, as at d = 32 (load_a_frag reads the 128-byte
  // swizzle only), 80 and 96 (whose buffer then needs no proxy fence)
  constexpr bool Q_IN_REGS = D == 128;
  const typename L::Bars bars{base + L::BARS};
  const int* meta = reinterpret_cast<const int*>(smem + L::META);
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int slot = NH == 2 ? wg : 0;        // the warpgroup's Q tile of the step
  const int r0 = warp * 16 + g;             // this thread's rows of the tile: r0 and r0 + 8
  const int row0 = i * BQ + r0;             // local (padded) row
  int n0 = pos.ring;  // the ring position of the step's first K/V tile
  int j = pos.slot;   // the entry-slot position
  for (int s = 0; s < steps; ++s) {
    const int qs = pos.qstep + s;
    const int b = qs % L::QBUF;
    const int h = h_item + s * NH + slot;
    const uint32_t sq = base + (b * NH + slot) * L::TB;
    float o[J][4];
    zero(o);
    float m[2] = {-INFINITY, -INFINITY}, ref[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(bars.q_full(b), (qs / L::QBUF) & 1);
    uint32_t qf[Q_IN_REGS ? D / 16 : 1][4];
    if constexpr (Q_IN_REGS) {  // Q into registers once: the A operand of S = Q K^T
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a_frag(qf[kk], sq, kk, warp, lane);
    }
    // The walk's entries, this warpgroup's in turn: entry e of k block kb,
    // the step-th distinct k block, at ring position n; its slot em stays
    // held until its intervals are read.
    int e = e_begin - 1, step = -1, kb = -1, cur = -1, n = -1;
    const int* em = nullptr;
    auto next = [&]() -> bool {
      while (++e < e_end) {
        const int ms = j % L::SLOTS;
        mbar_wait(bars.meta_full(ms), (j / L::SLOTS) & 1);
        em = meta + ms * SLOT_INTS;
        ++j;
        const int kbe = em[2 * BQ];
        if (kbe != kb) {
          kb = kbe;
          ++step;
        }
        if (L::SPLIT && (step & 1) != wg) {  // the other warpgroup's entry
          release_stage(bars.meta_empty(ms));
          continue;
        }
        n = n0 + step;
        if (n != cur) {  // a new k block
          // unpipelined: done with the last one's K and V, which the next
          // fill may take (a stream of one stage waits on that)
          if (!L::PIPELINE && cur >= 0) release_stage(bars.empty(cur % L::STG));
          cur = n;
          mbar_wait(bars.full(n % L::STG), (n / L::STG) & 1);
        }
        return true;
      }
      return false;
    };
    // S = Q K^T for entry e, 64 rows x 64 keys, issued; then its rows'
    // k-intervals read from the slot while it runs
    float x[BK / 8][4];
    int lo[2], hi[2];
    auto issue_scores = [&]() {
      const uint32_t sk = base + L::RING + (n % L::STG) * 2 * L::TB;
      fence_regs(x);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        if constexpr (Q_IN_REGS)
          wgmma_rs_k(x, qf[kk], desc_k_major<D>(sk, kk), kk > 0);
        else
          wgmma_ss(x, desc_k_major<D>(sq, kk), desc_k_major<D>(sk, kk), kk > 0);
      }
      wgmma_commit();
    };
    auto read_intervals = [&]() {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        lo[rr] = em[r0 + 8 * rr];
        hi[rr] = em[BQ + r0 + 8 * rr];
      }
      release_stage(bars.meta_empty((j - 1) % L::SLOTS));
    };
    // the softmax of the scores in x (then P, rounded to bf16 in pp as the
    // TPU kernel rounds it to V's type) and O's rescale
    uint32_t pp[4][4];
    auto softmax_and_pack = [&](bool pv_in_flight, int pend) {
      float alpha[2];
      int delta[2];
      softmax_tile<AMLA>(x, m, ref, l, alpha, delta, lo, hi, kb * BK, t4, a.scale, a.softcap);
      if (pv_in_flight) {
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pp);
        if (pend != n) release_stage(bars.empty(pend % L::STG));
      }
      if constexpr (AMLA) {  // O times 2^delta: exponent adds, where a row of the warp moved
        if (__any_sync(0xffffffffu, delta[0] != 0 || delta[1] != 0)) {
#pragma unroll
          for (int jj = 0; jj < J; ++jj) {
            o[jj][0] = amla_rescale(o[jj][0], delta[0]);
            o[jj][1] = amla_rescale(o[jj][1], delta[0]);
            o[jj][2] = amla_rescale(o[jj][2], delta[1]);
            o[jj][3] = amla_rescale(o[jj][3], delta[1]);
          }
        }
      } else if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          o[jj][0] *= alpha[0];
          o[jj][1] *= alpha[0];
          o[jj][2] *= alpha[1];
          o[jj][3] *= alpha[1];
        }
      }
      to_a_frags(pp, x);
    };
    auto issue_pv = [&](int pend) {  // O += P V with the P of ring position pend
      fence_regs(o);
      fence_regs(pp);
      wgmma_fence();
      acc_product(o, pp, base + L::RING + (pend % L::STG) * 2 * L::TB + L::TB);
      wgmma_commit();
    };

    if constexpr (!L::PIPELINE) {
      // one entry after the other: S, softmax, P V, each waited for
      while (next()) {
        issue_scores();
        read_intervals();
        wgmma_wait<0>();
        fence_regs(x);
        softmax_and_pack(false, n);
        issue_pv(n);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pp);
      }
      if (cur >= 0) release_stage(bars.empty(cur % L::STG));  // the last K and V
    } else if (next()) {
      issue_scores();
      read_intervals();
      wgmma_wait<0>();
      fence_regs(x);
      softmax_and_pack(false, n);
      int pend = n;
      // steady state: entry e's scores and the last entry's P V together,
      // the P V running under e's softmax
      while (next()) {
        issue_scores();
        issue_pv(pend);
        read_intervals();
        wgmma_wait<1>();
        fence_regs(x);
        softmax_and_pack(true, pend);
        pend = n;
      }
      issue_pv(pend);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pp);
      release_stage(bars.empty(pend % L::STG));
    }
    // every product that read Q is done, and at d = 128 the ldmatrix reads of
    // it too, which the proxy fence orders before the producer's next TMA
    // load into the buffer (released right after those reads, with no fence,
    // the buffer was now and then refilled under them)
    if constexpr (Q_IN_REGS) fence_proxy_async();
    release_stage(bars.q_empty(b));
    n0 += step + 1;

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // the rows' sums over the quad
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    }
    if constexpr (L::SPLIT) {
      merge_partials<J, L::ROUNDS>(o, m, ref, l, reinterpret_cast<float*>(smem + L::STASH), wg,
                                   tid);
      if (wg == 0)
        fwd_store<AMLA, 0, J / 2>(o, m, ref, l, a, h, row0, t4, true);
      else
        fwd_store<AMLA, J / 2, J / 2>(o, m, ref, l, a, h, row0, t4, false);
    } else {
      fwd_store<AMLA, 0, J>(o, m, ref, l, a, h, row0, t4, true);
    }
  }
  pos.ring = n0;
  pos.slot = j;
  pos.qstep += steps;
}

// A stream's barriers, by one thread before the roles split. item_empty
// completes on one arrival from each warp that takes the stream's items:
// its consumer warps and its entry warp.
template <int NH, int WGS, typename Bars>
__device__ __forceinline__ void fwd_init_bars(const Bars& bars) {
  for (int b = 0; b < 2; ++b) {
    mbar_init(bars.q_full(b), 1);
    mbar_init(bars.q_empty(b), WGS * WG_THREADS / 32);  // every consumer warp reads Q
  }
  for (int s = 0; s < Bars::N_STG; ++s) {
    mbar_init(bars.full(s), 1);
    mbar_init(bars.empty(s), NH * WG_THREADS / 32);  // the warps that read the stage
  }
  for (int s = 0; s < Bars::N_SLOTS; ++s) {
    mbar_init(bars.meta_full(s), 32);  // the entry warp's lanes
    mbar_init(bars.meta_empty(s), WGS * WG_THREADS / 32);
  }
  for (int x = 0; x < ITEM_SLOTS; ++x) {
    mbar_init(bars.item_full(x), 1);
    mbar_init(bars.item_empty(x), WGS * WG_THREADS / 32 + 1);
  }
  fence_barrier_init();
}

// One thread block of the row-major grid: q block order[blockIdx.y] of the
// head_block q heads from blockIdx.x * head_block, in steps of NH heads.
// NH = 2 where G is even (a step's two heads share their kv head), else 1.
template <int D, int NH, typename OutT>
__device__ __forceinline__ void fwd_block(unsigned char* smem_raw, const CUtensorMap* tm_q,
                                          const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                          const FwdArgs<OutT>& a, int head_block) {
  using L = FwdLayout<D, NH>;
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const typename L::Bars bars{base + L::BARS};
  const int i = a.order[blockIdx.y];  // q block
  const int h_item = blockIdx.x * head_block;
  const int steps = head_block / NH;
  const int e_begin = a.rs[i], e_end = a.rs[i] + a.rc[i];
  if (threadIdx.x == 0) fwd_init_bars<NH, CONSUMERS>(bars);
  __syncthreads();
  FwdPos pos{0, 0, 0};
  const int producer_tid = threadIdx.x - CONSUMERS * WG_THREADS;
  if (producer_tid >= 0) {
    reg_dealloc<FWD_PRODUCER_REGS>();
    if (producer_tid == 0)
      fwd_producer<D, NH, CONSUMERS>(tm_q, tm_k, tm_v, a.kblk, e_begin, e_end, h_item, steps,
                                     a.group, i, a.tqp, a.tkp, base, pos);
    else if (producer_tid / 32 == 1)
      fwd_entries(a.kblk, a.sid, a.runs, a.bounds, e_begin, e_end, steps, i,
                  reinterpret_cast<int*>(smem + L::META), bars, pos);
  } else {
    reg_alloc<FWD_CONSUMER_REGS>();
    fwd_consumer<D, NH, CONSUMERS, false>(threadIdx.x / WG_THREADS, smem, base, a, e_begin,
                                          e_end, h_item, steps, i, pos);
  }
}

// A persistent block of the sparse grid: (group of heads_per_item q heads,
// q block) items of the work list (group * nq + q block, longest walk
// first) through the counter, each in steps of NH heads with the AMLA
// softmax, on SparseLayout's streams: at NH = 1 the producer warpgroup's
// warps 0-1 serve consumer warpgroup 0 and warps 2-3 warpgroup 1. A
// stream's producer thread claims each item one ahead, so that the
// counter's and the tables' latency is spent while the current item's loads
// go out, and publishes it to its entry warp and consumers once the
// previous item's last load is issued; a last item past the list's end
// stops them.
template <int D, int NH, typename OutT>
__device__ __forceinline__ void fwd_persistent(unsigned char* smem_raw, const CUtensorMap* tm_q,
                                               const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                               const FwdArgs<OutT>& a, const int* work,
                                               int* counter, int nq, int n_items,
                                               int heads_per_item) {
  using L = SparseLayout<D, NH>;
  constexpr int WGS = NH == 2 ? CONSUMERS : 1;
  constexpr int STREAMS = CONSUMERS / WGS;
  unsigned char* smem0 = align_1024(smem_raw);
  const int producer_tid = threadIdx.x - CONSUMERS * WG_THREADS;
  const int stream = STREAMS == 1 ? 0
                     : producer_tid >= 0 ? producer_tid / 64 : (int)(threadIdx.x / WG_THREADS);
  unsigned char* smem = smem0 + stream * L::STREAM;
  const uint32_t base = smem_u32(smem);
  const typename L::Bars bars{base + L::BARS};
  int* items = reinterpret_cast<int*>(smem + L::ITEMS);
  const uint32_t full0 = bars.item_full(0), empty0 = bars.item_empty(0);
  const int steps = heads_per_item / NH;
  if (threadIdx.x == 0)
    for (int st = 0; st < STREAMS; ++st)
      fwd_init_bars<NH, WGS>(typename L::Bars{smem_u32(smem0 + st * L::STREAM) + L::BARS});
  __syncthreads();
  FwdPos pos{0, 0, 0};
  if (producer_tid >= 0) {
    reg_dealloc<FWD_PRODUCER_REGS>();
    const int role = STREAMS == 1 ? producer_tid : producer_tid % 64;
    if (role == 0) {
      Item next = claim_item(counter, work, a.rs, a.rc, n_items, nq, heads_per_item);
      for (int n = 0;; ++n) {
        const Item it = next;
        publish_item(full0, empty0, items, n, it);
        if (it.idx >= n_items) return;
        next = claim_item(counter, work, a.rs, a.rc, n_items, nq, heads_per_item);
        fwd_producer<D, NH, WGS>(tm_q, tm_k, tm_v, a.kblk, it.e_begin, it.e_end, it.head, steps,
                                 a.group, it.i, a.tqp, a.tkp, base, pos);
      }
    } else if (role / 32 == 1) {
      for (int n = 0;; ++n) {
        const Item it = take_item(full0, empty0, items, n);
        if (it.idx >= n_items) return;
        fwd_entries(a.kblk, a.sid, a.runs, a.bounds, it.e_begin, it.e_end, steps, it.i,
                    reinterpret_cast<int*>(smem + L::META), bars, pos);
      }
    }
  } else {
    reg_alloc<FWD_CONSUMER_REGS>();
    const int wg = STREAMS == 1 ? (int)(threadIdx.x / WG_THREADS) : 0;
    for (int n = 0;; ++n) {
      const Item it = take_item(full0, empty0, items, n);
      if (it.idx >= n_items) return;
      fwd_consumer<D, NH, WGS, true>(wg, smem, base, a, it.e_begin, it.e_end, it.head, steps,
                                     it.i, pos);
    }
  }
}

// -- host -----------------------------------------------------------------------------

// A launch of kernel (flex_fwd_kernel or flex_fwd_hb_kernel at D, NH and
// OutT) over q [hq, tqp, D], k/v [hk, tkp, D] bf16 (16-byte aligned, for
// TMA): grid (hq / head_block, nq), 384 threads, one block per SM.
template <int D, int NH, typename OutT, typename Kernel>
inline cudaError_t launch_fwd(Kernel kernel, const void* q, const void* k, const void* v,
                              const FwdArgs<OutT>& args, int hq, int hk, int nq, int head_block,
                              cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_tile_map(&tm_q, q, hq * args.tqp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_k, k, hk * args.tkp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_v, v, hk * args.tkp, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = FwdLayout<D, NH>::ALLOC;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(hq / head_block, nq);
  kernel<<<grid, WS_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, args, head_block);
  return cudaGetLastError();
}

// A launch of kernel (flex_fwd_sparse_kernel or flex_fwd_sparse_hb_kernel at
// D, NH and OutT) over the n_items items of work: as many persistent blocks
// of 384 threads as fit on the card, one per SM (or one per item, if fewer),
// the counter zeroed on the stream first.
template <int D, int NH, typename OutT, typename Kernel>
inline cudaError_t launch_fwd_persistent(Kernel kernel, const void* q, const void* k,
                                         const void* v, const FwdArgs<OutT>& args, int hq,
                                         int hk, const void* work, void* counter, int nq,
                                         int n_items, int heads_per_item,
                                         cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_tile_map(&tm_q, q, hq * args.tqp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_k, k, hk * args.tkp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_v, v, hk * args.tkp, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = SparseLayout<D, NH>::ALLOC;
  int grid = 0;
  err = persistent_launch_dims(kernel, WS_THREADS, smem, n_items, (int*)counter, stream, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WS_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, args, (const int*)work,
                                              (int*)counter, nq, n_items, heads_per_item);
  return cudaGetLastError();
}

// The sparse forwards' shared entry-point checks: the 64 x 64 tile, the
// padded lengths, heads_per_item a multiple of NH dividing hq, and one item
// per (head group, q block).
inline bool fwd_sparse_args_ok(int hq, int hk, int tqp, int tkp, int nq, int block_q,
                               int block_k, int n_items, int heads_per_item, int nh) {
  return block_q == BQ && block_k == BK && hk > 0 && hq % hk == 0 && tqp == nq * BQ &&
         tkp % BK == 0 && heads_per_item > 0 && heads_per_item % nh == 0 &&
         hq % heads_per_item == 0 && n_items == hq / heads_per_item * nq;
}

// The FwdArgs of a C entry point's arguments.
template <typename OutT>
inline FwdArgs<OutT> fwd_args(const void* sink, const void* kblk, const void* sid,
                              const void* runs, const void* bounds, const void* rs,
                              const void* rc, const void* order, void* out, void* lse,
                              void* rowmax, int group, int tqp, int tkp, float scale,
                              float softcap, int has_sink) {
  return FwdArgs<OutT>{(const float*)sink, (const int*)kblk, (const int*)sid,
                       (const int*)runs, (const int*)bounds, (const int*)rs,
                       (const int*)rc, (const int*)order, (OutT*)out, (float*)lse,
                       (float*)rowmax, group, tqp, tkp, scale, softcap, has_sink};
}

}  // namespace sm90
}  // namespace flex

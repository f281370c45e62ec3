// The warp-specialised walks of the row-major flex-attention backward for
// Hopper (sm_90a): flex_dq.cu (dq over the forward, q-major entry table) and
// flex_dkv.cu (dk, dv over the backward, k-major one). The math is the
// reference's, step for step (see the two .cu files); this header is how a
// thread block runs it.
//
// A block is three warpgroups. The third is the producer: after giving up
// its registers (setmaxnreg) one of its threads issues every TMA load of the
// block — the block's resident tiles once, then the streamed tiles of the
// walk through a ring of STAGES shared-memory stages, each gated by a "full"
// mbarrier (the TMA bytes landed) and an "empty" one (its readers are done).
// The first two are consumer warpgroups with the producer's registers: they
// wait on a stage, run the products on wgmma (the score-type products from
// two shared-memory tiles, the accumulating ones with the rounded P or dS
// tile from registers as the A operand) and the per-logit core of
// flex_tile.cuh between them, and release the stage. A consumer works out
// a tile's mask while its score products run and waits for each group of
// products before it touches their registers; two consumers per block, so
// that one's products overlap the other's softmax core. (Issuing a tile's
// accumulating products together with the next tile's score products
// instead does not pay here: ptxas serialises that wgmma chain, notice
// C7515.)
//
// Determinism: no atomics on data. Each block owns its output rows; where
// the two warpgroups split a walk, the split is fixed by the walk's order
// and their two partial sums are added once, through shared memory, at the
// end. The same inputs give the same bits on every run.
#pragma once

#include "flex_tile.cuh"
#include "flex_sm90.cuh"

namespace flex {
namespace sm90 {

constexpr int CONSUMERS = 2;  // consumer warpgroups a block
constexpr int BWD_THREADS = (CONSUMERS + 1) * WG_THREADS;  // and one producer warpgroup
constexpr int STAGES = 4;  // ring depth: two stages in flight per consumer warpgroup
// 128 x 24 + 256 x 240 registers: the 64 K of an SM, one block per SM
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int BAR_CONSUMERS = 1;  // named barrier over both consumer warpgroups
constexpr int BAR_WG = 2;         // + wg: one consumer warpgroup alone

template <int D>
constexpr int tile_bytes() {
  return BQ * D * 2;  // 64 rows of D bf16
}

// flex_dq's shared memory, from a 1024-byte aligned base: the Q and dO tiles
// of its NH resident q heads, then K and V per ring stage, then the barriers.
template <int D, int NH>
struct DqLayout {
  static constexpr int TB = tile_bytes<D>();
  static constexpr int RING = 2 * NH * TB;
  static constexpr int BARS = RING + STAGES * 2 * TB;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;  // the dynamic allocation, with room to align
};

// flex_dkv's: the resident K and V tiles, then Q and dO per ring stage, then
// each stage's 64 lse and 64 delta_eff values, then each consumer
// warpgroup's two buffers of per-row k-intervals [lo | hi], then the
// barriers.
template <int D>
struct DkvLayout {
  static constexpr int TB = tile_bytes<D>();
  static constexpr int RING = 2 * TB;
  static constexpr int VEC = RING + STAGES * 2 * TB;
  static constexpr int IV = VEC + STAGES * 2 * BQ * 4;
  static constexpr int BARS = IV + CONSUMERS * 2 * 2 * BQ * 4;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;
};

// The barriers: the resident tiles' one, then full[STAGES], then empty[STAGES].
struct Bars {
  uint32_t base;
  __device__ __forceinline__ uint32_t resident() const { return base; }
  __device__ __forceinline__ uint32_t full(int s) const { return base + 8 + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + 8 * (1 + STAGES + s); }
};

// By one thread, before the roles split. A full barrier completes on the
// producer's one arrival and its bytes; an empty one on one arrival from
// each warp that reads the stage (release_stage).
__device__ __forceinline__ void init_bars(const Bars& b, int empty_arrivals) {
  mbar_init(b.resident(), 1);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(b.full(s), 1);
    mbar_init(b.empty(s), empty_arrivals);
  }
  fence_barrier_init();
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

// s = A B^T and t = C E^T over the D columns of four 64-row tiles at
// shared-memory addresses a, b, c, e. Issued, not committed or waited for.
template <int D>
__device__ __forceinline__ void two_scores(float (&s)[BK / 8][4], float (&t)[BK / 8][4],
                                           uint32_t a, uint32_t b, uint32_t c, uint32_t e) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss(s, desc_k_major(a, kk), desc_k_major(b, kk), kk > 0);
    wgmma_ss(t, desc_k_major(c, kk), desc_k_major(e, kk), kk > 0);
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

// Accumulator columns J0 .. J0+N-1 (of 8) into / out of a thread-major
// shared-memory buffer: the hand-over of a partial sum between the two
// consumer warpgroups, whose threads hold the same (row, column) places.
template <int J0, int N, int J>
__device__ __forceinline__ void stash(float* buf, const float (&acc)[J][4], int tid) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) buf[(j * 4 + c) * WG_THREADS + tid] = acc[J0 + j][c];
}

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

// -- flex_dq -----------------------------------------------------------------------------

// The next entry of the q-major walk after e that this consumer warpgroup
// computes, keeping the distinct-k-block count (step) and the k block (kb)
// up to date; false past the end. SPLIT: the warpgroups split the walk by
// k block, step % 2 == wg.
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

// The producer of flex_dq (one thread): the Q and dO tiles of the block's NH
// q heads, then K and V once per distinct k block of the walk (consecutive
// entries may share one: the slices of one tile), stage after stage.
template <int D, int NH>
__device__ __forceinline__ void dq_producer(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                            const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                            const int* __restrict__ kblk, int e_begin, int e_end,
                                            int h0, int kvh, int i, int tqp, int tkp,
                                            uint32_t base) {
  using L = DqLayout<D, NH>;
  const Bars bars{base + L::BARS};
  mbar_expect_tx(bars.resident(), 2 * NH * L::TB);
  for (int hh = 0; hh < NH; ++hh) {
    const int row = (h0 + hh) * tqp + i * BQ;
    tma_load_tile<D>(base + 2 * hh * L::TB, tm_q, bars.resident(), row);
    tma_load_tile<D>(base + (2 * hh + 1) * L::TB, tm_do, bars.resident(), row);
  }
  int step = -1, loaded = -1;
  for (int e = e_begin; e < e_end; ++e) {
    const int kb = kblk[e];
    if (kb == loaded) continue;
    loaded = kb;
    ++step;
    const int st = step % STAGES;
    mbar_wait(bars.empty(st), ((step / STAGES) & 1) ^ 1);
    mbar_expect_tx(bars.full(st), 2 * L::TB);
    const uint32_t dst = base + L::RING + st * 2 * L::TB;
    const int row = kvh * tkp + kb * BK;
    tma_load_tile<D>(dst, tm_k, bars.full(st), row);
    tma_load_tile<D>(dst + L::TB, tm_v, bars.full(st), row);
  }
}

// A consumer warpgroup of flex_dq. NH = 2: warpgroup wg owns q head h0 + wg
// and walks every entry (both read each stage: G > 1 heads of one kv head
// have identical walks). NH = 1: both own q head h0 and split its walk by k
// block — the s-th distinct k block goes to warpgroup s % 2 — and each
// keeps half of the columns of the sum of their two partials.
template <int D, int NH>
__device__ __forceinline__ void dq_consumer(
    int wg, unsigned char* smem, uint32_t base, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ kblk, const int* __restrict__ sid,
    const int* __restrict__ runs, const int* __restrict__ bounds, int e_begin, int e_end,
    float* __restrict__ dq, int h0, int i, int tqp, float scale, float softcap) {
  using L = DqLayout<D, NH>;
  constexpr int J = D / 8;
  const Bars bars{base + L::BARS};
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int slot = NH == 2 ? wg : 0;  // the resident head
  const int h = h0 + slot;
  const uint32_t sq = base + 2 * slot * L::TB, sdo = sq + L::TB;

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

  mbar_wait(bars.resident(), 0);
  // the walk: entry e of k block kb, the step-th distinct k block of the walk
  int e = e_begin - 1, step = -1, kb = -1, held = -1;
  while (next_entry<NH == 1>(kblk, e, e_end, step, kb, wg)) {
    const uint32_t sk = base + L::RING + (step % STAGES) * 2 * L::TB, sv = sk + L::TB;
    if (step != held) {  // a new k block: done with the last one's K and V
      if (held >= 0) release_stage(bars.empty(held % STAGES));
      held = step;
      mbar_wait(bars.full(step % STAGES), (step / STAGES) & 1);
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

  float* out = dq + (size_t)h * tqp * D;
  const int row0 = i * BQ + r0;
  if constexpr (NH == 1) {
    constexpr int HALF = J / 2;
    named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);  // both walks done: the ring is free
    fence_proxy_async();
    float* handoff = reinterpret_cast<float*>(smem + L::RING);  // [wg][HALF * 4][128]
    float* from_wg0 = handoff;
    float* from_wg1 = handoff + HALF * 4 * WG_THREADS;
    if (wg == 0)
      stash<HALF, HALF>(from_wg0, acc, tid);  // warpgroup 0 keeps the first half
    else
      stash<0, HALF>(from_wg1, acc, tid);
    named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);
    if (wg == 0) {
      add_stashed<0, HALF>(acc, from_wg1, tid);
      store_cols<0, HALF>(out, acc, row0, t4, scale);
    } else {
      add_stashed<HALF, HALF>(acc, from_wg0, tid);
      store_cols<HALF, HALF>(out, acc, row0, t4, scale);
    }
  } else {
    store_cols<0, J>(out, acc, row0, t4, scale);
  }
}

// -- flex_dkv ----------------------------------------------------------------------------

// The producer of flex_dkv (one thread): the K and V tiles of the block,
// then per (entry, q head) of the walk — entry outer, the G q heads of the
// kv head inner — the Q and dO tiles with their 64 lse and delta_eff
// values, stage after stage.
template <int D>
__device__ __forceinline__ void dkv_producer(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qblk, int e_begin, int e_end, int group, int hk, int i, int tqp,
    int tkp, uint32_t base) {
  using L = DkvLayout<D>;
  const Bars bars{base + L::BARS};
  mbar_expect_tx(bars.resident(), 2 * L::TB);
  const int krow = hk * tkp + i * BK;
  tma_load_tile<D>(base, tm_k, bars.resident(), krow);
  tma_load_tile<D>(base + L::TB, tm_v, bars.resident(), krow);
  int n = 0;
  for (int e = e_begin; e < e_end; ++e) {
    const int qb = qblk[e];
    for (int gi = 0; gi < group; ++gi, ++n) {
      const int st = n % STAGES;
      mbar_wait(bars.empty(st), ((n / STAGES) & 1) ^ 1);
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
}

// A consumer warpgroup of flex_dkv: the (entry, q head) items of the walk
// alternate between the two warpgroups (item n to warpgroup n % 2), each
// accumulating its own dK and dV partials over the block's 64 keys; at the
// end warpgroup 0 adds warpgroup 1's dK partial to its own and stores dK,
// warpgroup 1 does the same for dV.
template <int D>
__device__ __forceinline__ void dkv_consumer(
    int wg, unsigned char* smem, uint32_t base, const int* __restrict__ qblk,
    const int* __restrict__ sid, const int* __restrict__ runs, const int* __restrict__ bounds,
    int e_begin, int e_end, float* __restrict__ dk, float* __restrict__ dv, int group, int hk,
    int i, int tkp, float scale, float softcap) {
  using L = DkvLayout<D>;
  constexpr int J = D / 8;
  const Bars bars{base + L::BARS};
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's key rows of the tile: r0 and r0 + 8
  const int key[2] = {i * BK + r0, i * BK + r0 + 8};
  const float* vec = reinterpret_cast<const float*>(smem + L::VEC);
  int* iv = reinterpret_cast<int*>(smem + L::IV) + wg * 2 * 2 * BQ;  // [buffer][lo | hi][row]
  const uint32_t sk = base, sv = base + L::TB;

  float dka[J][4], dva[J][4];
  zero(dka);
  zero(dva);

  mbar_wait(bars.resident(), 0);
  // item n = (entry e_begin + n / group, q head n % group); this warpgroup's
  // are n = wg, wg + 2, ...
  const int n_items = (e_end - e_begin) * group;
  int buf = 0, last = -1;
  for (int n = wg; n < n_items; n += CONSUMERS) {
    const int e = e_begin + n / group;
    const int stage = n % STAGES;
    const uint32_t sq = base + L::RING + stage * 2 * L::TB, sdo = sq + L::TB;
    mbar_wait(bars.full(stage), (n / STAGES) & 1);

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

  named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);  // both walks done: the ring is free
  fence_proxy_async();
  float* sib_k = reinterpret_cast<float*>(smem + L::RING);  // warpgroup 1's dK partial
  float* sib_v = sib_k + J * 4 * WG_THREADS;                // warpgroup 0's dV partial
  if (wg == 1)
    stash<0, J>(sib_k, dka, tid);
  else
    stash<0, J>(sib_v, dva, tid);
  named_sync(BAR_CONSUMERS, CONSUMERS * WG_THREADS);
  const size_t k0 = (size_t)hk * tkp;
  if (wg == 0) {
    add_stashed<0, J>(dka, sib_k, tid);
    store_cols<0, J>(dk + k0 * D, dka, i * BK + r0, t4, scale);
  } else {
    add_stashed<0, J>(dva, sib_v, tid);
    store_cols<0, J>(dv + k0 * D, dva, i * BK + r0, t4, 1.f);
  }
}

}  // namespace sm90
}  // namespace flex

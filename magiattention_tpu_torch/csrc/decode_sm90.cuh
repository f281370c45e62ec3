// paged_decode on Hopper's tensor cores: the split-KV walk over the paged
// KV cache as per-warp cp.async pipelines feeding mma.sync, for bf16 caches.
//
// Replaces the TPU kernel magiattention_tpu/serving/decode_attn.py::
// _decode_pallas (kernel body _decode_kernel) and computes what it computes
// for each (sequence, split): scores q.k^T * scale, an optional softcap
// cap * tanh(z / cap), positions >= seq_len masked to -inf, a natural-exp
// online softmax over the split's pages, p rounded to bf16 before P.V with
// the sum l taken over the unrounded p, and the partial (out f32, lse f32),
// (0, -inf) for a split with no coverage. The splits merge outside the
// kernel (ops/correction.py::merge_partials), as on the TPU.
//
// What bounds it on the card: bytes. Each cached K/V byte feeds one
// multiply-add per q row of its kv head (G = 4 at Llama-3.1-8B widths), far
// below the ~295 FLOP/byte an H100 needs before the tensor cores are the
// limit: the serving batch's 130.7 MB of K/V take 0.039 ms at 3.35 TB/s.
//
// What this design does about it:
// - Loads in flight while the warps compute. A walk (one kv head, split and
//   row group) is shared by the NWARPS warps of each block of a cluster of
//   up to MAX_CLUSTER blocks: its 16-token chunks go round the cluster's
//   warps in turn, and each warp keeps a ring of STAGES chunk buffers of
//   its own: it issues chunk j + STAGES - 1 by cp.async (16 B a lane)
//   before it computes chunk j, so STAGES - 1 chunks of every warp are in
//   flight, and no block-wide barrier stands in the walk.
// - Parallelism inside the split. A decode step has few walks (8 sequences
//   x 8 kv heads on the serving batch), and one warp walks slowly: with a
//   warp or two a scheduler, a chunk's chain of dependent instructions, not
//   the memory, sets its pace (on the H100 a block's rate grew with its
//   warps, not with its ring stages). So a walk is spread over a cluster of
//   blocks (enough that every SM gets one) of 6 warps each. Extra splits
//   are not needed for that, and each costs a merge_partials round of
//   small kernels outside this one (chip_smoke.py's decode_timing times
//   both).
// - Determinism: every warp keeps its own running max, sum and
//   accumulator; they merge once, at the end, in warp order through shared
//   memory, then the cluster's blocks in block order through distributed
//   shared memory. Two runs give the same bits.
// - Bytes in flight: pages past the sequence's end are never read (the
//   chunks stop at the split's live tokens). The tokens past seq_len in
//   the last page are not read either: their cp.async copies 0 source
//   bytes and zero-fills the row, so no garbage there (NaN included) can
//   reach P.V, where p is 0 but 0 * NaN would not be.
// - Tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate): a
//   walk's q rows are the M rows, in one m16 tile (a sequence's G <= 16 q
//   heads, their fragments held in registers) or two (G <= 32); K comes in
//   by ldmatrix and V by ldmatrix.trans from the ring; the score
//   accumulators, rounded to bf16, are P.V's A fragments as they stand.
//   wgmma would need 64 M rows, and a decode tile has G q heads (4 here):
//   it would spend 16x the products for nothing, and its asynchrony buys
//   nothing when the walk waits on memory. A flat group of more than 32 q
//   heads fills one or two 64-row tiles, and takes decode_wide_sm90.cuh's
//   TMA and wgmma walk instead.
// - Shared mode, the cascade's level 1: every member of a group reads one
//   block-table row and one length (the shared prefix), and a walk serves
//   up to MAX_ROWS = 32 q rows across members (8 members of G = 4) from each
//   chunk it loads, each row with its own softmax state and its own member's
//   partial. So the shared pages are read once per 32 rows, not once per
//   member.
//
// Grid: (kv heads x cluster blocks, splits, row groups), clusters along x;
// NWARPS * 32 threads. Row i of a launch is q head h * G + i % G of member
// i / G; a row group is one sequence's G rows (flat mode) or up to 32 rows
// across members (shared). Head dims 32, 64, 80, 96, 128 and 256: a d-32 row
// is 64 bytes, four 16-byte cp.async copies, and its 80-byte padded shared
// row keeps an ldmatrix phase's 8 rows on distinct banks as the wider ones
// do; d = 80 and 96 (Phi-2's and Phi-3-mini's widths) are 10 and 12 copies a
// row, their padded rows 176 and 208 bytes (11 and 13 units of 16: odd, so
// an ldmatrix phase's 8 rows again fall on distinct banks), their products 5
// and 6 k slices and 10 and 12 n8 tiles of the accumulator.
//
// d = 256 (Gemma's width): a chunk's K and V take 16.5 KB, so each warp's
// ring has two stages (one chunk in flight while it computes one: 198 KB
// for the six warps), q is read from shared memory at every chunk, and a
// walk holds one m16 tile of rows (its accumulator alone is 128 registers a
// thread; two tiles would pass the 255 a thread can have): a flat-mode
// group past 16 q heads is cut into row tiles of at most 16 rows, each a
// walk of its own over the sequence's pages (the group's K/V read once per
// tile), and the shared mode serves 16 rows a walk.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace decode_sm90 {

namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;

constexpr int NWARPS = 6;
constexpr int NTHREADS = NWARPS * 32;
constexpr int CH = 16;        // tokens a chunk: the k depth of one P.V product
constexpr int STAGES = 4;     // each warp's ring of chunk buffers
constexpr int MAX_ROWS = 32;  // shared mode: two m16 tiles across members
constexpr int MAX_CLUSTER = 8;  // blocks sharing one walk (the portable cluster limit)
constexpr int WIDE_D_ROWS = 16;  // d = 256: the rows of a walk (one m16 tile)

// Each warp's ring of chunk buffers: STAGES, two at d = 256 (see the top).
template <int D>
__host__ __device__ constexpr int stages() {
  return D > 128 ? 2 : STAGES;
}

// Shared-memory rows of D bf16 padded by 16 bytes: the 8 rows an ldmatrix
// phase reads fall on distinct banks.
template <int D>
__host__ __device__ constexpr int row_elems() {
  return D + 8;
}
template <int D>
__host__ __device__ constexpr int stage_elems() {  // one chunk's K and V
  return 2 * CH * row_elems<D>();
}
template <int D, int MT>
constexpr size_t fixed_smem() {  // the rings and the q rows
  return sizeof(bf16) *
         ((size_t)NWARPS * stages<D>() * stage_elems<D>() + MT * 16 * row_elems<D>());
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; a row past the sequence copies 0
// source bytes and fills the 16 with zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// q [b, hq, D]; k_pages/v_pages [P, ps, hk, D] bf16; bt [b or 1, mpp];
// sl [b or 1]; out_parts [b, splits, hq, D] f32; lse_parts [b, splits, hq].
// MT m16 tiles of q rows a block.
template <int D, int MT>
__global__ void __launch_bounds__(NTHREADS, 1)
paged_decode_mma(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, const int* __restrict__ bt,
                 const int* __restrict__ sl, float* __restrict__ out_parts,
                 float* __restrict__ lse_parts, int hq, int hk, int group, int rows_total,
                 int rows_per_block, int shared, int ps, int mpp, int splits, float scale,
                 float softcap) {
  constexpr int RE = row_elems<D>();
  constexpr int ROWS = MT * 16;
  constexpr int DN = D / 8;  // n8 tiles of the accumulator
  constexpr int STAGES = stages<D>();  // this width's ring depth
  static_assert(D <= 128 || MT == 1, "d = 256 walks hold one m16 tile of rows");
  static_assert(D % 16 == 0 && CH * (D / 8) % 32 == 0 && DN % 2 == 0,
                "whole k slices, copies a lane and pairs of n8 tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* sQ = ring + NWARPS * STAGES * stage_elems<D>();  // [ROWS][RE]

  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = cluster.num_blocks(), rank = cluster.block_rank();
  const int h = blockIdx.x / nblk, s = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // flat mode: a sequence's group in row tiles of rows_per_block rows, gps
  // of them a sequence (the last may be shorter; gps is 1 but at d = 256)
  const int gps = shared ? 1 : (group + rows_per_block - 1) / rows_per_block;
  const int tb = shared ? 0 : z / gps;  // the block-table row this group reads
  const int row0 = shared ? z * rows_per_block : tb * group + (z % gps) * rows_per_block;
  const int rows = min(rows_per_block, (shared ? rows_total : (tb + 1) * group) - row0);
  const int pps = mpp / splits;
  const int* bt_split = bt + (size_t)tb * mpp + s * pps;  // the split's page ids
  // the split's live tokens: positions s * pps * ps + [0, n)
  const int n = max(0, min(pps * ps, sl[tb] - s * pps * ps));
  const int nchunks = (n + CH - 1) / CH;

  for (int x = tid; x < ROWS * (D / 8); x += NTHREADS) {
    const int r = x / (D / 8), c = x % (D / 8);
    uint4 v = make_uint4(0, 0, 0, 0);  // padding rows: zeros, never written out
    if (r < rows) {
      const int i = row0 + r;
      const int qm = i / group;  // the member whose q this row is
      v = *reinterpret_cast<const uint4*>(q + ((size_t)qm * hq + h * group + i % group) * D +
                                          c * 8);
    }
    *reinterpret_cast<uint4*>(sQ + r * RE + c * 8) = v;
  }
  __syncthreads();

  // this warp's chunks: gw, gw + GW, ... where gw is its place among the GW
  // warps of the cluster
  const int gw = rank * NWARPS + warp, GW = nblk * NWARPS;
  const int mine = nchunks > gw ? (nchunks - gw + GW - 1) / GW : 0;
  bf16* wring = ring + warp * STAGES * stage_elems<D>();
  const size_t head_off = (size_t)h * D;
  const size_t tok_stride = (size_t)hk * D;
  const bool page_chunks = ps % CH == 0;  // every chunk lies in one page

  // chunk j of this warp into its ring stage: row t of the chunk is split
  // position pos0 + t, on page bt_split[pos / ps] at pos % ps
  auto load = [&](int j) {
    const int pos0 = (gw + j * GW) * CH;
    bf16* sk = wring + (j % STAGES) * stage_elems<D>();
    bf16* sv = sk + CH * RE;
    size_t base = 0;
    if (page_chunks)
      base = ((size_t)__ldg(bt_split + pos0 / ps) * ps + pos0 % ps) * tok_stride + head_off;
#pragma unroll
    for (int k = 0; k < CH * (D / 8) / 32; ++k) {
      const int u = lane + 32 * k;
      const int t = u / (D / 8), cc = u % (D / 8);
      const int pos = pos0 + t;
      const bool live = pos < n;
      size_t off = 0;
      if (live)
        off = (page_chunks ? base + t * tok_stride
                           : ((size_t)__ldg(bt_split + pos / ps) * ps + pos % ps) * tok_stride +
                                 head_off) +
              cc * 8;
      cp_async_16(sk + t * RE + cc * 8, kp + off, live);
      cp_async_16(sv + t * RE + cc * 8, vp + off, live);
    }
  };

  float m[MT][2], l[MT][2], acc[MT][DN][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      acc[mt][dn][0] = acc[mt][dn][1] = acc[mt][dn][2] = acc[mt][dn][3] = 0.f;
  }
  // one m16 tile: its q fragments stay in registers for the walk (not at d
  // = 256, where they would take 64 registers beside the accumulator's 128)
  constexpr bool Q_REGS = MT == 1 && D <= 128;
  uint32_t qreg[Q_REGS ? D / 16 : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qreg[kk], sQ + (lane & 15) * RE + kk * 16 + (lane >> 4) * 8);
  }

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < mine) load(j);
    cp_async_commit();  // one group a chunk, empty past the end: the wait count stays fixed
  }
  const int t4 = lane & 3;
  for (int j = 0; j < mine; ++j) {
    if (j + STAGES - 1 < mine) load(j + STAGES - 1);  // into the stage chunk j - 1 left
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // chunk j's group has landed
    __syncwarp();                 // ... for every lane's copies
    const bf16* sk = wring + (j % STAGES) * stage_elems<D>();
    const bf16* sv = sk + CH * RE;
    const int live = n - (gw + j * GW) * CH;  // live tokens of the chunk (>= 1)

    // S = Q K^T: [ROWS x 16 tokens], two n8 tiles per m16 tile, the even
    // and odd k slices summed in two chains
    float sc[MT][2][4], sc2[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][jn][e] = sc2[mt][jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];  // b0 b1 of tokens 0-7, b0 b1 of tokens 8-15
      ldmatrix_x4(kb, sk + ((lane & 7) + (lane >> 4) * 8) * RE + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qa[4];
        if constexpr (Q_REGS) {
#pragma unroll
          for (int x = 0; x < 4; ++x) qa[x] = qreg[kk][x];
        } else {
          ldmatrix_x4(qa, sQ + (mt * 16 + (lane & 15)) * RE + kk * 16 + (lane >> 4) * 8);
        }
        float (&dst)[2][4] = kk % 2 ? sc2[mt] : sc[mt];
        mma_bf16(dst[0], qa, kb[0], kb[1]);
        mma_bf16(dst[1], qa, kb[2], kb[3]);
      }
    }

    // online softmax: this thread holds rows lane / 4 (e = 0, 1) and
    // lane / 4 + 8 (e = 2, 3) of each m16 tile, tokens 8 jn + 2 t4 (+1)
    uint32_t pa[MT][4];
    float alpha[MT][2];
    bool grew = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float zz = (sc[mt][jn][e] + sc2[mt][jn][e]) * scale;
          if (softcap > 0.f) zz = softcap * tanhf(zz / softcap);
          sc[mt][jn][e] = 8 * jn + 2 * t4 + (e & 1) < live ? zz : -INFINITY;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = fmaxf(fmaxf(sc[mt][0][2 * r], sc[mt][0][2 * r + 1]),
                         fmaxf(sc[mt][1][2 * r], sc[mt][1][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mnew = fmaxf(m[mt][r], mx);
        const float msafe = mnew == -INFINITY ? 0.f : mnew;
        alpha[mt][r] = m[mt][r] == -INFINITY ? 0.f : __expf(m[mt][r] - msafe);
        grew |= mnew != m[mt][r];  // alpha is exactly 1 where the max held
        m[mt][r] = mnew;
        float ls = 0.f;
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float zz = sc[mt][jn][e];
            const float p = zz == -INFINITY ? 0.f : __expf(zz - msafe);
            ls += p;  // l over the unrounded p
            sc[mt][jn][e] = p;
          }
        l[mt][r] = l[mt][r] * alpha[mt][r] + ls;  // this thread's share; the quad sums at the end
      }
      // p rounded to bf16: the A fragment of P.V over the chunk's 16 tokens
      pa[mt][0] = pack_bf16(sc[mt][0][0], sc[mt][0][1]);
      pa[mt][1] = pack_bf16(sc[mt][0][2], sc[mt][0][3]);
      pa[mt][2] = pack_bf16(sc[mt][1][0], sc[mt][1][1]);
      pa[mt][3] = pack_bf16(sc[mt][1][2], sc[mt][1][3]);
    }
    // the accumulator rescaled only when some row's max grew (a scale of
    // exactly 1 elsewhere: skipping it changes no bit)
    if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          acc[mt][dn][0] *= alpha[mt][0];
          acc[mt][dn][1] *= alpha[mt][0];
          acc[mt][dn][2] *= alpha[mt][1];
          acc[mt][dn][3] *= alpha[mt][1];
        }
    }

    // O += P V: V's rows are the k dimension, read transposed
#pragma unroll
    for (int dn = 0; dn < DN; dn += 2) {
      uint32_t vb[4];  // b0 b1 of columns 8 dn.., b0 b1 of columns 8 dn + 8..
      ldmatrix_x4_trans(vb, sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * RE + dn * 8 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][dn], pa[mt], vb[0], vb[1]);
        mma_bf16(acc[mt][dn + 1], pa[mt], vb[2], vb[3]);
      }
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
  }

  // the warps' partials, merged in warp order through shared memory (the
  // rings are free now): per warp its rows' max and sum, then its [ROWS][D]
  // accumulator
  cp_async_wait<0>();
  __syncthreads();
  float* mrg = reinterpret_cast<float*>(smem);
  constexpr int WARP_FLOATS = 2 * ROWS + ROWS * D;
  {
    float* wm = mrg + warp * WARP_FLOATS;
    float* wl = wm + ROWS;
    float* wacc = wl + ROWS;
    const int g = lane >> 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lt = l[mt][r];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const int row = mt * 16 + g + 8 * r;
        if (t4 == 0) {
          wm[row] = m[mt][r];
          wl[row] = lt;
        }
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          wacc[row * D + dn * 8 + 2 * t4] = acc[mt][dn][2 * r];
          wacc[row * D + dn * 8 + 2 * t4 + 1] = acc[mt][dn][2 * r + 1];
        }
      }
  }
  __syncthreads();
  // the block's partial, in warp order: its rows' max and sum, then its
  // [ROWS][D] accumulator scaled to that max; a lone block writes the
  // split's result itself
  float* part = mrg + NWARPS * WARP_FLOATS;
  for (int x = tid; x < rows * (D + 1); x += NTHREADS) {
    const int r = x / (D + 1), d = x % (D + 1);  // d == D: the row's max, sum and lse
    float mmax = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mmax = fmaxf(mmax, mrg[w * WARP_FLOATS + r]);
    const float msafe = mmax == -INFINITY ? 0.f : mmax;
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* wm = mrg + w * WARP_FLOATS;
      const float e = wm[r] == -INFINITY ? 0.f : __expf(wm[r] - msafe);
      lsum += e * wm[ROWS + r];
      if (d < D) o += e * wm[2 * ROWS + r * D + d];
    }
    if (nblk > 1) {
      if (d < D) {
        part[2 * ROWS + r * D + d] = o;
      } else {
        part[r] = mmax;
        part[ROWS + r] = lsum;
      }
      continue;
    }
    const int i = row0 + r;
    const size_t orow = ((size_t)(i / group) * splits + s) * hq + h * group + i % group;
    if (d < D)
      out_parts[orow * D + d] = lsum > 0.f ? o / lsum : 0.f;
    else
      lse_parts[orow] = lsum > 0.f ? msafe + logf(lsum) : -INFINITY;
  }
  if (nblk == 1) return;

  // the cluster's blocks' partials, merged in block order through
  // distributed shared memory, each (row, d) by one thread of the cluster
  cluster.sync();
  for (int x = rank * NTHREADS + tid; x < rows * (D + 1); x += nblk * NTHREADS) {
    const int r = x / (D + 1), d = x % (D + 1);
    float mmax = -INFINITY;
    for (int b = 0; b < nblk; ++b) mmax = fmaxf(mmax, cluster.map_shared_rank(part, b)[r]);
    const float msafe = mmax == -INFINITY ? 0.f : mmax;
    float lsum = 0.f, o = 0.f;
    for (int b = 0; b < nblk; ++b) {
      const float* bp = cluster.map_shared_rank(part, b);
      const float e = bp[r] == -INFINITY ? 0.f : __expf(bp[r] - msafe);
      lsum += e * bp[ROWS + r];
      if (d < D) o += e * bp[2 * ROWS + r * D + d];
    }
    const int i = row0 + r;
    const size_t orow = ((size_t)(i / group) * splits + s) * hq + h * group + i % group;
    if (d < D)
      out_parts[orow * D + d] = lsum > 0.f ? o / lsum : 0.f;
    else
      lse_parts[orow] = lsum > 0.f ? msafe + logf(lsum) : -INFINITY;
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// The blocks that share one (kv head, split, row group) walk: a cluster of
// up to MAX_CLUSTER, the fewest that give every SM a block (the rings allow
// one an SM at d 128), as long as each warp keeps two chunks at the split's
// full length. ``walks`` counts the walks of the whole head count a launch
// stands for: a tensor-parallel head slice sizes its clusters as the full
// launch does, so each walk merges over the same block partition and gives
// the same bits.
inline int cluster_blocks(int walks, int split_tokens) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  int c = 1;
  while (c < MAX_CLUSTER && c * walks < sms) c *= 2;
  while (c > 1 && split_tokens < 2 * CH * NWARPS * c) c /= 2;
  return c;
}

template <int D, int MT>
cudaError_t launch_mt(const bf16* q, const bf16* kp, const bf16* vp, const int* bt,
                      const int* sl, float* out_parts, float* lse_parts, int hq, int hk,
                      int rows_total, int rows_per_block, int shared, int ps, int mpp,
                      int splits, int cluster_heads, float scale, float softcap,
                      cudaStream_t stream) {
  constexpr int ROWS = MT * 16;
  const size_t smem = fixed_smem<D, MT>();
  static_assert((NWARPS * (2 * ROWS + ROWS * D) + 2 * ROWS + ROWS * D) * sizeof(float) <=
                    NWARPS * stages<D>() * stage_elems<D>() * sizeof(bf16),
                "the merge buffers fit in the rings");
  static_assert(fixed_smem<D, MT>() <= 232448, "a block's shared memory fits an SM");
  auto kernel = paged_decode_mma<D, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // row groups: rows_per_block rows each, in the flat mode a sequence's
  // row tiles
  const int group = hq / hk;
  const int groups = shared ? (rows_total + rows_per_block - 1) / rows_per_block
                            : rows_total / group * ((group + rows_per_block - 1) / rows_per_block);
  const int c = cluster_blocks(cluster_heads * splits * groups, mpp / splits * ps);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hk * c, splits, groups);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, q, kp, vp, bt, sl, out_parts, lse_parts, hq, hk,
                            hq / hk, rows_total, rows_per_block, shared, ps, mpp, splits, scale,
                            softcap);
}

// b rows of q (sequences, or a shared prefix's members), bf16 pages.
// ``cluster_heads``: the kv-head count the cluster size is chosen for (at
// least hk; hk for a launch that stands for itself). A flat-mode group of
// up to one m16 tile of q heads runs the walk above with its rows in one
// tile, up to MAX_ROWS in two; a larger one is decode_wide_sm90.cuh's
// (decode.cu chooses). The shared mode takes MAX_ROWS rows a walk at any
// group.
template <int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* bt,
                   const void* sl, void* out_parts, void* lse_parts, int b, int hq, int hk,
                   int ps, int mpp, int splits, int shared, int cluster_heads, float scale,
                   float softcap, cudaStream_t stream) {
  const int group = hq / hk;
  if (cluster_heads < hk || (!shared && group > MAX_ROWS)) return cudaErrorInvalidValue;
  const int rows_total = b * group;
  // one m16 tile a walk at d = 256 (see the top), up to two below
  const int rows_per_block = min(shared ? rows_total : group, D > 128 ? WIDE_D_ROWS : MAX_ROWS);
#define MAGI_DECODE_MT(MT)                                                                   \
  launch_mt<D, MT>((const bf16*)q, (const bf16*)kp, (const bf16*)vp, (const int*)bt,          \
                   (const int*)sl, (float*)out_parts, (float*)lse_parts, hq, hk, rows_total,  \
                   rows_per_block, shared, ps, mpp, splits, cluster_heads, scale, softcap,   \
                   stream)
  if constexpr (D <= 128) {
    if (rows_per_block > 16) return MAGI_DECODE_MT(2);
  }
  return MAGI_DECODE_MT(1);
#undef MAGI_DECODE_MT
}

}  // namespace decode_sm90

// The previous row-major flex-attention forward walk (the port's first
// design: mma.sync, synchronous tile loads, no TMA, pipeline or warp
// specialisation), kept only as the yardstick that chip_smoke.py builds
// beside the kernels and times in turns with them. No kernel of the port
// includes it: flex_fwd.cu and flex_fwd_hb.cu run flex_fwd_sm90.cuh.
//
// What it computes is the body of the TPU kernels magiattention_tpu/ops/
// flex_attn.py::_fwd_kernel and _fwd_kernel_hb: for one q block and NH q
// heads of one kv head it walks that block's entries rs[i] .. rs[i]+rc[i]-1
// and runs scores -> scale -> softcap -> the entry's per-row k-interval
// mask -> the natural-exp online softmax, then folds in the optional
// per-head sink. Outputs: out [hq, tqp, d] (bf16 or f32), lse and rowmax
// [hq, tqp] f32 (rowmax without the sink).
//
// NH x 4 warps: warp w serves head w / 4, rows 16 (w % 4) .. +16 of the q
// block; a K/V tile is loaded once per distinct k block of the walk, with
// __syncthreads() around each load, so loads and products do not overlap.
#pragma once

#include "flex_tile.cuh"

namespace flex {

// The shared memory of a block of NH heads: NH Q tiles, one K and one V tile.
template <int D, int NH>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(NH * BQ + 2 * BK) * (D + PAD) * sizeof(bf16);
}

// One q block i of the NH q heads h0 .. h0+NH-1, all of kv head kvh, by a
// block of NH * NTHREADS threads. The caller makes sure no warp still reads
// the shared memory of a previous call.
template <int D, int NH, typename OutT>
__device__ __forceinline__ void fwd_rows(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ sink, const int* __restrict__ kblk,
    const int* __restrict__ sid, const int* __restrict__ runs,
    const int* __restrict__ bounds, const int* __restrict__ rs, const int* __restrict__ rc,
    OutT* __restrict__ out, float* __restrict__ lse, float* __restrict__ rowmax, int h0,
    int kvh, int i, int tqp, int tkp, float scale, float softcap, int has_sink,
    unsigned char* smem_raw) {
  constexpr int LDS = D + PAD;
  constexpr int NT = NH * NTHREADS;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // NH q tiles
  bf16* sK = sQ + NH * BQ * LDS;
  bf16* sV = sK + BK * LDS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int hw = warp / NWARPS;            // which of the NH heads
  const int h = h0 + hw;                   // this warp's q head

  const bf16* kh = k + (size_t)kvh * tkp * D;
  const bf16* vh = v + (size_t)kvh * tkp * D;

#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
    load_tile<D, NT>(sQ + hh * BQ * LDS, q + ((size_t)(h0 + hh) * tqp + (size_t)i * BQ) * D,
                     BQ);
  __syncthreads();

  // this thread's query rows within the block: r0 and r0 + 8
  const int r0 = (warp % NWARPS) * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<LDS>(qf[kk], sQ + hw * BQ * LDS, r0, kk * 16 + 2 * t4);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const int row[2] = {i * BQ + r0, i * BQ + r0 + 8};  // local (padded) rows

  const int e_begin = rs[i], e_end = rs[i] + rc[i];
  int loaded = -1;  // k block currently in sK/sV
  for (int e = e_begin; e < e_end; ++e) {
    const int kb = kblk[e];
    if (kb != loaded) {
      __syncthreads();  // every warp is done with the previous tile
      load_tile<D, NT>(sK, kh + (size_t)kb * BK * D, BK);
      load_tile<D, NT>(sV, vh + (size_t)kb * BK * D, BK);
      __syncthreads();
      loaded = kb;
    }

    // the entry's mask as a k-interval [lo, hi) per row (_entry_interval_mask)
    int lo[2], hi[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) entry_interval(runs, bounds, sid[e], e, row[rr], lo[rr], hi[rr]);

    // S = Q K^T for this warp's 16 rows x BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* p = sK + (j * 8 + g) * LDS + kk * 16 + 2 * t4;
        mma_16816(s[j], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    // scale -> softcap -> mask, and the rows' maxima
    const int col0 = kb * BK + 2 * t4;
    float mcur[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        const int col = col0 + j * 8 + (c & 1);
        float z = logit(s[j][c], scale, softcap);
        z = (col >= lo[rr] && col < hi[rr]) ? z : -INFINITY;
        s[j][c] = z;
        mcur[rr] = fmaxf(mcur[rr], z);
      }
    }
    float msafe[2], alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // a row's 16 columns per tile are spread over the 4 lanes of a quad
      mcur[rr] = fmaxf(mcur[rr], __shfl_xor_sync(0xffffffffu, mcur[rr], 1));
      mcur[rr] = fmaxf(mcur[rr], __shfl_xor_sync(0xffffffffu, mcur[rr], 2));
      const float mnew = fmaxf(m[rr], mcur[rr]);
      msafe[rr] = mnew == -INFINITY ? 0.f : mnew;  // empty rows: no -inf - -inf
      alpha[rr] = m[rr] == -INFINITY ? 0.f : expf(m[rr] - msafe[rr]);
      m[rr] = mnew;
    }
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[j][c] - msafe[c >> 1]);
        s[j][c] = p;
        lsum[c >> 1] += p;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      lsum[rr] += __shfl_xor_sync(0xffffffffu, lsum[rr], 1);
      lsum[rr] += __shfl_xor_sync(0xffffffffu, lsum[rr], 2);
      l[rr] = l[rr] * alpha[rr] + lsum[rr];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, P cast to bf16 (V's type) as the TPU kernel does
    mma_a_tile<D, LDS>(o, s, sV, lane);
  }

  // epilogue: sink fold, uncovered rows (out=0, lse=-inf or sink), outputs
  float oscale[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mt_safe, ltot, resc = 1.f;
    if (has_sink) {
      const float sk = sink[h];
      const float mtot = fmaxf(m[rr], sk);
      mt_safe = mtot == -INFINITY ? 0.f : mtot;
      resc = m[rr] == -INFINITY ? 0.f : expf(m[rr] - mt_safe);
      ltot = l[rr] * resc + expf(sk - mt_safe);
    } else {
      mt_safe = m[rr] == -INFINITY ? 0.f : m[rr];
      ltot = l[rr];
    }
    const bool covered = ltot > 0.f;
    oscale[rr] = covered ? resc / ltot : 0.f;
    if (t4 == 0) {
      const size_t idx = (size_t)h * tqp + row[rr];
      lse[idx] = covered ? mt_safe + logf(ltot) : -INFINITY;
      rowmax[idx] = m[rr];
    }
  }
  OutT* o0 = out + ((size_t)h * tqp + row[0]) * D + 2 * t4;
  OutT* o1 = out + ((size_t)h * tqp + row[1]) * D + 2 * t4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    store2(o0 + j * 8, o[j][0] * oscale[0], o[j][1] * oscale[0]);
    store2(o1 + j * 8, o[j][2] * oscale[1], o[j][3] * oscale[1]);
  }
}

}  // namespace flex

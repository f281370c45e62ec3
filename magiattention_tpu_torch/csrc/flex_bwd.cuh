// The previous per-item bodies of the flex-attention backward: mma.sync,
// loads by the threads, no pipeline. The row-major flex_dq.cu / flex_dkv.cu
// and then the sparse-grid flex_dq_sparse.cu / flex_dkv_sparse.cu ran them
// until all four moved onto the TMA + wgmma walks of flex_bwd_sm90.cuh. No
// kernel includes this header any more: it serves only chip_smoke.py's
// yardsticks of the backward (the row-major grid's and the persistent
// sparse grid's previous walks). The math is the one flex_dq.cu and
// flex_dkv.cu describe.
#pragma once

#include "flex_tile.cuh"

namespace flex {

// The shared-memory bytes of one dq item and of one dkv item.
template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * BQ + 2 * BK) * (D + PAD) * sizeof(bf16);
}

template <int D>
constexpr size_t dkv_smem() {
  return (size_t)(2 * BK + 2 * BQ) * (D + PAD) * sizeof(bf16) + (size_t)4 * BQ * sizeof(float);
}

// dq of one (q head h, q block i): flex_dq.cu's walk (see there), in
// dq_smem<D>() bytes of shared memory. Starts by loading Q and dO: the
// caller makes sure no warp still reads the shared tiles of a previous
// item.
template <int D>
__device__ __forceinline__ void dq_item(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ kblk,
    const int* __restrict__ sid, const int* __restrict__ runs,
    const int* __restrict__ bounds, const int* __restrict__ rs,
    const int* __restrict__ rc, float* __restrict__ dq, int group, int tqp, int tkp,
    float scale, float softcap, int h, int i, unsigned char* smem) {
  constexpr int LDS = D + PAD;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + BQ * LDS;  // dO
  bf16* sK = sO + BQ * LDS;
  bf16* sV = sK + BK * LDS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const bf16* kh = k + (size_t)(h / group) * tkp * D;
  const bf16* vh = v + (size_t)(h / group) * tkp * D;
  const size_t q0 = (size_t)h * tqp + (size_t)i * BQ;
  load_tile<D>(sQ, q + q0 * D, BQ);
  load_tile<D>(sO, dout + q0 * D, BQ);

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int row[2] = {i * BQ + r0, i * BQ + r0 + 8};
  float lse_safe[2], dlt[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float L = lse[(size_t)h * tqp + row[rr]];
    lse_safe[rr] = L == -INFINITY ? 0.f : L;
    dlt[rr] = delta[(size_t)h * tqp + row[rr]];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int e_begin = rs[i], e_end = rs[i] + rc[i];
  int loaded = -1;  // k block currently in sK/sV
  for (int e = e_begin; e < e_end; ++e) {
    const int kb = kblk[e];
    if (kb != loaded) {
      __syncthreads();  // every warp is done with the previous tile (and sQ/sO are in)
      load_tile<D>(sK, kh + (size_t)kb * BK * D, BK);
      load_tile<D>(sV, vh + (size_t)kb * BK * D, BK);
      __syncthreads();
      loaded = kb;
    }
    int lo[2], hi[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) entry_interval(runs, bounds, sid[e], e, row[rr], lo[rr], hi[rr]);

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<LDS>(qa, sQ, r0, kk * 16 + 2 * t4);
      load_a<LDS>(oa, sO, r0, kk * 16 + 2 * t4);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int off = (j * 8 + g) * LDS + kk * 16 + 2 * t4;
        mma_16816(s[j], qa, ld32(sK + off), ld32(sK + off + 8));
        mma_16816(dp[j], oa, ld32(sV + off), ld32(sV + off + 8));
      }
    }

    // dS in place of S
    const int col0 = kb * BK + 2 * t4;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = c >> 1;
        const int col = col0 + j * 8 + (c & 1);
        float p, ds;
        p_ds(logit(s[j][c], scale, softcap), col >= lo[rr] && col < hi[rr],
             lse_safe[rr], dp[j][c], dlt[rr], softcap, p, ds);
        s[j][c] = ds;
      }
    }

    // dQ += dS K, dS rounded to bf16 (K's type)
    mma_a_tile<D, LDS>(acc, s, sK, lane);
  }

  float* d0 = dq + ((size_t)h * tqp + row[0]) * D + 2 * t4;
  float* d1 = dq + ((size_t)h * tqp + row[1]) * D + 2 * t4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    store2(d0 + j * 8, acc[j][0] * scale, acc[j][1] * scale);
    store2(d1 + j * 8, acc[j][2] * scale, acc[j][3] * scale);
  }
}

// dk, dv of one (kv head hk, k block i): flex_dkv.cu's walk (see there),
// in dkv_smem<D>() bytes of shared memory. Starts by loading K and V: the
// caller makes sure no warp still reads the shared tiles of a previous
// item.
template <int D>
__device__ __forceinline__ void dkv_item(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qblk,
    const int* __restrict__ sid, const int* __restrict__ runs,
    const int* __restrict__ bounds, const int* __restrict__ rs,
    const int* __restrict__ rc, float* __restrict__ dk, float* __restrict__ dv,
    int group, int tqp, int tkp, float scale, float softcap, int hk, int i,
    unsigned char* smem) {
  constexpr int LDS = D + PAD;
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LDS;
  bf16* sQ = sV + BK * LDS;
  bf16* sO = sQ + BQ * LDS;  // dO
  float* sLse = reinterpret_cast<float*>(sO + BQ * LDS);  // lse, -inf -> 0
  float* sDelta = sLse + BQ;
  int* sLo = reinterpret_cast<int*>(sDelta + BQ);  // the entry's k-interval per query row
  int* sHi = sLo + BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  load_tile<D>(sK, k + ((size_t)hk * tkp + (size_t)i * BK) * D, BK);
  load_tile<D>(sV, v + ((size_t)hk * tkp + (size_t)i * BK) * D, BK);

  const int r0 = warp * 16 + g;  // this thread's key rows: r0 and r0 + 8
  const int key[2] = {i * BK + r0, i * BK + r0 + 8};

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }

  const int e_begin = rs[i], e_end = rs[i] + rc[i];
  for (int e = e_begin; e < e_end; ++e) {
    const int qb = qblk[e];
    for (int gi = 0; gi < group; ++gi) {
      const int h = hk * group + gi;
      const size_t q0 = (size_t)h * tqp + (size_t)qb * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO/lse tiles
      load_tile<D>(sQ, q + q0 * D, BQ);
      load_tile<D>(sO, dout + q0 * D, BQ);
      if (threadIdx.x < BQ) {
        const int t = threadIdx.x;
        const float L = lse[q0 + t];
        sLse[t] = L == -INFINITY ? 0.f : L;
        sDelta[t] = delta[q0 + t];
        if (gi == 0) entry_interval(runs, bounds, sid[e], e, qb * BQ + t, sLo[t], sHi[t]);
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries
      float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = dpt[j][0] = dpt[j][1] =
            dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LDS>(ka, sK, r0, kk * 16 + 2 * t4);
        load_a<LDS>(va, sV, r0, kk * 16 + 2 * t4);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int off = (j * 8 + g) * LDS + kk * 16 + 2 * t4;
          mma_16816(st[j], ka, ld32(sQ + off), ld32(sQ + off + 8));
          mma_16816(dpt[j], va, ld32(sO + off), ld32(sO + off + 8));
        }
      }

      // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = j * 8 + 2 * t4 + (c & 1);  // query row in the tile
          const int col = key[c >> 1];
          float p, ds;
          p_ds(logit(st[j][c], scale, softcap), col >= sLo[t] && col < sHi[t],
               sLse[t], dpt[j][c], sDelta[t], softcap, p, ds);
          st[j][c] = p;
          dpt[j][c] = ds;
        }
      }

      // dV += P^T dO (P rounded to bf16, dO's type); dK += dS^T Q (dS
      // rounded to bf16, Q's type)
      mma_a_tile<D, LDS>(dv_acc, st, sO, lane);
      mma_a_tile<D, LDS>(dk_acc, dpt, sQ, lane);
    }
  }

  const size_t k0 = (size_t)hk * tkp;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float* pk = dk + (k0 + key[rr]) * D + 2 * t4;
    float* pv = dv + (k0 + key[rr]) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(pk + j * 8, dk_acc[j][2 * rr] * scale, dk_acc[j][2 * rr + 1] * scale);
      store2(pv + j * 8, dv_acc[j][2 * rr], dv_acc[j][2 * rr + 1]);
    }
  }
}

}  // namespace flex

// The previous sparse-grid flex-attention forward walk (the port's first
// design: mma.sync from padded shared memory, synchronous tile loads with a
// __syncthreads() on every new k block, no TMA, pipeline or warp
// specialisation), kept only as the yardstick that chip_smoke.py builds
// beside the kernels and times in turns with them. No kernel of the port
// includes it: flex_fwd_sparse.cu and flex_fwd_sparse_hb.cu run the
// persistent walk of flex_fwd_sm90.cuh.
//
// What it computes is the body of the TPU kernels magiattention_tpu/ops/
// flex_attn.py::_fwd_kernel_sparse and _fwd_kernel_hb_sparse: persistent
// blocks take (heads, q block) items from the longest-walk-first work list
// (flex_tile.cuh::next_item); per item and q head the entry walk
// rs[i] .. rs[i]+rc[i]-1 (scores -> scale -> softcap -> the entry's per-row
// k-interval mask) with AMLA's online softmax: in base 2, the running max
// quantized up to an integer, s2 = s log2(e), m = max(m, ceil(max s2)),
// p = exp2(s2 - m), the rescale of l and of the f32 accumulator by
// 2^(m_old - m_new) an integer add on the exponent bits (amla_rescale). The
// exact natural-scale row max is tracked apart for rowmax; the epilogue is
// _amla_finalize. P is rounded to bf16 before P V.
//
// NH (1 or 2) q heads of one kv head go through a block at once: NH x 4
// warps, warp w serving head w / 4, rows 16 (w % 4) .. +16 of the q block;
// an item of more heads than NH walks its entries once per chunk of NH
// heads, Q reloaded per chunk.
#pragma once

#include "flex_tile.cuh"

namespace flex {

template <int D, int NH, typename OutT>
__global__ void __launch_bounds__(NH * NTHREADS)
flex_fwd_sparse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ sink,
                       const int* __restrict__ kblk, const int* __restrict__ sid,
                       const int* __restrict__ runs, const int* __restrict__ bounds,
                       const int* __restrict__ rs, const int* __restrict__ rc,
                       const int* __restrict__ work, int* __restrict__ counter,
                       OutT* __restrict__ out, float* __restrict__ lse,
                       float* __restrict__ rowmax, int group, int tqp, int tkp, int nq,
                       int n_items, int heads_per_item, float scale, float softcap,
                       int has_sink) {
  constexpr int LDS = D + PAD;
  constexpr int NT = NH * NTHREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // NH q tiles
  bf16* sK = sQ + NH * BQ * LDS;
  bf16* sV = sK + BK * LDS;
  __shared__ int s_item;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hw = warp / NWARPS;              // which of the chunk's NH heads
  const int r0 = (warp % NWARPS) * 16 + g;   // this thread's rows: r0, r0 + 8

  for (int item = next_item(counter, &s_item); item < n_items;
       item = next_item(counter, &s_item)) {
    const int i = work[item] % nq;  // q block
    const int h_first = (work[item] / nq) * heads_per_item;
    const int row[2] = {i * BQ + r0, i * BQ + r0 + 8};  // local (padded) rows
    const int e_begin = rs[i], e_end = rs[i] + rc[i];
    for (int c = 0; c < heads_per_item; c += NH) {
      const int h = h_first + c + hw;  // this warp's q head
      // NH divides the GQA group: the chunk's heads share one kv head
      const bf16* kh = k + (size_t)((h_first + c) / group) * tkp * D;
      const bf16* vh = v + (size_t)((h_first + c) / group) * tkp * D;

      __syncthreads();  // every warp is done with the previous chunk's tiles
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        load_tile<D, NT>(sQ + hh * BQ * LDS,
                         q + ((size_t)(h_first + c + hh) * tqp + (size_t)i * BQ) * D, BQ);
      __syncthreads();
      uint32_t qf[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        load_a<LDS>(qf[kk], sQ + hw * BQ * LDS, r0, kk * 16 + 2 * t4);

      float o[D / 8][4];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};   // base-2 running max, integer-valued
      float mx[2] = {-INFINITY, -INFINITY};  // exact natural-scale row max
      float l[2] = {0.f, 0.f};

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
        int lo[2], hi[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          entry_interval(runs, bounds, sid[e], e, row[rr], lo[rr], hi[rr]);

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

        // scale -> softcap -> mask, and the rows' natural-scale maxima
        const int col0 = kb * BK + 2 * t4;
        float zmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int rr = cc >> 1;
            const int col = col0 + j * 8 + (cc & 1);
            float z = logit(s[j][cc], scale, softcap);
            z = (col >= lo[rr] && col < hi[rr]) ? z : -INFINITY;
            s[j][cc] = z;
            zmax[rr] = fmaxf(zmax[rr], z);
          }
        }
        // AMLA: the quantized max, and the rescale as an exponent add
        float msafe[2];
        int delta[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          // a row's 16 columns per tile are spread over the 4 lanes of a quad
          zmax[rr] = fmaxf(zmax[rr], __shfl_xor_sync(0xffffffffu, zmax[rr], 1));
          zmax[rr] = fmaxf(zmax[rr], __shfl_xor_sync(0xffffffffu, zmax[rr], 2));
          mx[rr] = fmaxf(mx[rr], zmax[rr]);
          // ceil(max(s) log2 e) = ceil(max(s log2 e)): rounding is monotone
          const float mnew = fmaxf(m[rr], ceilf(zmax[rr] * LOG2E_F));
          msafe[rr] = mnew == -INFINITY ? 0.f : mnew;
          // fresh rows (m = -inf) carry zero state: rescale by 2^0
          delta[rr] = (int)((m[rr] == -INFINITY ? msafe[rr] : m[rr]) - msafe[rr]);
          m[rr] = mnew;
        }
        float lsum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float p = exp2f(s[j][cc] * LOG2E_F - msafe[cc >> 1]);
            s[j][cc] = p;
            lsum[cc >> 1] += p;
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          lsum[rr] += __shfl_xor_sync(0xffffffffu, lsum[rr], 1);
          lsum[rr] += __shfl_xor_sync(0xffffffffu, lsum[rr], 2);
          l[rr] = amla_rescale(l[rr], delta[rr]) + lsum[rr];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[j][0] = amla_rescale(o[j][0], delta[0]);
          o[j][1] = amla_rescale(o[j][1], delta[0]);
          o[j][2] = amla_rescale(o[j][2], delta[1]);
          o[j][3] = amla_rescale(o[j][3], delta[1]);
        }
        // O += P V, P rounded to bf16 (V's type) as the TPU kernel does
        mma_a_tile<D, LDS>(o, s, sV, lane);
      }

      // epilogue (_amla_finalize): mu = m ln2, the sink fold, uncovered rows
      float oscale[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float mu = m[rr] * LN2_F;
        float mt_safe, ltot, resc = 1.f;
        if (has_sink) {
          const float sk = sink[h];
          const float mtot = fmaxf(mu, sk);
          mt_safe = mtot == -INFINITY ? 0.f : mtot;
          resc = mu == -INFINITY ? 0.f : expf(mu - mt_safe);
          ltot = l[rr] * resc + expf(sk - mt_safe);
        } else {
          mt_safe = mu == -INFINITY ? 0.f : mu;
          ltot = l[rr];
        }
        const bool covered = ltot > 0.f;
        oscale[rr] = covered ? resc * (1.f / ltot) : 0.f;
        if (t4 == 0) {
          const size_t idx = (size_t)h * tqp + row[rr];
          lse[idx] = covered ? mt_safe + logf(ltot) : -INFINITY;
          rowmax[idx] = mx[rr];
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
  }
}

template <int D, int NH, typename OutT>
cudaError_t launch_fwd_sparse(const void* q, const void* k, const void* v,
                              const void* sink, const void* kblk, const void* sid,
                              const void* runs, const void* bounds, const void* rs,
                              const void* rc, const void* work, void* counter, void* out,
                              void* lse, void* rowmax, int hq, int hk, int tqp, int tkp,
                              int nq, int n_items, int heads_per_item, float scale,
                              float softcap, int has_sink, cudaStream_t stream) {
  const size_t smem = (size_t)(NH * BQ + 2 * BK) * (D + PAD) * sizeof(bf16);
  auto kernel = flex_fwd_sparse_kernel<D, NH, OutT>;
  int grid = 0;
  cudaError_t err = persistent_launch_dims(kernel, NH * NTHREADS, smem, n_items,
                                           (int*)counter, stream, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NH * NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)sink,
      (const int*)kblk, (const int*)sid, (const int*)runs, (const int*)bounds,
      (const int*)rs, (const int*)rc, (const int*)work, (int*)counter, (OutT*)out,
      (float*)lse, (float*)rowmax, hq / hk, tqp, tkp, nq, n_items, heads_per_item,
      scale, softcap, has_sink);
  return cudaGetLastError();
}

// The C entry points' shared checks and head_dim / output-type dispatch.
template <int NH>
cudaError_t dispatch_fwd_sparse(const void* q, const void* k, const void* v,
                                const void* sink, const void* kblk, const void* sid,
                                const void* runs, const void* bounds, const void* rs,
                                const void* rc, const void* work, void* counter,
                                void* out, void* lse, void* rowmax, int hq, int hk,
                                int tqp, int tkp, int head_dim, int nq, int block_q,
                                int block_k, int n_items, int heads_per_item,
                                float scale, float softcap, int has_sink, int out_f32,
                                void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 ||
      tqp != nq * BQ || tkp % BK != 0 || heads_per_item <= 0 ||
      heads_per_item % NH != 0 || hq % heads_per_item != 0 ||
      (hq / hk) % NH != 0 || n_items != (hq / heads_per_item) * nq)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MAGI_FWD_SPARSE_LAUNCH(DIM)                                               \
  return out_f32 ? launch_fwd_sparse<DIM, NH, float>(                            \
                       q, k, v, sink, kblk, sid, runs, bounds, rs, rc, work,     \
                       counter, out, lse, rowmax, hq, hk, tqp, tkp, nq, n_items, \
                       heads_per_item, scale, softcap, has_sink, st)             \
                 : launch_fwd_sparse<DIM, NH, bf16>(                             \
                       q, k, v, sink, kblk, sid, runs, bounds, rs, rc, work,     \
                       counter, out, lse, rowmax, hq, hk, tqp, tkp, nq, n_items, \
                       heads_per_item, scale, softcap, has_sink, st)
  switch (head_dim) {
    case 64: MAGI_FWD_SPARSE_LAUNCH(64);
    case 128: MAGI_FWD_SPARSE_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef MAGI_FWD_SPARSE_LAUNCH
}

}  // namespace flex

// flex_fwd: the flex-attention forward over a host-built entry table, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::_fwd_pallas
// (kernel body _fwd_kernel): for each (q head, q block) it walks that block's
// entries — (k block, slice, run window) tiles from ops/block_meta.py — and
// runs scores -> scale -> softcap -> per-entry interval mask -> online
// softmax, then folds in the optional per-head sink. Outputs: out
// [hq, tqp, d] (bf16 or f32), lse and rowmax [hq, tqp] f32 (the TPU's
// 128-lane broadcast of lse/rowmax was a tiling artefact and is dropped).
//
// What bounds it on the card: a causal prefill at d=128 does ~4*d FLOPs
// per unmasked (q, k) pair against 2 bytes of K/V per key that a q block
// re-reads from L2, so it is bound by tensor-core operations (989 TFLOP/s
// bf16 dense on an H100 SXM), not by memory.
//
// What this design does about it, and what it does not yet: the products
// run on the tensor cores (mma.sync m16n8k16 bf16 -> f32, Ampere-style,
// 4 warps x 16 query rows per thread block), the score tile and the
// online-softmax state never leave registers, and a K/V tile is loaded
// once per distinct k block of the walk. It does not yet use wgmma, TMA,
// a cp.async pipeline or warp specialisation, so loads and products do not
// overlap; that is the work of a later change.
//
// Grid: (q blocks, q heads). One thread block per (head h, q block i); the
// loop over entries rs[i] .. rs[i]+rc[i] takes the place of the TPU's
// sequential grid axis. K/V come from kv head h / group.

#include "flex_tile.cuh"

namespace {

using namespace flex;

template <int D, typename OutT>
__global__ void __launch_bounds__(NTHREADS)
flex_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ sink,
                const int* __restrict__ kblk, const int* __restrict__ sid,
                const int* __restrict__ runs, const int* __restrict__ bounds,
                const int* __restrict__ rs, const int* __restrict__ rc,
                OutT* __restrict__ out, float* __restrict__ lse,
                float* __restrict__ rowmax, int group, int tqp, int tkp,
                float scale, float softcap, int has_sink) {
  constexpr int LDS = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LDS;
  bf16* sV = sK + BK * LDS;

  const int i = blockIdx.x;  // q block
  const int h = blockIdx.y;  // q head
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair

  const bf16* kh = k + (size_t)(h / group) * tkp * D;
  const bf16* vh = v + (size_t)(h / group) * tkp * D;

  load_tile<D>(sQ, q + ((size_t)h * tqp + (size_t)i * BQ) * D, BQ);
  __syncthreads();

  // this thread's query rows within the block: r0 and r0 + 8
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a<LDS>(qf[kk], sQ, r0, kk * 16 + 2 * t4);

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
      load_tile<D>(sK, kh + (size_t)kb * BK * D, BK);
      load_tile<D>(sV, vh + (size_t)kb * BK * D, BK);
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

template <int D, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* sink,
                   const void* kblk, const void* sid, const void* runs,
                   const void* bounds, const void* rs, const void* rc, void* out,
                   void* lse, void* rowmax, int hq, int hk, int tqp, int tkp,
                   int nq, float scale, float softcap, int has_sink,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 2 * BK) * (D + PAD) * sizeof(bf16);
  auto kernel = flex_fwd_kernel<D, OutT>;
  // above 48 KB of dynamic shared memory a kernel has to opt in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, hq);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)sink,
      (const int*)kblk, (const int*)sid, (const int*)runs, (const int*)bounds,
      (const int*)rs, (const int*)rc, (OutT*)out, (float*)lse, (float*)rowmax,
      hq / hk, tqp, tkp, scale, softcap, has_sink);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [hq, tqp, d] bf16; k/v [hk, tkp, d] bf16; sink [hq] f32; int32 tables
// (kblk, sid [E]; runs [7E]; bounds [5(S+1)]; rs, rc [nq]); out [hq, tqp, d]
// bf16 (out_f32=0) or f32 (out_f32=1); lse, rowmax [hq, tqp] f32.
int magi_flex_fwd(const void* q, const void* k, const void* v, const void* sink,
                  const void* kblk, const void* sid, const void* runs,
                  const void* bounds, const void* rs, const void* rc, void* out,
                  void* lse, void* rowmax, int hq, int hk, int tqp, int tkp,
                  int head_dim, int nq, int block_q, int block_k, float scale,
                  float softcap, int has_sink, int out_f32, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 ||
      tqp != nq * BQ || tkp % BK != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MAGI_FLEX_LAUNCH(D)                                                   \
  return out_f32 ? launch<D, float>(q, k, v, sink, kblk, sid, runs, bounds,  \
                                    rs, rc, out, lse, rowmax, hq, hk, tqp,   \
                                    tkp, nq, scale, softcap, has_sink, st)   \
                 : launch<D, bf16>(q, k, v, sink, kblk, sid, runs, bounds,   \
                                   rs, rc, out, lse, rowmax, hq, hk, tqp,    \
                                   tkp, nq, scale, softcap, has_sink, st)
  switch (head_dim) {
    case 64: MAGI_FLEX_LAUNCH(64);
    case 128: MAGI_FLEX_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef MAGI_FLEX_LAUNCH
}

}  // extern "C"

// flex_dq: the flex-attention backward's dq over the forward (q-major) entry
// table, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::_dq_pallas
// (kernel body _dq_kernel, shared core _bwd_p_ds): for each (q head, q
// block) it walks that block's entries, and for each one recomputes
// S = scale Q K^T (+ softcap), applies the entry's interval mask, forms
// P = exp(S - lse) from the forward's stored lse, dP = dO V^T and
// dS = P (dP - delta_eff) (times 1 - (S/cap)^2 under a softcap), and
// accumulates dQ += scale dS K with dS rounded to bf16 before the product,
// as the TPU kernel does. Output: dq [hq, tqp, d] f32.
//
// What bounds it on the card: 6 d FLOPs per unmasked (q, k) pair (S, dP
// and dQ) against 4 bytes of K/V per key that a q block re-reads from L2,
// so on a long causal sequence it is bound by tensor-core operations
// (989 TFLOP/s bf16 dense on an H100 SXM).
//
// What this design does about it, and what it does not yet: the three
// products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32, 4 warps
// x 16 query rows), S, dP and the dQ accumulator never leave registers, Q
// and dO are loaded once per block and K/V once per distinct k block of the
// walk. No atomics: each block owns its dQ rows, so the result is the same
// bits on every run. It does not yet use wgmma, TMA or a cp.async pipeline,
// so loads and products do not overlap; that is a later change.
//
// Grid: (q blocks, q heads); K/V come from kv head h / group. A q block
// with no entry to walk still writes its (zero) rows.

#include "flex_tile.cuh"

namespace {

using namespace flex;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flex_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ kblk, const int* __restrict__ sid,
               const int* __restrict__ runs, const int* __restrict__ bounds,
               const int* __restrict__ rs, const int* __restrict__ rc,
               float* __restrict__ dq, int group, int tqp, int tkp, float scale,
               float softcap) {
  constexpr int LDS = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BQ * LDS;  // dO
  bf16* sK = sO + BQ * LDS;
  bf16* sV = sK + BK * LDS;

  const int i = blockIdx.x;  // q block
  const int h = blockIdx.y;  // q head
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

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* kblk,
                   const void* sid, const void* runs, const void* bounds,
                   const void* rs, const void* rc, void* dq, int hq, int hk,
                   int tqp, int tkp, int nq, float scale, float softcap,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(2 * BQ + 2 * BK) * (D + PAD) * sizeof(bf16);
  auto kernel = flex_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, hq);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (const int*)kblk, (const int*)sid,
      (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
      (float*)dq, hq / hk, tqp, tkp, scale, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/dout [hq, tqp, d] bf16; k/v [hk, tkp, d] bf16; lse/delta [hq, tqp] f32
// (delta = sum_d dout*out - dlse); the forward's int32 tables (kblk, sid
// [E]; runs [7E]; bounds [5(S+1)]; rs, rc [nq]); dq [hq, tqp, d] f32.
int magi_flex_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* kblk,
                 const void* sid, const void* runs, const void* bounds,
                 const void* rs, const void* rc, void* dq, int hq, int hk,
                 int tqp, int tkp, int head_dim, int nq, int block_q,
                 int block_k, float scale, float softcap, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 ||
      tqp != nq * BQ || tkp % BK != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs,
                        rc, dq, hq, hk, tqp, tkp, nq, scale, softcap, st);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs,
                         rc, dq, hq, hk, tqp, tkp, nq, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

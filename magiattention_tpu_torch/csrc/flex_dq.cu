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

#include "flex_bwd.cuh"

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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dq_item<D>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, dq, group, tqp,
             tkp, scale, softcap, /*h=*/blockIdx.y, /*i=*/blockIdx.x, smem_raw);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* kblk,
                   const void* sid, const void* runs, const void* bounds,
                   const void* rs, const void* rc, void* dq, int hq, int hk,
                   int tqp, int tkp, int nq, float scale, float softcap,
                   cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
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

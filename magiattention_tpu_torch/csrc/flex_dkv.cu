// flex_dkv: the flex-attention backward's dk and dv over the backward
// (k-major) entry table, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::_dkv_pallas
// (kernel body _dkv_kernel, shared core _bwd_p_ds): for each (kv head, k
// block) it walks that block's entries, and inside each entry the G q heads
// h = hk G + g in order (entry outer, group inner: the TPU grid
// (hk, nk, steps, group)). Per (entry, head) it recomputes the transposed
// scores S^T = scale K Q^T (+ softcap) and dP^T = V dO^T, masks them with
// the entry's interval mask (row0 = qblk[e] bq, col0 = i bk), forms
// P = exp(S - lse) and dS = P (dP - delta_eff), and accumulates
// dV += P^T dO (P rounded to bf16) and dK += scale dS^T Q (dS rounded to
// bf16), as the TPU kernel does. Outputs: dk, dv [hk, tkp, d] f32.
//
// What bounds it on the card: 8 d FLOPs per unmasked (q, k) pair and q
// head (S, dP, dV, dK) against 4 bytes of Q/dO per query row that a k
// block re-reads from L2, so on a long causal sequence it is bound by
// tensor-core operations (989 TFLOP/s bf16 dense on an H100 SXM).
//
// What this design does about it, and what it does not yet: the four
// products run on the tensor cores (mma.sync m16n8k16 bf16 -> f32, 4 warps
// x 16 key rows); K and V stay in shared memory and the dK and dV
// accumulators (2 x 16 x d f32 per warp) in registers for the whole walk,
// while Q, dO, lse and delta_eff stream through per (entry, head). The sum
// over the G q heads of a kv head happens in that block in a fixed order,
// with no atomics, so the result is the same bits on every run (the
// reference's deterministic mode). At d=128 the two accumulators take 128
// registers a thread, which is what limits occupancy; splitting d across
// more warps, wgmma, TMA and pipelining are later changes.
//
// Grid: (k blocks, kv heads). A k block with no entry to walk still writes
// its (zero) rows.

#include "flex_bwd.cuh"

namespace {

using namespace flex;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flex_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ qblk, const int* __restrict__ sid,
                const int* __restrict__ runs, const int* __restrict__ bounds,
                const int* __restrict__ rs, const int* __restrict__ rc,
                float* __restrict__ dk, float* __restrict__ dv, int group,
                int tqp, int tkp, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dkv_item<D>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, dk, dv, group,
              tqp, tkp, scale, softcap, /*hk=*/blockIdx.y, /*i=*/blockIdx.x, smem_raw);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qblk,
                   const void* sid, const void* runs, const void* bounds,
                   const void* rs, const void* rc, void* dk, void* dv, int hq,
                   int hk, int tqp, int tkp, int nk, float scale, float softcap,
                   cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  auto kernel = flex_dkv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nk, hk);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (const int*)qblk, (const int*)sid,
      (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
      (float*)dk, (float*)dv, hq / hk, tqp, tkp, scale, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/dout [hq, tqp, d] bf16; k/v [hk, tkp, d] bf16; lse/delta [hq, tqp] f32
// (delta = sum_d dout*out - dlse); the backward's int32 tables (qblk, sid
// [E2]; runs [7 E2]; bounds [5(S+1)]; rs, rc [nk] over its k blocks);
// dk, dv [hk, tkp, d] f32.
int magi_flex_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* qblk,
                  const void* sid, const void* runs, const void* bounds,
                  const void* rs, const void* rc, void* dk, void* dv, int hq,
                  int hk, int tqp, int tkp, int head_dim, int nk, int block_q,
                  int block_k, float scale, float softcap, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 ||
      tkp != nk * BK || tqp % BQ != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs,
                        rc, dk, dv, hq, hk, tqp, tkp, nk, scale, softcap, st);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs,
                         rc, dk, dv, hq, hk, tqp, tkp, nk, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

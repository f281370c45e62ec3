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
// tensor-core operations: 8 pairs d hq FLOPs against 989 TFLOP/s bf16
// dense on an H100 SXM.
//
// What the design does about it (flex_bwd_sm90.cuh): the four products run
// on wgmma (S^T and dP^T with K/V and Q/dO both in swizzled shared memory,
// computed transposed so that P^T and dS^T are already the A operands of
// dV += P^T dO and dK += dS^T Q, from registers, with dO and Q read
// transposed). K and V are loaded once per block by TMA and stay; a
// producer warpgroup streams Q, dO, lse and delta_eff per (entry, head)
// through a four-stage ring while the consumers compute. The two consumer
// warpgroups take the items in turn (item n to warpgroup n % 2), so one's
// products overlap the other's softmax core, and each keeps its own dK/dV
// partial in registers (2 x 64 x d f32 over 128 threads: 128 registers a
// thread at d = 128, of the 240 the producer's setmaxnreg leaves them). The
// partials are added once, in shared memory, at the end: a fixed split and
// no atomics, so the result is the same bits on every run (the reference's
// deterministic mode).
//
// Grid: (kv heads, k blocks), the k blocks in the host's launch order
// (longest walk first, ops/flex_attn.py::walk_order). A k block with no
// entry to walk still writes its (zero) rows.

#include "flex_bwd_sm90.cuh"

namespace {

using namespace flex;
using namespace flex::sm90;

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flex_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ qblk, const int* __restrict__ sid,
                const int* __restrict__ runs, const int* __restrict__ bounds,
                const int* __restrict__ rs, const int* __restrict__ rc,
                const int* __restrict__ order, float* __restrict__ dk, float* __restrict__ dv,
                int group, int tqp, int tkp, float scale, float softcap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int i = order[blockIdx.y];  // k block
  const int hk = blockIdx.x;
  const int e_begin = rs[i], e_end = rs[i] + rc[i];
  if (threadIdx.x == 0) init_bars(Bars{base + DkvLayout<D>::BARS}, WG_THREADS / 32);
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * WG_THREADS) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG_THREADS)
      dkv_producer<D>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, qblk, e_begin, e_end, group, hk,
                      i, tqp, tkp, base);
  } else {
    reg_alloc<CONSUMER_REGS>();
    dkv_consumer<D>(threadIdx.x / WG_THREADS, smem, base, qblk, sid, runs, bounds, e_begin,
                    e_end, dk, dv, group, hk, i, tkp, scale, softcap);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qblk, const void* sid,
                   const void* runs, const void* bounds, const void* rs, const void* rc,
                   const void* order, void* dk, void* dv, int hq, int hk, int tqp, int tkp,
                   int nk, float scale, float softcap, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(lse) % 16 != 0 || reinterpret_cast<uintptr_t>(delta) % 16 != 0)
    return cudaErrorMisalignedAddress;  // the 1-D bulk copies of lse and delta
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = encode_tile_map(&tm_q, q, hq * tqp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_k, k, hk * tkp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_v, v, hk * tkp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_do, dout, hq * tqp, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = DkvLayout<D>::ALLOC;
  auto kernel = flex_dkv_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(hk, nk);
  kernel<<<grid, WS_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta, (const int*)qblk,
      (const int*)sid, (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
      (const int*)order, (float*)dk, (float*)dv, hq / hk, tqp, tkp, scale, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/dout [hq, tqp, d] bf16; k/v [hk, tkp, d] bf16 (16-byte aligned, for
// TMA); lse/delta [hq, tqp] f32 (delta = sum_d dout*out - dlse; 16-byte
// aligned); the backward's int32 tables (qblk, sid [E2]; runs [7 E2]; bounds
// [5(S+1)]; rs, rc [nk] over its k blocks) and the launch order of the k
// blocks (a permutation of 0..nk-1); dk, dv [hk, tkp, d] f32.
int magi_flex_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* qblk,
                  const void* sid, const void* runs, const void* bounds,
                  const void* rs, const void* rc, const void* order, void* dk, void* dv, int hq,
                  int hk, int tqp, int tkp, int head_dim, int nk, int block_q,
                  int block_k, float scale, float softcap, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 ||
      tkp != nk * BK || tqp % BQ != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, order, dk,
                        dv, hq, hk, tqp, tkp, nk, scale, softcap, st);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, order, dk,
                         dv, hq, hk, tqp, tkp, nk, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

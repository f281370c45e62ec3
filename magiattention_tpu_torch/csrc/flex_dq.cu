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
// What bounds it on the card: 6 d FLOPs per unmasked (q, k) pair and q head
// (S, dP, dQ) against 4 bytes of K/V per key that a q block re-reads from
// L2, so on a long causal sequence it is bound by tensor-core operations:
// 6 pairs d hq FLOPs against 989 TFLOP/s bf16 dense on an H100 SXM.
//
// What the design does about it (flex_bwd_sm90.cuh): the three products run
// on wgmma, the only path to the card's full tensor-core rate (S and dP with
// both operands in swizzled shared memory; dQ with dS from registers and K
// read transposed). A producer warpgroup streams K and V by TMA through a
// four-stage ring, once per distinct k block of the walk, while the two
// consumer warpgroups compute, so loads overlap products and neither waits
// on memory once the ring is full. At G > 1 the two consumer warpgroups take
// two q heads of one kv head (NH = 2): their walks are identical, so each
// K/V tile is loaded once for the pair. At odd G they share one head and
// split its walk by k block, adding their two partials once at the end. No
// atomics: each block owns its dQ rows, so the result is the same bits on
// every run (the reference's deterministic mode).
//
// Grid: (q heads / NH, q blocks), the q blocks in the host's launch order
// (longest walk first, ops/flex_attn.py::walk_order), so the long walks of
// every head start first and the short ones fill the tail. A q block with
// no entry to walk still writes its (zero) rows.
//
// Float32 q/k/v/dout (in_f32) take the CUDA-core walk of flex_simt.cuh
// instead: one q head and q block per block, the same math in full f32.

#include "flex_bwd_sm90.cuh"
#include "flex_simt.cuh"

namespace {

using namespace flex;
using namespace flex::sm90;

template <int D, int NH>
__global__ void __launch_bounds__(WS_THREADS, 1)
flex_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ kblk, const int* __restrict__ sid,
               const int* __restrict__ runs, const int* __restrict__ bounds,
               const int* __restrict__ rs, const int* __restrict__ rc,
               const int* __restrict__ order, float* __restrict__ dq, int group, int tqp,
               int tkp, float scale, float softcap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int i = order[blockIdx.y];  // q block
  const int h0 = blockIdx.x * NH;   // first q head
  const int e_begin = rs[i], e_end = rs[i] + rc[i];
  if (threadIdx.x == 0)
    init_bars(Bars{base + DqLayout<D, NH, 1>::BARS}, NH * WG_THREADS / 32);
  __syncthreads();
  // the block's one item: n = 0, the ring from fill 0
  if (threadIdx.x >= CONSUMERS * WG_THREADS) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG_THREADS)
      dq_producer<D, NH, 1>(&tm_q, &tm_k, &tm_v, &tm_do, kblk, e_begin, e_end, h0, h0 / group,
                            i, tqp, tkp, base, 0, 0);
  } else {
    reg_alloc<CONSUMER_REGS>();
    dq_consumer<D, NH, 1>(threadIdx.x / WG_THREADS, smem, base, lse, delta, kblk, sid, runs,
                          bounds, e_begin, e_end, dq, h0, i, tqp, scale, softcap, 0, 0);
  }
}

template <int D, int NH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* kblk, const void* sid,
                   const void* runs, const void* bounds, const void* rs, const void* rc,
                   const void* order, void* dq, int hq, int hk, int tqp, int tkp, int nq,
                   float scale, float softcap, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = encode_tile_map(&tm_q, q, hq * tqp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_k, k, hk * tkp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_v, v, hk * tkp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_do, dout, hq * tqp, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = DqLayout<D, NH, 1>::ALLOC;
  auto kernel = flex_dq_kernel<D, NH>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(hq / NH, nq);
  kernel<<<grid, WS_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta, (const int*)kblk,
      (const int*)sid, (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
      (const int*)order, (float*)dq, hq / hk, tqp, tkp, scale, softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* kblk, const void* sid,
                     const void* runs, const void* bounds, const void* rs, const void* rc,
                     const void* order, void* dq, int hq, int hk, int tqp, int tkp, int nq,
                     float scale, float softcap, cudaStream_t stream) {
  // a head pair of one kv head per block where G is even, else one head
  if ((hq / hk) % 2 == 0)
    return launch<D, 2>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, order, dq,
                        hq, hk, tqp, tkp, nq, scale, softcap, stream);
  return launch<D, 1>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, order, dq, hq,
                      hk, tqp, tkp, nq, scale, softcap, stream);
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/dout [hq, tqp, d] bf16 (in_f32=0) or f32 (in_f32=1); k/v [hk, tkp, d]
// of q's type (16-byte aligned, for TMA); lse/delta [hq, tqp] f32 (delta = sum_d dout*out - dlse); the
// forward's int32 tables (kblk, sid [E]; runs [7E]; bounds [5(S+1)]; rs, rc
// [nq]) and the launch order of the q blocks (a permutation of 0..nq-1);
// dq [hq, tqp, d] f32.
int magi_flex_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* kblk,
                 const void* sid, const void* runs, const void* bounds,
                 const void* rs, const void* rc, const void* order, void* dq, int hq, int hk,
                 int tqp, int tkp, int head_dim, int nq, int block_q,
                 int block_k, float scale, float softcap, int in_f32, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 ||
      tqp != nq * BQ || tkp % BK != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32)
    return simt::bwd<true>(
        simt::BwdArgs{(const float*)q, (const float*)k, (const float*)v, (const float*)dout,
                      (const float*)lse, (const float*)delta, (const int*)kblk, (const int*)sid,
                      (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
                      (const int*)order, (float*)dq, nullptr, nullptr, hq / hk, tqp, tkp, scale,
                      softcap},
        hq, nq, head_dim, st);
  switch (head_dim) {
    case 32:
      return dispatch<32>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, order, dq,
                          hq, hk, tqp, tkp, nq, scale, softcap, st);
    case 64:
      return dispatch<64>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, order, dq,
                          hq, hk, tqp, tkp, nq, scale, softcap, st);
    case 80:
      return dispatch<80>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, order, dq,
                          hq, hk, tqp, tkp, nq, scale, softcap, st);
    case 96:
      return dispatch<96>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, order, dq,
                          hq, hk, tqp, tkp, nq, scale, softcap, st);
    case 128:
      return dispatch<128>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, order,
                           dq, hq, hk, tqp, tkp, nq, scale, softcap, st);
    case 256:
      return dispatch<256>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, order,
                           dq, hq, hk, tqp, tkp, nq, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

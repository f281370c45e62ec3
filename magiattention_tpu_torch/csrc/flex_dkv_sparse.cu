// flex_dkv_sparse: the flex-attention backward's dk and dv on the sparse
// grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::
// _dkv_pallas_sparse (kernel body _dkv_kernel_sparse): the compact
// (hk, E, group) grid over the k-major entry table, which computes exactly
// what the row-major _dkv_pallas computes. For each (kv head, k block) it
// walks that block's entries, and inside each entry the G q heads of the kv
// head in order; per (entry, head) it recomputes S^T = scale K Q^T
// (+ softcap) and dP^T = V dO^T, the entry's interval mask, P and
// dS = P (dP - delta_eff), and accumulates dV += P^T dO (P rounded to bf16)
// and dK += scale dS^T Q (dS rounded to bf16). Outputs: dk, dv [hk, tkp, d]
// f32, no atomics on data.
//
// What bounds it on the card: 8 d FLOPs per unmasked (q, k) pair and q head
// on the tensor cores (989 TFLOP/s bf16 dense on an H100 SXM), as flex_dkv.
//
// What the design does about it: flex_dkv's walk (flex_bwd_sm90.cuh — K and
// V resident, Q, dO, lse and delta_eff streamed per (entry, q head) by TMA
// and bulk copies through a four-stage ring, two consumer warpgroups on
// wgmma taking the steps in turn, each with its dK/dV partial in registers)
// in a persistent kernel: one block per SM takes (kv head, k block) items
// from the longest-walk-first work list over the k-major walks
// (ops/block_sparse.py::work_list) through an atomic counter. Most walks of
// a heterogeneous mask are short, so the fixed cost of an item matters: the
// barriers are set up once per block; two resident K/V buffers let the
// producer load the next item's K and V during the current walk, and it
// streams the next item's first stages as soon as the current walk frees
// them, while the consumers hand their partials over (through the current
// item's resident buffer, not the ring the producer is refilling) and store
// dk and dv. The partials start from zero at every item. Each item is
// computed whole by one block in flex_dkv's order: the same bits on every
// run, and flex_dkv's bits on the same tables.
//
// float32 q/k/v (in_f32 = 1) take flex_simt.cuh's CUDA-core walk instead:
// persistent blocks of 256 threads over the same work list, each item
// computed as the row-major float32 walk computes it, so the float32
// results equal its bits too.

#include "flex_bwd_sm90.cuh"
#include "flex_simt.cuh"

namespace {

using namespace flex;
using namespace flex::sm90;

constexpr int RES = 2;  // resident K/V buffers: the next item's load during this walk

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flex_dkv_sparse_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                       const float* __restrict__ delta, const int* __restrict__ qblk,
                       const int* __restrict__ sid, const int* __restrict__ runs,
                       const int* __restrict__ bounds, const int* __restrict__ rs,
                       const int* __restrict__ rc, const int* __restrict__ work,
                       int* __restrict__ counter, float* __restrict__ dk,
                       float* __restrict__ dv, int group, int tqp, int tkp, int nk, int n_items,
                       float scale, float softcap) {
  using L = DkvLayout<D, RES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const Bars bars{base + L::BARS};
  int* slots = reinterpret_cast<int*>(smem + L::BARS + BAR_BYTES);
  if (threadIdx.x == 0) init_bars(bars, DKV_STAGE_READERS<D>);
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * WG_THREADS) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS * WG_THREADS) return;
    int ring = 0;  // Q/dO fills issued so far
    // each item is claimed one item ahead, so that the counter's and the
    // tables' latency is spent while the current item's loads go out
    Item next = claim_item(counter, work, rs, rc, n_items, nk, 1);
    for (int n = 0;; ++n) {
      const Item it = next;
      publish_item(bars, slots, n, it);
      if (it.idx >= n_items) return;
      next = claim_item(counter, work, rs, rc, n_items, nk, 1);
      ring = dkv_producer<D, RES>(&tm_q, &tm_k, &tm_v, &tm_do, lse, delta, qblk, it.e_begin,
                                  it.e_end, group, it.head, it.i, tqp, tkp, base, n, ring);
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG_THREADS;
    float dka[DKV_J<D>][4], dva[DKV_J<D>][4];
    int ring = 0;
    for (int n = 0;; ++n) {
      const Item it = take_item(bars, slots, n);
      if (it.idx >= n_items) return;
      zero(dka);
      zero(dva);
      ring = dkv_item<D, RES>(wg, smem, base, qblk, sid, runs, bounds, it.e_begin, it.e_end,
                              dk, dv, group, it.head, it.i, tkp, scale, softcap, n, ring, dka,
                              dva);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qblk, const void* sid,
                   const void* runs, const void* bounds, const void* rs, const void* rc,
                   const void* work, void* counter, void* dk, void* dv, int hq, int hk,
                   int tqp, int tkp, int nk, int n_items, float scale, float softcap,
                   cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(lse) % 16 != 0 || reinterpret_cast<uintptr_t>(delta) % 16 != 0)
    return cudaErrorMisalignedAddress;  // the 1-D bulk copies of lse and delta
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = encode_tile_map(&tm_q, q, hq * tqp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_k, k, hk * tkp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_v, v, hk * tkp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_do, dout, hq * tqp, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = DkvLayout<D, RES>::ALLOC;
  auto kernel = flex_dkv_sparse_kernel<D>;
  int grid = 0;
  err = persistent_launch_dims(kernel, WS_THREADS, smem, n_items, (int*)counter, stream, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WS_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta, (const int*)qblk,
      (const int*)sid, (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
      (const int*)work, (int*)counter, (float*)dk, (float*)dv, hq / hk, tqp, tkp, nk, n_items,
      scale, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// As magi_flex_dkv (q/k/v/dout bf16, or float32 with in_f32 = 1), plus work [n_items] int32 (kv head * nk + k block, one
// item per (kv head, k block), longest k-major walk first) and counter [1]
// int32 scratch.
int magi_flex_dkv_sparse(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* qblk,
                         const void* sid, const void* runs, const void* bounds,
                         const void* rs, const void* rc, const void* work, void* counter,
                         void* dk, void* dv, int hq, int hk, int tqp, int tkp,
                         int head_dim, int nk, int block_q, int block_k, int n_items,
                         float scale, float softcap, int in_f32, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 ||
      tkp != nk * BK || tqp % BQ != 0 || n_items != hk * nk)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32)  // the CUDA-core walk (flex_simt.cuh): flex_dkv's float32 bits
    return simt::bwd_sparse<false>(
        simt::BwdArgs{(const float*)q, (const float*)k, (const float*)v, (const float*)dout,
                      (const float*)lse, (const float*)delta, (const int*)qblk, (const int*)sid,
                      (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
                      nullptr, nullptr, (float*)dk, (float*)dv, hq / hk, tqp, tkp, scale,
                      softcap},
        work, counter, nk, n_items, 1, head_dim, st);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, work,
                        counter, dk, dv, hq, hk, tqp, tkp, nk, n_items, scale, softcap, st);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, work,
                        counter, dk, dv, hq, hk, tqp, tkp, nk, n_items, scale, softcap, st);
    case 80:
      return launch<80>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, work,
                        counter, dk, dv, hq, hk, tqp, tkp, nk, n_items, scale, softcap, st);
    case 96:
      return launch<96>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, work,
                        counter, dk, dv, hq, hk, tqp, tkp, nk, n_items, scale, softcap, st);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, work,
                         counter, dk, dv, hq, hk, tqp, tkp, nk, n_items, scale, softcap,
                         st);
    case 256:
      return launch<256>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, work,
                         counter, dk, dv, hq, hk, tqp, tkp, nk, n_items, scale, softcap,
                         st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

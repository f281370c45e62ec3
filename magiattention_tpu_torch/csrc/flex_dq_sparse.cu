// flex_dq_sparse: the flex-attention backward's dq on the sparse grid, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::
// _dq_pallas_sparse (kernel body _dq_kernel_sparse): the compact (hq, E)
// grid's dq, which computes exactly what the row-major _dq_pallas computes
// (the backward has no online rescale, so no AMLA: the stored lse is the
// reference). For each (q head, q block) it walks that block's entries and
// recomputes S = scale Q K^T (+ softcap), the entry's interval mask,
// P = exp(S - lse), dP = dO V^T and dS = P (dP - delta_eff) (times
// 1 - (S/cap)^2 under a softcap), and accumulates dQ += scale dS K with dS
// rounded to bf16 before the product. Output: dq [hq, tqp, d] f32.
//
// What bounds it on the card: 6 d FLOPs per unmasked (q, k) pair and q head
// on the tensor cores (989 TFLOP/s bf16 dense on an H100 SXM), as flex_dq;
// each K/V tile is read once per q block and head pair.
//
// What the design does about it: flex_dq's walk (flex_bwd_sm90.cuh — a
// producer warp streaming K and V by TMA through a four-stage ring, two
// consumer warpgroups on wgmma) in a persistent kernel: one block per SM
// takes (head pair, q block) items (one q head at odd G) from the
// longest-walk-first work list (ops/block_sparse.py::work_list) through an
// atomic counter, so the long walks of a heterogeneous mask start in the
// first wave and the short ones fill the tail. On such a mask most walks
// are a few tiles long, so what an item costs besides its tiles counts: the
// barriers are set up once per block, not per item, and the producer takes
// the next item and issues its Q and dO and its K/V stages while the
// consumers finish the current walk and store its dq (the pipeline of
// flex_bwd_sm90.cuh's top: two item slots in shared memory, the resident
// buffers' barrier phases and the ring's fill count running on across
// items). At even G an item is two q heads of one kv head, one per
// consumer warpgroup, so each K/V tile is loaded once for the pair; at odd G
// the two warpgroups split one head's walk by k block, as flex_dq does, and
// hand their partials over through the item's second resident buffer. Each
// item is computed whole by one block in flex_dq's order, with no atomics:
// the same bits on every run, and flex_dq's bits on the same tables.
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

// Resident Q/dO buffers: one at a head pair (64 KB at d = 128 beside the
// 128 KB ring), two at one head; one at d = 256, where a head's split walk
// needs its two ring stages (flex_bwd_sm90.cuh's DqLayout).
template <int D, int NH>
constexpr int RESIDENT_BUFFERS = NH == 2 || D > 128 ? 1 : 2;

template <int D, int NH>
__global__ void __launch_bounds__(WS_THREADS, 1)
flex_dq_sparse_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int* __restrict__ kblk,
                      const int* __restrict__ sid, const int* __restrict__ runs,
                      const int* __restrict__ bounds, const int* __restrict__ rs,
                      const int* __restrict__ rc, const int* __restrict__ work,
                      int* __restrict__ counter, float* __restrict__ dq, int group, int tqp,
                      int tkp, int nq, int n_items, float scale, float softcap) {
  constexpr int RES = RESIDENT_BUFFERS<D, NH>;
  using L = DqLayout<D, NH, RES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const Bars bars{base + L::BARS};
  int* slots = reinterpret_cast<int*>(smem + L::BARS + BAR_BYTES);
  if (threadIdx.x == 0) init_bars(bars, NH * WG_THREADS / 32);
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * WG_THREADS) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS * WG_THREADS) return;
    int ring = 0;  // K/V fills issued so far
    // each item is claimed one item ahead, so that the counter's and the
    // tables' latency is spent while the current item's loads go out
    Item next = claim_item(counter, work, rs, rc, n_items, nq, NH);
    for (int n = 0;; ++n) {
      const Item it = next;
      publish_item(bars, slots, n, it);
      if (it.idx >= n_items) return;
      next = claim_item(counter, work, rs, rc, n_items, nq, NH);
      ring = dq_producer<D, NH, RES>(&tm_q, &tm_k, &tm_v, &tm_do, kblk, it.e_begin, it.e_end,
                                     it.head, it.head / group, it.i, tqp, tkp, base, n, ring);
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG_THREADS;
    int ring = 0;
    for (int n = 0;; ++n) {
      const Item it = take_item(bars, slots, n);
      if (it.idx >= n_items) return;
      ring = dq_consumer<D, NH, RES>(wg, smem, base, lse, delta, kblk, sid, runs, bounds,
                                     it.e_begin, it.e_end, dq, it.head, it.i, tqp, scale,
                                     softcap, n, ring);
    }
  }
}

template <int D, int NH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* kblk, const void* sid,
                   const void* runs, const void* bounds, const void* rs, const void* rc,
                   const void* work, void* counter, void* dq, int hq, int hk, int tqp, int tkp,
                   int nq, int n_items, float scale, float softcap, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = encode_tile_map(&tm_q, q, hq * tqp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_k, k, hk * tkp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_v, v, hk * tkp, D);
  if (err == cudaSuccess) err = encode_tile_map(&tm_do, dout, hq * tqp, D);
  if (err != cudaSuccess) return err;
  constexpr int smem = DqLayout<D, NH, RESIDENT_BUFFERS<D, NH>>::ALLOC;
  auto kernel = flex_dq_sparse_kernel<D, NH>;
  int grid = 0;
  err = persistent_launch_dims(kernel, WS_THREADS, smem, n_items, (int*)counter, stream, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, WS_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, (const float*)lse, (const float*)delta, (const int*)kblk,
      (const int*)sid, (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
      (const int*)work, (int*)counter, (float*)dq, hq / hk, tqp, tkp, nq, n_items, scale,
      softcap);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* kblk, const void* sid,
                     const void* runs, const void* bounds, const void* rs, const void* rc,
                     const void* work, void* counter, void* dq, int hq, int hk, int tqp,
                     int tkp, int nq, int n_items, float scale, float softcap,
                     cudaStream_t stream) {
  if ((hq / hk) % 2 == 0)
    return launch<D, 2>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, work,
                        counter, dq, hq, hk, tqp, tkp, nq, n_items, scale, softcap, stream);
  return launch<D, 1>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, work, counter,
                      dq, hq, hk, tqp, tkp, nq, n_items, scale, softcap, stream);
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// As magi_flex_dq (q/k/v/dout bf16, or float32 with in_f32 = 1), plus
// work [n_items] int32 and counter [1] int32 scratch.
// An item is (head pair of one kv head, q block) where G = hq / hk is even,
// else (q head, q block), encoded as pair (or head) * nq + q block, longest
// walk first (ops/flex_attn.py::sparse_work); n_items = hq / 2 * nq or
// hq * nq.
int magi_flex_dq_sparse(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* kblk,
                        const void* sid, const void* runs, const void* bounds,
                        const void* rs, const void* rc, const void* work, void* counter,
                        void* dq, int hq, int hk, int tqp, int tkp, int head_dim, int nq,
                        int block_q, int block_k, int n_items, float scale,
                        float softcap, int in_f32, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 || tqp != nq * BQ ||
      tkp % BK != 0)
    return cudaErrorInvalidValue;
  const int heads_per_item = (hq / hk) % 2 == 0 ? 2 : 1;
  if (n_items != hq / heads_per_item * nq) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32)  // the CUDA-core walk (flex_simt.cuh): flex_dq's float32 bits
    return simt::bwd_sparse<true>(
        simt::BwdArgs{(const float*)q, (const float*)k, (const float*)v, (const float*)dout,
                      (const float*)lse, (const float*)delta, (const int*)kblk, (const int*)sid,
                      (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
                      nullptr, (float*)dq, nullptr, nullptr, hq / hk, tqp, tkp, scale, softcap},
        work, counter, nq, n_items, heads_per_item, head_dim, st);
  switch (head_dim) {
    case 32:
      return dispatch<32>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, work,
                          counter, dq, hq, hk, tqp, tkp, nq, n_items, scale, softcap, st);
    case 64:
      return dispatch<64>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, work,
                          counter, dq, hq, hk, tqp, tkp, nq, n_items, scale, softcap, st);
    case 80:
      return dispatch<80>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, work,
                          counter, dq, hq, hk, tqp, tkp, nq, n_items, scale, softcap, st);
    case 96:
      return dispatch<96>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, work,
                          counter, dq, hq, hk, tqp, tkp, nq, n_items, scale, softcap, st);
    case 128:
      return dispatch<128>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, work,
                           counter, dq, hq, hk, tqp, tkp, nq, n_items, scale, softcap, st);
    case 256:
      return dispatch<256>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, work,
                           counter, dq, hq, hk, tqp, tkp, nq, n_items, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

// flex_fwd_sparse: the sparse-grid flex-attention forward, one q head per
// work item, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::
// _fwd_pallas_sparse (kernel body _fwd_kernel_sparse): the compact (hq, E)
// grid's forward with the AMLA softmax (an integer base-2 reference, the
// rescale an exponent add; flex_fwd_sparse.cuh's previous walk and the
// plain ops/flex_attn.py::_fwd_torch_sparse compute the same). The wrapper
// launches it where the JAX package launches _fwd_pallas_sparse:
// grid="sparse" with head_block=1.
//
// What bounds it on the card: ~4 d FLOPs per unmasked (q, k) pair and q
// head on the tensor cores (989 TFLOP/s bf16 dense on an H100 SXM), with
// each K/V tile re-read from L2 once per q block and head. On a
// heterogeneous mask most walks are a few tiles long, so what an item costs
// besides its tiles (Q loads, barrier set-up, the epilogue) counts too.
//
// What the design does about it: flex_fwd_sm90.cuh's walk (TMA ring,
// producer and entry warps, two wgmma consumer warpgroups) in its AMLA mode,
// in persistent blocks, one per SM, over the longest-walk-first work list
// (ops/flex_attn.py::sparse_work): the barriers are set up once per block,
// and the next item's Q and first K/V stages load while the consumers
// finish the current walk and store it. An item is one q head, whose walk
// one consumer warpgroup computes whole: each warpgroup has a stream of its
// own (half the ring and entry slots, its own producer thread and entry
// warp) and takes items of its own, so two of the mask's many short walks
// run at once, with no split and no merge of partials. Each item is
// computed whole by one warpgroup, without atomics on data: the same bits
// on every run.

#include "flex_fwd_sm90.cuh"

namespace {

using namespace flex;
using namespace flex::sm90;

template <int D, typename OutT>
__global__ void __launch_bounds__(WS_THREADS, 1)
flex_fwd_sparse_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ FwdArgs<OutT> args, const int* __restrict__ work,
                       int* __restrict__ counter, int nq, int n_items, int heads_per_item) {
  extern __shared__ unsigned char smem_raw[];
  fwd_persistent<D, 1>(smem_raw, &tm_q, &tm_k, &tm_v, args, work, counter, nq, n_items,
                       heads_per_item);
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [hq, tqp, d] bf16; k/v [hk, tkp, d] bf16 (16-byte aligned, for TMA);
// sink [hq] f32; the forward's int32 tables (kblk, sid [E]; runs [7E];
// bounds [5(S+1)]; rs, rc [nq]); work [n_items] int32 (q head * nq + q
// block, longest walk first); counter [1] int32 scratch; out [hq, tqp, d]
// bf16 (out_f32=0) or f32; lse, rowmax [hq, tqp] f32. heads_per_item must
// be 1.
int magi_flex_fwd_sparse(const void* q, const void* k, const void* v, const void* sink,
                         const void* kblk, const void* sid, const void* runs,
                         const void* bounds, const void* rs, const void* rc,
                         const void* work, void* counter, void* out, void* lse,
                         void* rowmax, int hq, int hk, int tqp, int tkp, int head_dim,
                         int nq, int block_q, int block_k, int n_items,
                         int heads_per_item, float scale, float softcap, int has_sink,
                         int out_f32, void* stream) {
  if (heads_per_item != 1 ||
      !fwd_sparse_args_ok(hq, hk, tqp, tkp, nq, block_q, block_k, n_items, heads_per_item, 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MAGI_FWD_SPARSE_LAUNCH(D, T)                                                          \
  return launch_fwd_persistent<D, 1>(                                                       \
      flex_fwd_sparse_kernel<D, T>, q, k, v,                                                \
      fwd_args<T>(sink, kblk, sid, runs, bounds, rs, rc, nullptr, out, lse, rowmax, hq / hk, \
                  tqp, tkp, scale, softcap, has_sink),                                      \
      hq, hk, work, counter, nq, n_items, heads_per_item, st)
  switch (head_dim) {
    case 64:
      if (out_f32) MAGI_FWD_SPARSE_LAUNCH(64, float);
      MAGI_FWD_SPARSE_LAUNCH(64, bf16);
    case 128:
      if (out_f32) MAGI_FWD_SPARSE_LAUNCH(128, float);
      MAGI_FWD_SPARSE_LAUNCH(128, bf16);
    default:
      return cudaErrorInvalidValue;
  }
#undef MAGI_FWD_SPARSE_LAUNCH
}

}  // extern "C"

// flex_fwd_sparse: the sparse-grid flex-attention forward, one q head per
// work item, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::
// _fwd_pallas_sparse (kernel body _fwd_kernel_sparse): the persistent
// entry walk with the AMLA softmax of flex_fwd_sparse.cuh, one block of 4
// warps per (q head, q block) item of the longest-walk-first work list.
// The wrapper launches it where the JAX package launches _fwd_pallas_sparse:
// grid="sparse" with head_block=1.

#include "flex_fwd_sparse.cuh"

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [hq, tqp, d] bf16; k/v [hk, tkp, d] bf16; sink [hq] f32; the forward's
// int32 tables (kblk, sid [E]; runs [7E]; bounds [5(S+1)]; rs, rc [nq]);
// work [n_items] int32 (q head * nq + q block, longest walk first);
// counter [1] int32 scratch; out [hq, tqp, d] bf16 (out_f32=0) or f32;
// lse, rowmax [hq, tqp] f32. heads_per_item must be 1.
int magi_flex_fwd_sparse(const void* q, const void* k, const void* v, const void* sink,
                         const void* kblk, const void* sid, const void* runs,
                         const void* bounds, const void* rs, const void* rc,
                         const void* work, void* counter, void* out, void* lse,
                         void* rowmax, int hq, int hk, int tqp, int tkp, int head_dim,
                         int nq, int block_q, int block_k, int n_items,
                         int heads_per_item, float scale, float softcap, int has_sink,
                         int out_f32, void* stream) {
  if (heads_per_item != 1) return cudaErrorInvalidValue;
  return flex::dispatch_fwd_sparse<1>(
      q, k, v, sink, kblk, sid, runs, bounds, rs, rc, work, counter, out, lse, rowmax,
      hq, hk, tqp, tkp, head_dim, nq, block_q, block_k, n_items, heads_per_item, scale,
      softcap, has_sink, out_f32, stream);
}

}  // extern "C"

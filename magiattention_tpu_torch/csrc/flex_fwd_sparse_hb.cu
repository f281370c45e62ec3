// flex_fwd_sparse_hb: the head-batched sparse-grid flex-attention forward,
// head_block q heads per work item, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::
// _fwd_pallas_hb_sparse (kernel body _fwd_kernel_hb_sparse): the entry walk
// with the AMLA softmax of flex_fwd_sparse.cuh over (group of head_block q
// heads, q block) items, head_block a multiple of the GQA group G. On the
// TPU the HB kv heads' G q heads stack their rows into one (G bq, d) block
// so that one K/V block and one mask serve them all. Here the G q heads of
// a kv head pack into the M dimension of one thread block two at a time
// (8 warps, 128 rows, when G is even; 4 warps one head at a time when G is
// odd): each K/V tile is loaded from memory once for the pair, and the
// block walks the item's kv heads and head pairs in turn. Two, not G:
// a warp holds a 16 x d f32 accumulator (64 registers a thread at
// d=128) and the whole walk needs ~220 registers, so 8 warps (256 threads)
// is what one SM's 64 K registers hold.

#include "flex_fwd_sparse.cuh"

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// As magi_flex_fwd_sparse, with work items (q head group * nq + q block)
// of heads_per_item = head_block q heads each.
int magi_flex_fwd_sparse_hb(const void* q, const void* k, const void* v,
                            const void* sink, const void* kblk, const void* sid,
                            const void* runs, const void* bounds, const void* rs,
                            const void* rc, const void* work, void* counter, void* out,
                            void* lse, void* rowmax, int hq, int hk, int tqp, int tkp,
                            int head_dim, int nq, int block_q, int block_k, int n_items,
                            int heads_per_item, float scale, float softcap, int has_sink,
                            int out_f32, void* stream) {
  if (hk <= 0 || hq % hk != 0 || heads_per_item % (hq / hk) != 0)
    return cudaErrorInvalidValue;
  const bool pairs = (hq / hk) % 2 == 0;
  return pairs ? flex::dispatch_fwd_sparse<2>(
                     q, k, v, sink, kblk, sid, runs, bounds, rs, rc, work, counter, out,
                     lse, rowmax, hq, hk, tqp, tkp, head_dim, nq, block_q, block_k,
                     n_items, heads_per_item, scale, softcap, has_sink, out_f32, stream)
               : flex::dispatch_fwd_sparse<1>(
                     q, k, v, sink, kblk, sid, runs, bounds, rs, rc, work, counter, out,
                     lse, rowmax, hq, hk, tqp, tkp, head_dim, nq, block_q, block_k,
                     n_items, heads_per_item, scale, softcap, has_sink, out_f32, stream);
}

}  // extern "C"

// flex_fwd_hb: the head-batched row-major flex-attention forward, head_block
// q heads per thread block, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::_fwd_pallas_hb
// (kernel body _fwd_kernel_hb): the row-major entry walk of flex_fwd with
// the natural-exp online softmax and the sink folded in the epilogue, over
// (group of head_block q heads, q block) work items, head_block a multiple
// of the GQA group G. On the TPU the HB kv heads' G q heads stack their rows
// into one (G bq, d) block, so that one K/V block and one mask serve them
// all. Here a block takes the item's q heads in steps of a head pair of one
// kv head (one head where G is odd), the two consumer warpgroups one head
// each, each K/V tile loaded once for the pair; the producer streams the
// next step's Q and K/V tiles while the current step finishes. The walk is
// flex_fwd_sm90.cuh's, shared with flex_fwd, so a row's bits do not depend
// on the kernel; its bound and design are described there.
//
// Grid: (head groups, q blocks), the q blocks in the host's launch order
// (longest walk first, ops/flex_attn.py::walk_order), so on a causal mask
// the longest walks (the last q blocks) of every head group start first and
// the short ones fill the tail.

#include "flex_fwd_sm90.cuh"

namespace {

using namespace flex;
using namespace flex::sm90;

template <int D, int NH, typename OutT>
__global__ void __launch_bounds__(WS_THREADS, 1)
flex_fwd_hb_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ FwdArgs<OutT> args,
                   int head_block) {
  extern __shared__ unsigned char smem_raw[];
  fwd_block<D, NH>(smem_raw, &tm_q, &tm_k, &tm_v, args, head_block);
}

template <int D, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const FwdArgs<OutT>& args, int hq,
                   int hk, int nq, int head_block, cudaStream_t st) {
  // steps of a head pair of one kv head where G is even, else of one head
  if ((hq / hk) % 2 == 0)
    return launch_fwd<D, 2>(flex_fwd_hb_kernel<D, 2, OutT>, q, k, v, args, hq, hk, nq,
                            head_block, st);
  return launch_fwd<D, 1>(flex_fwd_hb_kernel<D, 1, OutT>, q, k, v, args, hq, hk, nq, head_block,
                          st);
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// As magi_flex_fwd, with head_block q heads (a multiple of the GQA group
// that divides hq) per thread block.
int magi_flex_fwd_hb(const void* q, const void* k, const void* v, const void* sink,
                     const void* kblk, const void* sid, const void* runs, const void* bounds,
                     const void* rs, const void* rc, const void* order, void* out, void* lse,
                     void* rowmax, int hq, int hk, int tqp, int tkp, int head_dim, int nq,
                     int block_q, int block_k, int head_block, float scale, float softcap,
                     int has_sink, int out_f32, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 || tqp != nq * BQ ||
      tkp % BK != 0 || head_block <= 0 || head_block % (hq / hk) != 0 ||
      hq % head_block != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MAGI_FLEX_HB_LAUNCH(D)                                                                  \
  return out_f32 ? launch<D>(q, k, v,                                                           \
                             fwd_args<float>(sink, kblk, sid, runs, bounds, rs, rc, order, out, \
                                             lse, rowmax, hq / hk, tqp, tkp, scale, softcap,    \
                                             has_sink),                                         \
                             hq, hk, nq, head_block, st)                                        \
                 : launch<D>(q, k, v,                                                           \
                             fwd_args<bf16>(sink, kblk, sid, runs, bounds, rs, rc, order, out,  \
                                            lse, rowmax, hq / hk, tqp, tkp, scale, softcap,     \
                                            has_sink),                                          \
                             hq, hk, nq, head_block, st)
  switch (head_dim) {
    case 64: MAGI_FLEX_HB_LAUNCH(64);
    case 128: MAGI_FLEX_HB_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef MAGI_FLEX_HB_LAUNCH
}

}  // extern "C"

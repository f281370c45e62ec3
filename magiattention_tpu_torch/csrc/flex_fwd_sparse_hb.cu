// flex_fwd_sparse_hb: the head-batched sparse-grid flex-attention forward,
// head_block q heads per work item, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::
// _fwd_pallas_hb_sparse (kernel body _fwd_kernel_hb_sparse): the AMLA
// entry walk of flex_fwd_sparse over (group of head_block q heads, q block)
// items, head_block a multiple of the GQA group G. On the TPU the HB kv
// heads' G q heads stack their rows into one (G bq, d) block, so that one
// K/V block and one mask serve them all.
//
// What bounds it on the card is flex_fwd_sparse's (tensor-core operations,
// ~4 d FLOPs per unmasked pair and q head, plus each item's fixed cost on
// a mask of short walks). What the design does about it: the same
// persistent walk of flex_fwd_sm90.cuh in its AMLA mode; a block takes an
// item's q heads in steps of a head pair of one kv head where G is even (one
// head per consumer warpgroup, both reading each K/V stage, so each K/V
// tile is loaded once for the pair); where G is odd each consumer
// warpgroup takes items of its own, one head at a time, on a stream of its
// own (as flex_fwd_sparse). The producer streams the next step's (and the
// next item's) Q and K/V tiles while the current step finishes.
//
// float32 q/k/v (in_f32 = 1) take flex_simt.cuh's CUDA-core walk instead:
// persistent blocks of 256 threads over the same work list, each item's
// heads one after another in the AMLA softmax (fwd_item's AMLA mode).

#include "flex_fwd_sm90.cuh"
#include "flex_simt.cuh"

namespace {

using namespace flex;
using namespace flex::sm90;

template <int D, int NH, typename OutT>
__global__ void __launch_bounds__(WS_THREADS, 1)
flex_fwd_sparse_hb_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ FwdArgs<OutT> args,
                          const int* __restrict__ work, int* __restrict__ counter, int nq,
                          int n_items, int heads_per_item) {
  extern __shared__ unsigned char smem_raw[];
  fwd_persistent<D, NH>(smem_raw, &tm_q, &tm_k, &tm_v, args, work, counter, nq, n_items,
                        heads_per_item);
}

template <int D, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const FwdArgs<OutT>& args,
                   int hq, int hk, const void* work, void* counter, int nq, int n_items,
                   int heads_per_item, cudaStream_t st) {
  // steps of a head pair of one kv head where G is even, else of one head
  if ((hq / hk) % 2 == 0)
    return launch_fwd_persistent<D, 2>(flex_fwd_sparse_hb_kernel<D, 2, OutT>, q, k, v, args, hq,
                                       hk, work, counter, nq, n_items, heads_per_item, st);
  return launch_fwd_persistent<D, 1>(flex_fwd_sparse_hb_kernel<D, 1, OutT>, q, k, v, args, hq,
                                     hk, work, counter, nq, n_items, heads_per_item, st);
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// As magi_flex_fwd_sparse, with work items (q head group * nq + q block)
// of heads_per_item = head_block q heads each, a multiple of the GQA group
// that divides hq.
int magi_flex_fwd_sparse_hb(const void* q, const void* k, const void* v,
                            const void* sink, const void* kblk, const void* sid,
                            const void* runs, const void* bounds, const void* rs,
                            const void* rc, const void* work, void* counter, void* out,
                            void* lse, void* rowmax, int hq, int hk, int tqp, int tkp,
                            int head_dim, int nq, int block_q, int block_k, int n_items,
                            int heads_per_item, float scale, float softcap, int has_sink,
                            int out_f32, int in_f32, void* stream) {
  if (hk <= 0 || hq % hk != 0) return cudaErrorInvalidValue;
  const int nh = (hq / hk) % 2 == 0 ? 2 : 1;
  if (heads_per_item % (hq / hk) != 0 ||
      !fwd_sparse_args_ok(hq, hk, tqp, tkp, nq, block_q, block_k, n_items, heads_per_item, nh))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32)  // the CUDA-core walk (flex_simt.cuh), float32 q/k/v and out
    return out_f32 ? simt::fwd_sparse(
                         simt::FwdArgs{(const float*)q, (const float*)k, (const float*)v,
                                       (const float*)sink, (const int*)kblk, (const int*)sid,
                                       (const int*)runs, (const int*)bounds, (const int*)rs,
                                       (const int*)rc, nullptr, (float*)out, (float*)lse,
                                       (float*)rowmax, hq / hk, tqp, tkp, scale, softcap,
                                       has_sink},
                         work, counter, nq, n_items, heads_per_item, head_dim, st)
                   : cudaErrorInvalidValue;
#define MAGI_FWD_SPARSE_HB_LAUNCH(D, T)                                                        \
  return launch<D>(q, k, v,                                                                  \
                   fwd_args<T>(sink, kblk, sid, runs, bounds, rs, rc, nullptr, out, lse,      \
                               rowmax, hq / hk, tqp, tkp, scale, softcap, has_sink),         \
                   hq, hk, work, counter, nq, n_items, heads_per_item, st)
  switch (head_dim) {
    case 32:
      if (out_f32) MAGI_FWD_SPARSE_HB_LAUNCH(32, float);
      MAGI_FWD_SPARSE_HB_LAUNCH(32, bf16);
    case 64:
      if (out_f32) MAGI_FWD_SPARSE_HB_LAUNCH(64, float);
      MAGI_FWD_SPARSE_HB_LAUNCH(64, bf16);
    case 80:
      if (out_f32) MAGI_FWD_SPARSE_HB_LAUNCH(80, float);
      MAGI_FWD_SPARSE_HB_LAUNCH(80, bf16);
    case 96:
      if (out_f32) MAGI_FWD_SPARSE_HB_LAUNCH(96, float);
      MAGI_FWD_SPARSE_HB_LAUNCH(96, bf16);
    case 128:
      if (out_f32) MAGI_FWD_SPARSE_HB_LAUNCH(128, float);
      MAGI_FWD_SPARSE_HB_LAUNCH(128, bf16);
    case 256:
      if (out_f32) MAGI_FWD_SPARSE_HB_LAUNCH(256, float);
      MAGI_FWD_SPARSE_HB_LAUNCH(256, bf16);
    default:
      return cudaErrorInvalidValue;
  }
#undef MAGI_FWD_SPARSE_HB_LAUNCH
}

}  // extern "C"

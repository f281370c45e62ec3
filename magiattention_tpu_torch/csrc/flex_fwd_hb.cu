// flex_fwd_hb: the head-batched row-major flex-attention forward, head_block
// q heads per thread block, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::_fwd_pallas_hb
// (kernel body _fwd_kernel_hb): the row-major entry walk of flex_fwd with
// the natural-exp online softmax and the sink folded in the epilogue, over
// (group of head_block q heads, q block) work items, head_block a multiple
// of the GQA group G. On the TPU the HB kv heads' G q heads stack their rows
// into one (G bq, d) block, so that one K/V block and one mask serve them
// all. Here the G q heads of a kv head pack into the M dimension of one
// thread block two at a time (8 warps, 128 rows, when G is even; 4 warps,
// one head at a time, when G is odd): each K/V tile is loaded once for the
// pair, and the block walks the item's kv heads, and their head pairs, in
// turn. Two, not G: a warp holds a 16 x d f32 accumulator (64 registers a
// thread at d=128) and the walk needs ~220 registers a thread, so 8 warps
// (256 threads) is what one SM's 64 K registers hold. The walk itself is
// flex_fwd.cuh's fwd_rows, shared with flex_fwd, so a row's bits do not
// depend on the kernel.
//
// What bounds it: as flex_fwd, tensor-core operations (~4 d FLOPs per
// unmasked pair and q head; 989 TFLOP/s bf16 dense on an H100 SXM), with
// K/V re-read from L2 once per head pair instead of once per head.
//
// Grid: (head groups, q blocks), q blocks in reverse order: blocks are
// dispatched in linear order, so on a causal mask the longest walks (the
// last q blocks) of every head group start first and the short ones fill
// the tail.

#include "flex_fwd.cuh"

namespace {

using namespace flex;

template <int D, int NH, typename OutT>
__global__ void __launch_bounds__(NH * NTHREADS)
flex_fwd_hb_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ sink,
                   const int* __restrict__ kblk, const int* __restrict__ sid,
                   const int* __restrict__ runs, const int* __restrict__ bounds,
                   const int* __restrict__ rs, const int* __restrict__ rc,
                   OutT* __restrict__ out, float* __restrict__ lse,
                   float* __restrict__ rowmax, int group, int tqp, int tkp, int nq,
                   int head_block, float scale, float softcap, int has_sink) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h_item = blockIdx.x * head_block;  // the item's first q head
  const int i = nq - 1 - blockIdx.y;           // q block, last first
  for (int c = 0; c < head_block; c += NH) {
    // NH divides the GQA group: the NH heads of a step share one kv head
    const int kvh = (h_item + c) / group;
    if (c > 0) __syncthreads();  // every warp is done with the last step's tiles
    fwd_rows<D, NH, OutT>(q, k, v, sink, kblk, sid, runs, bounds, rs, rc, out, lse, rowmax,
                          h_item + c, kvh, i, tqp, tkp, scale, softcap, has_sink, smem_raw);
  }
}

template <int D, int NH, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* sink,
                   const void* kblk, const void* sid, const void* runs,
                   const void* bounds, const void* rs, const void* rc, void* out,
                   void* lse, void* rowmax, int hq, int hk, int tqp, int tkp, int nq,
                   int head_block, float scale, float softcap, int has_sink,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D, NH>();
  auto kernel = flex_fwd_hb_kernel<D, NH, OutT>;
  // above 48 KB of dynamic shared memory a kernel has to opt in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(hq / head_block, nq);
  kernel<<<grid, NH * NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)sink,
      (const int*)kblk, (const int*)sid, (const int*)runs, (const int*)bounds,
      (const int*)rs, (const int*)rc, (OutT*)out, (float*)lse, (float*)rowmax,
      hq / hk, tqp, tkp, nq, head_block, scale, softcap, has_sink);
  return cudaGetLastError();
}

template <int NH>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* sink,
                     const void* kblk, const void* sid, const void* runs,
                     const void* bounds, const void* rs, const void* rc, void* out,
                     void* lse, void* rowmax, int hq, int hk, int tqp, int tkp,
                     int head_dim, int nq, int head_block, float scale, float softcap,
                     int has_sink, int out_f32, cudaStream_t st) {
#define MAGI_FLEX_HB_LAUNCH(DIM)                                                  \
  return out_f32 ? launch<DIM, NH, float>(q, k, v, sink, kblk, sid, runs, bounds,  \
                                          rs, rc, out, lse, rowmax, hq, hk, tqp,   \
                                          tkp, nq, head_block, scale, softcap,     \
                                          has_sink, st)                            \
                 : launch<DIM, NH, bf16>(q, k, v, sink, kblk, sid, runs, bounds,   \
                                         rs, rc, out, lse, rowmax, hq, hk, tqp,    \
                                         tkp, nq, head_block, scale, softcap,      \
                                         has_sink, st)
  switch (head_dim) {
    case 64: MAGI_FLEX_HB_LAUNCH(64);
    case 128: MAGI_FLEX_HB_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef MAGI_FLEX_HB_LAUNCH
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// As magi_flex_fwd, with head_block q heads (a multiple of the GQA group
// that divides hq) per thread block.
int magi_flex_fwd_hb(const void* q, const void* k, const void* v, const void* sink,
                     const void* kblk, const void* sid, const void* runs,
                     const void* bounds, const void* rs, const void* rc, void* out,
                     void* lse, void* rowmax, int hq, int hk, int tqp, int tkp,
                     int head_dim, int nq, int block_q, int block_k, int head_block,
                     float scale, float softcap, int has_sink, int out_f32, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 || tqp != nq * BQ ||
      tkp % BK != 0 || head_block <= 0 || head_block % (hq / hk) != 0 ||
      hq % head_block != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pairs = (hq / hk) % 2 == 0;
  return pairs ? dispatch<2>(q, k, v, sink, kblk, sid, runs, bounds, rs, rc, out, lse,
                             rowmax, hq, hk, tqp, tkp, head_dim, nq, head_block, scale,
                             softcap, has_sink, out_f32, st)
               : dispatch<1>(q, k, v, sink, kblk, sid, runs, bounds, rs, rc, out, lse,
                             rowmax, hq, hk, tqp, tkp, head_dim, nq, head_block, scale,
                             softcap, has_sink, out_f32, st);
}

}  // extern "C"

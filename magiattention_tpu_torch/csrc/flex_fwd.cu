// flex_fwd: the flex-attention forward over a host-built entry table for
// Hopper (sm_90a), a q block of one q head — of a head pair of one kv head
// where the GQA group G is even — per thread block.
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::_fwd_pallas
// (kernel body _fwd_kernel). The walk, its bound on the card and what the
// design does about it are those of flex_fwd_sm90.cuh (TMA ring, two
// wgmma consumer warpgroups, deterministic), which this kernel shares with
// the head-batched flex_fwd_hb.cu; here a block's work item is one step of
// that walk (head_block NH), so both give the same bits.
//
// Grid: (q heads / NH, q blocks), the q blocks in the host's launch order
// (longest walk first, ops/flex_attn.py::walk_order), so the long walks of
// every head start first and the short ones fill the tail. The loop over
// entries takes the place of the TPU's sequential grid axis.

#include "flex_fwd_sm90.cuh"

namespace {

using namespace flex;
using namespace flex::sm90;

template <int D, int NH, typename OutT>
__global__ void __launch_bounds__(WS_THREADS, 1)
flex_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ FwdArgs<OutT> args,
                int head_block) {
  extern __shared__ unsigned char smem_raw[];
  fwd_block<D, NH>(smem_raw, &tm_q, &tm_k, &tm_v, args, head_block);
}

template <int D, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const FwdArgs<OutT>& args, int hq,
                   int hk, int nq, cudaStream_t st) {
  // a head pair of one kv head per block where G is even, else one head
  if ((hq / hk) % 2 == 0)
    return launch_fwd<D, 2>(flex_fwd_kernel<D, 2, OutT>, q, k, v, args, hq, hk, nq, 2, st);
  return launch_fwd<D, 1>(flex_fwd_kernel<D, 1, OutT>, q, k, v, args, hq, hk, nq, 1, st);
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [hq, tqp, d] bf16; k/v [hk, tkp, d] bf16 (16-byte aligned, for TMA);
// sink [hq] f32; int32 tables (kblk, sid [E]; runs [7E]; bounds [5(S+1)];
// rs, rc [nq]) and the launch order of the q blocks (a permutation of
// 0..nq-1); out [hq, tqp, d] bf16 (out_f32=0) or f32 (out_f32=1); lse,
// rowmax [hq, tqp] f32.
int magi_flex_fwd(const void* q, const void* k, const void* v, const void* sink,
                  const void* kblk, const void* sid, const void* runs, const void* bounds,
                  const void* rs, const void* rc, const void* order, void* out, void* lse,
                  void* rowmax, int hq, int hk, int tqp, int tkp, int head_dim, int nq,
                  int block_q, int block_k, float scale, float softcap, int has_sink,
                  int out_f32, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 || tqp != nq * BQ ||
      tkp % BK != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MAGI_FLEX_LAUNCH(D)                                                                     \
  return out_f32 ? launch<D>(q, k, v,                                                           \
                             fwd_args<float>(sink, kblk, sid, runs, bounds, rs, rc, order, out, \
                                             lse, rowmax, hq / hk, tqp, tkp, scale, softcap,    \
                                             has_sink),                                         \
                             hq, hk, nq, st)                                                    \
                 : launch<D>(q, k, v,                                                           \
                             fwd_args<bf16>(sink, kblk, sid, runs, bounds, rs, rc, order, out,  \
                                            lse, rowmax, hq / hk, tqp, tkp, scale, softcap,     \
                                            has_sink),                                          \
                             hq, hk, nq, st)
  switch (head_dim) {
    case 64: MAGI_FLEX_LAUNCH(64);
    case 128: MAGI_FLEX_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef MAGI_FLEX_LAUNCH
}

}  // extern "C"

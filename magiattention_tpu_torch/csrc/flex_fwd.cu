// flex_fwd: the flex-attention forward over a host-built entry table, one
// q head per thread block, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::_fwd_pallas
// (kernel body _fwd_kernel). The walk, its bound on the card and what the
// design does about it are those of flex_fwd.cuh (fwd_rows with NH = 1),
// which this kernel shares with the head-batched flex_fwd_hb.cu.
//
// Grid: (q blocks, q heads). One thread block of 4 warps per (head h, q
// block i); the loop over entries rs[i] .. rs[i]+rc[i] takes the place of
// the TPU's sequential grid axis. K/V come from kv head h / group.

#include "flex_fwd.cuh"

namespace {

using namespace flex;

template <int D, typename OutT>
__global__ void __launch_bounds__(NTHREADS)
flex_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ sink,
                const int* __restrict__ kblk, const int* __restrict__ sid,
                const int* __restrict__ runs, const int* __restrict__ bounds,
                const int* __restrict__ rs, const int* __restrict__ rc,
                OutT* __restrict__ out, float* __restrict__ lse,
                float* __restrict__ rowmax, int group, int tqp, int tkp,
                float scale, float softcap, int has_sink) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y;  // q head
  fwd_rows<D, 1, OutT>(q, k, v, sink, kblk, sid, runs, bounds, rs, rc, out, lse, rowmax, h,
                       h / group, blockIdx.x, tqp, tkp, scale, softcap, has_sink, smem_raw);
}

template <int D, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* sink,
                   const void* kblk, const void* sid, const void* runs,
                   const void* bounds, const void* rs, const void* rc, void* out,
                   void* lse, void* rowmax, int hq, int hk, int tqp, int tkp,
                   int nq, float scale, float softcap, int has_sink,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D, 1>();
  auto kernel = flex_fwd_kernel<D, OutT>;
  // above 48 KB of dynamic shared memory a kernel has to opt in
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, hq);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)sink,
      (const int*)kblk, (const int*)sid, (const int*)runs, (const int*)bounds,
      (const int*)rs, (const int*)rc, (OutT*)out, (float*)lse, (float*)rowmax,
      hq / hk, tqp, tkp, scale, softcap, has_sink);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [hq, tqp, d] bf16; k/v [hk, tkp, d] bf16; sink [hq] f32; int32 tables
// (kblk, sid [E]; runs [7E]; bounds [5(S+1)]; rs, rc [nq]); out [hq, tqp, d]
// bf16 (out_f32=0) or f32 (out_f32=1); lse, rowmax [hq, tqp] f32.
int magi_flex_fwd(const void* q, const void* k, const void* v, const void* sink,
                  const void* kblk, const void* sid, const void* runs,
                  const void* bounds, const void* rs, const void* rc, void* out,
                  void* lse, void* rowmax, int hq, int hk, int tqp, int tkp,
                  int head_dim, int nq, int block_q, int block_k, float scale,
                  float softcap, int has_sink, int out_f32, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 ||
      tqp != nq * BQ || tkp % BK != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MAGI_FLEX_LAUNCH(D)                                                   \
  return out_f32 ? launch<D, float>(q, k, v, sink, kblk, sid, runs, bounds,  \
                                    rs, rc, out, lse, rowmax, hq, hk, tqp,   \
                                    tkp, nq, scale, softcap, has_sink, st)   \
                 : launch<D, bf16>(q, k, v, sink, kblk, sid, runs, bounds,   \
                                   rs, rc, out, lse, rowmax, hq, hk, tqp,    \
                                   tkp, nq, scale, softcap, has_sink, st)
  switch (head_dim) {
    case 64: MAGI_FLEX_LAUNCH(64);
    case 128: MAGI_FLEX_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef MAGI_FLEX_LAUNCH
}

}  // extern "C"

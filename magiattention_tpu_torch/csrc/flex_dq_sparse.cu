// flex_dq_sparse: the flex-attention backward's dq on the sparse grid, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::
// _dq_pallas_sparse (kernel body _dq_kernel_sparse): the compact (hq, E)
// grid's dq, which computes exactly what the row-major _dq_pallas computes
// (the backward has no online rescale, so no AMLA: the stored lse is the
// reference). Here: flex_dq's math (flex_bwd.cuh::dq_item — S, dP, dS = P
// (dP - delta_eff) with the softcap chain rule, dS rounded to bf16 before
// dS K) in a persistent kernel whose blocks take (q head, q block) items
// from the longest-walk-first work list (flex_tile.cuh::next_item), so the
// long walks of a heterogeneous mask start in the first wave. Each item is
// computed whole by one block, with no atomics: the same bits on every run.
// What bounds it: 6 d FLOPs per unmasked (q, k) pair and q head on the
// tensor cores, as flex_dq.

#include "flex_bwd.cuh"

namespace {

using namespace flex;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flex_dq_sparse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ kblk, const int* __restrict__ sid,
                      const int* __restrict__ runs, const int* __restrict__ bounds,
                      const int* __restrict__ rs, const int* __restrict__ rc,
                      const int* __restrict__ work, int* __restrict__ counter,
                      float* __restrict__ dq, int group, int tqp, int tkp, int nq,
                      int n_items, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_item;
  for (int item = next_item(counter, &s_item); item < n_items;
       item = next_item(counter, &s_item)) {
    dq_item<D>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, dq, group, tqp,
               tkp, scale, softcap, /*h=*/work[item] / nq, /*i=*/work[item] % nq, smem_raw);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* kblk,
                   const void* sid, const void* runs, const void* bounds,
                   const void* rs, const void* rc, const void* work, void* counter,
                   void* dq, int hq, int hk, int tqp, int tkp, int nq, int n_items,
                   float scale, float softcap, cudaStream_t stream) {
  auto kernel = flex_dq_sparse_kernel<D>;
  int grid = 0;
  cudaError_t err = persistent_launch_dims(kernel, NTHREADS, dq_smem<D>(), n_items,
                                           (int*)counter, stream, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, dq_smem<D>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (const int*)kblk, (const int*)sid,
      (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
      (const int*)work, (int*)counter, (float*)dq, hq / hk, tqp, tkp, nq, n_items, scale,
      softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// As magi_flex_dq, plus work [n_items] int32 (q head * nq + q block, one
// item per (q head, q block), longest walk first) and counter [1] int32
// scratch.
int magi_flex_dq_sparse(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, const void* kblk,
                        const void* sid, const void* runs, const void* bounds,
                        const void* rs, const void* rc, const void* work, void* counter,
                        void* dq, int hq, int hk, int tqp, int tkp, int head_dim, int nq,
                        int block_q, int block_k, int n_items, float scale,
                        float softcap, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 ||
      tqp != nq * BQ || tkp % BK != 0 || n_items != hq * nq)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, work,
                        counter, dq, hq, hk, tqp, tkp, nq, n_items, scale, softcap, st);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, kblk, sid, runs, bounds, rs, rc, work,
                         counter, dq, hq, hk, tqp, tkp, nq, n_items, scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

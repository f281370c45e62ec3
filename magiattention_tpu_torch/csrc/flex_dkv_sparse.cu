// flex_dkv_sparse: the flex-attention backward's dk and dv on the sparse
// grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/ops/flex_attn.py::
// _dkv_pallas_sparse (kernel body _dkv_kernel_sparse): the compact
// (hk, E, group) grid over the k-major entry table, which computes exactly
// what the row-major _dkv_pallas computes. Here: flex_dkv's math
// (flex_bwd.cuh::dkv_item — the transposed products, the G q heads of the
// kv head in order inside each entry, dK and dV resident in registers for
// the whole walk) in a persistent kernel whose blocks take (kv head,
// k block) items from the longest-walk-first work list over the k-major
// walks (flex_tile.cuh::next_item). Each item is computed whole by one
// block, with no atomics: the same bits on every run. What bounds it:
// 8 d FLOPs per unmasked (q, k) pair and q head on the tensor cores, as
// flex_dkv, whose two 16 x d f32 accumulators a warp (255 registers a
// thread at d=128) limit occupancy.

#include "flex_bwd.cuh"

namespace {

using namespace flex;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flex_dkv_sparse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ qblk, const int* __restrict__ sid,
                       const int* __restrict__ runs, const int* __restrict__ bounds,
                       const int* __restrict__ rs, const int* __restrict__ rc,
                       const int* __restrict__ work, int* __restrict__ counter,
                       float* __restrict__ dk, float* __restrict__ dv, int group, int tqp,
                       int tkp, int nk, int n_items, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_item;
  for (int item = next_item(counter, &s_item); item < n_items;
       item = next_item(counter, &s_item)) {
    dkv_item<D>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, dk, dv, group,
                tqp, tkp, scale, softcap, /*hk=*/work[item] / nk, /*i=*/work[item] % nk,
                smem_raw);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qblk,
                   const void* sid, const void* runs, const void* bounds,
                   const void* rs, const void* rc, const void* work, void* counter,
                   void* dk, void* dv, int hq, int hk, int tqp, int tkp, int nk,
                   int n_items, float scale, float softcap, cudaStream_t stream) {
  auto kernel = flex_dkv_sparse_kernel<D>;
  int grid = 0;
  cudaError_t err = persistent_launch_dims(kernel, NTHREADS, dkv_smem<D>(), n_items,
                                           (int*)counter, stream, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, dkv_smem<D>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (const int*)qblk, (const int*)sid,
      (const int*)runs, (const int*)bounds, (const int*)rs, (const int*)rc,
      (const int*)work, (int*)counter, (float*)dk, (float*)dv, hq / hk, tqp, tkp, nk,
      n_items, scale, softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// As magi_flex_dkv, plus work [n_items] int32 (kv head * nk + k block, one
// item per (kv head, k block), longest k-major walk first) and counter [1]
// int32 scratch.
int magi_flex_dkv_sparse(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* qblk,
                         const void* sid, const void* runs, const void* bounds,
                         const void* rs, const void* rc, const void* work, void* counter,
                         void* dk, void* dv, int hq, int hk, int tqp, int tkp,
                         int head_dim, int nk, int block_q, int block_k, int n_items,
                         float scale, float softcap, void* stream) {
  if (block_q != BQ || block_k != BK || hk <= 0 || hq % hk != 0 ||
      tkp != nk * BK || tqp % BQ != 0 || n_items != hk * nk)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, work,
                        counter, dk, dv, hq, hk, tqp, tkp, nk, n_items, scale, softcap, st);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, qblk, sid, runs, bounds, rs, rc, work,
                         counter, dk, dv, hq, hk, tqp, tkp, nk, n_items, scale, softcap,
                         st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

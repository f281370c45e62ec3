// paged_decode: split-KV ("flash-decoding") attention over the paged KV
// cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel magiattention_tpu/serving/decode_attn.py::
// _decode_pallas (kernel body _decode_kernel): one query token per sequence
// attends over its paged history; each of num_splits KV splits walks its
// share of the block table, masks positions >= seq_len, runs an online
// softmax over the q heads that share one kv head, and writes its partial
// (out, lse) in f32. The splits merge outside the kernel through
// ops/correction.py::merge_partials, as on the TPU.
//
// Bound by bytes (each cached K/V byte feeds one multiply-add per q head of
// its group). bf16 caches take the tensor-core walk of decode_sm90.cuh
// (per-warp cp.async rings, mma.sync; its note says how it meets that
// bound), and in the flat mode a group of more than 32 q heads the TMA and
// wgmma walk of decode_wide_sm90.cuh (persistent blocks over segments of
// each walk, merged in a tree through ``scratch`` and ``counters``, cut by
// ``seg_chunks`` and launched as ``blocks`` blocks: the host's
// serving/decode_attn.py::wide_schedule); float32 caches the CUDA-core walk
// of decode_simt.cuh, which keeps the f32 arithmetic of the plain version.
//
// shared = 0: row b of q reads table row b and length b (flat decode).
// shared = 1: every row reads table row 0 and length 0, the cascade's shared
// prefix, and one block serves several members' q heads from each load.
// cluster_heads: the kv-head count the tensor-core walk sizes its clusters
// for, hk for a launch of its own; a tensor-parallel head slice passes the
// whole pool's, so that its walks merge as the full launch's do and give
// the same bits (the CUDA-core walk has no clusters and ignores it; the
// wide walk's host schedule takes it the same way, into seg_chunks).
// num_pages: the cache's pages (the wide walk's tensor maps span them).
//
// head_dim 32, 64, 80, 96 or 128 (the flex kernels' widths), any number of q heads
// per kv head: a group past what one walk keeps in registers runs as row
// tiles of one walk over each K/V chunk it loads (decode_wide_sm90.cuh,
// decode_simt.cuh's WIDE mode). head_dim 256 in bf16 on decode_sm90.cuh's
// walk, up to 32 q heads a kv head in the flat mode and any number in the
// shared mode; float32 and the wide walk are not built at 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_simt.cuh"
#include "decode_sm90.cuh"
#include "decode_wide_sm90.cuh"

extern "C" {

const char* magi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int magi_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                      const void* block_table, const void* seq_lens,
                      void* out_parts, void* lse_parts, int b, int hq, int hk,
                      int head_dim, int page_size, int mpp, int num_splits,
                      int shared, int is_f32, int cluster_heads, int num_pages, int seg_chunks,
                      int blocks, float scale, float softcap, void* scratch, void* counters,
                      void* stream) {
  if (b <= 0 || hk <= 0 || hq % hk != 0 || num_splits <= 0 || mpp % num_splits != 0 ||
      page_size <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = !is_f32 && !shared && hq / hk > decode_sm90::MAX_ROWS;
#define MAGI_DECODE_LAUNCH(D)                                                                \
  if (is_f32)                                                                                \
    return decode_simt::launch<float, D>(q, k_pages, v_pages, block_table, seq_lens,         \
                                         out_parts, lse_parts, b, hq, hk, page_size, mpp,    \
                                         num_splits, shared, scale, softcap, st);            \
  if (wide)                                                                                  \
    return decode_wide::launch<D>(q, k_pages, v_pages, block_table, seq_lens, out_parts,     \
                                  lse_parts, scratch, counters, b, hq, hk, page_size,        \
                                  num_pages, mpp, num_splits, seg_chunks, blocks, scale,     \
                                  softcap, st);                                              \
  return decode_sm90::launch<D>(q, k_pages, v_pages, block_table, seq_lens, out_parts,       \
                                lse_parts, b, hq, hk, page_size, mpp, num_splits, shared,    \
                                cluster_heads, scale, softcap, st)
  switch (head_dim) {
    case 32: MAGI_DECODE_LAUNCH(32);
    case 64: MAGI_DECODE_LAUNCH(64);
    case 80: MAGI_DECODE_LAUNCH(80);
    case 96: MAGI_DECODE_LAUNCH(96);
    case 128: MAGI_DECODE_LAUNCH(128);
    case 256:
      if (is_f32 || wide) return cudaErrorInvalidValue;
      return decode_sm90::launch<256>(q, k_pages, v_pages, block_table, seq_lens, out_parts,
                                      lse_parts, b, hq, hk, page_size, mpp, num_splits, shared,
                                      cluster_heads, scale, softcap, st);
    default: return cudaErrorInvalidValue;
  }
#undef MAGI_DECODE_LAUNCH
}

}  // extern "C"

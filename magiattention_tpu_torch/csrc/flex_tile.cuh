// Shared pieces of the flex-attention kernels (the row-major flex_fwd,
// flex_dq, flex_dkv and the sparse-grid flex_fwd_sparse(_hb),
// flex_dq_sparse, flex_dkv_sparse): the 64x64 tile, the bf16 tensor-core
// product (mma.sync m16n8k16, f32 accumulators), tile loads into padded
// shared memory, the per-entry mask of the host-built entry table
// (ops/block_meta.py) as a k-interval per query row — the JAX package's
// ops/flex_attn.py::_entry_interval_mask —, AMLA's exponent-add rescale
// and the persistent kernels' work-list scheduling.
//
// Fragment layout of mma m16n8k16 (lane = 4 g + t4): A holds rows g and g+8,
// columns 2 t4 (+1) and 2 t4 + 8 (+1); B holds column g, rows 2 t4 (+1) and
// 2 t4 + 8 (+1); C holds rows g and g+8, columns 2 t4 and 2 t4 + 1.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace flex {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int NWARPS = 4;      // each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;         // bf16 of padding per shared-memory row
constexpr int RUN_FIELDS = 7;  // ops/block_meta.py RUN_FIELDS
constexpr int SLICE_FIELDS = 5;  // ops/block_meta.py SLICE_FIELDS
constexpr int BIG = 1 << 30;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[16x8] += A[16x16] * B[16x8], bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed on the way: lanes 8m..8m+7 give the
// row addresses of matrix m, register m receives it.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const bf16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows r0, r0+8 and columns c0 + 2 t4 (+8) of a padded
// shared-memory tile with row stride LDS.
template <int LDS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0,
                                       int c0) {
  const bf16* p = tile + r0 * LDS + c0;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LDS);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LDS + 8);
}

// acc[16 x D] += A[16 x 64] * tile[64 rows x D]: A is an f32 accumulator
// tile of mma results (the C layout), rounded to bf16 on the way; the tile
// is read transposed (ldmatrix.trans). The "P V" product shape.
static_assert(BQ == BK, "the 64-wide A operand serves both orientations");
template <int D, int LDS>
__device__ __forceinline__ void mma_a_tile(float (&acc)[D / 8][4],
                                           const float (&a32)[BK / 8][4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(a32[2 * kk][0], a32[2 * kk][1]);
    a[1] = pack_bf16(a32[2 * kk][2], a32[2 * kk][3]);
    a[2] = pack_bf16(a32[2 * kk + 1][0], a32[2 * kk + 1][1]);
    a[3] = pack_bf16(a32[2 * kk + 1][2], a32[2 * kk + 1][3]);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3,
                        tile + (kk * 16 + (lane & 15)) * LDS + (j + (lane >> 4)) * 8);
      mma_16816(acc[j], a, b0, b1);
      mma_16816(acc[j + 1], a, b2, b3);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows [0, nrows) x D of a head-major [tokens, D] array -> shared, 16 B a
// thread, by a block of NT threads
template <int D, int NT = NTHREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int nrows) {
  constexpr int LDS = D + PAD;
  constexpr int CHUNKS = D / 8;
  for (int c = threadIdx.x; c < nrows * CHUNKS; c += NT) {
    const int r = c / CHUNKS, cc = c % CHUNKS;
    *reinterpret_cast<uint4*>(dst + r * LDS + cc * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + cc * 8);
  }
}

// Entry e's mask for local (padded) query row rl as the key interval
// [lo, hi): the run window, the slice bounds, causal (bit 0, bottom-right
// aligned) and inv-causal (bit 1, top-left aligned). A row outside the
// entry gets the empty interval; dummy entries point at the all-zero
// sentinel slice and so mask every row.
__device__ __forceinline__ void entry_interval(const int* runs, const int* bounds,
                                               int slice, int e, int rl, int& lo,
                                               int& hi) {
  const int* ru = runs + (size_t)e * RUN_FIELDS;
  const int* bo = bounds + (size_t)slice * SLICE_FIELDS;
  const int ql0 = ru[0], ql1 = ru[1], kl0 = ru[2], kl1 = ru[3];
  const int qoff = ru[4], koff = ru[5];
  const int q0 = bo[0], q1 = bo[1], k0 = bo[2], k1 = bo[3], typ = bo[4];
  const bool ok = rl >= ql0 && rl < ql1 && rl + qoff >= q0 && rl + qoff < q1;
  int a = max(kl0, k0 - koff);
  if (typ & 2) a = max(a, rl + (qoff - q0 + k0 - koff));
  int b = min(kl1, k1 - koff);
  if (typ & 1) b = min(b, rl + (qoff - q1 + k1 - koff + 1));
  lo = ok ? a : BIG;
  hi = ok ? b : -BIG;
}

constexpr float LOG2E_F = 1.4426950408889634f;  // the JAX package's float32(LOG2E)
constexpr float LN2_F = 0.6931471805599453f;

// x * 2^delta for delta <= 0, as an integer add on the exponent field: the
// rescale of the sparse forwards' AMLA softmax, whose running max is an
// integer in base 2. Exact for normal floats; 0 where the exponent would
// leave the normal range, and for zeros and subnormals. Bit for bit the JAX
// _amla_rescale (its int32 add wraps; here the add is unsigned, so the same
// bits without signed overflow).
__device__ __forceinline__ float amla_rescale(float x, int delta) {
  const uint32_t bits = __float_as_uint(x);
  const int exp_field = (int)((bits >> 23) & 0xFFu);
  const uint32_t shifted = bits + ((uint32_t)delta << 23);
  return exp_field + delta > 0 ? __uint_as_float(shifted) : 0.f;
}

// Scale, then the optional softcap cap * tanh(z / cap): the logit the
// forward's softmax saw.
__device__ __forceinline__ float logit(float acc, float scale, float softcap) {
  const float z = acc * scale;
  return softcap > 0.f ? softcap * tanhf(z / softcap) : z;
}

// The backward's per-logit core (the JAX package's _bwd_p_ds): p from the
// stored lse, ds = p (dp - delta_eff), times the softcap derivative
// 1 - (z / cap)^2; 0 off the mask (where the softcap term is not finite).
__device__ __forceinline__ void p_ds(float z, bool on, float lse_safe, float dp,
                                     float delta, float softcap, float& p,
                                     float& ds) {
  p = on ? expf(z - lse_safe) : 0.f;
  ds = p * (dp - delta);
  if (softcap > 0.f) {
    const float t = z / softcap;
    ds = on ? ds * (1.f - t * t) : 0.f;
  }
}

// The persistent kernels take the items of a longest-walk-first work list
// (ops/block_sparse.py::work_list) through one counter per launch, zeroed
// on the launch's stream: a block that finishes an item takes the next one
// not yet taken, so the long walks start first and the short ones fill the
// tail. Each item is computed whole by one block, so which block took it
// does not change a bit of the result.
//
// The next item for the whole block (the sparse forwards): thread 0 takes
// it, shared memory broadcasts it. The barrier in front also means every
// warp is done with the previous item's shared memory. (The warp-specialised
// sparse backward, whose warpgroups cannot meet at __syncthreads, hands its
// items over through mbarriers: flex_bwd_sm90.cuh.)
__device__ __forceinline__ int next_item(int* counter, int* s_item) {
  __syncthreads();
  if (threadIdx.x == 0) *s_item = atomicAdd(counter, 1);
  __syncthreads();
  return *s_item;
}

// The launch of a persistent kernel: as many blocks as fit on the card at
// once (or one per item, if fewer), and its counter zeroed on the stream.
template <typename Kernel>
inline cudaError_t persistent_launch_dims(Kernel kernel, int threads, size_t smem,
                                          int n_items, int* counter,
                                          cudaStream_t stream, int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  const int fit = sms * (per_sm > 0 ? per_sm : 1);
  grid = n_items < fit ? (n_items > 0 ? n_items : 1) : fit;
  return err;
}

}  // namespace flex

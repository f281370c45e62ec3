// The float32 walks of the flex-attention kernels on the CUDA cores (FFMA
// in full f32): the row-major forward that flex_fwd.cu and flex_fwd_hb.cu
// share, flex_dq.cu's dq and flex_dkv.cu's dk, dv, and their sparse-grid
// twins behind flex_fwd_sparse(_hb).cu, flex_dq_sparse.cu and
// flex_dkv_sparse.cu, over the same entry tables, with the same outputs and
// the same per-logit core (flex_tile.cuh) as the bf16 warp-specialised
// walks. A work item (fwd_item, dq_item, dkv_item) is one function that both
// grids call: a row-major block computes one, a persistent sparse-grid block
// takes item after item from the longest-walk-first work list.
//
// Replaces, for float32 q/k/v, the TPU kernels magiattention_tpu/ops/
// flex_attn.py::_fwd_pallas, _fwd_pallas_hb (kernel bodies _fwd_kernel,
// _fwd_kernel_hb), _dq_pallas (_dq_kernel), _dkv_pallas (_dkv_kernel) and
// the sparse grid's _fwd_pallas_sparse, _fwd_pallas_hb_sparse,
// _dq_pallas_sparse and _dkv_pallas_sparse, which run float32 on the TPU's
// matrix unit. On the card a float32 product runs in full f32 by default;
// the tensor cores' TF32 keeps about three digits, outside the float32 error
// budget (telemetry/numerics.py: max_abs 1e-4, max_rel 1e-3), so these walks
// use the CUDA cores, as decode_simt.cuh does for the float32 paged decode.
// The sparse forwards run the TPU sparse kernels' AMLA softmax (an integer
// base-2 reference, exponent-add rescales: fwd_item's AMLA mode); the
// sparse dq and dk/dv compute each item as the row-major walks do, so they
// give flex_dq's and flex_dkv's bits on the same tables.
//
// What bounds them on the card: ~4 d FLOPs per unmasked (q, k) pair and q
// head for the forward (S, P V), 6 d for dq (S, dP, dQ), 8 d for dk/dv,
// against 67 TFLOP/s of CUDA-core FP32 on an H100 SXM: operations.
//
// What the design does about it: a block of 256 threads holds 64 x d tiles
// in shared memory (rows padded by 4 floats, so that 16-byte loads from
// eight different rows hit different banks: rows of 36, 68, 84, 100 and 132
// floats put eight consecutive rows' 16 bytes on eight distinct 16-byte
// units of a 128-byte bank line) and computes a 64 x 64 score
// tile as a 16 x 16 grid of threads, each 4 rows x 4 columns in registers
// (rows tr + 16 i, columns tc + 16 j): a thread's 16 accumulators take 64
// FFMAs per 8 shared-memory loads of 16 bytes. The row reductions of the
// softmax stay inside a half warp (the 16 threads of a row group) through
// shuffles. P (or dS) goes through shared memory to the accumulating
// product, where each thread owns 4 rows x d / 16 columns (tc + 16 jj) of
// its output tile. A simple walk, right first: no TMA, no ring, a
// __syncthreads between the phases of an entry.
//
// Determinism: no atomics on data; each item is computed whole by one block,
// which owns its output rows and sums in the walk's fixed order, so the same
// inputs give the same bits on every run whichever block takes an item, and
// flex_fwd and flex_fwd_hb (whose work item only batches heads) the same
// bits as each other.
#pragma once

#include "flex_tile.cuh"

namespace flex {
namespace simt {

constexpr int THREADS = 256;  // a 16 x 16 grid over a 64 x 64 tile
constexpr int GRID = 16;
constexpr int RPT = BQ / GRID;  // rows a thread owns: tr + 16 i
constexpr int CPT = BK / GRID;  // score columns a thread owns: tc + 16 j
constexpr int TPAD = 4;         // floats of padding a tile row
constexpr int PLDS = BK + 1;    // the P / dS tile's row stride
static_assert(BQ == BK, "one thread grid serves both orientations");

template <int D>
__host__ __device__ constexpr int lds() {
  return D + TPAD;
}
template <int D>
__host__ __device__ constexpr int tile_floats() {
  return BQ * lds<D>();
}

// rows [0, 64) x D of a head-major [tokens, D] f32 array into a padded
// shared tile, 16 bytes a thread
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src) {
  constexpr int V4 = D / 4;
  for (int c = threadIdx.x; c < BQ * V4; c += THREADS) {
    const int r = c / V4, cc = c % V4;
    *reinterpret_cast<float4*>(dst + r * lds<D>() + cc * 4) =
        *reinterpret_cast<const float4*>(src + (size_t)r * D + cc * 4);
  }
}

// s[i][j] = sum_d A[tr + 16 i][d] B[tc + 16 j][d] over two padded tiles.
template <int D>
__device__ __forceinline__ void scores(float (&s)[RPT][CPT], const float* a, const float* b,
                                       int tr, int tc) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RPT], bv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (tr + GRID * i) * lds<D>() + d);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tc + GRID * j) * lds<D>() + d);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][jj] += sum_k P[tr + 16 i][k] T[k][tc + 16 jj]: a 64 x 64 tile from
// shared memory (row stride PLDS) times a padded 64 x D tile.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[RPT][D / GRID], const float* p,
                                           const float* t, int tr, int tc) {
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float pv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) pv[i] = p[(tr + GRID * i) * PLDS + k];
#pragma unroll
    for (int jj = 0; jj < D / GRID; ++jj) {
      const float tv = t[k * lds<D>() + tc + GRID * jj];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i][jj] = fmaf(pv[i], tv, acc[i][jj]);
    }
  }
}

// the max and the sum of a row's values over the 16 threads of its row group
// (the lanes of one half warp)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int w = 1; w < GRID; w *= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int w = 1; w < GRID; w *= 2) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// -- forward ----------------------------------------------------------------------------

struct FwdArgs {
  const float *q, *k, *v, *sink;
  const int *kblk, *sid, *runs, *bounds, *rs, *rc, *order;
  float *out, *lse, *rowmax;
  int group, tqp, tkp;
  float scale, softcap;
  int has_sink;
};

template <int D>
constexpr int fwd_smem_bytes() {
  return (3 * tile_floats<D>() + BQ * PLDS) * 4;  // Q, K, V, P
}

// One work item of the forward: q block ib of the nheads q heads from h0,
// one head after the other. Per entry of the head's walk: S = Q K^T, the
// scale and softcap, the entry's interval mask, the online softmax, O += P
// V; then the sink, lse, rowmax and out = O / l as the bf16 walk's epilogue
// (flex_fwd_sm90.cuh::fwd_store). The row-major grid (AMLA = false) runs the
// natural-exp softmax whose reference moves with every new row max; the
// sparse grid (AMLA = true) the TPU sparse kernels' AMLA softmax, as the
// plain ops/flex_attn.py::_amla_update computes it: an integer reference in
// base 2, ceil(max z log2 e), moved on every rise, P = exp2(z log2 e - ref),
// l and O rescaled by 2^(ref_old - ref_new) as exponent adds
// (flex_tile.cuh's amla_rescale), the epilogue against ref ln 2; m is the
// exact natural max either way (rowmax).
template <int D, bool AMLA>
__device__ __forceinline__ void fwd_item(const FwdArgs& a, float* smem, int h0, int nheads,
                                         int ib) {
  constexpr int CJ = D / GRID;
  float* sq = smem;
  float* sk = sq + tile_floats<D>();
  float* sv = sk + tile_floats<D>();
  float* sp = sv + tile_floats<D>();
  const int tr = threadIdx.x / GRID, tc = threadIdx.x % GRID;
  const int e_begin = a.rs[ib], e_end = a.rs[ib] + a.rc[ib];
  for (int hh = 0; hh < nheads; ++hh) {
    const int h = h0 + hh;
    const int kvh = h / a.group;
    __syncthreads();  // the previous head's (or item's) readers are done with Q
    load_tile_f32<D>(sq, a.q + ((size_t)h * a.tqp + ib * BQ) * D);
    float m[RPT], ref[RPT], l[RPT], o[RPT][CJ];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      m[i] = ref[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) o[i][jj] = 0.f;
    }
    int loaded = -1;
    for (int e = e_begin; e < e_end; ++e) {
      const int kb = a.kblk[e];
      __syncthreads();  // P, K and V of the last entry are read
      if (kb != loaded) {
        loaded = kb;
        const size_t row = (size_t)kvh * a.tkp + kb * BK;
        load_tile_f32<D>(sk, a.k + row * D);
        load_tile_f32<D>(sv, a.v + row * D);
      }
      __syncthreads();
      float s[RPT][CPT];
      scores<D>(s, sq, sk, tr, tc);
      const int sd = a.sid[e];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        int lo, hi;
        entry_interval(a.runs, a.bounds, sd, e, ib * BQ + tr + GRID * i, lo, hi);
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = kb * BK + tc + GRID * j;
          const float z = logit(s[i][j], a.scale, a.softcap);
          s[i][j] = (col >= lo && col < hi) ? z : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
        if constexpr (AMLA) {
          const float tile_max = group_max(mx);
          m[i] = fmaxf(m[i], tile_max);
          const float ref_new = fmaxf(ref[i], ceilf(tile_max * LOG2E_F));
          const float ref_safe = ref_new == -INFINITY ? 0.f : ref_new;
          // a row that meets its first live key carries zero state: 2^0
          const int delta = ref[i] == -INFINITY ? 0 : (int)(ref[i] - ref_safe);
          ref[i] = ref_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float p = exp2f(s[i][j] * LOG2E_F - ref_safe);
            sp[(tr + GRID * i) * PLDS + tc + GRID * j] = p;
            sum += p;
          }
          l[i] = amla_rescale(l[i], delta) + group_sum(sum);
#pragma unroll
          for (int jj = 0; jj < CJ; ++jj) o[i][jj] = amla_rescale(o[i][jj], delta);
        } else {
          const float m_new = fmaxf(m[i], group_max(mx));
          // a row that meets no live key yet keeps zero state
          const float alpha = m_new == -INFINITY ? 1.f : m[i] == -INFINITY ? 0.f
                                                                            : expf(m[i] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float p = m_new == -INFINITY ? 0.f : expf(s[i][j] - m_new);
            sp[(tr + GRID * i) * PLDS + tc + GRID * j] = p;
            sum += p;
          }
          l[i] = l[i] * alpha + group_sum(sum);
          m[i] = m_new;
#pragma unroll
          for (int jj = 0; jj < CJ; ++jj) o[i][jj] *= alpha;
        }
      }
      __syncthreads();
      accumulate<D>(o, sp, sv, tr, tc);
    }
    // the epilogue of this thread's rows: l and O are against the reference
    // mu (the exact max m on the row-major grid, ref ln 2 under AMLA)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ib * BQ + tr + GRID * i;
      const float mu = AMLA ? ref[i] * LN2_F : m[i];  // -inf stays -inf
      float mt_safe, ltot, resc = 1.f;
      if (a.has_sink) {
        const float sk0 = a.sink[h];
        const float mtot = fmaxf(mu, sk0);
        mt_safe = mtot == -INFINITY ? 0.f : mtot;
        resc = mu == -INFINITY ? 0.f : expf(mu - mt_safe);
        ltot = l[i] * resc + expf(sk0 - mt_safe);
      } else {
        mt_safe = mu == -INFINITY ? 0.f : mu;
        ltot = l[i];
      }
      const bool covered = ltot > 0.f;
      const float osc = covered ? resc / ltot : 0.f;
      const size_t idx = (size_t)h * a.tqp + r;
      if (tc == 0) {
        a.lse[idx] = covered ? mt_safe + logf(ltot) : -INFINITY;
        a.rowmax[idx] = m[i];
      }
#pragma unroll
      for (int jj = 0; jj < CJ; ++jj) a.out[idx * D + tc + GRID * jj] = o[i][jj] * osc;
    }
  }
}

// The row-major forward: one block per (group of head_block q heads
// blockIdx.x, q block order[blockIdx.y]).
template <int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const FwdArgs a, int head_block) {
  extern __shared__ float smem[];
  fwd_item<D, false>(a, smem, blockIdx.x * head_block, head_block, a.order[blockIdx.y]);
}

// The sparse-grid forward: persistent blocks take the items of the
// longest-walk-first work list (group of heads_per_item q heads * nq + q
// block) through the launch's counter (flex_tile.cuh's next_item).
template <int D>
__global__ void __launch_bounds__(THREADS)
fwd_sparse_kernel(const FwdArgs a, const int* __restrict__ work, int* __restrict__ counter,
                  int nq, int n_items, int heads_per_item) {
  extern __shared__ float smem[];
  __shared__ int s_item;
  for (;;) {
    const int n = next_item(counter, &s_item);
    if (n >= n_items) return;
    const int item = work[n];
    fwd_item<D, true>(a, smem, item / nq * heads_per_item, heads_per_item, item % nq);
  }
}

template <int D>
inline cudaError_t launch_fwd(const FwdArgs& a, int hq, int nq, int head_block,
                              cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(hq / head_block, nq);
  fwd_kernel<D><<<grid, THREADS, smem, stream>>>(a, head_block);
  return cudaGetLastError();
}

// A forward entry point's launch at head_dim d (32, 64, 80, 96 or 128).
inline cudaError_t fwd(const FwdArgs& a, int hq, int nq, int head_dim, int head_block,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_fwd<32>(a, hq, nq, head_block, stream);
    case 64: return launch_fwd<64>(a, hq, nq, head_block, stream);
    case 80: return launch_fwd<80>(a, hq, nq, head_block, stream);
    case 96: return launch_fwd<96>(a, hq, nq, head_block, stream);
    case 128: return launch_fwd<128>(a, hq, nq, head_block, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
inline cudaError_t launch_fwd_sparse(const FwdArgs& a, const int* work, int* counter, int nq,
                                     int n_items, int heads_per_item, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = persistent_launch_dims(fwd_sparse_kernel<D>, THREADS, fwd_smem_bytes<D>(),
                                           n_items, counter, stream, grid);
  if (err != cudaSuccess) return err;
  fwd_sparse_kernel<D><<<grid, THREADS, fwd_smem_bytes<D>(), stream>>>(a, work, counter, nq,
                                                                       n_items, heads_per_item);
  return cudaGetLastError();
}

// A sparse-grid forward entry point's launch at head_dim d (32, 64, 80, 96 or 128).
inline cudaError_t fwd_sparse(const FwdArgs& a, const void* work, void* counter, int nq,
                              int n_items, int heads_per_item, int head_dim,
                              cudaStream_t stream) {
  const int* w = static_cast<const int*>(work);
  int* c = static_cast<int*>(counter);
  switch (head_dim) {
    case 32: return launch_fwd_sparse<32>(a, w, c, nq, n_items, heads_per_item, stream);
    case 64: return launch_fwd_sparse<64>(a, w, c, nq, n_items, heads_per_item, stream);
    case 80: return launch_fwd_sparse<80>(a, w, c, nq, n_items, heads_per_item, stream);
    case 96: return launch_fwd_sparse<96>(a, w, c, nq, n_items, heads_per_item, stream);
    case 128: return launch_fwd_sparse<128>(a, w, c, nq, n_items, heads_per_item, stream);
    default: return cudaErrorInvalidValue;
  }
}

// -- backward ---------------------------------------------------------------------------

struct BwdArgs {
  const float *q, *k, *v, *dout, *lse, *delta;
  const int *major, *sid, *runs, *bounds, *rs, *rc, *order;  // major: kblk (dq), qblk (dkv)
  float *dq, *dk, *dv;
  int group, tqp, tkp;
  float scale, softcap;
};

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * tile_floats<D>() + BQ * PLDS) * 4;  // Q, dO, K, V, dS
}

// dq of q head h over q block ib. Per entry: S = Q K^T, dP = dO V^T, P =
// exp(S - lse) on the entry's mask, dS = P (dP - delta_eff) (flex_tile.cuh's
// p_ds), dQ += dS K; dq = scale dQ.
template <int D>
__device__ __forceinline__ void dq_item(const BwdArgs& a, float* smem, int h, int ib) {
  constexpr int CJ = D / GRID;
  float* sq = smem;
  float* sdo = sq + tile_floats<D>();
  float* sk = sdo + tile_floats<D>();
  float* sv = sk + tile_floats<D>();
  float* sds = sv + tile_floats<D>();
  const int tr = threadIdx.x / GRID, tc = threadIdx.x % GRID;
  const int kvh = h / a.group;
  const int e_begin = a.rs[ib], e_end = a.rs[ib] + a.rc[ib];
  const size_t q0 = (size_t)h * a.tqp + ib * BQ;
  __syncthreads();  // the previous item's readers are done with the tiles
  load_tile_f32<D>(sq, a.q + q0 * D);
  load_tile_f32<D>(sdo, a.dout + q0 * D);
  float lse_safe[RPT], dlt[RPT], acc[RPT][CJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float x = a.lse[q0 + tr + GRID * i];
    lse_safe[i] = x == -INFINITY ? 0.f : x;
    dlt[i] = a.delta[q0 + tr + GRID * i];
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) acc[i][jj] = 0.f;
  }
  int loaded = -1;
  for (int e = e_begin; e < e_end; ++e) {
    const int kb = a.major[e];
    __syncthreads();  // dS, K and V of the last entry are read
    if (kb != loaded) {
      loaded = kb;
      const size_t row = (size_t)kvh * a.tkp + kb * BK;
      load_tile_f32<D>(sk, a.k + row * D);
      load_tile_f32<D>(sv, a.v + row * D);
    }
    __syncthreads();
    float s[RPT][CPT], dp[RPT][CPT];
    scores<D>(s, sq, sk, tr, tc);
    scores<D>(dp, sdo, sv, tr, tc);
    const int sd = a.sid[e];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      int lo, hi;
      entry_interval(a.runs, a.bounds, sd, e, ib * BQ + tr + GRID * i, lo, hi);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = kb * BK + tc + GRID * j;
        float p, ds;
        p_ds(logit(s[i][j], a.scale, a.softcap), col >= lo && col < hi, lse_safe[i], dp[i][j],
             dlt[i], a.softcap, p, ds);
        sds[(tr + GRID * i) * PLDS + tc + GRID * j] = ds;
      }
    }
    __syncthreads();
    accumulate<D>(acc, sds, sk, tr, tc);
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj)
      a.dq[(q0 + tr + GRID * i) * D + tc + GRID * jj] = acc[i][jj] * a.scale;
}

// The row-major dq: one block per (q head blockIdx.x, q block
// order[blockIdx.y]).
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  dq_item<D>(a, smem, blockIdx.x, a.order[blockIdx.y]);
}

// The sparse-grid dq: persistent blocks over the work list's (group of
// heads_per_item q heads * nq + q block) items, each head of an item
// computed as dq_kernel computes it: dq_kernel's bits.
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_sparse_kernel(const BwdArgs a, const int* __restrict__ work, int* __restrict__ counter,
                 int nq, int n_items, int heads_per_item) {
  extern __shared__ float smem[];
  __shared__ int s_item;
  for (;;) {
    const int n = next_item(counter, &s_item);
    if (n >= n_items) return;
    const int item = work[n];
    for (int hh = 0; hh < heads_per_item; ++hh)
      dq_item<D>(a, smem, item / nq * heads_per_item + hh, item % nq);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  // K, V, Q, dO, P^T, dS^T, then the q rows' lse, delta_eff and k-intervals
  return (4 * tile_floats<D>() + 2 * BK * PLDS + 2 * BQ) * 4 + 2 * BQ * 4;
}

// dk, dv of kv head hk over k block ib. Per entry of the k-major walk, and inside it the G q heads of the kv head
// in order (the bf16 walk's order): S^T = K Q^T, dP^T = V dO^T, P^T and
// dS^T on the entry's mask, dV += P^T dO, dK += dS^T Q; dk = scale dK.
template <int D>
__device__ __forceinline__ void dkv_item(const BwdArgs& a, float* smem, int hk, int ib) {
  constexpr int CJ = D / GRID;
  float* sk = smem;
  float* sv = sk + tile_floats<D>();
  float* sq = sv + tile_floats<D>();
  float* sdo = sq + tile_floats<D>();
  float* spt = sdo + tile_floats<D>();
  float* sdst = spt + BK * PLDS;
  float* slse = sdst + BK * PLDS;
  float* sdelta = slse + BQ;
  int* slo = reinterpret_cast<int*>(sdelta + BQ);
  int* shi = slo + BQ;
  const int tr = threadIdx.x / GRID, tc = threadIdx.x % GRID;
  const int e_begin = a.rs[ib], e_end = a.rs[ib] + a.rc[ib];
  const size_t k0 = (size_t)hk * a.tkp + ib * BK;
  __syncthreads();  // the previous item's readers are done with the tiles
  load_tile_f32<D>(sk, a.k + k0 * D);
  load_tile_f32<D>(sv, a.v + k0 * D);
  float dka[RPT][CJ], dva[RPT][CJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) dka[i][jj] = dva[i][jj] = 0.f;
  for (int e = e_begin; e < e_end; ++e) {
    const int qb = a.major[e];
    for (int g = 0; g < a.group; ++g) {
      const size_t q0 = (size_t)(hk * a.group + g) * a.tqp + qb * BQ;
      __syncthreads();  // the last step's tiles are read
      load_tile_f32<D>(sq, a.q + q0 * D);
      load_tile_f32<D>(sdo, a.dout + q0 * D);
      if (threadIdx.x < BQ) {
        const float x = a.lse[q0 + threadIdx.x];
        slse[threadIdx.x] = x == -INFINITY ? 0.f : x;
        sdelta[threadIdx.x] = a.delta[q0 + threadIdx.x];
        if (g == 0)  // the entry's k-interval per query row
          entry_interval(a.runs, a.bounds, a.sid[e], e, qb * BQ + threadIdx.x, slo[threadIdx.x],
                         shi[threadIdx.x]);
      }
      __syncthreads();
      float st[RPT][CPT], dpt[RPT][CPT];
      scores<D>(st, sk, sq, tr, tc);
      scores<D>(dpt, sv, sdo, tr, tc);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int key = ib * BK + tr + GRID * i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int t = tc + GRID * j;  // the query row of the tile
          float p, ds;
          p_ds(logit(st[i][j], a.scale, a.softcap), key >= slo[t] && key < shi[t], slse[t],
               dpt[i][j], sdelta[t], a.softcap, p, ds);
          spt[(tr + GRID * i) * PLDS + t] = p;
          sdst[(tr + GRID * i) * PLDS + t] = ds;
        }
      }
      __syncthreads();
      accumulate<D>(dva, spt, sdo, tr, tc);
      accumulate<D>(dka, sdst, sq, tr, tc);
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) {
      const size_t idx = (k0 + tr + GRID * i) * D + tc + GRID * jj;
      a.dk[idx] = dka[i][jj] * a.scale;
      a.dv[idx] = dva[i][jj];
    }
}

// The row-major dk, dv: one block per (kv head blockIdx.x, k block
// order[blockIdx.y]).
template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  dkv_item<D>(a, smem, blockIdx.x, a.order[blockIdx.y]);
}

// The sparse-grid dk, dv: persistent blocks over the work list's (kv head
// * nk + k block) items: dkv_kernel's bits.
template <int D>
__global__ void __launch_bounds__(THREADS)
dkv_sparse_kernel(const BwdArgs a, const int* __restrict__ work, int* __restrict__ counter,
                  int nk, int n_items) {
  extern __shared__ float smem[];
  __shared__ int s_item;
  for (;;) {
    const int n = next_item(counter, &s_item);
    if (n >= n_items) return;
    const int item = work[n];
    dkv_item<D>(a, smem, item / nk, item % nk);
  }
}

template <int D, bool DQ>
inline cudaError_t launch_bwd(const BwdArgs& a, int heads, int blocks, cudaStream_t stream) {
  void (*kernel)(const BwdArgs);
  int smem;
  if constexpr (DQ) {
    kernel = dq_kernel<D>;
    smem = dq_smem_bytes<D>();
  } else {
    kernel = dkv_kernel<D>;
    smem = dkv_smem_bytes<D>();
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(heads, blocks), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// dq (over hq heads and the q blocks) or dk/dv (over hk heads and the k
// blocks) at head_dim d (32, 64, 80, 96 or 128).
template <bool DQ>
inline cudaError_t bwd(const BwdArgs& a, int heads, int blocks, int head_dim,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_bwd<32, DQ>(a, heads, blocks, stream);
    case 64: return launch_bwd<64, DQ>(a, heads, blocks, stream);
    case 80: return launch_bwd<80, DQ>(a, heads, blocks, stream);
    case 96: return launch_bwd<96, DQ>(a, heads, blocks, stream);
    case 128: return launch_bwd<128, DQ>(a, heads, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D, bool DQ>
inline cudaError_t launch_bwd_sparse(const BwdArgs& a, const int* work, int* counter,
                                     int blocks, int n_items, int heads_per_item,
                                     cudaStream_t stream) {
  constexpr int smem = DQ ? dq_smem_bytes<D>() : dkv_smem_bytes<D>();
  int grid = 0;
  cudaError_t err;
  if constexpr (DQ) {
    err = persistent_launch_dims(dq_sparse_kernel<D>, THREADS, smem, n_items, counter, stream,
                                 grid);
    if (err != cudaSuccess) return err;
    dq_sparse_kernel<D><<<grid, THREADS, smem, stream>>>(a, work, counter, blocks, n_items,
                                                         heads_per_item);
  } else {
    err = persistent_launch_dims(dkv_sparse_kernel<D>, THREADS, smem, n_items, counter, stream,
                                 grid);
    if (err != cudaSuccess) return err;
    dkv_sparse_kernel<D><<<grid, THREADS, smem, stream>>>(a, work, counter, blocks, n_items);
  }
  return cudaGetLastError();
}

// The sparse-grid dq (items of heads_per_item q heads and a q block, over
// nq blocks) or dk/dv (items of a kv head and a k block, over nk blocks) at
// head_dim d (32, 64, 80, 96 or 128).
template <bool DQ>
inline cudaError_t bwd_sparse(const BwdArgs& a, const void* work, void* counter, int blocks,
                              int n_items, int heads_per_item, int head_dim,
                              cudaStream_t stream) {
  const int* w = static_cast<const int*>(work);
  int* c = static_cast<int*>(counter);
  switch (head_dim) {
    case 32:
      return launch_bwd_sparse<32, DQ>(a, w, c, blocks, n_items, heads_per_item, stream);
    case 64:
      return launch_bwd_sparse<64, DQ>(a, w, c, blocks, n_items, heads_per_item, stream);
    case 80:
      return launch_bwd_sparse<80, DQ>(a, w, c, blocks, n_items, heads_per_item, stream);
    case 96:
      return launch_bwd_sparse<96, DQ>(a, w, c, blocks, n_items, heads_per_item, stream);
    case 128:
      return launch_bwd_sparse<128, DQ>(a, w, c, blocks, n_items, heads_per_item, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt
}  // namespace flex

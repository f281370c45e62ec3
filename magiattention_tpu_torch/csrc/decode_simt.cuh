// The paged-decode walk on CUDA cores (f32 arithmetic), one page at a time:
// the kernel behind paged_decode for float32 caches, and, built on its own
// at bf16, chip_smoke.py's yardstick for the tensor-core walk of
// decode_sm90.cuh (it was paged_decode's only walk before that one).
//
// One thread block per (kv head, split, row group): it walks its split's
// pages of one block-table row in order, loading each live K/V row of the
// page into shared memory (16 B a thread; pages past the sequence's end and
// tokens past seq_len are never read), then computes the scores of its q
// rows (one thread a token), the online-softmax update (one warp a row) and
// P.V (one thread a (row, d)), with a barrier between the steps: no load is
// in flight while the block computes.
//
// A row group is at most MAXG q rows of one kv head, row i of the launch
// being q head h * G + i % G of member i / G. Flat mode: a group is one
// sequence's G rows on its own table row and length. Shared mode: every
// member reads table row 0 and length 0 (a cascade's shared prefix), and a
// group takes MAXG rows across members, so each page is read once per
// MAXG rows. A flat-mode group of more than MAXG q heads (WIDE) runs as
// row tiles of MAXG over each page the block loads, its accumulators in
// shared memory, so that the page is read once for all of them; past
// WIDE_MAX_ROWS q heads a sequence's group is cut into row slices
// (blockIdx.z = sequence * slices + slice), each reading the pages once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_simt {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;  // q rows a block serves (a row tile, under WIDE)
constexpr int WIDE_MAX_ROWS = 64;  // q rows a WIDE block serves

// The row slices of a flat-mode group of ``group`` q rows.
__host__ __device__ inline int wide_slices(int group) {
  return (group + WIDE_MAX_ROWS - 1) / WIDE_MAX_ROWS;
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
// p rounded to the cache's type before P.V, as the TPU kernel does
__device__ __forceinline__ float round_to(bf16*, float p) {
  return __bfloat162float(__float2bfloat16(p));
}
__device__ __forceinline__ float round_to(float*, float p) { return p; }

// q [b, hq, D]; k_pages/v_pages [P, ps, hk, D] (T); bt [b or 1, mpp];
// sl [b or 1]; out_parts [b, splits, hq, D] f32; lse_parts [b, splits, hq].
// WIDE (flat mode only): rows_per_block is a slice's rows, ``slices`` the
// slices of a sequence's group.
template <typename T, int D, bool WIDE>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ sl, float* __restrict__ out_parts,
                    float* __restrict__ lse_parts, int hq, int hk, int group,
                    int rows_total, int rows_per_block, int shared, int ps, int mpp,
                    int splits, float scale, float softcap, int slices) {
  // K/V rows in shared memory with a row stride of an odd number of 32-bit
  // words, so that threads reading one row each hit distinct banks
  constexpr int ROW_WORDS = D * (int)sizeof(T) / 4 + 1;
  constexpr int EPW = 4 / (int)sizeof(T);  // elements per 32-bit word
  constexpr int CHUNKS = D * (int)sizeof(T) / 16;  // 16 B chunks per row
  constexpr int MAXOUT = (MAXG * D + NTHREADS - 1) / NTHREADS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sK = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* sV = sK + ps * ROW_WORDS;
  float* sQ = reinterpret_cast<float*>(sV + ps * ROW_WORDS);  // [rows][D]
  float* sP = sQ + rows_per_block * D;                        // [rows][ps]
  float* sM = sP + rows_per_block * ps;                       // [rows]
  float* sL = sM + rows_per_block;
  float* sA = sL + rows_per_block;
  float* sO = sA + rows_per_block;  // WIDE: the accumulators [rows][D]

  const int h = blockIdx.x, s = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the block-table row this group reads, its first row, its rows
  const int tb = shared ? 0 : WIDE ? z / slices : z;
  const int row0 = WIDE ? tb * group + (z % slices) * rows_per_block : z * rows_per_block;
  const int rows = WIDE ? min(rows_per_block, (tb + 1) * group - row0)
                        : min(rows_per_block, rows_total - row0);
  const int seq_len = sl[tb];
  const int pps = mpp / splits;

  for (int x = tid; x < rows * D; x += NTHREADS) {
    const int i = row0 + x / D;
    sQ[x] = to_f(q[((size_t)(i / group) * hq + h * group + i % group) * D + x % D]);
  }
  for (int x = tid; x < rows; x += NTHREADS) {
    sM[x] = -INFINITY;
    sL[x] = 0.f;
  }
  float acc[MAXOUT];
#pragma unroll
  for (int r = 0; r < MAXOUT; ++r) acc[r] = 0.f;
  if constexpr (WIDE)
    for (int x = tid; x < rows * D; x += NTHREADS) sO[x] = 0.f;
  __syncthreads();

  for (int p = 0; p < pps; ++p) {
    const int base = (s * pps + p) * ps;  // first position of this page
    if (base >= seq_len) break;           // pages past the sequence: not read
    const int ntok = min(ps, seq_len - base);
    const int page = bt[(size_t)tb * mpp + s * pps + p];

    const size_t row_0 = ((size_t)page * ps * hk + h) * D;  // token 0 of head h
    for (int c = tid; c < ntok * CHUNKS; c += NTHREADS) {
      const int tok = c / CHUNKS, cc = c % CHUNKS;
      const size_t off = row_0 + (size_t)tok * hk * D + cc * (16 / sizeof(T));
      const uint4 kv = *reinterpret_cast<const uint4*>(kp + off);
      const uint4 vv = *reinterpret_cast<const uint4*>(vp + off);
      uint32_t* dk = sK + tok * ROW_WORDS + cc * 4;
      uint32_t* dv = sV + tok * ROW_WORDS + cc * 4;
      dk[0] = kv.x; dk[1] = kv.y; dk[2] = kv.z; dk[3] = kv.w;
      dv[0] = vv.x; dv[1] = vv.y; dv[2] = vv.z; dv[3] = vv.w;
    }
    __syncthreads();

    // scores: one thread per token, all rows (a tile of MAXG rows at a time)
    for (int t0 = 0; t0 < rows; t0 += MAXG) {
      const int trows = rows - t0;
      const float* tq = sQ + t0 * D;
      float* tp = sP + t0 * ps;
      for (int tok = tid; tok < ntok; tok += NTHREADS) {
        float dot[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
        const T* krow = reinterpret_cast<const T*>(sK + tok * ROW_WORDS);
#pragma unroll 4
        for (int w = 0; w < D / EPW; ++w) {
          float kx[EPW];
#pragma unroll
          for (int u = 0; u < EPW; ++u) kx[u] = to_f(krow[w * EPW + u]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < trows) {
#pragma unroll
              for (int u = 0; u < EPW; ++u) dot[g] += tq[g * D + w * EPW + u] * kx[u];
            }
          }
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < trows) {
            float z = dot[g] * scale;
            if (softcap > 0.f) z = softcap * tanhf(z / softcap);
            tp[g * ps + tok] = z;
          }
        }
      }
      if constexpr (!WIDE) break;  // at most MAXG rows
    }
    __syncthreads();

    // online-softmax update, one warp per row
    for (int g = warp; g < rows; g += NWARPS) {
      float* row = sP + g * ps;
      float mcur = -INFINITY;
      for (int tok = lane; tok < ntok; tok += 32) mcur = fmaxf(mcur, row[tok]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, o));
      const float mprev = sM[g];
      const float mnew = fmaxf(mprev, mcur);
      const float msafe = mnew == -INFINITY ? 0.f : mnew;
      const float alpha = mprev == -INFINITY ? 0.f : expf(mprev - msafe);
      float lsum = 0.f;
      for (int tok = lane; tok < ntok; tok += 32) {
        const float z = row[tok];
        const float pe = z == -INFINITY ? 0.f : expf(z - msafe);
        lsum += pe;
        row[tok] = round_to((T*)nullptr, pe);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
      __syncwarp();
      if (lane == 0) {
        sM[g] = mnew;
        sL[g] = sL[g] * alpha + lsum;
        sA[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha + sum_tok p[g][tok] * V[tok][d]
    if constexpr (WIDE) {
      for (int x = tid; x < rows * D; x += NTHREADS) {
        const int g = x / D, d = x % D;
        const float* pg = sP + g * ps;
        const T* vcol = reinterpret_cast<const T*>(sV) + d;
        float a = sO[x] * sA[g];
        for (int tok = 0; tok < ntok; ++tok)
          a += pg[tok] * to_f(vcol[(size_t)tok * ROW_WORDS * EPW]);
        sO[x] = a;
      }
    } else {
#pragma unroll
      for (int r = 0; r < MAXOUT; ++r) {
        const int x = tid + r * NTHREADS;
        if (x < rows * D) {
          const int g = x / D, d = x % D;
          const float* pg = sP + g * ps;
          const T* vcol = reinterpret_cast<const T*>(sV) + d;
          float a = acc[r] * sA[g];
          for (int tok = 0; tok < ntok; ++tok)
            a += pg[tok] * to_f(vcol[(size_t)tok * ROW_WORDS * EPW]);
          acc[r] = a;
        }
      }
    }
    __syncthreads();  // before the next page overwrites sK/sV/sP
  }

  // finalize: (0, -inf) for a split with no coverage
  if constexpr (WIDE) {
    for (int x = tid; x < rows * D; x += NTHREADS) {
      const int i = row0 + x / D;
      const size_t o = ((size_t)(i / group) * splits + s) * hq + h * group + i % group;
      const float lg = sL[x / D];
      out_parts[o * D + x % D] = lg > 0.f ? sO[x] / lg : 0.f;
    }
  } else {
#pragma unroll
    for (int r = 0; r < MAXOUT; ++r) {
      const int x = tid + r * NTHREADS;
      if (x < rows * D) {
        const int i = row0 + x / D;
        const size_t o = ((size_t)(i / group) * splits + s) * hq + h * group + i % group;
        const float lg = sL[x / D];
        out_parts[o * D + x % D] = lg > 0.f ? acc[r] / lg : 0.f;
      }
    }
  }
  for (int g = tid; g < rows; g += NTHREADS) {
    const int i = row0 + g;
    const size_t o = ((size_t)(i / group) * splits + s) * hq + h * group + i % group;
    const float lg = sL[g], mg = sM[g];
    const float msafe = mg == -INFINITY ? 0.f : mg;
    lse_parts[o] = lg > 0.f ? msafe + logf(lg) : -INFINITY;
  }
}

// b rows of q (sequences, or a shared prefix's members); rows of one kv head
// in groups of at most MAXG: one sequence's G rows in flat mode (G <= MAXG;
// a larger G runs WIDE), MAXG rows across members in shared mode.
template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* bt,
                   const void* sl, void* out_parts, void* lse_parts, int b, int hq,
                   int hk, int ps, int mpp, int splits, int shared, float scale,
                   float softcap, cudaStream_t stream) {
  const int group = hq / hk;
  const bool wide = !shared && group > MAXG;
  const int slices = wide ? wide_slices(group) : 1;
  const int rows_total = b * group;
  const int rows_per_block = shared ? min(rows_total, MAXG)
                             : wide ? (group + slices - 1) / slices : group;
  const size_t row_bytes = (size_t)(D * sizeof(T) / 4 + 1) * 4;
  const size_t smem = 2 * ps * row_bytes + sizeof(float) * ((size_t)rows_per_block * D +
                                                             (size_t)rows_per_block * ps +
                                                             3 * rows_per_block +
                                                             (wide ? (size_t)rows_per_block * D
                                                                   : 0));
  auto kernel = wide ? paged_decode_kernel<T, D, true> : paged_decode_kernel<T, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = wide ? b * slices : (rows_total + rows_per_block - 1) / rows_per_block;
  dim3 grid(hk, splits, groups);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)bt, (const int*)sl,
      (float*)out_parts, (float*)lse_parts, hq, hk, group, rows_total, rows_per_block,
      shared, ps, mpp, splits, scale, softcap, slices);
  return cudaGetLastError();
}

}  // namespace decode_simt

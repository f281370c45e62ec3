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
// MAXG rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_simt {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;  // q rows a block serves

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
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ sl, float* __restrict__ out_parts,
                    float* __restrict__ lse_parts, int hq, int hk, int group,
                    int rows_total, int rows_per_block, int shared, int ps, int mpp,
                    int splits, float scale, float softcap) {
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

  const int h = blockIdx.x, s = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tb = shared ? 0 : z;  // the block-table row this group reads
  const int row0 = z * rows_per_block;
  const int rows = min(rows_per_block, rows_total - row0);
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

    // scores: one thread per token, all rows
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
          if (g < rows) {
#pragma unroll
            for (int u = 0; u < EPW; ++u) dot[g] += sQ[g * D + w * EPW + u] * kx[u];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < rows) {
          float z = dot[g] * scale;
          if (softcap > 0.f) z = softcap * tanhf(z / softcap);
          sP[g * ps + tok] = z;
        }
      }
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
    __syncthreads();  // before the next page overwrites sK/sV/sP
  }

  // finalize: (0, -inf) for a split with no coverage
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
  for (int g = tid; g < rows; g += NTHREADS) {
    const int i = row0 + g;
    const size_t o = ((size_t)(i / group) * splits + s) * hq + h * group + i % group;
    const float lg = sL[g], mg = sM[g];
    const float msafe = mg == -INFINITY ? 0.f : mg;
    lse_parts[o] = lg > 0.f ? msafe + logf(lg) : -INFINITY;
  }
}

// b rows of q (sequences, or a shared prefix's members); rows of one kv head
// in groups of at most MAXG: one sequence's G rows in flat mode (G <= MAXG),
// MAXG rows across members in shared mode.
template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* bt,
                   const void* sl, void* out_parts, void* lse_parts, int b, int hq,
                   int hk, int ps, int mpp, int splits, int shared, float scale,
                   float softcap, cudaStream_t stream) {
  const int group = hq / hk;
  if (!shared && group > MAXG) return cudaErrorInvalidValue;
  const int rows_total = b * group;
  const int rows_per_block = shared ? min(rows_total, MAXG) : group;
  const size_t row_bytes = (size_t)(D * sizeof(T) / 4 + 1) * 4;
  const size_t smem = 2 * ps * row_bytes + sizeof(float) * ((size_t)rows_per_block * D +
                                                             (size_t)rows_per_block * ps +
                                                             3 * rows_per_block);
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(hk, splits, (rows_total + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)bt, (const int*)sl,
      (float*)out_parts, (float*)lse_parts, hq, hk, group, rows_total, rows_per_block,
      shared, ps, mpp, splits, scale, softcap);
  return cudaGetLastError();
}

}  // namespace decode_simt

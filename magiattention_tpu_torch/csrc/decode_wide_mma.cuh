// The previous wide walk of paged_decode (PR 25's): a flat-mode bf16 walk
// of more than MAX_ROWS q rows as m16 row tiles of one block, one warp a
// tile, over one block-wide cp.async ring with a block barrier a chunk, the
// blocks of a cluster taking the walk's chunks in turn. No kernel of the
// port uses it since decode_wide_sm90.cuh replaced it: it is the source of
// chip_smoke.py's yardstick for that walk (``decode_wide_mma``), timed
// beside it in turns.
#pragma once

#include "decode_sm90.cuh"

namespace decode_sm90 {

// The wide walk: a flat-mode walk of more than MAX_ROWS q rows (a GQA group
// of more than 32 q heads, or a multi-query model's whole head count: G =
// 48 at StarCoder-15B's 48 q heads over 1 kv head). paged_decode_mma keeps all
// of a walk's rows in each warp's registers, which register space allows up
// to two m16 tiles; past that, one (sequence, kv head) walk runs as several
// m16 row tiles of one block, each warp one tile, over one ring of chunks
// that the block loads together (cp.async, a block barrier per chunk), so
// that each K/V chunk is read once for all the tiles' q heads. A group of
// more than WIDE_MAX_TILES tiles runs as several row slices of at most
// WIDE_MAX_TILES * 16 rows (blockIdx.z = sequence * slices + slice), each
// reading the pages once. The blocks of a cluster take the walk's chunks in
// turn, each keeping (max, sum, accumulator) per row; they merge in block
// order through distributed shared memory, as the walk above does.
constexpr int WIDE_MAX_TILES = 8;  // warps (m16 row tiles) of a wide block

// The row slices of a flat-mode group of ``group`` q rows: 1 up to
// WIDE_MAX_TILES tiles, else the fewest of at most that many tiles.
__host__ __device__ inline int wide_slices(int group) {
  return (group + WIDE_MAX_TILES * 16 - 1) / (WIDE_MAX_TILES * 16);
}

template <int D>
constexpr size_t wide_ring_bytes() {
  return sizeof(bf16) * (size_t)STAGES * stage_elems<D>();
}

template <int D>
__global__ void __launch_bounds__(WIDE_MAX_TILES * 32, 1)
paged_decode_wide(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                  const bf16* __restrict__ vp, const int* __restrict__ bt,
                  const int* __restrict__ sl, float* __restrict__ out_parts,
                  float* __restrict__ lse_parts, int hq, int hk, int group, int slices,
                  int slice_rows, int ps, int mpp, int splits, float scale, float softcap) {
  constexpr int RE = row_elems<D>();
  constexpr int DN = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* sQ = ring + STAGES * stage_elems<D>();  // [tiles * 16][RE]

  cg::cluster_group cluster = cg::this_cluster();
  const int nblk = cluster.num_blocks(), rank = cluster.block_rank();
  const int h = blockIdx.x / nblk, s = blockIdx.y;
  const int member = blockIdx.z / slices;          // the sequence (its table row)
  const int r0 = (blockIdx.z % slices) * slice_rows;  // its first q head in the group
  const int rows = min(slice_rows, group - r0);
  const int nt = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = nt / 32;
  const int pps = mpp / splits;
  const int* bt_split = bt + (size_t)member * mpp + s * pps;
  const int n = max(0, min(pps * ps, sl[member] - s * pps * ps));
  const int chunks = (n + CH - 1) / CH;  // the split's chunks of CH tokens
  const size_t qrow0 = (size_t)member * hq + h * group + r0;  // q row of the slice's row 0

  for (int x = tid; x < tiles * 16 * (D / 8); x += nt) {
    const int r = x / (D / 8), c = x % (D / 8);
    uint4 v = make_uint4(0, 0, 0, 0);  // padding rows: zeros, never written out
    if (r < rows) v = *reinterpret_cast<const uint4*>(q + (qrow0 + r) * D + c * 8);
    *reinterpret_cast<uint4*>(sQ + r * RE + c * 8) = v;
  }

  const int mine = chunks > rank ? (chunks - rank + nblk - 1) / nblk : 0;
  const size_t head_off = (size_t)h * D;
  const size_t tok_stride = (size_t)hk * D;
  // chunk j of this block (the walk's chunk rank + j nblk) into ring stage
  // j % STAGES, by every thread of the block
  auto load = [&](int j) {
    const int pos0 = (rank + j * nblk) * CH;
    bf16* sk = ring + (j % STAGES) * stage_elems<D>();
    bf16* sv = sk + CH * RE;
    for (int u = tid; u < CH * (D / 8); u += nt) {
      const int t = u / (D / 8), cc = u % (D / 8);
      const int pos = pos0 + t;
      const bool live = pos < n;
      size_t off = 0;
      if (live)
        off = ((size_t)__ldg(bt_split + pos / ps) * ps + pos % ps) * tok_stride + head_off +
              cc * 8;
      cp_async_16(sk + t * RE + cc * 8, kp + off, live);
      cp_async_16(sv + t * RE + cc * 8, vp + off, live);
    }
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < mine) load(j);
    cp_async_commit();  // one group a chunk, empty past the end: the wait count stays fixed
  }
  __syncthreads();  // sQ is written

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  uint32_t qreg[D / 16][4];  // this warp's m16 tile, held for the walk
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qreg[kk], sQ + (warp * 16 + (lane & 15)) * RE + kk * 16 + (lane >> 4) * 8);

  const int t4 = lane & 3;
  for (int j = 0; j < mine; ++j) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk j have landed
    __syncthreads();              // ... every thread's; and chunk j - 1 is read by all
    if (j + STAGES - 1 < mine) load(j + STAGES - 1);  // into the stage chunk j - 1 left
    cp_async_commit();
    const bf16* sk = ring + (j % STAGES) * stage_elems<D>();
    const bf16* sv = sk + CH * RE;
    const int live = n - (rank + j * nblk) * CH;  // live tokens of the chunk (>= 1)

    // S = Q K^T: [16 rows x 16 tokens], the even and odd k slices in two chains
    float sc[2][4] = {}, sc2[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];  // b0 b1 of tokens 0-7, b0 b1 of tokens 8-15
      ldmatrix_x4(kb, sk + ((lane & 7) + (lane >> 4) * 8) * RE + kk * 16 + ((lane >> 3) & 1) * 8);
      float (&dst)[2][4] = kk % 2 ? sc2 : sc;
      mma_bf16(dst[0], qreg[kk], kb[0], kb[1]);
      mma_bf16(dst[1], qreg[kk], kb[2], kb[3]);
    }
    // online softmax over this thread's rows lane / 4 (e = 0, 1) and
    // lane / 4 + 8 (e = 2, 3), tokens 8 jn + 2 t4 (+1)
    float alpha[2];
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float zz = (sc[jn][e] + sc2[jn][e]) * scale;
        if (softcap > 0.f) zz = softcap * tanhf(zz / softcap);
        sc[jn][e] = 8 * jn + 2 * t4 + (e & 1) < live ? zz : -INFINITY;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]), fmaxf(sc[1][2 * r], sc[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[r], mx);
      const float msafe = mnew == -INFINITY ? 0.f : mnew;
      alpha[r] = m[r] == -INFINITY ? 0.f : __expf(m[r] - msafe);
      m[r] = mnew;
      float ls = 0.f;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float zz = sc[jn][e];
          const float p = zz == -INFINITY ? 0.f : __expf(zz - msafe);
          ls += p;  // l over the unrounded p
          sc[jn][e] = p;
        }
      l[r] = l[r] * alpha[r] + ls;  // this thread's share; the quad sums at the end
    }
    // p rounded to bf16: the A fragment of P.V over the chunk's 16 tokens
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    // O += P V: V's rows are the k dimension, read transposed
#pragma unroll
    for (int dn = 0; dn < DN; dn += 2) {
      uint32_t vb[4];  // b0 b1 of columns 8 dn.., b0 b1 of columns 8 dn + 8..
      ldmatrix_x4_trans(vb, sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * RE + dn * 8 +
                                (lane >> 4) * 8);
      mma_bf16(acc[dn], pa, vb[0], vb[1]);
      mma_bf16(acc[dn + 1], pa, vb[2], vb[3]);
    }
  }

  // this warp's rows: the quad's sums of l; a lone block writes the split's
  // result, a cluster's blocks put their partials in shared memory (the ring
  // and the q rows are free now) and merge them in block order
  cp_async_wait<0>();
  __syncthreads();
  const int rows_b = tiles * 16;
  float* part = reinterpret_cast<float*>(smem);  // max [rows_b], sum [rows_b], acc [rows_b][D]
  const int g = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = warp * 16 + g + 8 * r;
    if (nblk > 1) {
      if (t4 == 0) {
        part[row] = m[r];
        part[rows_b + row] = lt;
      }
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        part[2 * rows_b + row * D + dn * 8 + 2 * t4] = acc[dn][2 * r];
        part[2 * rows_b + row * D + dn * 8 + 2 * t4 + 1] = acc[dn][2 * r + 1];
      }
      continue;
    }
    if (row >= rows) continue;
    const size_t orow = ((size_t)member * splits + s) * hq + h * group + r0 + row;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      out_parts[orow * D + dn * 8 + 2 * t4] = lt > 0.f ? acc[dn][2 * r] * inv : 0.f;
      out_parts[orow * D + dn * 8 + 2 * t4 + 1] = lt > 0.f ? acc[dn][2 * r + 1] * inv : 0.f;
    }
    if (t4 == 0) {
      const float msafe = m[r] == -INFINITY ? 0.f : m[r];
      lse_parts[orow] = lt > 0.f ? msafe + logf(lt) : -INFINITY;
    }
  }
  if (nblk == 1) return;

  cluster.sync();
  for (int x = rank * nt + tid; x < rows * (D + 1); x += nblk * nt) {
    const int r = x / (D + 1), d = x % (D + 1);  // d == D: the row's lse
    float mmax = -INFINITY;
    for (int b = 0; b < nblk; ++b) mmax = fmaxf(mmax, cluster.map_shared_rank(part, b)[r]);
    const float msafe = mmax == -INFINITY ? 0.f : mmax;
    float lsum = 0.f, o = 0.f;
    for (int b = 0; b < nblk; ++b) {
      const float* bp = cluster.map_shared_rank(part, b);
      const float e = bp[r] == -INFINITY ? 0.f : __expf(bp[r] - msafe);
      lsum += e * bp[rows_b + r];
      if (d < D) o += e * bp[2 * rows_b + r * D + d];
    }
    const size_t orow = ((size_t)member * splits + s) * hq + h * group + r0 + r;
    if (d < D)
      out_parts[orow * D + d] = lsum > 0.f ? o / lsum : 0.f;
    else
      lse_parts[orow] = lsum > 0.f ? msafe + logf(lsum) : -INFINITY;
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// The blocks of a wide walk's cluster: up to MAX_CLUSTER, the fewest that
// give every SM a block, as long as each block keeps a ring's worth of
// chunks at the split's full length.
inline int wide_cluster_blocks(int walks, int split_tokens) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int c = 1;
  while (c < MAX_CLUSTER && c * walks < sms) c *= 2;
  while (c > 1 && split_tokens < STAGES * CH * c) c /= 2;
  return c;
}

template <int D>
cudaError_t launch_wide(const bf16* q, const bf16* kp, const bf16* vp, const int* bt,
                        const int* sl, float* out_parts, float* lse_parts, int b, int hq,
                        int hk, int ps, int mpp, int splits, int cluster_heads, float scale,
                        float softcap, cudaStream_t stream) {
  const int group = hq / hk;
  const int slices = wide_slices(group);
  const int slice_rows = (group + slices - 1) / slices;
  const int tiles = (slice_rows + 15) / 16;
  const size_t merge = sizeof(float) * (size_t)tiles * 16 * (2 + D);
  const size_t smem = std::max(wide_ring_bytes<D>() + sizeof(bf16) * tiles * 16 * row_elems<D>(),
                               merge);
  auto kernel = paged_decode_wide<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = b * slices;
  const int c = wide_cluster_blocks(cluster_heads * splits * groups, mpp / splits * ps);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hk * c, splits, groups);
  cfg.blockDim = dim3(tiles * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, q, kp, vp, bt, sl, out_parts, lse_parts, hq, hk, group,
                            slices, slice_rows, ps, mpp, splits, scale, softcap);
}

}  // namespace decode_sm90

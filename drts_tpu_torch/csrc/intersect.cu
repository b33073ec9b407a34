// Ray-sphere kernels for sphere scenes on Hopper (sm_90a).
//
// drts_morton_closest_hit replaces the TPU kernel
// drts_tpu/ops/intersect_pallas.py:intersect_morton_planar (B1),
// drts_brute_closest_hit replaces intersect_spheres_planar (B11) and
// drts_morton_occlusion replaces occlusion_morton_planar (B2). All are
// bound to PyTorch through a plain C interface and ctypes
// (drts_tpu_torch/ops/intersect_kernels.py holds the wrappers and the plain
// PyTorch versions they are checked against).
//
// Design: one thread per ray. Rays arrive planar, (8, N) float32
// [ox oy oz dx dy dz tmin tmax], so each row load is coalesced. The sphere
// table goes through shared memory as float4 pairs; every thread of a warp
// reads the same column at once, a shared-memory broadcast. The per-pair
// work is ~25 float operations and one IEEE sqrt, against 32 bytes read
// from the ray and 4 or 8 written, so the sweeps are bound by instruction
// issue (FP32 and the sqrt sequence), not by device-memory bandwidth.
// B11 has no accel to cull by: it skips dead blocks, rows of radius 0 and
// the root of every row the ray misses. B1 and B2 stage the Morton table in
// tiles of whole chunks with the chunk bounds of the Morton accel, and
// cull chunks per lane (see their notes below); no skip or cull changes a
// bit of the result.
//
// Numbers: built with -fmad=false and without --use_fast_math. Every
// multiply and add rounds on its own, in the order the plain PyTorch
// versions use, so the kernels equal them bit for bit. The unguarded
// sqrtf of a negative discriminant in the Morton kernels gives NaN, which
// fails both range compares, as the TPU kernel relies on.

#include <cuda_runtime.h>

#include "rays.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // B11's sphere tile
constexpr int kInfBits = 0x7F800000;  // bit pattern of +inf: packed miss

// The Morton table of B1 and B2: (9, cols) planar
// [cx cy cz r obj -2cx -2cy -2cz |c|^2-r^2], empty slots at
// |c|^2-r^2 = 1e30; bounds: (5, n_chunks) planar [cx cy cz r count], one
// bounding sphere per chunk of `chunk` consecutive columns and the number
// of its filled slots, which come first (clusters.make_morton_accel).
//
// Staging: each block stages the table into dynamic shared memory in
// tiles of whole chunks, at most kTileBytes each, per column two float4s
// [cx cy cz obj] [-2c |c|^2-r^2] and per chunk its bound and count; the
// block-wide barriers around each tile are joined by every thread,
// finished or dead ones too. The demo scene's 480 columns (~15 KB) are
// one tile. The object id goes in as its int bits for B1's packed min and
// as a float for B2's compare with the ray's excluded id.
//
// An empty slot has |c|^2-r^2 = 1e30, and b2^2 - c2 < 0 for every ray
// while |o| + |c| < 1e14, so sweeping only the filled slots is exact.
constexpr size_t kTileBytes = 48 * 1024;  // no opt-in above the default
constexpr int kGroup = 4;  // B2's slots tested together before its exit

template <bool kObjBits>
__device__ __forceinline__ void stage_chunks(
    const float* __restrict__ table, int cols,
    const float* __restrict__ bounds, int n_chunks, int chunk, int k0,
    int m, float scale, float4* s_lin, float4* s_quad, float4* s_bnd,
    int* s_cnt) {
  const int c0 = k0 * chunk;
  for (int c = threadIdx.x; c < m * chunk; c += blockDim.x) {
    const int col = c0 + c;
    const float obj = table[4 * cols + col];
    s_lin[c] = make_float4(table[0 * cols + col], table[1 * cols + col],
                           table[2 * cols + col],
                           kObjBits ? __int_as_float((int)obj) : obj);
    s_quad[c] = make_float4(table[5 * cols + col], table[6 * cols + col],
                            table[7 * cols + col], table[8 * cols + col]);
  }
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const int kk = k0 + k;
    s_bnd[k] = cull_sphere(bounds[0 * n_chunks + kk],
                           bounds[1 * n_chunks + kk],
                           bounds[2 * n_chunks + kk],
                           bounds[3 * n_chunks + kk], scale);
    s_cnt[k] = min(max((int)bounds[4 * n_chunks + kk], 0), chunk);
  }
}

// Shared-memory layout of one tile of `tile` chunks.
struct ChunkTile {
  float4* lin;
  float4* quad;
  float4* bnd;
  int* cnt;
};

__device__ __forceinline__ ChunkTile chunk_tile(float4* s_mem, int tile,
                                                int chunk) {
  ChunkTile t;
  t.lin = s_mem;
  t.quad = t.lin + tile * chunk;
  t.bnd = t.quad + tile * chunk;
  t.cnt = reinterpret_cast<int*>(t.bnd + tile);
  return t;
}

// B1: closest hit over the Morton table. The result per ray is the min of
// the packed word (t bits with the low pos_bits replaced by the object
// id), unpacked into t (truncated down) and the object id.
//
// Design: per lane and in table order (chunks sorted near to far from the
// camera), a chunk is skipped when the ray's segment [tmin, t_end] passes
// farther from the chunk's bound than lim, and only a met chunk's filled
// slots are swept; a warp runs a chunk's sweep while any of its lanes
// meets it. t_end starts at tmax; after each met chunk whose sweep left a
// hit in the packed best, t_end = min(tmax, top(best)), where top(best) is
// the largest float whose truncated bits equal the best's. The packed
// winner w has (t_w & trunc) <= (best & trunc) for every best the lane
// holds on the way, so t_w <= top(best) and its chunk is never skipped; a
// sphere beyond top(best) truncates to a larger key and cannot win, not
// even on a tie of truncated t. (The truncated t itself as segment end
// would drop a tie that a lower object id wins.)
//
// The cull and its margin, which holds on a half-line (tmax = +inf), are
// in csrc/rays.cuh, shared with B5; the caller passes scale =
// ops/intersect_kernels.py:CULL_SCALE, which states the rounding part.
// A pair whose discriminant is negative misses; the lane skips its root
// and range tests (the plain version's NaN root fails them: the same
// result). Most swept pairs miss, and neighbouring lanes miss the same
// spheres. Bound by instruction issue: ~16 float operations per pair
// swept, ~11 more and one sqrt where the discriminant is not negative,
// ~30 per chunk tested. (Measured on an H100, PERF.md: the root skip
// halved the primary batch's time, 0.60 -> 0.33 ms.)
__global__ void __launch_bounds__(kThreads)
morton_closest_hit(const float* __restrict__ rays, int n,
                   const float* __restrict__ table, int cols,
                   const float* __restrict__ bounds, int n_chunks, int chunk,
                   int tile_chunks, float scale, int pos_bits,
                   float* __restrict__ t_out, int* __restrict__ obj_out) {
  extern __shared__ float4 s_mem[];
  const ChunkTile s = chunk_tile(s_mem, tile_chunks, chunk);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  if (i < n) r = load_ray(rays, n, i);
  const bool live = i < n && r.tmax >= r.tmin;
  const int trunc = ~((1 << pos_bits) - 1);
  float od = 0.f, oo = 0.f;
  SegmentCull cull = {0.f, 0.f, 0.f};
  if (live) {
    od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
    oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
    cull = segment_cull(r, scale);
  }
  int best = kInfBits;
  float t_end = r.tmax;
  for (int k0 = 0; k0 < n_chunks; k0 += tile_chunks) {
    const int m = min(tile_chunks, n_chunks - k0);
    __syncthreads();
    stage_chunks<true>(table, cols, bounds, n_chunks, chunk, k0, m, scale,
                       s.lin, s.quad, s.bnd, s.cnt);
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < m; ++k) {
      if (segment_misses(cull, r, t_end, s.bnd[k])) continue;
      const int c0 = k * chunk, end = c0 + s.cnt[k];
#pragma unroll 4
      for (int c = c0; c < end; ++c) {
        const float4 a = s.lin[c];
        const float4 q = s.quad[c];
        const float b2 = od - (a.x * r.dx + a.y * r.dy + a.z * r.dz);
        const float c2 = oo + (q.x * r.ox + q.y * r.oy + q.z * r.oz) + q.w;
        const float disc = b2 * b2 - c2;
        if (disc < 0.f) continue;  // a miss: its NaN root would fail
        const float sq = sqrtf(disc);
        const float t_near = -b2 - sq;
        const float t = t_near >= r.tmin ? t_near : sq - b2;
        if (t >= r.tmin && t <= r.tmax) {
          best = min(best, (__float_as_int(t) & trunc) | __float_as_int(a.w));
        }
      }
      if (best >= 0 && best < kInfBits) {
        t_end = fminf(r.tmax, __int_as_float((best & trunc) | ~trunc));
      }
    }
  }
  if (i < n) {
    t_out[i] = __int_as_float(best & trunc);
    obj_out[i] = best & ~trunc;
  }
}

// B11. spheres: (4, k) planar [cx cy cz r], padded with r = 0. The
// smallest t wins; on ties the lowest sphere index (strict <, ascending).
//
// Design: a dead lane reads its tmin and tmax only, and a block with no
// live lane leaves before it reads the table (the TPU kernel's dead-block
// skip). The others stage the table in tiles of
// kTile columns, compacted: only the rows with r > 0 (the plain version's
// `valid` needs r > 0), in index order, as (cx cy cz |c|^2-r^2) and the
// index, so a light table whose unused rows are zeroed is swept only over
// its lights. A live lane sweeps the staged rows kB11Group at a time: the
// group's discriminants first, so its shared-memory loads and arithmetic
// overlap, then in index order the root, the range test and the compare of
// each row whose discriminant is positive (`valid` needs disc > 0, so a
// row with disc <= 0 needs no root: the same result). Most rows miss, and
// neighbouring lanes miss the same rows. Bound by instruction issue: ~17
// float operations per row swept, ~11 more and one sqrt per positive
// discriminant.
constexpr int kB11Group = 8;

// Stage columns [base, base + m) of the sphere table into s_sph / s_idx,
// keeping the rows with r > 0 in index order; returns how many were kept
// (the same on every thread). Every thread of the block calls it; its
// first barrier comes before any write to s_sph or s_idx, so the tile
// before it has been swept by then.
__device__ __forceinline__ int stage_live_spheres(
    const float* __restrict__ spheres, int k, int base, int m, float4* s_sph,
    int* s_idx, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int kept = 0;
  for (int c0 = 0; c0 < m; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    float cx = 0.f, cy = 0.f, cz = 0.f, rad = 0.f;
    if (c < m) {
      cx = spheres[0 * k + base + c];
      cy = spheres[1 * k + base + c];
      cz = spheres[2 * k + base + c];
      rad = spheres[3 * k + base + c];
    }
    const bool keep = c < m && rad > 0.f;
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int at = kept, round = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      at += w < warp ? s_warp[w] : 0;
      round += s_warp[w];
    }
    if (keep) {
      at += __popc(mask & ((1u << lane) - 1u));
      s_sph[at] = make_float4(cx, cy, cz, cx * cx + cy * cy + cz * cz -
                                              rad * rad);
      s_idx[at] = base + c;
    }
    kept += round;
    __syncthreads();  // s_warp is read before the next round writes it
  }
  return kept;
}

// One ray x staged row of B11: the discriminant, and b through `b_out`.
__device__ __forceinline__ float brute_disc(const float4 s, const Ray& r,
                                            float od, float oo,
                                            float* b_out) {
  const float b = od - (s.x * r.dx + s.y * r.dy + s.z * r.dz);
  const float c0 = oo - 2.0f * (s.x * r.ox + s.y * r.oy + s.z * r.oz) + s.w;
  *b_out = b;
  return b * b - c0;
}

// The root of a row with disc > 0, folded into the lane's best.
__device__ __forceinline__ void brute_fold(float b, float disc, int idx,
                                           const Ray& r, float* best_t,
                                           int* best_i) {
  const float sq = sqrtf(disc);
  const float t_near = -b - sq;
  const float t = t_near >= r.tmin ? t_near : -b + sq;
  if (t >= r.tmin && t <= r.tmax && t < *best_t) {
    *best_t = t;
    *best_i = idx;
  }
}

__global__ void __launch_bounds__(kThreads)
brute_closest_hit(const float* __restrict__ rays, int n,
                  const float* __restrict__ spheres, int k,
                  float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float4 s_sph[kTile];  // cx cy cz |c|^2-r^2, rows with r > 0
  __shared__ int s_idx[kTile];     // their sphere indices
  __shared__ int s_warp[kThreads / 32];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  Ray r;
  const bool live = load_live_ray(rays, n, i, &r);
  float best_t = __int_as_float(kInfBits);
  int best_i = 0;
  if (__syncthreads_or(live)) {
    const float od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
    const float oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
    for (int base = 0; base < k; base += kTile) {
      const int cnt = stage_live_spheres(spheres, k, base,
                                         min(kTile, k - base), s_sph, s_idx,
                                         s_warp);
      if (!live) continue;
      int c = 0;
      for (; c + kB11Group <= cnt; c += kB11Group) {
        float b[kB11Group], disc[kB11Group];
#pragma unroll
        for (int u = 0; u < kB11Group; ++u) {
          disc[u] = brute_disc(s_sph[c + u], r, od, oo, &b[u]);
        }
#pragma unroll
        for (int u = 0; u < kB11Group; ++u) {
          if (disc[u] > 0.f) {
            brute_fold(b[u], disc[u], s_idx[c + u], r, &best_t, &best_i);
          }
        }
      }
      for (; c < cnt; ++c) {
        float b;
        const float disc = brute_disc(s_sph[c], r, od, oo, &b);
        if (disc > 0.f) brute_fold(b, disc, s_idx[c], r, &best_t, &best_i);
      }
    }
  }
  if (in_range) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
  }
}

// B2. rays: (9, n) planar [ox oy oz dx dy dz tmin tmax exclude_obj];
// table and bounds as B1's. A ray is blocked when any column has t in
// [tmin, tmax] and an object id other than the ray's excluded one (-1
// excludes nothing).
//
// Design: one thread per shadow ray over the staged tiles. Per lane and
// in table order, a chunk is skipped when the ray's segment passes farther
// than the chunk's bound (the per-lane form of the TPU kernel's per-block
// cone and range culls), only its filled slots are swept, kGroup at a
// time, and the lane leaves after the group that holds its first blocker;
// a warp runs a chunk's sweep while any of its lanes needs it. Bound by
// instruction issue: ~22 float operations and one sqrt per pair swept, 25
// per chunk tested. (Measured on an H100: a grid of one block per 256 rays
// beat a grid of resident blocks walking the rays with a stride, whose
// last warps ran alone, and groups of four slots beat one at a time;
// PERF.md.)
//
// The cull never skips a chunk that holds a blocker, so the result equals
// the unculled sweep bit for bit. With v = C - o and the segment's nearest
// point s = clamp(v.d / d.d, tmin, tmax), the chunk is skipped when
// |v - s d|^2 > lim^2, lim = R + scale (|C|_1 + R + |o|_1 + T)
// + T sqrt(|d.d - 1|), T = max(|tmin|, |tmax|). Two margins:
// - R holds refit's 0.25 slack, which covers motion between refits;
// - scale covers rounding: the caller passes
//   ops/intersect_kernels.py:CULL_SCALE, which states its derivation.
//   The quadratic takes d as a unit vector; T sqrt(|d.d-1|) covers the
//   distance a non-unit d adds to a root's point, and outside d.d in
//   [0.5, 2] no chunk is skipped.
// Non-finite inputs make lim infinite or the compare false: no skip.

// One ray x table column of B2: t in [tmin, tmax] and another object.
__device__ __forceinline__ bool pair_blocks(const float4 a, const float4 q,
                                            const Ray& r, float od, float oo,
                                            float exclude) {
  const float b2 = od - (a.x * r.dx + a.y * r.dy + a.z * r.dz);
  const float c2 = oo + (q.x * r.ox + q.y * r.oy + q.z * r.oz) + q.w;
  const float sq = sqrtf(b2 * b2 - c2);  // NaN when the ray misses
  const float t_near = -b2 - sq;
  const float t = t_near >= r.tmin ? t_near : sq - b2;
  return t >= r.tmin && t <= r.tmax && a.w != exclude;
}

__global__ void __launch_bounds__(kThreads)
morton_occlusion(const float* __restrict__ rays, int n,
                 const float* __restrict__ table, int cols,
                 const float* __restrict__ bounds, int n_chunks, int chunk,
                 int tile_chunks, float scale,
                 unsigned char* __restrict__ occ_out) {
  extern __shared__ float4 s_mem[];
  const ChunkTile st = chunk_tile(s_mem, tile_chunks, chunk);
  float4* s_lin = st.lin;
  float4* s_quad = st.quad;
  float4* s_bnd = st.bnd;
  int* s_cnt = st.cnt;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  if (i < n) r = load_ray(rays, n, i);
  bool open = i < n && r.tmax >= r.tmin;  // live and not yet blocked
  float exclude = 0.f, od = 0.f, oo = 0.f, inv_dd = 0.f, m_r = 0.f;
  if (open) {
    exclude = rays[8 * (size_t)n + i];
    od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
    oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
    const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    const float o1 = fabsf(r.ox) + fabsf(r.oy) + fabsf(r.oz);
    const float big_t = fmaxf(fabsf(r.tmin), fabsf(r.tmax));
    m_r = dd >= 0.5f && dd <= 2.0f
              ? big_t * sqrtf(fabsf(dd - 1.0f)) + scale * (o1 + big_t)
              : __int_as_float(kInfBits);
    inv_dd = 1.0f / dd;
  }
  bool blocked = false;
  for (int k0 = 0; k0 < n_chunks; k0 += tile_chunks) {
    const int m = min(tile_chunks, n_chunks - k0);
    __syncthreads();
    stage_chunks<false>(table, cols, bounds, n_chunks, chunk, k0, m, scale,
                        s_lin, s_quad, s_bnd, s_cnt);
    __syncthreads();
    for (int k = 0; open && k < m; ++k) {
      const float4 b = s_bnd[k];
      const float vx = b.x - r.ox, vy = b.y - r.oy, vz = b.z - r.oz;
      const float vd = vx * r.dx + vy * r.dy + vz * r.dz;
      const float s = fminf(fmaxf(vd * inv_dd, r.tmin), r.tmax);
      const float wx = vx - s * r.dx, wy = vy - s * r.dy, wz = vz - s * r.dz;
      const float lim = b.w + m_r;
      if (wx * wx + wy * wy + wz * wz > lim * lim) continue;
      int c = k * chunk;
      const int end = c + s_cnt[k];
      for (; c + kGroup <= end; c += kGroup) {
        bool hit = false;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          hit |= pair_blocks(s_lin[c + u], s_quad[c + u], r, od, oo,
                             exclude);
        }
        if (hit) {
          blocked = true;
          open = false;
          break;
        }
      }
      for (; open && c < end; ++c) {
        if (pair_blocks(s_lin[c], s_quad[c], r, od, oo, exclude)) {
          blocked = true;
          open = false;
        }
      }
    }
  }
  if (i < n) occ_out[i] = blocked;
}

inline int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

// Chunks per shared-memory tile of the Morton kernels, and its bytes;
// false where the bounds do not divide the table or no chunk fits.
bool morton_tile(int cols, int n_chunks, int* chunk, int* tile,
                 size_t* smem) {
  if (n_chunks <= 0 || cols % n_chunks != 0) return false;
  *chunk = cols / n_chunks;
  const size_t per_chunk = 2 * sizeof(float4) * *chunk + sizeof(float4) +
                           sizeof(int);
  *tile = min(n_chunks, (int)(kTileBytes / per_chunk));
  *smem = per_chunk * *tile;
  return *tile >= 1;
}

}  // namespace

// scale: the cull's rounding margin, relative to |o|_1 + |C|_1 + R + T
// (B2) or |o|_1 + |C|_1 + R + |t| (B1).
extern "C" int drts_morton_closest_hit(const float* rays, int n,
                                       const float* table, int cols,
                                       const float* bounds, int n_chunks,
                                       float scale, int pos_bits,
                                       float* t_out, int* obj_out,
                                       cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int chunk, tile;
  size_t smem;
  if (!morton_tile(cols, n_chunks, &chunk, &tile, &smem)) {
    return cudaErrorInvalidValue;
  }
  morton_closest_hit<<<grid_for(n), kThreads, smem, stream>>>(
      rays, n, table, cols, bounds, n_chunks, chunk, tile, scale, pos_bits,
      t_out, obj_out);
  return (int)cudaGetLastError();
}

extern "C" int drts_brute_closest_hit(const float* rays, int n,
                                      const float* spheres, int k,
                                      float* t_out, int* idx_out,
                                      cudaStream_t stream) {
  if (n > 0) {
    brute_closest_hit<<<grid_for(n), kThreads, 0, stream>>>(
        rays, n, spheres, k, t_out, idx_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int drts_morton_occlusion(const float* rays, int n,
                                     const float* table, int cols,
                                     const float* bounds, int n_chunks,
                                     float scale, unsigned char* occ_out,
                                     cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int chunk, tile;
  size_t smem;
  if (!morton_tile(cols, n_chunks, &chunk, &tile, &smem)) {
    return cudaErrorInvalidValue;
  }
  morton_occlusion<<<grid_for(n), kThreads, smem, stream>>>(
      rays, n, table, cols, bounds, n_chunks, chunk, tile, scale, occ_out);
  return (int)cudaGetLastError();
}

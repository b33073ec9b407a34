// Ray-sphere kernels for sphere scenes on Hopper (sm_90a).
//
// drts_morton_closest_hit replaces the TPU kernel
// drts_tpu/ops/intersect_pallas.py:intersect_morton_planar (B1),
// drts_brute_closest_hit replaces intersect_spheres_planar (B11),
// drts_morton_occlusion replaces occlusion_morton_planar (B2),
// drts_morton_mxu_closest_hit and drts_morton_mxu_occlusion replace
// intersect_morton_mxu (B12a) and occlusion_morton_mxu (B12b), and
// drts_clustered_closest_hit replaces intersect_clustered_planar (B13).
// All are bound to PyTorch through a plain C interface and ctypes
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
// versions use, so the kernels equal them bit for bit (B12a and B12b but
// for the tensor cores' sums, see their note). The unguarded sqrtf of a
// negative discriminant in the Morton kernels gives NaN, which fails both
// range compares, as the TPU kernel relies on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

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
// kTileBytes: the tile of the tiled loops. A launch above the default
// 48 KB of dynamic shared memory (B12a's tile with its exchange rows, a
// resident image) raises the kernel's limit in persistent_grid.
constexpr size_t kTileBytes = 48 * 1024;
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

// The closest-hit tail of the Morton kernels (B1, B12a;
// intersect_pallas._slim_tail) for one pair: fold the packed word
// (truncated t bits | obj) of a root in [tmin, tmax] into *best. A pair
// whose discriminant is negative misses and takes no root (the plain
// version's NaN root fails the range test: the same result).
__device__ __forceinline__ void fold_packed(float b2, float c2, float tmin,
                                            float tmax, int obj, int trunc,
                                            int* best) {
  const float disc = b2 * b2 - c2;
  if (disc < 0.f) return;
  const float sq = sqrtf(disc);
  const float t_near = -b2 - sq;
  const float t = t_near >= tmin ? t_near : sq - b2;
  if (t >= tmin && t <= tmax) {
    *best = min(*best, (__float_as_int(t) & trunc) | obj);
  }
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
        fold_packed(b2, c2, r.tmin, r.tmax, __float_as_int(a.w), trunc,
                    &best);
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

// The any-hit test of the Morton kernels (B2, B12b) for one pair: the
// root (near, else far) in [tmin, tmax] and an object other than the
// excluded one.
__device__ __forceinline__ bool root_blocks(float b2, float c2, float tmin,
                                            float tmax, float obj,
                                            float exclude) {
  const float sq = sqrtf(b2 * b2 - c2);  // NaN when the ray misses
  const float t_near = -b2 - sq;
  const float t = t_near >= tmin ? t_near : sq - b2;
  return t >= tmin && t <= tmax && obj != exclude;
}

// One ray x table column of B2.
__device__ __forceinline__ bool pair_blocks(const float4 a, const float4 q,
                                            const Ray& r, float od, float oo,
                                            float exclude) {
  const float b2 = od - (a.x * r.dx + a.y * r.dy + a.z * r.dz);
  const float c2 = oo + (q.x * r.ox + q.y * r.oy + q.z * r.oz) + q.w;
  return root_blocks(b2, c2, r.tmin, r.tmax, a.w, exclude);
}

// B2's chunk test on a lane's segment [tmin, tmax] (see the note above):
// the per-lane terms, and true where the lane skips the chunk.
struct RangeCull {
  float inv_dd, m_r;
};

__device__ __forceinline__ RangeCull range_cull(const Ray& r, float scale) {
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float o1 = fabsf(r.ox) + fabsf(r.oy) + fabsf(r.oz);
  const float big_t = fmaxf(fabsf(r.tmin), fabsf(r.tmax));
  RangeCull c;
  c.m_r = dd >= 0.5f && dd <= 2.0f
              ? big_t * sqrtf(fabsf(dd - 1.0f)) + scale * (o1 + big_t)
              : __int_as_float(kInfBits);
  c.inv_dd = 1.0f / dd;
  return c;
}

__device__ __forceinline__ bool range_misses(const RangeCull& c,
                                             const Ray& r, float4 b) {
  const float vx = b.x - r.ox, vy = b.y - r.oy, vz = b.z - r.oz;
  const float vd = vx * r.dx + vy * r.dy + vz * r.dz;
  const float s = fminf(fmaxf(vd * c.inv_dd, r.tmin), r.tmax);
  const float wx = vx - s * r.dx, wy = vy - s * r.dy, wz = vz - s * r.dz;
  const float lim = b.w + c.m_r;
  return wx * wx + wy * wy + wz * wz > lim * lim;
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
  float exclude = 0.f, od = 0.f, oo = 0.f;
  RangeCull cull = {0.f, 0.f};
  if (open) {
    exclude = rays[8 * (size_t)n + i];
    od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
    oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
    cull = range_cull(r, scale);
  }
  bool blocked = false;
  for (int k0 = 0; k0 < n_chunks; k0 += tile_chunks) {
    const int m = min(tile_chunks, n_chunks - k0);
    __syncthreads();
    stage_chunks<false>(table, cols, bounds, n_chunks, chunk, k0, m, scale,
                        s_lin, s_quad, s_bnd, s_cnt);
    __syncthreads();
    for (int k = 0; open && k < m; ++k) {
      if (range_misses(cull, r, s_bnd[k])) continue;
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


// B12a and B12b: B1's and B2's functions with the quadratic's b and
// c0 - |o|^2 from a rank-8 product on the tensor cores. Per chunk the
// A-matrix (2*chunk, 8) [b rows; c rows] (clusters.make_mxu_tables) times
// the rays' X = [dx dy dz ox oy oz od 1] gives Y; b2 = Y_b and
// c2 = Y_c + |o|^2. The product runs at the reference's DRTS_MXU_PREC
// (ops/intersect_kernels.py: MXU_PARTS, MXU_PRODUCTS), each kernel a
// template on the number P of bf16 parts that each operand splits into
// (__float2bfloat16_rn, as intersect_pallas._mxu_dot's casts; each part
// rounds what the ones before it leave, x - hi and x - hi - mid, exact in
// float32):
//
//   P = 1, "default":  hi.hi, one mma.
//   P = 2, "high":     (hi.hi + hi.lo) + lo.hi, three mmas.
//   P = 3, "highest":  ((((lo.hi + hi.lo) + mid.mid) + mid.hi) + hi.mid)
//                      + hi.hi, six mmas (mid.lo, lo.mid, lo.lo dropped).
//
// Design: mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate), a warp per
// 32 rays. The reference's K = 8 fills half of the mma's K = 16: each
// product takes its A part in K-slots 0-7 or 8-15, zero in the other
// eight, against a B operand that holds the matching X part there
// (mxu_tile_product), each into a zeroed accumulator, and the CUDA cores
// add the products in float32 in the plain version's order. A 16-row tile
// holds the b rows of 8 spheres (rows 0-7) and their c rows (rows 8-15),
// so the thread that holds b of sphere g for a ray in its C fragment
// (c0, c1: row g) also holds its c (c2, c3: row g + 8): the tail needs no
// shuffle at any chunk size, and a chunk that is not a multiple of 8
// sphere slots is padded in shared memory with slots that never hit (b
// rows 0, c rows |c|^2 - r^2 = 1e30). The staging splits the table's
// A-matrices into per-thread fragments in shared memory (B12b: once per
// block; B12a: once per persistent block, see its note): per slot and per
// thread-in-group t (k = 2t, 2t+1) the P parts as packed bf16 pairs of
// the b and c rows (MxuParts<P>::Frag: 8, 16 or 24 bytes).
//
// Lane L owns ray warp_base + L for the loads, the cull and the result.
// The four 8-ray tiles of the warp's 32 rays are laid out so that column
// c of tile j is the ray of lane (2j + (c & 1)) * 4 + (c >> 1): the lane
// (g, t) that holds columns 2t and 2t + 1 of tile j in its C fragment
// holds rays of lanes (2j + e) * 4 + t. B12b votes one ballot per (tile,
// column), which leaves each ray's result in its owner lane; B12a hands
// each pair to its ray's lane through shared memory (its note below).
//
// The tail runs on the CUDA cores: B12a's is B1's slim tail (the packed
// (t bits & trunc) | obj, min over the pairs), B12b's _anyhit_mxu_kernel's
// (unguarded sqrt, near root else far, blocked in [tmin, tmax] and not the
// excluded object). Chunks are culled per warp: each owner lane tests
// the chunk's bound as B1 (B12a: the half-line segment ending at its best)
// or B2 (B12b: the segment [tmin, tmax]) does, with the caller's margin
// (ops/intersect_kernels.py: MXU_CULL_SCALE, per precision, which covers
// the product's rounding; infinite at "default", whose margin would cut
// next to nothing), and the warp sweeps the chunk's filled slots, in
// groups of 8, where any lane meets it. Every lane folds a swept chunk's
// pairs, so a result differs from the unculled sweep only where a whole
// warp culls a chunk. B12b's warp leaves once none of its lanes is open.
//
// Numbers: each mma sums its 8 products in an order and with roundings
// that IEEE does not specify, so each product can differ from the plain
// version's float32 matmul by about an ulp of its terms; the products are
// added in the plain version's order on the CUDA cores. (Measured on an
// H100 against the float64 sum of the same halves: a K = 8 sum on the
// tensor cores within 2^-23.1 of sum |a||x|, cuBLAS's float32 within
// 2^-23.0; one mma for hi.hi + hi.lo with lo.hi accumulated into it within
// 2^-21.9, and it flipped 65 of 300,001 random rays against the plain
// version where these sums flip none; PERF.md.) The kernels are
// held to their plain versions with a stated tolerance
// (tests/test_torch_cuda.py, chip_smoke.py phase 24), not bit for bit: the
// split itself lies off the exact product (up to ~2^-14 of sum |a||x| at
// "high", ~2^-7 at "default", ~2^-23 at "highest"), on both sides alike,
// which can move the discriminant of a ray that misses its sphere to about
// zero, where a float32-grade difference of the sums decides the hit.
// Bound: per swept (ray, slot) each mma issues 32 MACs (64 flops, half on
// zero K-slots; ~0.065 ps at the dense bf16 rate of 989 TFLOP/s), P = 1, 2,
// 3 giving 1, 3, 6 mmas, and the tail ~12 float operations (~0.36 ps at
// 33.5e12 a second): by those rates the tail's float32 issue would limit
// the kernels. Measured on an H100, the mma.sync chain does instead: on
// the demo frame's primary rays with the cull off, B12a's products (then
// two mmas) alone took 0.50 ms of its 0.83, far from the dense rate (which
// only wgmma reaches; its sums are another order, so it would need its own
// tolerance).

// The per-thread fragment of one slot: the P bf16 parts of the b and c
// pairs, each part as {b pair, c pair}.
struct MxuFrag3 {
  uint2 hi, mid, lo;
};

template <int P>
struct MxuParts;
// Frag: a slot's per-thread fragment; kMinBlocks: B12a's launch bounds'
// resident blocks an SM (its note).
template <>
struct MxuParts<1> {
  using Frag = uint2;  // {b_hi, c_hi}
  static constexpr int kMinBlocks = 3;
};
template <>
struct MxuParts<2> {
  using Frag = uint4;  // {b_hi, c_hi, b_lo, c_lo}
  static constexpr int kMinBlocks = 3;
};
template <>
struct MxuParts<3> {
  using Frag = MxuFrag3;
  static constexpr int kMinBlocks = 2;
};

template <class F>
struct MxuTile {
  F* frag;      // per slot, 4 threads-in-group: MxuParts<P>::Frag
  int* obj;     // per slot: the object id (B12a: int; B12b: float bits)
  float4* bnd;  // per chunk: cull_sphere
  int* cnt;     // per chunk: filled slots
};

template <class F>
__device__ __forceinline__ MxuTile<F> mxu_tile(uint4* s_mem, int tile,
                                               int chunk_pad) {
  MxuTile<F> t;
  t.frag = reinterpret_cast<F*>(s_mem);
  t.bnd = reinterpret_cast<float4*>(t.frag + (size_t)tile * chunk_pad * 4);
  t.obj = reinterpret_cast<int*>(t.bnd + tile);
  t.cnt = t.obj + tile * chunk_pad;
  return t;
}

// Two floats as a bf16 pair, element k in the low half (the mma
// fragments' order).
__device__ __forceinline__ uint32_t bf16_pair(float lo_k, float hi_k) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x - bf16(x): what the next part rounds (exact in float32).
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

// A slot's fragment for thread-in-group t: the parts of its b pair
// (b0, b1) and c pair (c0, c1).
template <int P>
__device__ __forceinline__ typename MxuParts<P>::Frag mxu_frag(float b0,
                                                               float b1,
                                                               float c0,
                                                               float c1) {
  if constexpr (P == 1) {
    return make_uint2(bf16_pair(b0, b1), bf16_pair(c0, c1));
  } else if constexpr (P == 2) {
    return make_uint4(bf16_pair(b0, b1), bf16_pair(c0, c1),
                      bf16_pair(bf16_rest(b0), bf16_rest(b1)),
                      bf16_pair(bf16_rest(c0), bf16_rest(c1)));
  } else {
    const float rb0 = bf16_rest(b0), rb1 = bf16_rest(b1);
    const float rc0 = bf16_rest(c0), rc1 = bf16_rest(c1);
    MxuFrag3 f;
    f.hi = make_uint2(bf16_pair(b0, b1), bf16_pair(c0, c1));
    f.mid = make_uint2(bf16_pair(rb0, rb1), bf16_pair(rc0, rc1));
    f.lo = make_uint2(bf16_pair(bf16_rest(rb0), bf16_rest(rb1)),
                      bf16_pair(bf16_rest(rc0), bf16_rest(rc1)));
    return f;
  }
}

template <int P, bool kObjBits>
__device__ __forceinline__ void stage_mxu(
    const float* __restrict__ table, int cols,
    const float* __restrict__ bounds, int n_chunks, int chunk,
    int chunk_pad, const float* __restrict__ mxu_a, int k0, int m,
    float scale, const MxuTile<typename MxuParts<P>::Frag>& s) {
  for (int q = threadIdx.x; q < m * chunk_pad * 4; q += blockDim.x) {
    const int slot = q >> 2, t = q & 3;
    const int k = slot / chunk_pad, i = slot - k * chunk_pad;
    float b0 = 0.f, b1 = 0.f, c0 = 0.f, c1 = t == 3 ? 1e30f : 0.f;
    if (i < chunk) {
      const float* brow = mxu_a + ((size_t)2 * chunk * (k0 + k) + i) * 8;
      const float* crow = brow + (size_t)chunk * 8;
      b0 = brow[2 * t];
      b1 = brow[2 * t + 1];
      c0 = crow[2 * t];
      c1 = crow[2 * t + 1];
    }
    s.frag[q] = mxu_frag<P>(b0, b1, c0, c1);
    if (t == 0) {
      const float obj = i < chunk ? table[4 * cols + (k0 + k) * chunk + i]
                                  : 0.f;
      s.obj[slot] = kObjBits ? (int)obj : __float_as_int(obj);
    }
  }
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const int kk = k0 + k;
    s.bnd[k] = cull_sphere(bounds[0 * n_chunks + kk],
                           bounds[1 * n_chunks + kk],
                           bounds[2 * n_chunks + kk],
                           bounds[3 * n_chunks + kk], scale);
    s.cnt[k] = min(max((int)bounds[4 * n_chunks + kk], 0), chunk);
  }
}

// D = A B, m16n8k16, bf16 A (row) and B (col), f32 sums from a zero
// accumulator.
__device__ __forceinline__ void mma_bf16(float d[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
}

// The warp's rays as the mma's B operand: for tile j, this lane's pair
// (k = 2t, 2t + 1) of column g in each of the P parts, b[q][j] (q = 0 hi,
// then lo at P = 2, mid and lo at P = 3).
template <int P>
__device__ __forceinline__ void mxu_b_fragments(const Ray& r, float od,
                                                uint32_t b[P][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float v[8] = {r.dx, r.dy, r.dz, r.ox, r.oy, r.oz, od, 1.0f};
  uint32_t part[P][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float x0 = v[2 * p], x1 = v[2 * p + 1];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      part[q][p] = bf16_pair(x0, x1);
      if (q + 1 < P) {
        x0 = bf16_rest(x0);
        x1 = bf16_rest(x1);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int src = (2 * j + (g & 1)) * 4 + (g >> 1);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const uint32_t v_q = __shfl_sync(0xFFFFFFFFu, part[q][p], src);
        if (p == t) b[q][j] = v_q;
      }
    }
  }
}

// Y for 8 spheres (this lane's sphere g) x the 8 rays of tile j, whose B
// fragments are b[.][j]: d[0..1] = b2 of columns 2t, 2t + 1, d[2..3] =
// their c2 - |o|^2. Each product runs as its own mma into a zeroed
// accumulator, its A part in K-slots 0-7 or 8-15 and zero in the others,
// against the X part that the B operand holds in those slots, and the
// CUDA cores add them in the plain version's order (MXU_PRODUCTS; see the
// note above on why).
template <int P>
__device__ __forceinline__ void mxu_tile_product(
    const typename MxuParts<P>::Frag f, const uint32_t b[P][4], int j,
    float d[4]) {
  if constexpr (P == 1) {
    mma_bf16(d, f.x, f.y, 0u, 0u, b[0][j], 0u);                 // hi.hi
  } else if constexpr (P == 2) {
    float p[4];
    mma_bf16(d, f.x, f.y, 0u, 0u, b[0][j], b[1][j]);            // hi.hi
    mma_bf16(p, 0u, 0u, f.x, f.y, b[0][j], b[1][j]);            // hi.lo
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = __fadd_rn(d[q], p[q]);
    mma_bf16(p, f.z, f.w, 0u, 0u, b[0][j], b[1][j]);            // lo.hi
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = __fadd_rn(d[q], p[q]);
  } else {
    // B = [x_hi; x_mid] for five products, [x_lo; 0] for hi.lo.
    const uint32_t bh = b[0][j], bm = b[1][j], bl = b[2][j];
    float p[4];
    mma_bf16(d, f.lo.x, f.lo.y, 0u, 0u, bh, bm);                // lo.hi
    mma_bf16(p, f.hi.x, f.hi.y, 0u, 0u, bl, 0u);                // hi.lo
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = __fadd_rn(d[q], p[q]);
    mma_bf16(p, 0u, 0u, f.mid.x, f.mid.y, bh, bm);              // mid.mid
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = __fadd_rn(d[q], p[q]);
    mma_bf16(p, f.mid.x, f.mid.y, 0u, 0u, bh, bm);              // mid.hi
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = __fadd_rn(d[q], p[q]);
    mma_bf16(p, 0u, 0u, f.hi.x, f.hi.y, bh, bm);                // hi.mid
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = __fadd_rn(d[q], p[q]);
    mma_bf16(p, f.hi.x, f.hi.y, 0u, 0u, bh, bm);                // hi.hi
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = __fadd_rn(d[q], p[q]);
  }
}

// B12a: a persistent grid (persistent_grid: blocks = SMs x resident
// blocks) whose blocks walk blocks of kThreads rays, each warp 32 of them.
// Where the table's image fits in kResidentBytes (the demo scene's
// 32,940 B does), a block stages it once for its whole life and its warps
// never meet a block barrier; a larger table keeps a tiled loop: per
// block of rays, each tile of kTileBytes staged between two barriers.
// Shared memory holds the warps' exchange rows first, then the image
// (cudaFuncSetAttribute raises the kernel's limit above 48 KB).
//
// The products are those of the note above: per (group of 8 slots, 8-ray
// tile) one, three or six mma.sync. The C fragment leaves lane (g, t) with
// b2 and c2 - |o|^2 of slot g for rays 2t, 2t + 1 of the tile; a warp-wide
// fold over the fragment would mix 8 slots and 4 rays, and its discriminant
// branch would diverge wherever any of the 32 pairs meets (measured on an
// H100 on the demo frame's primary rays: a kernel that folded so took 0.505
// ms, 0.95 with every root taken, and staged the table in each of ~8,100
// blocks for 0.069 of it). Here each lane stores its pairs into its warp's
// exchange rows (slot-major, kSwapRow float2 a row: the stores of a tile and
// the loads of a ray's slots each meet 32 distinct banks), and after a
// __syncwarp each lane loads its own ray's 8 pairs and folds them in slot
// order, as B1 does: a warp-wide fold tests one slot against 32 neighbouring
// rays, which agree on the branch where the rays are coherent. The packed
// min does not depend on the order of its folds, so the words are those of
// any fold of the same products. No lane needs the other rays' tmin, tmax
// and |o|^2, nor a reduce-scatter. At 4 blocks of 256 an SM (64 registers)
// the three-mma product spills 8 bytes, so B12a takes 3 (80 registers, no
// spill; measured on an H100, the spilling build was 5% faster: PERF.md, PR
// 19); "default" keeps 3, "highest" (12 registers of B fragments and a
// 24-byte fragment) takes 2 (MxuParts<P>::kMinBlocks).
constexpr int kSwapRow = 36;                // float2: 32 rays and 4 of padding
constexpr int kSwapWarp = 8 * kSwapRow;     // float2: a warp's 8 slot rows
constexpr size_t kSwapBytes = (kThreads / 32) * kSwapWarp * sizeof(float2);
// The largest table image a block keeps resident; with the exchange rows
// two blocks still fit an SM's 227 KB.
constexpr size_t kResidentBytes = 92 * 1024;

template <int P>
__global__ void __launch_bounds__(kThreads, MxuParts<P>::kMinBlocks)
morton_mxu_closest_hit(const float* __restrict__ rays, int n,
                       const float* __restrict__ table, int cols,
                       const float* __restrict__ bounds, int n_chunks,
                       int chunk, int chunk_pad,
                       const float* __restrict__ mxu_a, int tile_chunks,
                       float scale, int pos_bits, float* __restrict__ t_out,
                       int* __restrict__ obj_out) {
  using Frag = typename MxuParts<P>::Frag;
  extern __shared__ uint4 s_mxu[];
  float2* swap = reinterpret_cast<float2*>(s_mxu) + (threadIdx.x >> 5) *
                                                        kSwapWarp;
  const MxuTile<Frag> s = mxu_tile<Frag>(s_mxu + kSwapBytes / sizeof(uint4),
                                         tile_chunks, chunk_pad);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int trunc = ~((1 << pos_bits) - 1);
  const bool resident = tile_chunks >= n_chunks;
  if (resident) {
    stage_mxu<P, true>(table, cols, bounds, n_chunks, chunk, chunk_pad,
                       mxu_a, 0, n_chunks, scale, s);
    __syncthreads();
  }
  for (int base = blockIdx.x * kThreads; base < n;
       base += gridDim.x * kThreads) {
    const int i = base + threadIdx.x;
    Ray r;
    const bool live = load_live_ray(rays, n, i, &r);
    const float od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
    const float oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
    const SegmentCull cull = segment_cull(r, scale);
    const bool warp_live = __any_sync(0xFFFFFFFFu, live);
    uint32_t b[P][4];
    if (warp_live) mxu_b_fragments<P>(r, od, b);
    int best = kInfBits;
    float t_end = r.tmax;
    for (int k0 = 0; k0 < n_chunks; k0 += tile_chunks) {
      const int m = min(tile_chunks, n_chunks - k0);
      if (!resident) {
        __syncthreads();
        stage_mxu<P, true>(table, cols, bounds, n_chunks, chunk, chunk_pad,
                           mxu_a, k0, m, scale, s);
        __syncthreads();
      }
      if (!warp_live) continue;
      for (int k = 0; k < m; ++k) {
        const bool meet = live && !segment_misses(cull, r, t_end, s.bnd[k]);
        if (!__any_sync(0xFFFFFFFFu, meet)) continue;
        const int groups = (s.cnt[k] + 7) >> 3;
        for (int grp = 0; grp < groups; ++grp) {
          const int slot0 = k * chunk_pad + grp * 8;
          const Frag f = s.frag[(slot0 + g) * 4 + t];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float d[4];
            mxu_tile_product<P>(f, b, j, d);
            // Column 2t + e of tile j is the ray of lane (2j + e) * 4 + t.
            swap[g * kSwapRow + (2 * j) * 4 + t] = make_float2(d[0], d[2]);
            swap[g * kSwapRow + (2 * j + 1) * 4 + t] = make_float2(d[1], d[3]);
          }
          __syncwarp();
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float2 y = swap[q * kSwapRow + lane];
            fold_packed(y.x, y.y + oo, r.tmin, r.tmax, s.obj[slot0 + q],
                        trunc, &best);
          }
          __syncwarp();
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
}

// B12b: B12a's grid and staging (a persistent grid; the table image
// staged once per block where it fits in kResidentBytes, with no block
// barrier after it, else the tiled loop per block of rays), B2's contract.
// Per chunk in table order, while some lane of the warp is open (live,
// not yet blocked): each open lane tests the chunk's bound on its segment
// [tmin, tmax] (range_misses with the caller's margin), and where some
// lane meets it the warp sweeps the chunk's filled slots in groups of 8.
// Lane (g, t) tests the 8 pairs of its C fragments (slot g, columns 2t +
// e of each tile j): the discriminant first, the root only where it is not
// negative (the plain version's NaN root does not block: the same
// result), blocked where the root lies in [tmin, tmax] and the slot's
// object is not the excluded one; then one ballot per (tile, column)
// leaves each ray's bit in its own lane, and a warp leaves the chunk loop
// once none of its lanes is open. The bit is an OR over the swept pairs,
// so any order of the tests gives the same bit. The column's ray terms
// (tmin, tmax, |o|^2, the excluded object) come from the warp's ray rows
// in shared memory, one 16-byte load a pair, not from 32 registers of
// shuffled terms: 48 registers, 5 blocks of 256 an SM. (Measured on an
// H100 on the MXU default frame's shadow batches, on this grid: B12a's
// exchange rows 3% slower, the terms in 80 registers 1% faster;
// PERF.md.) Left free, ptxas builds "highest" at 64 registers with 20
// bytes of spills, so its kernel asks for 3 blocks an SM (up to 80
// registers: morton_mxu_occlusion_highest); a bound of 1 block moved
// "high" from 48 registers to 56 (measured on an H100; PERF.md), so the
// other two stay free.
constexpr size_t kRayBytes = kThreads * sizeof(float4);

template <int P>
__device__ __forceinline__ void mxu_occlusion_body(
    const float* __restrict__ rays, int n, const float* __restrict__ table,
    int cols, const float* __restrict__ bounds, int n_chunks, int chunk,
    int chunk_pad, const float* __restrict__ mxu_a, int tile_chunks,
    float scale, unsigned char* __restrict__ occ_out) {
  using Frag = typename MxuParts<P>::Frag;
  extern __shared__ uint4 s_mxu[];
  float4* s_ray = reinterpret_cast<float4*>(s_mxu) + (threadIdx.x & ~31);
  const MxuTile<Frag> s = mxu_tile<Frag>(s_mxu + kRayBytes / sizeof(uint4),
                                         tile_chunks, chunk_pad);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool resident = tile_chunks >= n_chunks;
  if (resident) {
    stage_mxu<P, false>(table, cols, bounds, n_chunks, chunk, chunk_pad,
                        mxu_a, 0, n_chunks, scale, s);
    __syncthreads();
  }
  for (int base = blockIdx.x * kThreads; base < n;
       base += gridDim.x * kThreads) {
    const int i = base + threadIdx.x;
    Ray r;
    const bool live = load_live_ray(rays, n, i, &r);
    const float exclude = live ? rays[8 * (size_t)n + i] : 0.f;
    const float od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
    const float oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
    const RangeCull cull = range_cull(r, scale);
    uint32_t b[P][4];
    if (__any_sync(0xFFFFFFFFu, live)) mxu_b_fragments<P>(r, od, b);
    __syncwarp();  // the ray rows' last reads for the previous rays
    s_ray[lane] = make_float4(r.tmin, r.tmax, oo, exclude);
    __syncwarp();
    bool open = live;  // live and not yet blocked
    for (int k0 = 0; k0 < n_chunks; k0 += tile_chunks) {
      const int m = min(tile_chunks, n_chunks - k0);
      if (!resident) {
        __syncthreads();
        stage_mxu<P, false>(table, cols, bounds, n_chunks, chunk,
                            chunk_pad, mxu_a, k0, m, scale, s);
        __syncthreads();
      }
      for (int k = 0; k < m && __any_sync(0xFFFFFFFFu, open); ++k) {
        const bool meet = open && !range_misses(cull, r, s.bnd[k]);
        if (!__any_sync(0xFFFFFFFFu, meet)) continue;
        unsigned part = 0;  // bit 2j + e: column 2t + e of tile j blocked
        const int groups = (s.cnt[k] + 7) >> 3;
        for (int grp = 0; grp < groups; ++grp) {
          const int slot = k * chunk_pad + grp * 8 + g;
          const Frag f = s.frag[slot * 4 + t];
          const float obj = __int_as_float(s.obj[slot]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float d[4];
            mxu_tile_product<P>(f, b, j, d);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              // Column 2t + e of tile j is the ray of lane (2j + e) 4 + t.
              const float4 x = s_ray[(2 * j + e) * 4 + t];
              const float c2 = d[2 + e] + x.z;
              if (!(d[e] * d[e] - c2 < 0.f) &&
                  root_blocks(d[e], c2, x.x, x.y, obj, x.w)) {
                part |= 1u << (2 * j + e);
              }
            }
          }
        }
        bool mine = false;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const unsigned votes = __ballot_sync(0xFFFFFFFFu, (part >> q) & 1u);
          if (q == g) mine = (votes & (0x11111111u << t)) != 0u;
        }
        if (mine) open = false;
      }
    }
    if (i < n) occ_out[i] = live && !open;
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
morton_mxu_occlusion(const float* __restrict__ rays, int n,
                     const float* __restrict__ table, int cols,
                     const float* __restrict__ bounds, int n_chunks,
                     int chunk, int chunk_pad,
                     const float* __restrict__ mxu_a, int tile_chunks,
                     float scale, unsigned char* __restrict__ occ_out) {
  mxu_occlusion_body<P>(rays, n, table, cols, bounds, n_chunks, chunk,
                        chunk_pad, mxu_a, tile_chunks, scale, occ_out);
}

__global__ void __launch_bounds__(kThreads, 3)
morton_mxu_occlusion_highest(const float* __restrict__ rays, int n,
                             const float* __restrict__ table, int cols,
                             const float* __restrict__ bounds, int n_chunks,
                             int chunk, int chunk_pad,
                             const float* __restrict__ mxu_a,
                             int tile_chunks, float scale,
                             unsigned char* __restrict__ occ_out) {
  mxu_occlusion_body<3>(rays, n, table, cols, bounds, n_chunks, chunk,
                        chunk_pad, mxu_a, tile_chunks, scale, occ_out);
}

// B13. rays (8, n); bounds (4, c_pad) [cx cy cz r]; members
// (c_pad * mm, 8) [cx cy cz r obj 0 0 0], r = 0 in an empty slot
// (clusters.pack_for_kernel). Per cluster in plan order: the bound test
// (disc > 0 and the root interval meeting [tmin, tmax]); where some lane
// of the warp passes it, the member sweep: t of a slot with disc2 > 0, t
// in [tmin, tmax] and r > 0, the first slot at the least t; a cluster's
// best replaces the ray's where strictly less. A miss gives t = +inf and
// obj 0.
//
// Design: a persistent grid (persistent_grid) whose blocks walk blocks of
// kThreads rays, one thread per ray. Each block stages the plan into
// shared memory: the member rows' [cx cy cz r] and objects by cp.async,
// the bounds by plain loads, then each cluster's filled count, the last
// slot with r > 0 plus one. Where the image fits in kResidentBytes (the
// demo plan's 37 clusters of 32 take 24,420 B) it is staged once for the
// block's life and the warps never meet a block barrier; a larger plan
// keeps a tiled loop over clusters, each tile of kTileBytes staged between
// barriers per block of rays. Every read of the plan is then a shared
// broadcast: every lane of a warp reads the same cluster and slot. The
// TPU kernel sweeps a cluster's members for a block of 2048 rays where any
// of them touches its bound; here a warp does where any of its lanes does
// (__any_sync), the per-warp form of the same vote. It changes no result:
// a member hit by a ray lies inside the cluster's bound (refit's covering
// radius plus its 0.25 slack), so the ray's line meets the bound with its
// interval over the hit's t. Dead lanes touch nothing.
//
// Skips that change no bit: a sweep stops at the cluster's filled count
// (a slot past it has r = 0, and a slot whose r is not > 0 never passes
// the test; the demo plan fills 11.8 of 32 slots on average), and a root
// is taken only where its discriminant is positive, in the bound test
// and in each slot (the result reads it nowhere else, and there
// sqrt(max(disc, 0)) = sqrt(disc)). The staging computes each quadratic's
// sphere-side constant |c|^2 - r^2 once per slot and cluster, and moves
// r > 0 into the object. The arithmetic is the reference's
// (intersect_pallas._clustered_kernel), each operation in its order, so
// with -fmad=false the kernel equals its plain version bit for bit.
// Bound by instruction issue: ~16 float operations per cluster tested and
// ~7 more and one sqrt where disc > 0, ~16 per filled slot swept and ~12
// and one sqrt per positive discriminant. (Measured on an H100 on the
// demo frame's primary rays, with member rows still read from device
// memory: stopping at the filled count took a kernel that swept every
// slot from 0.534 to 0.323 ms, the roots where disc > 0 to 0.209; then
// the persistent grid with the plan in shared memory took 0.232, and with
// the staged constants 0.201.)

// Shared-memory layout of tile clusters of mm slots: [cx cy cz r] per
// slot, the bound [cx cy cz r] per cluster, the object per slot, the
// filled count per cluster. After staging, each w holds |c|^2 - r^2 and a
// slot whose r is not > 0 holds object -1.
struct ClusterTile {
  float4* row;
  float4* bnd;
  float* obj;
  int* cnt;
};

__device__ __forceinline__ ClusterTile cluster_tile(float4* s_mem, int tile,
                                                    int mm) {
  ClusterTile t;
  t.row = s_mem;
  t.bnd = t.row + (size_t)tile * mm;
  t.obj = reinterpret_cast<float*>(t.bnd + tile);
  t.cnt = reinterpret_cast<int*>(t.obj + (size_t)tile * mm);
  return t;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Stage clusters [c0, c0 + m) of the plan. Every thread of the block calls
// it; it ends with a barrier, and the caller's barrier before it keeps a
// tile being swept from being overwritten.
__device__ __forceinline__ void stage_clusters(
    const float* __restrict__ bounds, int c_pad,
    const float* __restrict__ members, int mm, int c0, int m,
    const ClusterTile& s) {
  const float* rows = members + (size_t)8 * c0 * mm;
  for (int q = threadIdx.x; q < m * mm; q += blockDim.x) {
    cp_async16(s.row + q, rows + (size_t)8 * q);
    cp_async4(s.obj + q, rows + (size_t)8 * q + 4);
  }
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    s.bnd[c] = make_float4(bounds[0 * c_pad + c0 + c],
                           bounds[1 * c_pad + c0 + c],
                           bounds[2 * c_pad + c0 + c],
                           bounds[3 * c_pad + c0 + c]);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    int filled = mm;
    while (filled > 0 && !(s.row[c * mm + filled - 1].w > 0.f)) --filled;
    s.cnt[c] = filled;
  }
  __syncthreads();
  // The sphere-side constant of each quadratic, in the reference's
  // operations and order; r > 0 moves into the object (-1: no hit).
  for (int q = threadIdx.x; q < m * mm; q += blockDim.x) {
    const float4 a = s.row[q];
    s.row[q].w = a.x * a.x + a.y * a.y + a.z * a.z - a.w * a.w;
    if (!(a.w > 0.f)) s.obj[q] = -1.f;
  }
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    const float4 b = s.bnd[c];
    s.bnd[c].w = b.x * b.x + b.y * b.y + b.z * b.z - b.w * b.w;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
clustered_closest_hit(const float* __restrict__ rays, int n,
                      const float* __restrict__ bounds, int c_pad,
                      const float* __restrict__ members, int n_clusters,
                      int mm, int tile_clusters, float* __restrict__ t_out,
                      int* __restrict__ obj_out) {
  extern __shared__ float4 s_cl[];
  const ClusterTile s = cluster_tile(s_cl, tile_clusters, mm);
  const bool resident = tile_clusters >= n_clusters;
  if (resident) stage_clusters(bounds, c_pad, members, mm, 0, n_clusters, s);
  for (int base = blockIdx.x * kThreads; base < n;
       base += gridDim.x * kThreads) {
    const int i = base + threadIdx.x;
    Ray r;
    const bool live = load_live_ray(rays, n, i, &r);
    float best_t = __int_as_float(kInfBits);
    int best_i = 0;
    // A warp with no live lane touches nothing; in the tiled loop the
    // block decides together, for the barriers of its staging.
    if (resident ? __any_sync(0xFFFFFFFFu, live) : __syncthreads_or(live)) {
      const float od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
      const float oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
      for (int c0 = 0; c0 < n_clusters; c0 += tile_clusters) {
        const int m = min(tile_clusters, n_clusters - c0);
        if (!resident) {
          __syncthreads();
          stage_clusters(bounds, c_pad, members, mm, c0, m, s);
        }
        for (int c = 0; c < m; ++c) {
          const float4 bb = s.bnd[c];
          const float b = od - (bb.x * r.dx + bb.y * r.dy + bb.z * r.dz);
          const float cc = oo - 2.0f * (bb.x * r.ox + bb.y * r.oy +
                                        bb.z * r.oz) + bb.w;
          const float disc = b * b - cc;
          bool touched = false;
          if (live && disc > 0.f) {
            const float sq = sqrtf(disc);
            touched = -b - sq <= r.tmax && -b + sq >= r.tmin;
          }
          if (!__any_sync(0xFFFFFFFFu, touched)) continue;
          float chunk_t = __int_as_float(kInfBits);
          float chunk_obj = 0.f;
          const float4* row = s.row + (size_t)c * mm;
          const int filled = s.cnt[c];
          for (int k = 0; k < filled; ++k) {
            const float4 a = row[k];
            const float b2 = od - (a.x * r.dx + a.y * r.dy + a.z * r.dz);
            const float c2 = oo - 2.0f * (a.x * r.ox + a.y * r.oy +
                                          a.z * r.oz) + a.w;
            const float disc2 = b2 * b2 - c2;
            if (disc2 > 0.f) {
              const float sq2 = sqrtf(disc2);
              const float t_near = -b2 - sq2;
              const float t = t_near >= r.tmin ? t_near : -b2 + sq2;
              const float o = s.obj[(size_t)c * mm + k];
              if (t >= r.tmin && t <= r.tmax && o >= 0.f && t < chunk_t) {
                chunk_t = t;
                chunk_obj = o;
              }
            }
          }
          if (chunk_t < best_t) {
            best_t = chunk_t;
            best_i = (int)chunk_obj;
          }
        }
      }
    }
    if (i < n) {
      t_out[i] = best_t;
      obj_out[i] = best_i;
    }
  }
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

// The tensor-core kernels' chunk layout for fragments of frag_bytes
// (MxuParts<P>::Frag): slots per chunk padded to whole groups of 8, chunks
// per shared-memory tile and its bytes; false where the bounds do not
// divide the table or no chunk fits.
bool mxu_tile_shape(int cols, int n_chunks, size_t frag_bytes, int* chunk,
                    int* chunk_pad, int* tile, size_t* smem) {
  if (n_chunks <= 0 || cols % n_chunks != 0) return false;
  *chunk = cols / n_chunks;
  *chunk_pad = (*chunk + 7) / 8 * 8;
  const size_t per_chunk = (size_t)*chunk_pad * (4 * frag_bytes +
                                                 sizeof(int)) +
                           sizeof(float4) + sizeof(int);
  *tile = min(n_chunks, (int)(kTileBytes / per_chunk));
  *smem = per_chunk * *tile;
  return *tile >= 1;
}

// B12a's and B12b's shape: as mxu_tile_shape, but the whole table as one
// resident image where it fits in kResidentBytes, and `head` bytes (B12a's
// exchange rows, B12b's ray rows) before the image.
template <int P>
bool mxu_shape(int cols, int n_chunks, size_t head, int* chunk,
               int* chunk_pad, int* tile, size_t* smem) {
  if (!mxu_tile_shape(cols, n_chunks, sizeof(typename MxuParts<P>::Frag),
                      chunk, chunk_pad, tile, smem)) {
    return false;
  }
  const size_t per_chunk = *smem / *tile;
  if (per_chunk * n_chunks <= kResidentBytes) *tile = n_chunks;
  *smem = per_chunk * *tile + head;
  return true;
}

// B13's shape: clusters per shared-memory tile and its bytes, the whole
// plan where it fits in kResidentBytes, else tiles of kTileBytes; false
// where no cluster fits.
bool cluster_shape(int n_clusters, int mm, int* tile, size_t* smem) {
  const size_t per_cluster = (size_t)mm * (sizeof(float4) + sizeof(float)) +
                             sizeof(float4) + sizeof(int);
  const size_t limit = per_cluster * n_clusters <= kResidentBytes
                           ? kResidentBytes
                           : kTileBytes;
  *tile = min(n_clusters, (int)(limit / per_cluster));
  *smem = per_cluster * *tile;
  return *tile >= 1;
}

// A persistent grid for `kernel` at `smem` bytes of dynamic shared memory:
// as many blocks as the card holds at once (SMs x resident blocks), at most
// one per kThreads rays. The runtime is asked for the SM count and the
// resident blocks once per (device, kernel, smem), and the answer kept; the
// kernel's dynamic shared-memory limit is raised where smem is above the
// default 48 KB and above every smem the kernel was launched with before.
struct GridShape {
  int dev;
  const void* kernel;
  size_t smem;
  int sms;
  int per_sm;
};

cudaError_t persistent_grid(const void* kernel, size_t smem, int n,
                            int* grid, int* per_sm) {
  static std::mutex mu;
  static std::vector<GridShape> shapes;
  int dev;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  std::lock_guard<std::mutex> lock(mu);
  size_t raised = kTileBytes;
  for (const GridShape& k : shapes) {
    if (k.dev != dev || k.kernel != kernel) continue;
    if (k.smem == smem) {
      *per_sm = k.per_sm;
      *grid = min(k.sms * k.per_sm, grid_for(n));
      return cudaSuccess;
    }
    if (k.smem > raised) raised = k.smem;
  }
  GridShape k{dev, kernel, smem, 0, 0};
  rc = cudaDeviceGetAttribute(&k.sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess && smem > raised) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
  }
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k.per_sm, kernel,
                                                       kThreads, smem);
  }
  if (rc != cudaSuccess) return rc;
  if (k.per_sm < 1) return cudaErrorInvalidConfiguration;
  shapes.push_back(k);
  *per_sm = k.per_sm;
  *grid = min(k.sms * k.per_sm, grid_for(n));
  return cudaSuccess;
}

// A kernel's resources at a launch shape: out = [registers per thread,
// local (spill) bytes per thread, dynamic shared bytes per block, threads
// per block, resident blocks per SM, blocks in the grid, 1 where the
// table is resident].
int kernel_info(const void* kernel, size_t smem, int n, bool resident,
                int* out) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  int grid = 0, per_sm = 0;
  if (rc == cudaSuccess) {
    rc = persistent_grid(kernel, smem, n, &grid, &per_sm);
  }
  if (rc != cudaSuccess) return (int)rc;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = kThreads;
  out[4] = per_sm;
  out[5] = grid;
  out[6] = resident;
  return 0;
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

namespace {

// B12a's and B12b's launches and resources, per precision's parts.
template <int P>
int mxu_closest_hit(const float* rays, int n, const float* table, int cols,
                    const float* bounds, int n_chunks, const float* mxu_a,
                    float scale, int pos_bits, float* t_out, int* obj_out,
                    cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int chunk, chunk_pad, tile, grid, per_sm;
  size_t smem;
  if (!mxu_shape<P>(cols, n_chunks, kSwapBytes, &chunk, &chunk_pad, &tile,
                    &smem)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t rc = persistent_grid(
      (const void*)morton_mxu_closest_hit<P>, smem, n, &grid, &per_sm);
  if (rc != cudaSuccess) return (int)rc;
  morton_mxu_closest_hit<P><<<grid, kThreads, smem, stream>>>(
      rays, n, table, cols, bounds, n_chunks, chunk, chunk_pad, mxu_a, tile,
      scale, pos_bits, t_out, obj_out);
  return (int)cudaGetLastError();
}

template <int P>
int mxu_closest_hit_info(int cols, int n_chunks, int n, int* out) {
  int chunk, chunk_pad, tile;
  size_t smem;
  if (!mxu_shape<P>(cols, n_chunks, kSwapBytes, &chunk, &chunk_pad, &tile,
                    &smem)) {
    return cudaErrorInvalidValue;
  }
  return kernel_info((const void*)morton_mxu_closest_hit<P>, smem, n,
                     tile >= n_chunks, out);
}

// B12b's kernel at P parts.
template <int P>
const void* mxu_occlusion_kernel() {
  if constexpr (P == 3) return (const void*)morton_mxu_occlusion_highest;
  return (const void*)morton_mxu_occlusion<P>;
}

template <int P>
int mxu_occlusion(const float* rays, int n, const float* table, int cols,
                  const float* bounds, int n_chunks, const float* mxu_a,
                  float scale, unsigned char* occ_out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int chunk, chunk_pad, tile, grid, per_sm;
  size_t smem;
  if (!mxu_shape<P>(cols, n_chunks, kRayBytes, &chunk, &chunk_pad, &tile,
                    &smem)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t rc = persistent_grid(mxu_occlusion_kernel<P>(), smem,
                                         n, &grid, &per_sm);
  if (rc != cudaSuccess) return (int)rc;
  if constexpr (P == 3) {
    morton_mxu_occlusion_highest<<<grid, kThreads, smem, stream>>>(
        rays, n, table, cols, bounds, n_chunks, chunk, chunk_pad, mxu_a,
        tile, scale, occ_out);
  } else {
    morton_mxu_occlusion<P><<<grid, kThreads, smem, stream>>>(
        rays, n, table, cols, bounds, n_chunks, chunk, chunk_pad, mxu_a,
        tile, scale, occ_out);
  }
  return (int)cudaGetLastError();
}

template <int P>
int mxu_occlusion_info(int cols, int n_chunks, int n, int* out) {
  int chunk, chunk_pad, tile;
  size_t smem;
  if (!mxu_shape<P>(cols, n_chunks, kRayBytes, &chunk, &chunk_pad, &tile,
                    &smem)) {
    return cudaErrorInvalidValue;
  }
  return kernel_info(mxu_occlusion_kernel<P>(), smem, n, tile >= n_chunks,
                     out);
}

}  // namespace

// parts: the bf16 parts of the precision's split (ops/intersect_kernels.py:
// MXU_PARTS: 1 "default", 2 "high", 3 "highest"; any other is refused);
// scale: the cull's rounding margin (MXU_CULL_SCALE); mxu_a:
// (n_chunks * 2 * chunk, 8) float32.
extern "C" int drts_morton_mxu_closest_hit(const float* rays, int n,
                                           const float* table, int cols,
                                           const float* bounds, int n_chunks,
                                           const float* mxu_a, int parts,
                                           float scale, int pos_bits,
                                           float* t_out, int* obj_out,
                                           cudaStream_t stream) {
  switch (parts) {
    case 1:
      return mxu_closest_hit<1>(rays, n, table, cols, bounds, n_chunks,
                                mxu_a, scale, pos_bits, t_out, obj_out,
                                stream);
    case 2:
      return mxu_closest_hit<2>(rays, n, table, cols, bounds, n_chunks,
                                mxu_a, scale, pos_bits, t_out, obj_out,
                                stream);
    case 3:
      return mxu_closest_hit<3>(rays, n, table, cols, bounds, n_chunks,
                                mxu_a, scale, pos_bits, t_out, obj_out,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// B12a's resources at `parts` for a table of cols columns in n_chunks
// chunks and n rays (kernel_info's out).
extern "C" int drts_morton_mxu_closest_hit_info(int cols, int n_chunks,
                                                int n, int parts, int* out) {
  switch (parts) {
    case 1:
      return mxu_closest_hit_info<1>(cols, n_chunks, n, out);
    case 2:
      return mxu_closest_hit_info<2>(cols, n_chunks, n, out);
    case 3:
      return mxu_closest_hit_info<3>(cols, n_chunks, n, out);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int drts_morton_mxu_occlusion(const float* rays, int n,
                                         const float* table, int cols,
                                         const float* bounds, int n_chunks,
                                         const float* mxu_a, int parts,
                                         float scale, unsigned char* occ_out,
                                         cudaStream_t stream) {
  switch (parts) {
    case 1:
      return mxu_occlusion<1>(rays, n, table, cols, bounds, n_chunks, mxu_a,
                              scale, occ_out, stream);
    case 2:
      return mxu_occlusion<2>(rays, n, table, cols, bounds, n_chunks, mxu_a,
                              scale, occ_out, stream);
    case 3:
      return mxu_occlusion<3>(rays, n, table, cols, bounds, n_chunks, mxu_a,
                              scale, occ_out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// B12b's resources at `parts` for a table of cols columns in n_chunks
// chunks and n rays (kernel_info's out).
extern "C" int drts_morton_mxu_occlusion_info(int cols, int n_chunks, int n,
                                              int parts, int* out) {
  switch (parts) {
    case 1:
      return mxu_occlusion_info<1>(cols, n_chunks, n, out);
    case 2:
      return mxu_occlusion_info<2>(cols, n_chunks, n, out);
    case 3:
      return mxu_occlusion_info<3>(cols, n_chunks, n, out);
    default:
      return cudaErrorInvalidValue;
  }
}

// bounds: (4, c_pad); members: (c_pad * mm, 8), 16-byte aligned (the
// member rows go to shared memory by 16-byte cp.async); n_clusters <=
// c_pad.
extern "C" int drts_clustered_closest_hit(const float* rays, int n,
                                          const float* bounds, int c_pad,
                                          const float* members,
                                          int n_clusters, int mm,
                                          float* t_out, int* obj_out,
                                          cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int tile, grid, per_sm;
  size_t smem;
  if (n_clusters <= 0 || n_clusters > c_pad || mm <= 0 ||
      reinterpret_cast<uintptr_t>(members) % 16 != 0 ||
      !cluster_shape(n_clusters, mm, &tile, &smem)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t rc = persistent_grid((const void*)clustered_closest_hit,
                                         smem, n, &grid, &per_sm);
  if (rc != cudaSuccess) return (int)rc;
  clustered_closest_hit<<<grid, kThreads, smem, stream>>>(
      rays, n, bounds, c_pad, members, n_clusters, mm, tile, t_out, obj_out);
  return (int)cudaGetLastError();
}

// B13's resources for n_clusters clusters of mm slots and n rays
// (kernel_info's out).
extern "C" int drts_clustered_closest_hit_info(int n_clusters, int mm, int n,
                                               int* out) {
  int tile;
  size_t smem;
  if (n_clusters <= 0 || mm <= 0 ||
      !cluster_shape(n_clusters, mm, &tile, &smem)) {
    return cudaErrorInvalidValue;
  }
  return kernel_info((const void*)clustered_closest_hit, smem, n,
                     tile >= n_clusters, out);
}

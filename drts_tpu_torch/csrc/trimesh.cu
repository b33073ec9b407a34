// Instanced triangle-mesh closest-hit and any-hit kernels for Hopper
// (sm_90a).
//
// drts_bound_scan replaces the TPU kernel
// drts_tpu/ops/trimesh_pallas.py:bound_scan (B5), drts_shared_blas_sweep
// replaces shared_blas_sweep (B6), drts_mesh_instances_closest replaces
// intersect_mesh_instances (B7), drts_shared_blas_any replaces
// shared_blas_any (B8, the any-hit twin of B6), drts_mesh_instances_any
// replaces intersect_mesh_instances_any (B9, the any-hit twin of B7) and
// drts_cand_fused replaces cand_fused (B10, the candidate rounds of B5 and
// B6 in one launch; without the reference's bundle cone, far-chunk cut,
// back-face cull and front-to-back chunk order, none of which changes a
// result). All are bound to PyTorch through a plain C interface and
// ctypes (drts_tpu_torch/ops/trimesh_kernels.py holds the wrappers, the
// table makers and the plain PyTorch versions the kernels are checked
// against).
//
// The TPU kernels work on blocks of 2,048 rays and decide per block: a
// bundle's origin sphere and direction cone cull instance chunks, instances
// and triangle chunks for the whole block, and B6 loops over the block's
// distinct candidate instances. Here B5-B8 and B10 take one thread per ray.
// The thread reads its own candidate's instance row, keeps its best packed
// word in a register and walks its own data-dependent loop; nothing is
// reduced across threads and there are no atomics. B9 compacts each
// block's live lanes first: a block with few of them puts all its threads
// on one live ray at a time, and otherwise one thread per live lane.
//
// Bound: a ray-sphere pair costs ~25 separately rounded float32 operations
// and one IEEE sqrt (B5), a ray-triangle pair ~50 and one IEEE division
// (B6-B9), against 36-48 bytes read and 4-12 written per ray. All five
// are bound by the instruction rate, not by device memory. What the design
// does about it: the tables (8-24 KB) are staged in shared memory as
// float4, so the inner loop's loads are broadcasts of 16 bytes (B5-B10);
// B6's per-lane instance row, which differs between neighbouring rays, is
// gathered once per thread through the read-only cache; B7's walk is
// different for every thread, so after staging its faces once it takes no
// barrier, reads the instance rows through the read-only cache, and
// threads that are done do not wait. B8 is laid out as B6; an any-hit
// lane needs no best, so it leaves its sweep at the first triangle that
// blocks its segment (B8), or its whole walk (B9), and B9's sphere tests
// take the lane's own tmax as the far limit.
//
// Culls kept: a dead lane (tmax < tmin, or no candidate in B6, B8) does
// no work, and a block with no live lane leaves before it stages a table
// (B5-B10); B5 and each round's scan of B10 test each ray
// against every instance chunk's covering sphere, with a segment that ends
// at its best key so far, and sweep only the rows of the chunks they meet
// (csrc/rays.cuh; scan_walk); B6, B8, B9 and each sweep of B10 test the
// ray, in the instance's object frame, against every triangle chunk's
// covering sphere, and in a chunk that the segment misses skip every face
// the ray does not graze, all of them where the chunk's guard cone shows
// none is grazed (sweep_tile states the cull; blas_sweep is B6's and
// B10's; B7 and B9 sweep each instance they enter so); B7 and B9 test each
// ray against every instance chunk's covering sphere and every member's
// bounding sphere, with the ray's running best (B7) or its own tmax (B9)
// as the far limit, and sweep only the instances that pass.
//
// Numbers: built with -fmad=false and without --use_fast_math. Every
// multiply, add, division and sqrt rounds on its own, in the order the
// plain PyTorch versions use, so the kernels equal them bit for bit.
// 1.0f / det is +-inf on a degenerate or padded (all-zero) triangle row,
// whose NaN or inf u, v, t fail every compare. sqrtf of a negative
// discriminant is NaN, which fails both interval compares (B5's padding
// rows carry 1e30 for that; B7's sphere test relies on it too).

#include <cuda_runtime.h>

#include "rays.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSphereTile = 512;  // B5, B10: bound-scan rows per shared tile
constexpr int kFaceTile = 512;    // B6, B8, B9, B10: triangle rows per tile
constexpr int kMinTriChunk = 8;   // B6, B8-B10: the least triangle chunk
constexpr int kInfBits = 0x7F800000;  // bit pattern of +inf: packed miss

struct Vec3 {
  float x, y, z;
};

// v rotated by the conjugate of the quaternion (world -> object):
// v' = v + 2 qv x (qv x v + w v) with qv negated.
__device__ __forceinline__ Vec3 conj_rotate(float qx, float qy, float qz,
                                            float qw, float vx, float vy,
                                            float vz) {
  const float ax = -qx, ay = -qy, az = -qz;
  const float c1x = ay * vz - az * vy + qw * vx;
  const float c1y = az * vx - ax * vz + qw * vy;
  const float c1z = ax * vy - ay * vx + qw * vz;
  Vec3 r;
  r.x = vx + 2.0f * (ay * c1z - az * c1y);
  r.y = vy + 2.0f * (az * c1x - ax * c1z);
  r.z = vz + 2.0f * (ax * c1y - ay * c1x);
  return r;
}

// Two-sided Moeller-Trumbore of one ray (o, d; t in units of |d|) against
// one triangle row [v0 e1 e2]: true where the hit lies in [tmin, tmax], with
// its t in *t_out. There is no |det| guard: 1 / det is +-inf on a degenerate
// row, and the compares on its NaN or inf u, v, t are false.
__device__ __forceinline__ bool mt_hit(
    const Vec3 o, const Vec3 d, float tmin, float tmax, float v0x, float v0y,
    float v0z, float e1x, float e1y, float e1z, float e2x, float e2y,
    float e2z, float* t_out) {
  const float pvx = d.y * e2z - d.z * e2y;
  const float pvy = d.z * e2x - d.x * e2z;
  const float pvz = d.x * e2y - d.y * e2x;
  const float det = pvx * e1x + pvy * e1y + pvz * e1z;
  const float inv = 1.0f / det;  // +-inf on a degenerate row
  const float tvx = o.x - v0x;
  const float tvy = o.y - v0y;
  const float tvz = o.z - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (d.x * qvx + d.y * qvy + d.z * qvz) * inv;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  *t_out = t;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin && t <= tmax;
}

// The packed word (t bits & trunc | pos) of mt_hit's hit, else the packed
// miss.
__device__ __forceinline__ int mt_packed(
    const Vec3 o, const Vec3 d, float tmin, float tmax, float v0x, float v0y,
    float v0z, float e1x, float e1y, float e1z, float e2x, float e2y,
    float e2z, int trunc, int pos) {
  float t;
  const bool ok = mt_hit(o, d, tmin, tmax, v0x, v0y, v0z, e1x, e1y, e1z, e2x,
                         e2y, e2z, &t);
  return ok ? ((__float_as_int(t) & trunc) | pos) : kInfBits;
}

// B5. table: (m_pad, 4) rows [cx cy cz |c|^2-r^2], 1e30 in the last column
// on padding; its first m_tbl rows are the columns of the instance table,
// grouped in chunks of `chunk` (INST_CHUNK) with one covering sphere each in
// bounds (4, ic_cols) planar [cx cy cz r], ordered near to far
// (make_inst_tables). Per ray the least key (bits of max(entry t, 0) with
// the low pos_bits replaced by the row) that is greater than the ray's
// cursor, over the spheres whose [entry, exit] overlaps [tmin, tmax]. Ties
// of the truncated entry t order by row, through the packed word itself.
//
// Design: a dead lane reads its tmin and tmax only, and a block with no
// live lane leaves before it stages a table. The others stage the rows
// below m_tbl (the rows beyond are padding, which never passes) in tiles of
// whole chunks, at most kSphereTile rows, with the tile's covering spheres.
// Per lane and in table order, a chunk is skipped when the ray's segment
// [tmin, t_end] passes farther from its covering sphere than the margin of
// csrc/rays.cuh (B1's cull, which holds at tmax = +inf; scale =
// ops/intersect_kernels.py:CULL_SCALE); a met chunk's rows are swept
// kB5Group at a time, the group's discriminants first, so that its
// shared-memory loads and arithmetic overlap; a warp runs a chunk's sweep
// while any of its lanes meets it. t_end starts at tmax; once the lane
// holds a key, t_end = min(tmax, top(best)), the largest float whose
// truncated bits equal the best's: a row whose key is below the best has
// its entry t at or below top(best) (and below tmax), and its exit at or
// above tmin, so its roots' interval meets [tmin, t_end] (or holds t_end,
// where t_end < tmin) and its chunk is met. The cull removes only rows
// that cannot lower the best, so the min does not change. A row whose
// discriminant is negative misses (the plain version's NaN root fails both
// compares): the lane skips its root, compares and key; at disc = 0 the
// root is 0 and the row can pass, so that one is kept. Bound by
// instruction issue: ~17 float operations per row swept, ~12 more and one
// sqrt per root taken, ~30 per chunk tested; in the candidate loop's later
// rounds tmax has shrunk to the best hit, and fewer chunks are met.
constexpr int kB5Group = 4;  // rows whose discriminants are taken together

// One ray x bound-scan row of B5: the discriminant, and b through `b_out`.
__device__ __forceinline__ float scan_disc(const float4 s, const Ray& r,
                                           float od, float oo,
                                           float* b_out) {
  const float b = od - (s.x * r.dx + s.y * r.dy + s.z * r.dz);
  const float c0 = oo - 2.0f * (s.x * r.ox + s.y * r.oy + s.z * r.oz) + s.w;
  *b_out = b;
  return b * b - c0;
}

// The root of a row whose discriminant is not negative (a negative one
// misses: the plain version's NaN root fails both compares), its key
// folded into the lane's best.
__device__ __forceinline__ void scan_fold(float b, float disc, int row,
                                          float tmin, float tmax, int trunc,
                                          int prev, int* best) {
  const float sq = sqrtf(disc);
  const float entry = -b - sq;
  const float exit_t = sq - b;
  const float ce = entry > 0.0f ? entry : 0.0f;
  const int key = (__float_as_int(ce) & trunc) | row;
  if (exit_t >= tmin && entry <= tmax && key > prev) {
    *best = min(*best, key);
  }
}

// B5's walk of one lane (bound_scan, and each round of cand_fused with
// tmax = min(tmax, best t)): the least key greater than prev over the rows
// below m_tbl whose [entry, exit] overlaps [tmin, tmax]. The table is
// staged tile by tile with barriers that the whole block takes; *staged
// (block-uniform, -1 for none) names the tile in shared memory, so a table
// of one tile is staged once per launch. A lane that is not scanning takes
// part in the barriers only.
__device__ __forceinline__ int scan_walk(
    bool scanning, const Ray& r, float tmax, const SegmentCull& cull,
    float od, float oo, int prev, const float4* __restrict__ table,
    int m_tbl, const float* __restrict__ bounds, int ic_cols, int chunk,
    int tile_chunks, float scale, int trunc, float4* s_tbl, float4* s_bnd,
    int* staged) {
  int best = kInfBits;
  const int n_chunks = (m_tbl + chunk - 1) / chunk;
  float t_end = tmax;
  for (int k0 = 0; k0 < n_chunks; k0 += tile_chunks) {
    const int m = min(tile_chunks, n_chunks - k0);
    const int row0 = k0 * chunk;
    const int rows = min(m * chunk, m_tbl - row0);
    if (*staged != k0) {
      __syncthreads();
      for (int c = threadIdx.x; c < rows; c += blockDim.x) {
        s_tbl[c] = table[row0 + c];
      }
      for (int k = threadIdx.x; k < m; k += blockDim.x) {
        const int kk = k0 + k;
        s_bnd[k] = cull_sphere(bounds[0 * ic_cols + kk],
                               bounds[1 * ic_cols + kk],
                               bounds[2 * ic_cols + kk],
                               bounds[3 * ic_cols + kk], scale);
      }
      __syncthreads();
      *staged = k0;
    }
    if (!scanning) continue;
    for (int k = 0; k < m; ++k) {
      if (segment_misses(cull, r, t_end, s_bnd[k])) continue;
      const int end = min((k + 1) * chunk, rows);
      int c = k * chunk;
      for (; c + kB5Group <= end; c += kB5Group) {
        float b[kB5Group], disc[kB5Group];
#pragma unroll
        for (int u = 0; u < kB5Group; ++u) {
          disc[u] = scan_disc(s_tbl[c + u], r, od, oo, &b[u]);
        }
#pragma unroll
        for (int u = 0; u < kB5Group; ++u) {
          if (!(disc[u] < 0.f)) {
            scan_fold(b[u], disc[u], row0 + c + u, r.tmin, tmax, trunc,
                      prev, &best);
          }
        }
      }
      for (; c < end; ++c) {
        float b;
        const float disc = scan_disc(s_tbl[c], r, od, oo, &b);
        if (!(disc < 0.f)) {
          scan_fold(b, disc, row0 + c, r.tmin, tmax, trunc, prev, &best);
        }
      }
      if (best < kInfBits) {
        t_end = fminf(tmax, __int_as_float((best & trunc) | ~trunc));
      }
    }
  }
  return best;
}

__global__ void __launch_bounds__(kThreads)
bound_scan(const float* __restrict__ rays, int n,
           const int* __restrict__ cursor, const float4* __restrict__ table,
           int m_tbl, const float* __restrict__ bounds, int ic_cols,
           int chunk, int tile_chunks, float scale, int pos_bits,
           int* __restrict__ key_out) {
  extern __shared__ float4 s_mem[];
  float4* s_tbl = s_mem;                        // tile_chunks * chunk rows
  float4* s_bnd = s_mem + tile_chunks * chunk;  // their covering spheres

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  Ray r;
  const bool live = load_live_ray(rays, n, i, &r);
  int best = kInfBits;
  if (__syncthreads_or(live)) {
    int prev = 0;
    float od = 0.f, oo = 0.f;
    SegmentCull cull = {0.f, 0.f, 0.f};
    if (live) {
      prev = cursor[i];
      od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
      oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
      cull = segment_cull(r, scale);
    }
    int staged = -1;
    best = scan_walk(live, r, r.tmax, cull, od, oo, prev, table, m_tbl,
                     bounds, ic_cols, chunk, tile_chunks, scale,
                     ~((1 << pos_bits) - 1), s_tbl, s_bnd, &staged);
  }
  if (in_range) key_out[i] = best;
}

// B7's per-ray sphere test (unit direction): the segment [tmin, far] meets
// the sphere grown by the slack (rad * scale + pad; the wrapper's
// BOUND_SCALE and BOUND_PAD). rad <= 0 (padding) never passes; the NaN
// half-chord of a miss fails both compares.
struct Slack {
  float scale, pad;
};

__device__ __forceinline__ bool reaches(const Ray& r, float cx, float cy,
                                        float cz, float rad, float far,
                                        const Slack slack) {
  const float vx = cx - r.ox, vy = cy - r.oy, vz = cz - r.oz;
  const float b = vx * r.dx + vy * r.dy + vz * r.dz;
  const float wx = vx - b * r.dx, wy = vy - b * r.dy, wz = vz - b * r.dz;
  const float rs = rad * slack.scale + slack.pad;
  const float h = sqrtf(rs * rs - (wx * wx + wy * wy + wz * wz));
  return rad > 0.0f && b + h >= r.tmin && b - h <= far;
}

// The triangle-chunk cull of B6-B10's sweeps. The lane's ray is in
// its candidate's object frame: ol and dl (rotated, not scaled), and
// [tmin, tmax] scaled by inv_s, the very floats mt_hit compares, so the
// argument needs nothing of conj_rotate or of the scaling but |dl.dl - 1|
// <= 2^-8, which segment_cull_tri checks on the lane's own dl (a unit
// world direction turned by a unit quaternion is within a few ulp of it;
// a lane outside skips nothing).
//
// A skip is exact when the skipped face holds no pair that mt_hit, built
// with -fmad=false, could accept on the segment. Let u = 2^-24 and T = ol
// - v0 as computed (taken as the exact input: ol moves by <= u |T|), and
// P, Q, det, U, V, W be MT's intermediates computed exactly from it. Each
// computed cross or dot product is off by <= 7u times the product of its
// factors' norms: |e_det| <= 7u |d||e1||e2|, |e_U| <= 7u |T||d||e2|, |e_V|
// <= 7u |T||d||e1|, |e_W| <= 7u |T||e1||e2|. det T = -W d + U e1 + V e2
// holds for any vectors, so with D = det + e_det the computed denominator
// and (t, u, v) = (W, U, V)' / D before the division's two roundings,
// X = ol + t d and Y = v0 + u e1 + v e2 obey D (X - Y) = e_det T + e_W d
// - e_U e1 - e_V e2: |X - Y| <= 28u |T| / (G - 7u), G = |det| / (|d||e1|
// |e2|) = |d . A| / |d| with A = (e1 x e2) / (|e1||e2|). An accepted pair
// has u, v >= 0 and u + v <= 1 + u: Y lies within u max|e| of the face,
// and the face within the chunk's covering sphere (C, R) up to R's
// rounding (the rounded corners v0 + e1, v0 + e2 and the float32
// distances: <= 6u (|C| + R)). The divisions' roundings move X by <= 2.01u
// |t||d| and Y by <= 2.01u (|e1| + |e2|) <= 8.1u R. In all, the accepted t
// puts ol + t dl within R + s (|ol|_1 + |C|_1 + R) + s |t| of C, with s =
// u (28 / (G - 7u) + 20) (|T| <= |ol|_1 + |C|_1 + R).
//
// The guard bounds G per (lane, face): stage_faces computes A in float32
// (off by <= 11u) and the lane g = |dl . A| (off by <= 3.01u |d|), so G >=
// g / 1.002 - 14u. A face is skipped only where g >= guard: at
// trimesh_kernels.TRI_GUARD = 2^-6, G >= 0.015593 and s <= 1816u. The cull
// test's own rounding (s*, its clamp, w, |w|^2, lim) and the covering
// radius's need <= 64u S, S = |ol|_1 + |C|_1 + R + |t|; the wrapper's
// scale TRI_CULL_SCALE = 2^-13 = 2048u covers both. From there csrc/
// rays.cuh's argument holds with k = scale and no sqrt(|d.d - 1|) term:
// |t| <= 1.125 (|s*| + e), a point of the segment lies within lim of C,
// and segment_misses is false. A face with g < guard, or a NaN g, is
// swept: every face the ray grazes (its t may be rounding noise anywhere
// on the segment), and the degenerate and padding rows (A = 0 where
// |e1||e2| < 2^-64, which also keeps underflow's absolute errors far
// inside the margin). The closest hit's segment (B6, B10) ends at min(tmax,
// top(best)) once the lane holds a hit in this sweep: a face that can
// lower the best has t <= top(best).
//
// B7 and B9 test another ray: their plain versions', with d = fl(dl *
// inv_s) (dl rotated only, |d| = inv_s) and the world segment [tmin,
// tmax]; the cull still reads rl = (ol, dl, fl(tmin * inv_s), fl(t_end *
// inv_s)), B8's frame (any_rays; B7's t_end = min(tmax, top(best)) with
// the best in world units, B9's t_end = tmax). The argument above holds
// for d with three more terms.
// (1) It never used |d| = 1: the MT bound 28u |T| / (G - 7u) is the same
// for any length of d, and G = |d . A| / |d| is; d's direction differs
// from dl's by <= 1.8u, so G >= g / 1.002 - 16u, and at g >= 2^-6 s stays
// <= 1816u. (2) An accepted t in [tmin, tmax] puts X = ol + t d within
// u |t'| |dl| of X' = ol + t' dl, t' = t inv_s exactly (d's rounding), and
// X' is a point of rl's line. (3) t' lies in [tmin inv_s, t_end inv_s]
// (B7: a face that can lower the world best has t <= top(best)),
// whose float ends differ from the exact ones by <= u |t'|: the segment's
// nearest point moves by <= 1.01u |t'|. With the divisions' 2.01u |t||d| =
// 2.01u |t'||dl|, X' lies within R + s (|ol|_1 + |C|_1 + R) + (s + 3u) |t'|
// of C, and the 2048u margin, which needs 1816u + 64u, covers the 3u.

// The staged form of the triangle table: per face three float4 (v0x v0y
// v0z e1x) (e1y e1z e2x e2y) (e2z Ax Ay Az), A the face's guard vector,
// and per chunk three float4: the covering sphere as cull_sphere reads it,
// and the guard cone (wx wy wz c) (s h - -) of tri_bounds' rows 4-9.
__device__ __forceinline__ void stage_face(const float* __restrict__ tri_tbl,
                                           int f, float4* dst) {
  const float* row = tri_tbl + (size_t)f * 9;
  const float e1x = row[3], e1y = row[4], e1z = row[5];
  const float e2x = row[6], e2y = row[7], e2z = row[8];
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nz = e1x * e2y - e1y * e2x;
  const float den = sqrtf(e1x * e1x + e1y * e1y + e1z * e1z) *
                    sqrtf(e2x * e2x + e2y * e2y + e2z * e2z);
  const float inv = den >= 0x1p-64f ? 1.0f / den : 0.0f;
  dst[0] = make_float4(row[0], row[1], row[2], e1x);
  dst[1] = make_float4(e1y, e1z, e2x, e2y);
  dst[2] = make_float4(e2z, nx * inv, ny * inv, nz * inv);
}

__device__ __forceinline__ void stage_tri_chunk(
    const float* __restrict__ tri_bounds, int tb_cols, int k, float scale,
    float4* dst) {
  const float* col = tri_bounds + k;
  dst[0] = cull_sphere(col[0 * tb_cols], col[1 * tb_cols], col[2 * tb_cols],
                       col[3 * tb_cols], scale);
  dst[1] = make_float4(col[4 * tb_cols], col[5 * tb_cols], col[6 * tb_cols],
                       col[7 * tb_cols]);
  dst[2] = make_float4(col[8 * tb_cols], col[9 * tb_cols], 0.f, 0.f);
}

// Stages face rows [base, base + m) and their m / chunk chunks into shared
// memory, the whole block taking part.
__device__ __forceinline__ void stage_faces(
    const float* __restrict__ tri_tbl, int base, int m,
    const float* __restrict__ tri_bounds, int tb_cols, int chunk,
    float scale, float4* s_tri, float4* s_tc) {
  for (int f = threadIdx.x; f < m; f += blockDim.x) {
    stage_face(tri_tbl, base + f, s_tri + 3 * f);
  }
  const int c0 = base / chunk;
  for (int k = threadIdx.x; k < m / chunk; k += blockDim.x) {
    stage_tri_chunk(tri_bounds, tb_cols, c0 + k, scale, s_tc + 3 * k);
  }
}

// One lane's sweep of the staged tile (faces base.. base + m, whole
// chunks), chunk by chunk in table order, culled by rl (the candidate's
// object frame: direction rotated, not scaled) and tested on rm, the ray
// Moeller-Trumbore takes (rl itself for B6, B8 and B10; B7's and B9's ray
// with the direction scaled by 1/scale and the world segment, as their
// plain versions compute it): a chunk met by rl's segment
// [tmin, t_end] has every face swept; a missed one none where its guard
// cone gives c |dl . w| - s sqrt(dl.dl - (dl . w)^2) - h >= guard (every
// face's G is at least that plus h, which covers the lane's rounding:
// trimesh_kernels._chunk_cone; the last three operations round by <= 4u,
// inside the 0.015625 - 0.015593 that the bound on s leaves), else only
// the faces the ray grazes (g < guard). Closest hit (kAny false): folds the packed words
// into *best, t_end = min(tmax, top(*best) end_scale) once it holds a hit
// (end_scale 1 where *best is in rl's units, B6 and B10; 1/scale where it
// is in world units, B7). Any hit:
// returns true at the first face that blocks, t_end = tmax. A warp sweeps
// a face while any of its lanes needs it. Bound by instruction issue:
// ~34 float operations per chunk tested, ~7 per cone and per face
// guard-tested, ~55 per face swept.
template <bool kAny>
__device__ __forceinline__ bool sweep_tile(const Ray& rl,
                                           const SegmentCull& cull,
                                           const Ray& rm, float guard,
                                           const float4* s_tri,
                                           const float4* s_tc, int base,
                                           int m, int chunk, int trunc,
                                           int* best, float end_scale = 1.f) {
  const Vec3 o = {rm.ox, rm.oy, rm.oz}, d = {rm.dx, rm.dy, rm.dz};
  const float dd = rl.dx * rl.dx + rl.dy * rl.dy + rl.dz * rl.dz;
  for (int k = 0, f0 = 0; f0 < m; ++k, f0 += chunk) {
    float t_end = rl.tmax;
    if (!kAny && *best < kInfBits) {
      const float top = __int_as_float((*best & trunc) | ~trunc);
      t_end = fminf(rl.tmax, top * end_scale);
    }
    const bool met = !segment_misses(cull, rl, t_end, s_tc[3 * k]);
    if (!met) {
      const float4 cw = s_tc[3 * k + 1];
      const float4 cs = s_tc[3 * k + 2];
      const float x = rl.dx * cw.x + rl.dy * cw.y + rl.dz * cw.z;
      if ((cw.w * fabsf(x) - cs.x * sqrtf(fmaxf(dd - x * x, 0.f))) - cs.y >=
          guard) {
        continue;
      }
    }
    for (int f = f0; f < f0 + chunk; ++f) {
      const float4 c = s_tri[3 * f + 2];
      if (!met && fabsf(rl.dx * c.y + rl.dy * c.z + rl.dz * c.w) >= guard) {
        continue;
      }
      const float4 a = s_tri[3 * f + 0];
      const float4 b = s_tri[3 * f + 1];
      if (kAny) {
        float t;
        if (mt_hit(o, d, rm.tmin, rm.tmax, a.x, a.y, a.z, a.w, b.x, b.y,
                   b.z, b.w, c.x, &t)) {
          return true;
        }
      } else {
        *best = min(*best, mt_packed(o, d, rm.tmin, rm.tmax, a.x, a.y, a.z,
                                     a.w, b.x, b.y, b.z, b.w, c.x, trunc,
                                     base + f));
      }
    }
  }
  return false;
}

// The lane's ray in instance k's object frame (inst_tbl (9, m_tbl) [px py
// pz qx qy qz qw 1/scale radius]): origin rotated and scaled, direction
// rotated only, [tmin, tmax] scaled into object units. *inv_s_out gets
// 1/scale.
__device__ __forceinline__ Ray to_object(const Ray& r, float tmax,
                                         const float* __restrict__ inst_tbl,
                                         int m_tbl, int k, float* inv_s_out) {
  const float px = __ldg(inst_tbl + 0 * m_tbl + k);
  const float py = __ldg(inst_tbl + 1 * m_tbl + k);
  const float pz = __ldg(inst_tbl + 2 * m_tbl + k);
  const float qx = __ldg(inst_tbl + 3 * m_tbl + k);
  const float qy = __ldg(inst_tbl + 4 * m_tbl + k);
  const float qz = __ldg(inst_tbl + 5 * m_tbl + k);
  const float qw = __ldg(inst_tbl + 6 * m_tbl + k);
  const float inv_s = __ldg(inst_tbl + 7 * m_tbl + k);
  const Vec3 ol = conj_rotate(qx, qy, qz, qw, r.ox - px, r.oy - py,
                              r.oz - pz);
  const Vec3 dl = conj_rotate(qx, qy, qz, qw, r.dx, r.dy, r.dz);
  *inv_s_out = inv_s;
  return {ol.x * inv_s, ol.y * inv_s, ol.z * inv_s, dl.x, dl.y, dl.z,
          r.tmin * inv_s, tmax * inv_s};
}

// B6's sweep of one lane's candidate instance (shared_blas_sweep, and
// each round of cand_fused): the lane's segment [tmin, tmx] in the
// candidate's object frame (to_object), the triangle table swept tile by
// tile with the triangle-chunk cull (sweep_tile, closest hit), and the
// least packed word, in object units, rescaled to world units, repacked and
// folded into *best (world units) and *binst. The object best starts at
// the packed miss: the two words are in different units, and only the
// segment's end carries the world best in. A table of one tile is staged
// once per launch (*staged, block-uniform, names the tile in shared
// memory); a wider one tile by tile, with barriers that the whole block
// takes, so a lane that is not sweeping takes part in them only. Closest
// hit has no early exit: the block stages every tile.
__device__ __forceinline__ void blas_sweep(
    bool sweeping, const Ray& r, float tmx, int cand,
    const float* __restrict__ inst_tbl, int m_tbl,
    const float* __restrict__ tri_tbl, int f_pad,
    const float* __restrict__ tri_bounds, int tb_cols, int chunk,
    float scale, float guard, int trunc, float4* s_tri, float4* s_tc,
    int* staged, int* best, int* binst) {
  Ray rl = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  SegmentCull cull = {0.f, 0.f, 0.f};
  float inv_s = 1.f;
  if (sweeping) {
    rl = to_object(r, tmx, inst_tbl, m_tbl, cand, &inv_s);
    cull = segment_cull_tri(rl, scale);
  }
  int best_obj = kInfBits;
  for (int base = 0; base < f_pad; base += kFaceTile) {
    const int m = min(kFaceTile, f_pad - base);
    if (*staged != base) {
      __syncthreads();
      stage_faces(tri_tbl, base, m, tri_bounds, tb_cols, chunk, scale, s_tri,
                  s_tc);
      __syncthreads();
      *staged = base;
    }
    if (!sweeping) continue;
    sweep_tile<false>(rl, cull, rl, guard, s_tri, s_tc, base, m, chunk,
                      trunc, &best_obj);
  }
  if (sweeping && best_obj < kInfBits) {
    const float t_w = __int_as_float(best_obj & trunc) * (1.0f / inv_s);
    const int packed_w = (__float_as_int(t_w) & trunc) | (best_obj & ~trunc);
    if (packed_w < *best) {
      *best = packed_w;
      *binst = cand;
    }
  }
}

// B6. Each live lane sweeps the shared triangle table in the object frame
// of its own candidate instance (cand, a column of inst_tbl (9, m_tbl)
// [px py pz qx qy qz qw 1/scale radius]), direction rotated but not scaled,
// so t is in object units; the least packed word is rescaled to world
// units, repacked and folded into the incoming best. Ties of the truncated
// t order by face row. A lane is live when it has a candidate in [0,
// m_tbl) and tmax_eff = min(tmax, top(best_in)) >= tmin; it reads cand,
// best_in and binst_in, then tmin and tmax where it has a candidate, then
// the other six ray rows where it is live. The sweep is blas_sweep with
// the segment ending at tmax_eff (scaled into object units); a block with
// no live lane leaves before it stages a table.
__global__ void __launch_bounds__(kThreads)
shared_blas_sweep(const float* __restrict__ rays, int n,
                  const int* __restrict__ cand,
                  const int* __restrict__ best_in,
                  const int* __restrict__ binst_in,
                  const float* __restrict__ inst_tbl, int m_tbl,
                  const float* __restrict__ tri_tbl, int f_pad, int pos_bits,
                  const float* __restrict__ tri_bounds, int tb_cols,
                  int chunk, float scale, float guard,
                  int* __restrict__ best_out, int* __restrict__ binst_out) {
  __shared__ float4 s_tri[kFaceTile * 3];
  __shared__ float4 s_tc[3 * kFaceTile / kMinTriChunk];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  const int trunc = ~((1 << pos_bits) - 1);
  Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  int k = -1, best = kInfBits, binst = 0;
  float tmax_eff = -1.f;
  bool live = false;
  if (in_range) {
    k = cand[i];
    best = best_in[i];
    binst = binst_in[i];
    if (k >= 0 && k < m_tbl) {
      r.tmin = rays[6 * (size_t)n + i];
      r.tmax = rays[7 * (size_t)n + i];
      tmax_eff = fminf(r.tmax, __int_as_float(best & trunc));
      live = tmax_eff >= r.tmin;
      if (live) load_origin_dir(rays, n, i, &r);
    }
  }
  if (__syncthreads_or(live)) {
    int staged = -1;
    blas_sweep(live, r, tmax_eff, k, inst_tbl, m_tbl, tri_tbl, f_pad,
               tri_bounds, tb_cols, chunk, scale, guard, trunc, s_tri, s_tc,
               &staged, &best, &binst);
  }
  if (in_range) {
    best_out[i] = best;
    binst_out[i] = binst;
  }
}

// B8. The any-hit twin of B6: does the lane's candidate instance block its
// segment? A lane is live when occ_in is 0, it has a candidate and tmax >=
// tmin; any other lane passes occ_in through, having read occ_in (then
// cand, then tmin and tmax) only. A live lane sweeps the shared triangle
// table in its candidate's object frame with the triangle-chunk cull
// (sweep_tile) and stops at the first face whose hit lies in its range; a
// block stops staging tiles once none of its lanes is still sweeping.
__global__ void __launch_bounds__(kThreads)
shared_blas_any(const float* __restrict__ rays, int n,
                const int* __restrict__ cand, const int* __restrict__ occ_in,
                const float* __restrict__ inst_tbl, int m_tbl,
                const float* __restrict__ tri_tbl, int f_pad,
                const float* __restrict__ tri_bounds, int tb_cols, int chunk,
                float scale, float guard, int* __restrict__ occ_out) {
  __shared__ float4 s_tri[kFaceTile * 3];
  __shared__ float4 s_tc[3 * kFaceTile / kMinTriChunk];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  int occ = 0, k = -1;
  bool live = false;
  Ray r;
  if (in_range) {
    occ = occ_in[i];
    if (occ == 0) {
      k = cand[i];
      if (k >= 0 && k < m_tbl) live = load_live_ray(rays, n, i, &r);
    }
  }
  if (__syncthreads_or(live)) {
    Ray rl = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
    SegmentCull cull = {0.f, 0.f, 0.f};
    if (live) {
      float inv_s;
      rl = to_object(r, r.tmax, inst_tbl, m_tbl, k, &inv_s);
      cull = segment_cull_tri(rl, scale);
    }
    bool walking = live;
    for (int base = 0; base < f_pad; base += kFaceTile) {
      const int m = min(kFaceTile, f_pad - base);
      if (!__syncthreads_or(walking)) break;
      stage_faces(tri_tbl, base, m, tri_bounds, tb_cols, chunk, scale, s_tri,
                  s_tc);
      __syncthreads();
      if (walking && sweep_tile<true>(rl, cull, rl, guard, s_tri, s_tc, base,
                                      m, chunk, 0, nullptr)) {
        occ = 1;
        walking = false;
      }
    }
  }
  if (in_range) occ_out[i] = occ;
}

// B7. Per ray the closest hit over every instance and every face, the
// direction scaled by 1/scale so t stays in world units. Instances are
// visited in table order, chunk by chunk, each entered where reaches
// passes with the running best as the far limit; the instance recorded is
// the first at which the packed best strictly improved. inst_bounds:
// (4, ic_cols) chunk spheres [cx cy cz r]; m_tbl = n_ichunks * inst_chunk.
//
// Design: a lane reads tmin and tmax first and the other six rows only
// where it is live (load_live_ray), and a block with no live lane writes
// its misses and leaves: a backstop batch of ~2M lanes with a few dozen
// live moves 8 B in and 12 B out per dead lane. (Measured on an H100, four
// rays a thread, for more of those bytes in flight, was slower on every
// batch; PERF.md, PR 19.) A block with live lanes stages the triangle
// table (f_pad <= kFaceTile: the geosphere's 512 faces) with its chunks'
// spheres and guard cones in shared memory once, in sweep_tile's form;
// after that barrier no lane waits for another, and a warp with no live
// lane writes its misses and leaves. A wider table is
// staged once per launch in device memory (stage_face_image, into the
// wrapper's scratch) and read from there (kStaged false). Each live lane
// walks the instances in table order, reads the instance rows through the
// read-only cache, and sweeps an entered instance chunk by chunk with the
// triangle-chunk cull of sweep_tile: culled in B8's frame (any_rays' rl:
// direction rotated only, unit, the segment [tmin, t_end] scaled by
// 1/scale, t_end = min(tmax, top(best)) in world units) and tested on B7's
// own ray (rm: the direction scaled by 1/scale, the world [tmin, tmax]),
// so every word is the unculled walk's: the cull's argument above holds
// for rm as it does for B9, with the segment's end from the world best
// (a face that can lower the best has t <= top(best), and t' = t / scale
// exactly, within the 3u that argument (3) leaves for the rounded ends).
// Bound by instruction issue: ~30 float operations per sphere test, ~80
// to move a ray into an instance's frame, and sweep_tile's per chunk,
// cone, guard and face.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
mesh_instances_closest(const float* __restrict__ rays, int n,
                       const float* __restrict__ inst_tbl, int m_tbl,
                       const float* __restrict__ inst_bounds, int ic_cols,
                       int n_ichunks, int inst_chunk, const Slack slack,
                       const float* __restrict__ tri_tbl, int f_pad,
                       int pos_bits, const float* __restrict__ tri_bounds,
                       int tb_cols, int chunk, float scale, float guard,
                       const float4* __restrict__ image,
                       float* __restrict__ t_out, int* __restrict__ face_out,
                       int* __restrict__ inst_out) {
  __shared__ float4 s_tri[kFaceTile * 3];
  __shared__ float4 s_tc[3 * kFaceTile / kMinTriChunk];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  const bool live = load_live_ray(rays, n, i, &r);
  const int trunc = ~((1 << pos_bits) - 1);
  int best = kInfBits, binst = 0;
  const float4* tri = kStaged ? s_tri : image;
  const float4* tc = kStaged ? s_tc : image + 3 * (size_t)f_pad;
  if (kStaged && __syncthreads_or(live)) {
    stage_faces(tri_tbl, 0, f_pad, tri_bounds, tb_cols, chunk, scale, s_tri,
                s_tc);
    __syncthreads();
  }
  if (live) {
    for (int ic = 0; ic < n_ichunks; ++ic) {
      const float far_c = fminf(r.tmax, __int_as_float(best & trunc));
      if (!reaches(r, __ldg(inst_bounds + 0 * ic_cols + ic),
                   __ldg(inst_bounds + 1 * ic_cols + ic),
                   __ldg(inst_bounds + 2 * ic_cols + ic),
                   __ldg(inst_bounds + 3 * ic_cols + ic), far_c, slack)) {
        continue;
      }
      for (int k = ic * inst_chunk; k < (ic + 1) * inst_chunk; ++k) {
        const float far_k = fminf(r.tmax, __int_as_float(best & trunc));
        if (!reaches(r, __ldg(inst_tbl + 0 * m_tbl + k),
                     __ldg(inst_tbl + 1 * m_tbl + k),
                     __ldg(inst_tbl + 2 * m_tbl + k),
                     __ldg(inst_tbl + 8 * m_tbl + k), far_k, slack)) {
          continue;
        }
        float inv_s;
        const Ray rl = to_object(r, r.tmax, inst_tbl, m_tbl, k, &inv_s);
        const Ray rm = {rl.ox,         rl.oy,         rl.oz, rl.dx * inv_s,
                        rl.dy * inv_s, rl.dz * inv_s, r.tmin, r.tmax};
        const int prev = best;
        sweep_tile<false>(rl, segment_cull_tri(rl, scale), rm, guard, tri, tc,
                          0, f_pad, chunk, trunc, &best, inv_s);
        if (best < prev) binst = k;
      }
    }
  }
  if (i < n) {
    t_out[i] = __int_as_float(best & trunc);
    face_out[i] = best & ~trunc;
    inst_out[i] = binst;
  }
}

// The triangle table in sweep_tile's staged form, in device memory: faces
// [0, f_pad) at image[0, 3 f_pad), chunks after them (B7's table wider
// than kFaceTile).
__global__ void __launch_bounds__(kThreads)
stage_face_image(const float* __restrict__ tri_tbl, int f_pad,
                 const float* __restrict__ tri_bounds, int tb_cols, int chunk,
                 float scale, float4* __restrict__ image) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < f_pad) stage_face(tri_tbl, q, image + 3 * (size_t)q);
  if (q < f_pad / chunk) {
    stage_tri_chunk(tri_bounds, tb_cols, q, scale,
                    image + 3 * (size_t)f_pad + 3 * q);
  }
}

// B9's two rays of a lane for instance k: rl, the triangle cull's, in
// B8's frame (to_object: direction rotated, not scaled; segment scaled by
// 1/scale), and rm, the one its plain version tests: the same origin, the
// direction also scaled by 1/scale (the floats B7 computes), the world
// segment [tmin, tmax] as given.
__device__ __forceinline__ void any_rays(const Ray& r,
                                         const float* __restrict__ inst_tbl,
                                         int m_tbl, int k, Ray* rl, Ray* rm) {
  float inv_s;
  *rl = to_object(r, r.tmax, inst_tbl, m_tbl, k, &inv_s);
  *rm = {rl->ox,         rl->oy,         rl->oz, rl->dx * inv_s,
         rl->dy * inv_s, rl->dz * inv_s, r.tmin, r.tmax};
}

// B9's walk of one lane over the staged tile [0, m): the instance chunks
// and their instances in table order, each entered where reaches passes
// with the lane's own tmax as the far limit, and swept with the
// triangle-chunk cull (sweep_tile on any_rays); true at the first face
// whose hit lies in [tmin, tmax]. Each pass of the outer loop first moves
// the lane on to its own next reached instance, then sweeps it: the lanes
// of a warp sweep together, each its own instance (the staged faces are
// broadcasts), so a warp sweeps as often as its lane with the most
// reached instances, not once per instance that any of its lanes reaches.
__device__ __forceinline__ bool any_walk_tile(
    const Ray& r, const float* __restrict__ inst_tbl, int m_tbl,
    const float* __restrict__ inst_bounds, int ic_cols, int n_ichunks,
    int inst_chunk, const Slack slack, const float4* s_tri,
    const float4* s_tc, int m, int chunk, float scale, float guard) {
  int ic = 0, k = 0, k_end = 0;  // the walk's place: chunk ic, up to k_end
  for (;;) {
    int found = -1;
    while (found < 0) {
      if (k == k_end) {
        if (ic == n_ichunks) break;
        const bool met = reaches(r, __ldg(inst_bounds + 0 * ic_cols + ic),
                                 __ldg(inst_bounds + 1 * ic_cols + ic),
                                 __ldg(inst_bounds + 2 * ic_cols + ic),
                                 __ldg(inst_bounds + 3 * ic_cols + ic),
                                 r.tmax, slack);
        k = ic * inst_chunk;
        k_end = met ? k + inst_chunk : k;
        ++ic;
        continue;
      }
      if (reaches(r, __ldg(inst_tbl + 0 * m_tbl + k),
                  __ldg(inst_tbl + 1 * m_tbl + k),
                  __ldg(inst_tbl + 2 * m_tbl + k),
                  __ldg(inst_tbl + 8 * m_tbl + k), r.tmax, slack)) {
        found = k;
      }
      ++k;
    }
    if (found < 0) return false;
    Ray rl, rm;
    any_rays(r, inst_tbl, m_tbl, found, &rl, &rm);
    if (sweep_tile<true>(rl, segment_cull_tri(rl, scale), rm, guard, s_tri,
                         s_tc, 0, m, chunk, 0, nullptr)) {
      return true;
    }
  }
}

// Sparse B9: triangle chunks a thread sweeps between two checks of the
// blocked flag.
constexpr int kB9Chunks = 2;

// B9. The any-hit twin of B7: is any triangle of any instance inside the
// ray's [tmin, tmax]? An instance is swept where the ray reaches both its
// chunk's covering sphere and its own bounding sphere, with the lane's own
// tmax as the far limit (no running best); the direction is scaled by
// 1/scale, so t stays in world units and tmin, tmax are used as given.
// Any hit is an OR over the (instance, face) pairs, so any split of the
// pairs over threads gives the plain version's bit, each pair being tested
// with the same floats (any_rays' rm, then mt_hit); the triangle-chunk
// cull skips only pairs that cannot hit (the cull's comment above extends
// its argument to B9's direction).
//
// Design: the frame's backstop batches hold ~0.5-2M lanes of which a few
// dozen are live, scattered, and one thread per ray leaves the card idle
// while those few walk ~10^4 pairs each. So each block reads tmin and tmax
// of its 256 lanes and compacts its live lanes in lane order (a ballot
// prefix); a block with none writes zeros and leaves. Below sparse_below
// live lanes (the wrapper's B9_SPARSE_LIVE) the block takes one live ray
// at a time: each thread tests one instance (chunk sphere, then its own
// sphere), the reached instances' rays and cull terms go to a shared list,
// and the (instance, triangle chunk) pairs are split over all threads,
// faces from the staged tile, kB9Chunks per thread between barriers that
// OR the threads' hits, so the block leaves the ray at its first hit. At
// or above it, each of the first n_live threads walks one compacted live
// lane in B7's order (any_walk_tile), with faces from the staged tile.
// Both put the tile loop outermost, so a table of one tile (512 faces) is
// staged once; every barrier sits in control flow that is uniform over the
// block (n_live, the list's length and the OR are results of barriers).
__global__ void __launch_bounds__(kThreads)
mesh_instances_any(const float* __restrict__ rays, int n,
                   const float* __restrict__ inst_tbl, int m_tbl,
                   const float* __restrict__ inst_bounds, int ic_cols,
                   int n_ichunks, int inst_chunk, const Slack slack,
                   const float* __restrict__ tri_tbl, int f_pad,
                   const float* __restrict__ tri_bounds, int tb_cols,
                   int chunk, float scale, float guard, int sparse_below,
                   int* __restrict__ occ_out) {
  __shared__ float4 s_tri[kFaceTile * 3];
  __shared__ float4 s_tc[3 * kFaceTile / kMinTriChunk];
  __shared__ float4 s_obj[3 * kThreads];  // sparse: reached instances' rays
  __shared__ int s_live[kThreads];        // the live lanes, in lane order
  __shared__ int s_occ[kThreads];         // sparse: their blocked bits
  __shared__ int s_warp[kThreads / 32];   // live lanes per warp
  __shared__ int s_count;                 // sparse: instances listed so far

  const int t = threadIdx.x;
  const int i = blockIdx.x * kThreads + t;
  float tmin = 0.f, tmax = -1.f;
  if (i < n) {
    tmin = rays[6 * (size_t)n + i];
    tmax = rays[7 * (size_t)n + i];
  }
  const bool live = tmax >= tmin;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if ((t & 31) == 0) s_warp[t >> 5] = __popc(ballot);
  if (t == 0) s_count = 0;
  const int n_live = __syncthreads_count(live);
  if (i < n && !live) occ_out[i] = 0;
  if (n_live == 0) return;
  if (live) {
    int slot = __popc(ballot & ((1u << (t & 31)) - 1u));
    for (int w = 0; w < (t >> 5); ++w) slot += s_warp[w];
    s_live[slot] = i;
    s_occ[slot] = 0;
  }
  __syncthreads();

  if (n_live >= sparse_below) {
    // Dense: thread t walks the t-th live lane.
    const bool mine = t < n_live;
    Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
    if (mine) r = load_ray(rays, n, s_live[t]);
    bool walking = mine;
    int occ = 0;
    for (int base = 0; base < f_pad; base += kFaceTile) {
      const int m = min(kFaceTile, f_pad - base);
      if (!__syncthreads_or(walking)) break;
      stage_faces(tri_tbl, base, m, tri_bounds, tb_cols, chunk, scale, s_tri,
                  s_tc);
      __syncthreads();
      if (walking && any_walk_tile(r, inst_tbl, m_tbl, inst_bounds, ic_cols,
                                   n_ichunks, inst_chunk, slack, s_tri, s_tc,
                                   m, chunk, scale, guard)) {
        occ = 1;
        walking = false;
      }
    }
    if (mine) occ_out[s_live[t]] = occ;
    return;
  }

  // Sparse: the whole block on one live ray at a time.
  int listed = 0;  // s_count at the start of the instance batch
  for (int base = 0; base < f_pad; base += kFaceTile) {
    const int m = min(kFaceTile, f_pad - base);
    const int n_tc = m / chunk;  // triangle chunks in the tile
    __syncthreads();
    stage_faces(tri_tbl, base, m, tri_bounds, tb_cols, chunk, scale, s_tri,
                s_tc);
    __syncthreads();
    for (int j = 0; j < n_live; ++j) {
      if (s_occ[j]) continue;  // blocked in an earlier tile
      const Ray r = load_ray(rays, n, s_live[j]);
      bool blocked = false;
      for (int k0 = 0; k0 < m_tbl && !blocked; k0 += kThreads) {
        const int k = k0 + t;
        bool pass = false;
        if (k < m_tbl) {
          const int ic = k / inst_chunk;
          pass = reaches(r, __ldg(inst_bounds + 0 * ic_cols + ic),
                         __ldg(inst_bounds + 1 * ic_cols + ic),
                         __ldg(inst_bounds + 2 * ic_cols + ic),
                         __ldg(inst_bounds + 3 * ic_cols + ic), r.tmax,
                         slack) &&
                 reaches(r, __ldg(inst_tbl + 0 * m_tbl + k),
                         __ldg(inst_tbl + 1 * m_tbl + k),
                         __ldg(inst_tbl + 2 * m_tbl + k),
                         __ldg(inst_tbl + 8 * m_tbl + k), r.tmax, slack);
        }
        if (pass) {
          float inv_s;
          const Ray rl = to_object(r, r.tmax, inst_tbl, m_tbl, k, &inv_s);
          const SegmentCull cull = segment_cull_tri(rl, scale);
          const int slot = atomicAdd(&s_count, 1) - listed;
          s_obj[3 * slot + 0] = make_float4(rl.ox, rl.oy, rl.oz, rl.dx);
          s_obj[3 * slot + 1] = make_float4(rl.dy, rl.dz, rl.tmin, rl.tmax);
          s_obj[3 * slot + 2] =
              make_float4(inv_s, cull.inv_dd, cull.m_o, cull.slope);
        }
        const int n_inst = __syncthreads_count(pass);
        listed += n_inst;
        // Task p = s * n_tc + c, triangle chunk c of listed instance s:
        // thread t takes p = t, t + kThreads, ...
        int s = t / n_tc, c = t - s * n_tc;
        for (int p0 = 0; p0 < n_inst * n_tc; p0 += kThreads * kB9Chunks) {
          bool hit = false;
          for (int q = 0; q < kB9Chunks && s < n_inst && !hit; ++q) {
            const float4 a = s_obj[3 * s + 0];
            const float4 b = s_obj[3 * s + 1];
            const float4 e = s_obj[3 * s + 2];
            const Ray rl = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
            const Ray rm = {a.x,       a.y,       a.z,    a.w * e.x,
                            b.x * e.x, b.y * e.x, r.tmin, r.tmax};
            hit = sweep_tile<true>(rl, {e.y, e.z, e.w}, rm, guard,
                                   s_tri + 3 * c * chunk, s_tc + 3 * c, 0,
                                   chunk, chunk, 0, nullptr);
            c += kThreads;
            while (c >= n_tc) {
              c -= n_tc;
              ++s;
            }
          }
          if (__syncthreads_or(hit)) {
            blocked = true;
            break;
          }
        }
      }
      if (blocked && t == 0) s_occ[j] = 1;
    }
  }
  __syncthreads();
  if (t < n_live) occ_out[s_live[t]] = s_occ[t];
}

// B10. The candidate loop in one launch: rounds + 1 bound scans (B5's
// contract and walk, scan_walk, with tmax_eff = min(tmax, best t) and a
// closed cursor never rescanning), and after each of the first `rounds`
// scans the sweep of the candidate found (B6's contract and walk,
// blas_sweep, with the triangle-chunk cull of sweep_tile). Shared memory
// (dynamic, < 48 KB) holds a scan tile of whole instance chunks (512 rows)
// with their covering spheres and a face tile (512 faces) with its chunks'
// spheres and guard cones (36,352 B at triangle chunk 8, 16-row instance
// chunks); a table of one tile stays for the whole launch, a wider one is
// staged tile by tile on every pass, and the barriers that staging needs are
// taken by the whole block, so a pass runs when any lane of the block needs
// it. Per lane the walk is the loop's: the same candidates in the same order
// and the culls remove only rows and faces that cannot change a word, so
// best, binst and the last key equal the multi-launch loop's words.
__global__ void __launch_bounds__(kThreads)
cand_fused(const float* __restrict__ rays, int n,
           const float4* __restrict__ bscan, int bs_pos_bits,
           const float* __restrict__ inst_tbl, int m_tbl,
           const float* __restrict__ inst_bounds, int ic_cols,
           int inst_chunk, int tile_chunks,
           const float* __restrict__ tri_tbl, int f_pad, int pos_bits,
           const float* __restrict__ tri_bounds, int tb_cols, int tri_chunk,
           float scan_scale, float tri_scale, float guard, int rounds,
           int* __restrict__ best_out, int* __restrict__ binst_out,
           int* __restrict__ key_out) {
  extern __shared__ float4 s_mem[];
  float4* s_bs = s_mem;                              // the scan tile
  float4* s_bnd = s_bs + tile_chunks * inst_chunk;   // its chunks' spheres
  float4* s_tri = s_bnd + tile_chunks;               // the face tile
  float4* s_tc = s_tri + 3 * kFaceTile;              // its chunks' bounds

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  Ray r;
  SegmentCull cull = {0.f, 0.f, 0.f};
  if (load_live_ray(rays, n, i, &r)) {
    cull = segment_cull(r, scan_scale);
  } else {  // tmax = -1 < tmin = 0 (a NaN tmax would pass fminf): no scan
    r.tmin = 0.f;
    r.tmax = -1.f;
  }
  const int trunc = ~((1 << pos_bits) - 1);
  const int bs_trunc = ~((1 << bs_pos_bits) - 1);
  const int bs_mask = (1 << bs_pos_bits) - 1;
  const float od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
  const float oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  int best = kInfBits, binst = 0, cursor = -1, key = kInfBits;
  int bs_staged = -1, tri_staged = -1;  // the tiles in shared memory
  for (int it = 0; it <= rounds; ++it) {
    // The scan: the least key beyond the cursor on [tmin, tmax_eff].
    const float tmx = fminf(r.tmax, __int_as_float(best & trunc));
    const bool scanning = cursor < kInfBits && tmx >= r.tmin;
    key = kInfBits;
    if (__syncthreads_or(scanning)) {
      key = scan_walk(scanning, r, tmx, cull, od, oo, cursor, bscan, m_tbl,
                      inst_bounds, ic_cols, inst_chunk, tile_chunks,
                      scan_scale, bs_trunc, s_bs, s_bnd, &bs_staged);
    }
    cursor = key;
    if (it == rounds) break;

    // The sweep of the candidate found, in its object frame.
    const int cand = key < kInfBits ? (key & bs_mask) : m_tbl;
    const bool sweeping = cand < m_tbl;
    if (!__syncthreads_or(sweeping)) continue;
    blas_sweep(sweeping, r, tmx, cand, inst_tbl, m_tbl, tri_tbl, f_pad,
               tri_bounds, tb_cols, tri_chunk, tri_scale, guard, trunc, s_tri,
               s_tc, &tri_staged, &best, &binst);
  }
  if (in_range) {
    best_out[i] = best;
    binst_out[i] = binst;
    key_out[i] = key;
  }
}

// The triangle chunk sizes B6-B10 take: a multiple of kMinTriChunk
// that divides 64 (the triangle table's padding, so every tile holds whole
// chunks), with tb_cols >= f_pad / chunk columns of bounds.
inline bool tri_chunks_ok(int f_pad, int tb_cols, int chunk) {
  return chunk >= kMinTriChunk && chunk % kMinTriChunk == 0 &&
         64 % chunk == 0 && f_pad % 64 == 0 && tb_cols >= f_pad / chunk;
}

inline int grid_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// m_tbl: the rows of table that are instance-table columns (the rest is
// padding); bounds: (4, ic_cols) chunk spheres, ic_cols >= ceil(m_tbl /
// chunk); scale: the cull's rounding margin (csrc/rays.cuh).
extern "C" int drts_bound_scan(const float* rays, int n, const int* cursor,
                               const float* table, int m_tbl,
                               const float* bounds, int ic_cols, int chunk,
                               float scale, int pos_bits, int* key_out,
                               cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (m_tbl < 1 || chunk < 1 || ic_cols < (m_tbl + chunk - 1) / chunk) {
    return cudaErrorInvalidValue;
  }
  const int tile_chunks = max(1, kSphereTile / chunk);
  const size_t smem = sizeof(float4) * (size_t)tile_chunks * (chunk + 1);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  bound_scan<<<grid_for(n), kThreads, smem, stream>>>(
      rays, n, cursor, reinterpret_cast<const float4*>(table), m_tbl, bounds,
      ic_cols, chunk, tile_chunks, scale, pos_bits, key_out);
  return (int)cudaGetLastError();
}

// tri_bounds: (10, tb_cols) covering spheres and guard cones of the
// triangle table's chunks of `chunk` rows; scale: the triangle cull's
// rounding margin and guard the least |dl . A| of a skipped face
// (sweep_tile).
extern "C" int drts_shared_blas_sweep(const float* rays, int n,
                                      const int* cand, const int* best_in,
                                      const int* binst_in,
                                      const float* inst_tbl, int m_tbl,
                                      const float* tri_tbl, int f_pad,
                                      int pos_bits, const float* tri_bounds,
                                      int tb_cols, int chunk, float scale,
                                      float guard, int* best_out,
                                      int* binst_out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (!tri_chunks_ok(f_pad, tb_cols, chunk)) return cudaErrorInvalidValue;
  shared_blas_sweep<<<grid_for(n), kThreads, 0, stream>>>(
      rays, n, cand, best_in, binst_in, inst_tbl, m_tbl, tri_tbl, f_pad,
      pos_bits, tri_bounds, tb_cols, chunk, scale, guard, best_out,
      binst_out);
  return (int)cudaGetLastError();
}

// tri_bounds, chunk, scale and guard as drts_shared_blas_sweep's; image:
// scratch of 3 (f_pad + f_pad / chunk) float4 where f_pad > kFaceTile
// (the staged table goes there), else null.
extern "C" int drts_mesh_instances_closest(
    const float* rays, int n, const float* inst_tbl, int m_tbl,
    const float* inst_bounds, int ic_cols, int n_ichunks, int inst_chunk,
    float bound_scale, float bound_pad, const float* tri_tbl, int f_pad,
    int pos_bits, const float* tri_bounds, int tb_cols, int chunk,
    float scale, float guard, float* image, float* t_out, int* face_out,
    int* inst_out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (inst_chunk < 1 || n_ichunks < 1 || m_tbl != n_ichunks * inst_chunk ||
      ic_cols < n_ichunks || !tri_chunks_ok(f_pad, tb_cols, chunk) ||
      (f_pad > kFaceTile) != (image != nullptr)) {
    return cudaErrorInvalidValue;
  }
  float4* img = reinterpret_cast<float4*>(image);
  if (img == nullptr) {
    mesh_instances_closest<true><<<grid_for(n), kThreads, 0, stream>>>(
        rays, n, inst_tbl, m_tbl, inst_bounds, ic_cols, n_ichunks,
        inst_chunk, Slack{bound_scale, bound_pad}, tri_tbl, f_pad, pos_bits,
        tri_bounds, tb_cols, chunk, scale, guard, img, t_out, face_out,
        inst_out);
    return (int)cudaGetLastError();
  }
  stage_face_image<<<grid_for(f_pad), kThreads, 0, stream>>>(
      tri_tbl, f_pad, tri_bounds, tb_cols, chunk, scale, img);
  mesh_instances_closest<false><<<grid_for(n), kThreads, 0, stream>>>(
      rays, n, inst_tbl, m_tbl, inst_bounds, ic_cols, n_ichunks, inst_chunk,
      Slack{bound_scale, bound_pad}, tri_tbl, f_pad, pos_bits, tri_bounds,
      tb_cols, chunk, scale, guard, img, t_out, face_out, inst_out);
  return (int)cudaGetLastError();
}

// tri_bounds, chunk, scale and guard as drts_shared_blas_sweep's.
extern "C" int drts_shared_blas_any(const float* rays, int n, const int* cand,
                                    const int* occ_in, const float* inst_tbl,
                                    int m_tbl, const float* tri_tbl, int f_pad,
                                    const float* tri_bounds, int tb_cols,
                                    int chunk, float scale, float guard,
                                    int* occ_out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (!tri_chunks_ok(f_pad, tb_cols, chunk)) return cudaErrorInvalidValue;
  shared_blas_any<<<grid_for(n), kThreads, 0, stream>>>(
      rays, n, cand, occ_in, inst_tbl, m_tbl, tri_tbl, f_pad, tri_bounds,
      tb_cols, chunk, scale, guard, occ_out);
  return (int)cudaGetLastError();
}

// tri_bounds, chunk, scale and guard as drts_shared_blas_sweep's;
// sparse_below: a block with fewer live lanes takes them one at a time
// with all its threads (mesh_instances_any).
extern "C" int drts_mesh_instances_any(
    const float* rays, int n, const float* inst_tbl, int m_tbl,
    const float* inst_bounds, int ic_cols, int n_ichunks, int inst_chunk,
    float bound_scale, float bound_pad, const float* tri_tbl, int f_pad,
    const float* tri_bounds, int tb_cols, int chunk, float scale,
    float guard, int sparse_below, int* occ_out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (inst_chunk < 1 || n_ichunks < 1 || m_tbl != n_ichunks * inst_chunk ||
      ic_cols < n_ichunks || !tri_chunks_ok(f_pad, tb_cols, chunk)) {
    return cudaErrorInvalidValue;
  }
  mesh_instances_any<<<grid_for(n), kThreads, 0, stream>>>(
      rays, n, inst_tbl, m_tbl, inst_bounds, ic_cols, n_ichunks, inst_chunk,
      Slack{bound_scale, bound_pad}, tri_tbl, f_pad, tri_bounds, tb_cols,
      chunk, scale, guard, sparse_below, occ_out);
  return (int)cudaGetLastError();
}

// bscan: (m_pad, 4) whose first m_tbl rows are the instance table's
// columns, in chunks of inst_chunk with spheres inst_bounds (4, ic_cols);
// tri_bounds and the scales as drts_shared_blas_any's, scan_scale B5's.
extern "C" int drts_cand_fused(const float* rays, int n, const float* bscan,
                               int m_pad, int bs_pos_bits,
                               const float* inst_tbl, int m_tbl,
                               const float* inst_bounds, int ic_cols,
                               int inst_chunk, const float* tri_tbl,
                               int f_pad, int pos_bits,
                               const float* tri_bounds, int tb_cols,
                               int tri_chunk, float scan_scale,
                               float tri_scale, float guard, int rounds,
                               int* best_out, int* binst_out, int* key_out,
                               cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (m_tbl < 1 || m_tbl > m_pad || inst_chunk < 1 ||
      ic_cols < (m_tbl + inst_chunk - 1) / inst_chunk ||
      !tri_chunks_ok(f_pad, tb_cols, tri_chunk)) {
    return cudaErrorInvalidValue;
  }
  const int tile_chunks = max(1, kSphereTile / inst_chunk);
  const size_t smem =
      sizeof(float4) * ((size_t)tile_chunks * (inst_chunk + 1) +
                        3 * kFaceTile + 3 * kFaceTile / tri_chunk);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  cand_fused<<<grid_for(n), kThreads, smem, stream>>>(
      rays, n, reinterpret_cast<const float4*>(bscan), bs_pos_bits, inst_tbl,
      m_tbl, inst_bounds, ic_cols, inst_chunk, tile_chunks, tri_tbl, f_pad,
      pos_bits, tri_bounds, tb_cols, tri_chunk, scan_scale, tri_scale, guard,
      rounds, best_out, binst_out, key_out);
  return (int)cudaGetLastError();
}

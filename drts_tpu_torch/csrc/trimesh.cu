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
// B6 in one launch; without the reference's bundle, chunk and back-face
// culls and its front-to-back chunk order, none of which changes a
// result). All are bound to PyTorch through a plain C interface and ctypes
// (drts_tpu_torch/ops/trimesh_kernels.py holds the wrappers, the table
// makers and the plain PyTorch versions the kernels are checked against).
//
// The TPU kernels work on blocks of 2,048 rays and decide per block: a
// bundle's origin sphere and direction cone cull instance chunks, instances
// and triangle chunks for the whole block, and B6 loops over the block's
// distinct candidate instances. Here each kernel takes one thread per ray.
// The thread reads its own candidate's instance row, keeps its best packed
// word in a register and walks its own data-dependent loop; nothing is
// reduced across threads and there are no atomics.
//
// Bound: a ray-sphere pair costs ~25 separately rounded float32 operations
// and one IEEE sqrt (B5), a ray-triangle pair ~50 and one IEEE division
// (B6-B9), against 36-48 bytes read and 4-12 written per ray. All five
// are bound by the instruction rate, not by device memory. What the design
// does about it: the tables (8-24 KB) are staged in shared memory as
// float4, so the inner loop's loads are broadcasts of 16 bytes (B5, B6);
// B6's per-lane instance row, which differs between neighbouring rays, is
// gathered once per thread through the read-only cache; B7's loop is
// different for every thread, so it reads all its tables through the
// read-only cache with no barrier, and threads that are done do not wait.
// B8 is laid out as B6 and B9 as B7; an any-hit lane needs no best, so it
// leaves its sweep at the first triangle that blocks its segment (B8), or
// its whole walk (B9), and B9's sphere tests take the lane's own tmax as
// the far limit.
//
// Culls kept: a dead lane (tmax < tmin, or no candidate in B6) does no
// work, and a block with no live lane leaves before it stages a table
// (B5, B6); B5 tests each ray against every instance chunk's covering
// sphere, with a segment that ends at its best key so far, and sweeps only
// the rows of the chunks it meets (csrc/rays.cuh); B7 tests each
// ray against every instance chunk's covering sphere and every member's
// bounding sphere, with the ray's running best as the far limit, and
// sweeps only the instances that pass. The TPU
// kernels' triangle-chunk culls (bounding sphere, normal cone) are left
// out: every sweep visits all face rows.
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
constexpr int kFaceTile = 512;    // B6: triangle rows per shared tile
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
                                          const Ray& r, int trunc, int prev,
                                          int* best) {
  const float sq = sqrtf(disc);
  const float entry = -b - sq;
  const float exit_t = sq - b;
  const float ce = entry > 0.0f ? entry : 0.0f;
  const int key = (__float_as_int(ce) & trunc) | row;
  if (exit_t >= r.tmin && entry <= r.tmax && key > prev) {
    *best = min(*best, key);
  }
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
    const int trunc = ~((1 << pos_bits) - 1);
    const int n_chunks = (m_tbl + chunk - 1) / chunk;
    float t_end = r.tmax;
    for (int k0 = 0; k0 < n_chunks; k0 += tile_chunks) {
      const int m = min(tile_chunks, n_chunks - k0);
      const int row0 = k0 * chunk;
      const int rows = min(m * chunk, m_tbl - row0);
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
      if (!live) continue;
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
              scan_fold(b[u], disc[u], row0 + c + u, r, trunc, prev, &best);
            }
          }
        }
        for (; c < end; ++c) {
          float b;
          const float disc = scan_disc(s_tbl[c], r, od, oo, &b);
          if (!(disc < 0.f)) {
            scan_fold(b, disc, row0 + c, r, trunc, prev, &best);
          }
        }
        if (best < kInfBits) {
          t_end = fminf(r.tmax, __int_as_float((best & trunc) | ~trunc));
        }
      }
    }
  }
  if (in_range) key_out[i] = best;
}

// B6. Each live lane sweeps the shared triangle table in the object frame
// of its own candidate instance (cand, a column of inst_tbl (9, m_tbl)
// [px py pz qx qy qz qw 1/scale radius]), direction rotated but not scaled,
// so t is in object units; the least packed word is rescaled to world
// units, repacked and folded into the incoming best. Ties of the truncated
// t order by face row.
__global__ void __launch_bounds__(kThreads)
shared_blas_sweep(const float* __restrict__ rays, int n,
                  const int* __restrict__ cand,
                  const int* __restrict__ best_in,
                  const int* __restrict__ binst_in,
                  const float* __restrict__ inst_tbl, int m_tbl,
                  const float* __restrict__ tri_tbl, int f_pad, int pos_bits,
                  int* __restrict__ best_out, int* __restrict__ binst_out) {
  // Rows as three float4: (v0x v0y v0z e1x) (e1y e1z e2x e2y) (e2z - - -).
  __shared__ float4 s_tri[kFaceTile * 3];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  const int trunc = ~((1 << pos_bits) - 1);
  Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  int k = -1, best0 = kInfBits, binst0 = 0;
  if (in_range) {
    r = load_ray(rays, n, i);
    k = cand[i];
    best0 = best_in[i];
    binst0 = binst_in[i];
  }
  const float tmax_eff = fminf(r.tmax, __int_as_float(best0 & trunc));
  const bool live = in_range && tmax_eff >= r.tmin && k >= 0 && k < m_tbl;
  int best = best0, binst = binst0;
  if (__syncthreads_or(live)) {
    Vec3 ol = {0.f, 0.f, 0.f}, dl = {0.f, 0.f, 1.f};
    float tmn_l = 0.f, tmx_l = -1.f, s_w = 1.f;
    if (live) {
      const float px = __ldg(inst_tbl + 0 * m_tbl + k);
      const float py = __ldg(inst_tbl + 1 * m_tbl + k);
      const float pz = __ldg(inst_tbl + 2 * m_tbl + k);
      const float qx = __ldg(inst_tbl + 3 * m_tbl + k);
      const float qy = __ldg(inst_tbl + 4 * m_tbl + k);
      const float qz = __ldg(inst_tbl + 5 * m_tbl + k);
      const float qw = __ldg(inst_tbl + 6 * m_tbl + k);
      const float inv_s = __ldg(inst_tbl + 7 * m_tbl + k);
      ol = conj_rotate(qx, qy, qz, qw, r.ox - px, r.oy - py, r.oz - pz);
      ol.x = ol.x * inv_s;
      ol.y = ol.y * inv_s;
      ol.z = ol.z * inv_s;
      dl = conj_rotate(qx, qy, qz, qw, r.dx, r.dy, r.dz);
      tmn_l = r.tmin * inv_s;
      tmx_l = tmax_eff * inv_s;
      s_w = 1.0f / inv_s;
    }
    int best_obj = kInfBits;
    for (int base = 0; base < f_pad; base += kFaceTile) {
      const int m = min(kFaceTile, f_pad - base);
      __syncthreads();
      for (int f = threadIdx.x; f < m; f += blockDim.x) {
        const float* row = tri_tbl + (size_t)(base + f) * 9;
        s_tri[3 * f + 0] = make_float4(row[0], row[1], row[2], row[3]);
        s_tri[3 * f + 1] = make_float4(row[4], row[5], row[6], row[7]);
        s_tri[3 * f + 2] = make_float4(row[8], 0.f, 0.f, 0.f);
      }
      __syncthreads();
      if (!live) continue;
      for (int f = 0; f < m; ++f) {
        const float4 a = s_tri[3 * f + 0];
        const float4 b = s_tri[3 * f + 1];
        const float4 c = s_tri[3 * f + 2];
        best_obj = min(best_obj,
                       mt_packed(ol, dl, tmn_l, tmx_l, a.x, a.y, a.z, a.w,
                                 b.x, b.y, b.z, b.w, c.x, trunc, base + f));
      }
    }
    if (live && best_obj < kInfBits) {
      const float t_w = __int_as_float(best_obj & trunc) * s_w;
      const int packed_w = (__float_as_int(t_w) & trunc) | (best_obj & ~trunc);
      if (packed_w < best0) {
        best = packed_w;
        binst = k;
      }
    }
  }
  if (in_range) {
    best_out[i] = best;
    binst_out[i] = binst;
  }
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

// B7. Per ray the closest hit over every instance and every face, the
// direction scaled by 1/scale so t stays in world units. Instances are
// visited in table order, chunk by chunk; the instance recorded is the
// first at which the packed best strictly improved. inst_bounds:
// (4, ic_cols) chunk spheres [cx cy cz r]; m_tbl = n_ichunks * inst_chunk.
__global__ void __launch_bounds__(kThreads)
mesh_instances_closest(const float* __restrict__ rays, int n,
                       const float* __restrict__ inst_tbl, int m_tbl,
                       const float* __restrict__ inst_bounds, int ic_cols,
                       int n_ichunks, int inst_chunk, const Slack slack,
                       const float* __restrict__ tri_tbl, int f_pad,
                       int pos_bits, float* __restrict__ t_out,
                       int* __restrict__ face_out, int* __restrict__ inst_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rays, n, i);
  const int trunc = ~((1 << pos_bits) - 1);
  int best = kInfBits, binst = 0;
  if (r.tmax >= r.tmin) {
    for (int ic = 0; ic < n_ichunks; ++ic) {
      const float far_c = fminf(r.tmax, __int_as_float(best & trunc));
      if (!reaches(r, __ldg(inst_bounds + 0 * ic_cols + ic),
                   __ldg(inst_bounds + 1 * ic_cols + ic),
                   __ldg(inst_bounds + 2 * ic_cols + ic),
                   __ldg(inst_bounds + 3 * ic_cols + ic), far_c, slack)) {
        continue;
      }
      for (int k = ic * inst_chunk; k < (ic + 1) * inst_chunk; ++k) {
        const float px = __ldg(inst_tbl + 0 * m_tbl + k);
        const float py = __ldg(inst_tbl + 1 * m_tbl + k);
        const float pz = __ldg(inst_tbl + 2 * m_tbl + k);
        const float brw = __ldg(inst_tbl + 8 * m_tbl + k);
        const float far_k = fminf(r.tmax, __int_as_float(best & trunc));
        if (!reaches(r, px, py, pz, brw, far_k, slack)) continue;
        const float qx = __ldg(inst_tbl + 3 * m_tbl + k);
        const float qy = __ldg(inst_tbl + 4 * m_tbl + k);
        const float qz = __ldg(inst_tbl + 5 * m_tbl + k);
        const float qw = __ldg(inst_tbl + 6 * m_tbl + k);
        const float inv_s = __ldg(inst_tbl + 7 * m_tbl + k);
        Vec3 ol = conj_rotate(qx, qy, qz, qw, r.ox - px, r.oy - py, r.oz - pz);
        ol.x = ol.x * inv_s;
        ol.y = ol.y * inv_s;
        ol.z = ol.z * inv_s;
        Vec3 dl = conj_rotate(qx, qy, qz, qw, r.dx, r.dy, r.dz);
        dl.x = dl.x * inv_s;
        dl.y = dl.y * inv_s;
        dl.z = dl.z * inv_s;
        const int prev = best;
        for (int f = 0; f < f_pad; ++f) {
          const float* row = tri_tbl + (size_t)f * 9;
          best = min(best,
                     mt_packed(ol, dl, r.tmin, r.tmax, __ldg(row + 0),
                               __ldg(row + 1), __ldg(row + 2), __ldg(row + 3),
                               __ldg(row + 4), __ldg(row + 5), __ldg(row + 6),
                               __ldg(row + 7), __ldg(row + 8), trunc, f));
        }
        if (best < prev) binst = k;
      }
    }
  }
  t_out[i] = __int_as_float(best & trunc);
  face_out[i] = best & ~trunc;
  inst_out[i] = binst;
}

// B8. The any-hit twin of B6: does the lane's candidate instance block its
// segment? A lane is live when tmax >= tmin, it has a candidate and
// occ_in is 0; any other lane passes occ_in through. A live lane sweeps the
// shared triangle table in its candidate's object frame, direction rotated
// but not scaled, so tmin and tmax are scaled into object units, and stops
// at the first triangle whose hit lies in that range.
__global__ void __launch_bounds__(kThreads)
shared_blas_any(const float* __restrict__ rays, int n,
                const int* __restrict__ cand, const int* __restrict__ occ_in,
                const float* __restrict__ inst_tbl, int m_tbl,
                const float* __restrict__ tri_tbl, int f_pad,
                int* __restrict__ occ_out) {
  __shared__ float4 s_tri[kFaceTile * 3];  // rows laid out as in B6

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  int k = -1, occ = 0;
  if (in_range) {
    r = load_ray(rays, n, i);
    k = cand[i];
    occ = occ_in[i];
  }
  const bool live =
      in_range && r.tmax >= r.tmin && k >= 0 && k < m_tbl && occ == 0;
  if (__syncthreads_or(live)) {
    Vec3 ol = {0.f, 0.f, 0.f}, dl = {0.f, 0.f, 1.f};
    float tmn_l = 0.f, tmx_l = -1.f;
    if (live) {
      const float px = __ldg(inst_tbl + 0 * m_tbl + k);
      const float py = __ldg(inst_tbl + 1 * m_tbl + k);
      const float pz = __ldg(inst_tbl + 2 * m_tbl + k);
      const float qx = __ldg(inst_tbl + 3 * m_tbl + k);
      const float qy = __ldg(inst_tbl + 4 * m_tbl + k);
      const float qz = __ldg(inst_tbl + 5 * m_tbl + k);
      const float qw = __ldg(inst_tbl + 6 * m_tbl + k);
      const float inv_s = __ldg(inst_tbl + 7 * m_tbl + k);
      ol = conj_rotate(qx, qy, qz, qw, r.ox - px, r.oy - py, r.oz - pz);
      ol.x = ol.x * inv_s;
      ol.y = ol.y * inv_s;
      ol.z = ol.z * inv_s;
      dl = conj_rotate(qx, qy, qz, qw, r.dx, r.dy, r.dz);
      tmn_l = r.tmin * inv_s;
      tmx_l = r.tmax * inv_s;
    }
    bool walking = live;
    for (int base = 0; base < f_pad; base += kFaceTile) {
      const int m = min(kFaceTile, f_pad - base);
      __syncthreads();
      for (int f = threadIdx.x; f < m; f += blockDim.x) {
        const float* row = tri_tbl + (size_t)(base + f) * 9;
        s_tri[3 * f + 0] = make_float4(row[0], row[1], row[2], row[3]);
        s_tri[3 * f + 1] = make_float4(row[4], row[5], row[6], row[7]);
        s_tri[3 * f + 2] = make_float4(row[8], 0.f, 0.f, 0.f);
      }
      __syncthreads();
      for (int f = 0; walking && f < m; ++f) {
        const float4 a = s_tri[3 * f + 0];
        const float4 b = s_tri[3 * f + 1];
        const float4 c = s_tri[3 * f + 2];
        float t;
        if (mt_hit(ol, dl, tmn_l, tmx_l, a.x, a.y, a.z, a.w, b.x, b.y, b.z,
                   b.w, c.x, &t)) {
          occ = 1;
          walking = false;
        }
      }
    }
  }
  if (in_range) occ_out[i] = occ;
}

// B9. The any-hit twin of B7: is any triangle of any instance inside the
// ray's [tmin, tmax]? The same (chunk, instance) walk in table order, the
// direction scaled by 1/scale so t stays in world units and tmin, tmax are
// used as given. There is no running best: both sphere tests take the
// lane's own tmax as the far limit, and the lane leaves at its first
// blocking triangle.
__global__ void __launch_bounds__(kThreads)
mesh_instances_any(const float* __restrict__ rays, int n,
                   const float* __restrict__ inst_tbl, int m_tbl,
                   const float* __restrict__ inst_bounds, int ic_cols,
                   int n_ichunks, int inst_chunk, const Slack slack,
                   const float* __restrict__ tri_tbl, int f_pad,
                   int* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rays, n, i);
  int occ = 0;
  if (r.tmax >= r.tmin) {
    for (int ic = 0; ic < n_ichunks && !occ; ++ic) {
      if (!reaches(r, __ldg(inst_bounds + 0 * ic_cols + ic),
                   __ldg(inst_bounds + 1 * ic_cols + ic),
                   __ldg(inst_bounds + 2 * ic_cols + ic),
                   __ldg(inst_bounds + 3 * ic_cols + ic), r.tmax, slack)) {
        continue;
      }
      for (int k = ic * inst_chunk; k < (ic + 1) * inst_chunk && !occ; ++k) {
        const float px = __ldg(inst_tbl + 0 * m_tbl + k);
        const float py = __ldg(inst_tbl + 1 * m_tbl + k);
        const float pz = __ldg(inst_tbl + 2 * m_tbl + k);
        const float brw = __ldg(inst_tbl + 8 * m_tbl + k);
        if (!reaches(r, px, py, pz, brw, r.tmax, slack)) continue;
        const float qx = __ldg(inst_tbl + 3 * m_tbl + k);
        const float qy = __ldg(inst_tbl + 4 * m_tbl + k);
        const float qz = __ldg(inst_tbl + 5 * m_tbl + k);
        const float qw = __ldg(inst_tbl + 6 * m_tbl + k);
        const float inv_s = __ldg(inst_tbl + 7 * m_tbl + k);
        Vec3 ol = conj_rotate(qx, qy, qz, qw, r.ox - px, r.oy - py, r.oz - pz);
        ol.x = ol.x * inv_s;
        ol.y = ol.y * inv_s;
        ol.z = ol.z * inv_s;
        Vec3 dl = conj_rotate(qx, qy, qz, qw, r.dx, r.dy, r.dz);
        dl.x = dl.x * inv_s;
        dl.y = dl.y * inv_s;
        dl.z = dl.z * inv_s;
        for (int f = 0; f < f_pad; ++f) {
          const float* row = tri_tbl + (size_t)f * 9;
          float t;
          if (mt_hit(ol, dl, r.tmin, r.tmax, __ldg(row + 0), __ldg(row + 1),
                     __ldg(row + 2), __ldg(row + 3), __ldg(row + 4),
                     __ldg(row + 5), __ldg(row + 6), __ldg(row + 7),
                     __ldg(row + 8), &t)) {
            occ = 1;
            break;
          }
        }
      }
    }
  }
  occ_out[i] = occ;
}

// B10. The candidate loop in one launch: rounds + 1 bound scans (B5's
// contract, with tmax_eff = min(tmax, best t) and a closed cursor never
// rescanning), and after each of the first `rounds` scans the sweep of the
// candidate found (B6's contract). Both tables sit in shared memory for the
// whole launch when they fit one tile each (512 scan rows, 8 KB; 512 face
// rows, 24 KB); a wider table is staged tile by tile on every pass, and the
// barriers that staging needs are taken by the whole block, so a pass runs
// when any lane of the block needs it. Per lane the walk is the loop's:
// the same candidates in the same order, the same operations, so best,
// binst and the last key equal the multi-launch loop's words.
__global__ void __launch_bounds__(kThreads)
cand_fused(const float* __restrict__ rays, int n,
           const float4* __restrict__ bscan, int m_pad, int bs_pos_bits,
           const float* __restrict__ inst_tbl, int m_tbl,
           const float* __restrict__ tri_tbl, int f_pad, int pos_bits,
           int rounds, int* __restrict__ best_out, int* __restrict__ binst_out,
           int* __restrict__ key_out) {
  __shared__ float4 s_bs[kSphereTile];
  __shared__ float4 s_tri[kFaceTile * 3];  // rows laid out as in B6

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  if (in_range) r = load_ray(rays, n, i);
  const bool live0 = in_range && r.tmax >= r.tmin;
  const int trunc = ~((1 << pos_bits) - 1);
  const int bs_trunc = ~((1 << bs_pos_bits) - 1);
  const int bs_mask = (1 << bs_pos_bits) - 1;
  const float od = r.ox * r.dx + r.oy * r.dy + r.oz * r.dz;
  const float oo = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  int best = kInfBits, binst = 0, cursor = -1, key = kInfBits;
  int bs_staged = -1, tri_staged = -1;  // the tile in shared memory
  for (int it = 0; it <= rounds; ++it) {
    // The scan: the least key beyond the cursor on [tmin, tmax_eff].
    const float tmx = fminf(r.tmax, __int_as_float(best & trunc));
    const bool scanning = live0 && cursor < kInfBits && tmx >= r.tmin;
    key = kInfBits;
    if (__syncthreads_or(scanning)) {
      for (int base = 0; base < m_pad; base += kSphereTile) {
        const int m = min(kSphereTile, m_pad - base);
        if (bs_staged != base) {
          __syncthreads();
          for (int c = threadIdx.x; c < m; c += blockDim.x) {
            s_bs[c] = bscan[base + c];
          }
          __syncthreads();
          bs_staged = base;
        }
        if (!scanning) continue;
        for (int c = 0; c < m; ++c) {
          const float4 s = s_bs[c];
          const float b = od - (s.x * r.dx + s.y * r.dy + s.z * r.dz);
          const float c0 =
              oo - 2.0f * (s.x * r.ox + s.y * r.oy + s.z * r.oz) + s.w;
          const float sq = sqrtf(b * b - c0);  // NaN when the ray misses
          const float entry = -b - sq;
          const float exit_t = sq - b;
          const float ce = entry > 0.0f ? entry : 0.0f;
          const int k = (__float_as_int(ce) & bs_trunc) | (base + c);
          if (exit_t >= r.tmin && entry <= tmx && k > cursor) {
            key = min(key, k);
          }
        }
      }
    }
    cursor = key;
    if (it == rounds) break;

    // The sweep of the candidate found, in its object frame.
    const int cand = key < kInfBits ? (key & bs_mask) : m_tbl;
    const bool sweeping = cand < m_tbl;
    if (!__syncthreads_or(sweeping)) continue;
    Vec3 ol = {0.f, 0.f, 0.f}, dl = {0.f, 0.f, 1.f};
    float tmn_l = 0.f, tmx_l = -1.f, s_w = 1.f;
    if (sweeping) {
      const float px = __ldg(inst_tbl + 0 * m_tbl + cand);
      const float py = __ldg(inst_tbl + 1 * m_tbl + cand);
      const float pz = __ldg(inst_tbl + 2 * m_tbl + cand);
      const float qx = __ldg(inst_tbl + 3 * m_tbl + cand);
      const float qy = __ldg(inst_tbl + 4 * m_tbl + cand);
      const float qz = __ldg(inst_tbl + 5 * m_tbl + cand);
      const float qw = __ldg(inst_tbl + 6 * m_tbl + cand);
      const float inv_s = __ldg(inst_tbl + 7 * m_tbl + cand);
      ol = conj_rotate(qx, qy, qz, qw, r.ox - px, r.oy - py, r.oz - pz);
      ol.x = ol.x * inv_s;
      ol.y = ol.y * inv_s;
      ol.z = ol.z * inv_s;
      dl = conj_rotate(qx, qy, qz, qw, r.dx, r.dy, r.dz);
      tmn_l = r.tmin * inv_s;
      tmx_l = tmx * inv_s;
      s_w = 1.0f / inv_s;
    }
    int best_obj = kInfBits;
    for (int base = 0; base < f_pad; base += kFaceTile) {
      const int m = min(kFaceTile, f_pad - base);
      if (tri_staged != base) {
        __syncthreads();
        for (int f = threadIdx.x; f < m; f += blockDim.x) {
          const float* row = tri_tbl + (size_t)(base + f) * 9;
          s_tri[3 * f + 0] = make_float4(row[0], row[1], row[2], row[3]);
          s_tri[3 * f + 1] = make_float4(row[4], row[5], row[6], row[7]);
          s_tri[3 * f + 2] = make_float4(row[8], 0.f, 0.f, 0.f);
        }
        __syncthreads();
        tri_staged = base;
      }
      if (!sweeping) continue;
      for (int f = 0; f < m; ++f) {
        const float4 a = s_tri[3 * f + 0];
        const float4 b = s_tri[3 * f + 1];
        const float4 c = s_tri[3 * f + 2];
        best_obj = min(best_obj,
                       mt_packed(ol, dl, tmn_l, tmx_l, a.x, a.y, a.z, a.w,
                                 b.x, b.y, b.z, b.w, c.x, trunc, base + f));
      }
    }
    if (sweeping && best_obj < kInfBits) {
      const float t_w = __int_as_float(best_obj & trunc) * s_w;
      const int packed_w = (__float_as_int(t_w) & trunc) | (best_obj & ~trunc);
      if (packed_w < best) {
        best = packed_w;
        binst = cand;
      }
    }
  }
  if (in_range) {
    best_out[i] = best;
    binst_out[i] = binst;
    key_out[i] = key;
  }
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

extern "C" int drts_shared_blas_sweep(const float* rays, int n,
                                      const int* cand, const int* best_in,
                                      const int* binst_in,
                                      const float* inst_tbl, int m_tbl,
                                      const float* tri_tbl, int f_pad,
                                      int pos_bits, int* best_out,
                                      int* binst_out, cudaStream_t stream) {
  if (n > 0) {
    shared_blas_sweep<<<grid_for(n), kThreads, 0, stream>>>(
        rays, n, cand, best_in, binst_in, inst_tbl, m_tbl, tri_tbl, f_pad,
        pos_bits, best_out, binst_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int drts_mesh_instances_closest(
    const float* rays, int n, const float* inst_tbl, int m_tbl,
    const float* inst_bounds, int ic_cols, int n_ichunks, int inst_chunk,
    float bound_scale, float bound_pad, const float* tri_tbl, int f_pad,
    int pos_bits, float* t_out, int* face_out, int* inst_out,
    cudaStream_t stream) {
  if (n > 0) {
    mesh_instances_closest<<<grid_for(n), kThreads, 0, stream>>>(
        rays, n, inst_tbl, m_tbl, inst_bounds, ic_cols, n_ichunks, inst_chunk,
        Slack{bound_scale, bound_pad}, tri_tbl, f_pad, pos_bits, t_out,
        face_out, inst_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int drts_shared_blas_any(const float* rays, int n, const int* cand,
                                    const int* occ_in, const float* inst_tbl,
                                    int m_tbl, const float* tri_tbl, int f_pad,
                                    int* occ_out, cudaStream_t stream) {
  if (n > 0) {
    shared_blas_any<<<grid_for(n), kThreads, 0, stream>>>(
        rays, n, cand, occ_in, inst_tbl, m_tbl, tri_tbl, f_pad, occ_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int drts_mesh_instances_any(
    const float* rays, int n, const float* inst_tbl, int m_tbl,
    const float* inst_bounds, int ic_cols, int n_ichunks, int inst_chunk,
    float bound_scale, float bound_pad, const float* tri_tbl, int f_pad,
    int* occ_out, cudaStream_t stream) {
  if (n > 0) {
    mesh_instances_any<<<grid_for(n), kThreads, 0, stream>>>(
        rays, n, inst_tbl, m_tbl, inst_bounds, ic_cols, n_ichunks, inst_chunk,
        Slack{bound_scale, bound_pad}, tri_tbl, f_pad, occ_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int drts_cand_fused(const float* rays, int n, const float* bscan,
                               int m_pad, int bs_pos_bits,
                               const float* inst_tbl, int m_tbl,
                               const float* tri_tbl, int f_pad, int pos_bits,
                               int rounds, int* best_out, int* binst_out,
                               int* key_out, cudaStream_t stream) {
  if (n > 0) {
    cand_fused<<<grid_for(n), kThreads, 0, stream>>>(
        rays, n, reinterpret_cast<const float4*>(bscan), m_pad, bs_pos_bits,
        inst_tbl, m_tbl, tri_tbl, f_pad, pos_bits, rounds, best_out,
        binst_out, key_out);
  }
  return (int)cudaGetLastError();
}

// Rays of the sphere and mesh kernels (csrc/intersect.cu, csrc/trimesh.cu):
// the planar layout (8, n) float32 [ox oy oz dx dy dz tmin tmax], the
// loads of one lane's ray, and the per-lane chunk cull on a half-line that
// B1 (chunks of the Morton sphere table), B5 and B10's scan (chunks of the
// instance table) share; B8 and B10's sweep (chunks of the triangle table)
// take it with segment_cull_tri's terms (csrc/trimesh.cu states why).
//
// The chunk cull: a lane tests a chunk's covering sphere (C, R) against
// its segment [tmin, t_end] and skips the chunk's rows where the segment
// passes farther than lim from C. The cull never skips a row whose
// quadratic, as the kernels compute it, gives a root that the row's test
// could accept, so it changes no bit of a result.
//
// The margin holds on a half-line (primary and bounce rays carry
// tmax = +inf, so a margin built on max(|tmin|, |tmax|) would be
// infinite). With v = C - o, s* = v.d / d.d, e = R + scale (|C|_1 + R +
// |o|_1) and k = sqrt(|d.d - 1|) + scale, the computed root t of a row's
// quadratic (b = o.d - c.d, c0 = |o|^2 - 2 c.o + |c|^2 - r^2, t = -b -+
// sqrt(b^2 - c0)) puts q = o + t d within e + k |t| of C: R covers
// |c - C| + r, scale the rounding (the caller passes
// ops/intersect_kernels.py:CULL_SCALE, which states it, a tangent row hit
// only by rounding included) and sqrt(|d.d - 1|) |t| the distance a
// non-unit d adds to a root's point. Projected on the ray,
// |t - s*| sqrt(d.d) <= e + k |t|, so where |d.d - 1| <= 2^-8 (k <=
// 0.0665, sqrt(d.d) >= 0.998), |t| <= 1.0713 |s*| + 1.0734 e <=
// 1.125 (|s*| + e). Both roots of a row lie within
// lim = e + 1.125 k (|s*| + e) of C, and so does every point between
// them (the distance to C is convex along the ray). A row that B1 accepts
// has a root in [tmin, t_end]; a row that B5 accepts has its roots'
// interval meet [tmin, t_end] (or, where t_end < tmin, hold t_end). Either
// way a point of the segment, or t_end itself, lies within lim of C, so
// the segment's nearest point s = clamp(s*, tmin, t_end) does too: the
// chunk is skipped only where |v - s d|^2 > lim^2. lim is finite for every
// chunk, so a ray with no hit yet is culled too. Outside |d.d - 1| <= 2^-8
// no chunk is skipped, and non-finite inputs make lim infinite or NaN or
// the compare false: no skip.

#pragma once

#include <cuda_runtime.h>

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int n, int i) {
  Ray r;
  r.ox = rays[0 * (size_t)n + i];
  r.oy = rays[1 * (size_t)n + i];
  r.oz = rays[2 * (size_t)n + i];
  r.dx = rays[3 * (size_t)n + i];
  r.dy = rays[4 * (size_t)n + i];
  r.dz = rays[5 * (size_t)n + i];
  r.tmin = rays[6 * (size_t)n + i];
  r.tmax = rays[7 * (size_t)n + i];
  return r;
}

// The six origin and direction rows of lane i's ray.
__device__ __forceinline__ void load_origin_dir(
    const float* __restrict__ rays, int n, int i, Ray* r) {
  r->ox = rays[0 * (size_t)n + i];
  r->oy = rays[1 * (size_t)n + i];
  r->oz = rays[2 * (size_t)n + i];
  r->dx = rays[3 * (size_t)n + i];
  r->dy = rays[4 * (size_t)n + i];
  r->dz = rays[5 * (size_t)n + i];
}

// Lane i's ray for a kernel whose dead lanes (tmax < tmin) do nothing:
// tmin and tmax first, the other six rows only where the lane is live
// (a dead lane keeps o = d = 0). Returns whether it is live.
__device__ __forceinline__ bool load_live_ray(const float* __restrict__ rays,
                                              int n, int i, Ray* r) {
  *r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  if (i >= n) return false;
  r->tmin = rays[6 * (size_t)n + i];
  r->tmax = rays[7 * (size_t)n + i];
  if (!(r->tmax >= r->tmin)) return false;
  load_origin_dir(rays, n, i, r);
  return true;
}

// The per-lane terms of the cull: 1 / d.d, scale |o|_1 and the slope
// 1.125 k (+inf outside |d.d - 1| <= 2^-8: no skip).
struct SegmentCull {
  float inv_dd, m_o, slope;
};

__device__ __forceinline__ SegmentCull segment_cull(const Ray& r,
                                                    float scale) {
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float o1 = fabsf(r.ox) + fabsf(r.oy) + fabsf(r.oz);
  const float dev = fabsf(dd - 1.0f);
  SegmentCull c;
  c.slope = dev <= 0.00390625f ? 1.125f * (sqrtf(dev) + scale)
                               : __int_as_float(0x7F800000);
  c.m_o = scale * o1;
  c.inv_dd = 1.0f / dd;
  return c;
}

// The per-lane terms of the triangle-chunk cull (csrc/trimesh.cu): as
// segment_cull, but with the slope 1.125 scale, since the point of a
// triangle hit's t assumes no unit direction (the quadratic's sqrt(|d.d -
// 1|) |t| term does not arise); +inf outside |d.d - 1| <= 2^-8: no skip.
__device__ __forceinline__ SegmentCull segment_cull_tri(const Ray& r,
                                                        float scale) {
  const float dd = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float o1 = fabsf(r.ox) + fabsf(r.oy) + fabsf(r.oz);
  const float dev = fabsf(dd - 1.0f);
  SegmentCull c;
  c.slope = dev <= 0.00390625f ? 1.125f * scale : __int_as_float(0x7F800000);
  c.m_o = scale * o1;
  c.inv_dd = 1.0f / dd;
  return c;
}

// A chunk's covering sphere as the cull reads it: centre and
// R + scale (|C|_1 + R).
__device__ __forceinline__ float4 cull_sphere(float bx, float by, float bz,
                                              float br, float scale) {
  return make_float4(bx, by, bz,
                     br + scale * (fabsf(bx) + fabsf(by) + fabsf(bz) + br));
}

// True where the segment [tmin, t_end] of the ray passes farther than lim
// from the sphere b (from cull_sphere): the lane skips the chunk.
__device__ __forceinline__ bool segment_misses(const SegmentCull& c,
                                               const Ray& r, float t_end,
                                               float4 b) {
  const float vx = b.x - r.ox, vy = b.y - r.oy, vz = b.z - r.oz;
  const float vd = vx * r.dx + vy * r.dy + vz * r.dz;
  const float s_star = vd * c.inv_dd;
  const float sc = fminf(fmaxf(s_star, r.tmin), t_end);
  const float wx = vx - sc * r.dx, wy = vy - sc * r.dy,
              wz = vz - sc * r.dz;
  const float e = b.w + c.m_o;
  const float lim = e + c.slope * (fabsf(s_star) + e);
  return wx * wx + wy * wy + wz * wz > lim * lim;
}

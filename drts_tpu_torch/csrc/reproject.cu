// History reprojection on Hopper (sm_90a).
//
// drts_reproject replaces the TPU kernel
// drts_tpu/ops/reproject_pallas.py:reproject_window (B4) with the exact
// per-pixel gather its window scheme approximates. It is bound to PyTorch
// through a plain C interface and ctypes; drts_tpu_torch/ops/
// reproject_kernels.py holds the wrapper and the plain PyTorch version it
// is checked against.
//
// Per output pixel (x, y) of a band of h rows starting at history row
// row0, the (src_h, W, C) history is sampled at (x + motion_x,
// row0 + y + motion_y) (row0 = 0 and h = src_h: the whole frame; the
// sharded frame writes only its band's rows of the gathered history):
// - nearest: the tap at round-half-even, clamped into the frame; the C
//   32-bit words are copied as integers, so f16-packed rows arrive bit for
//   bit;
// - bilinear: the clamp-addressed tent of reproject_pallas._gather_fallback
//   (floor, fraction, both taps of each axis clamped).
// ok = the sample point lies inside the history's frame (the caller's
// disocclusion test). The TPU fetched one window per 16 x 384 tile because a random row
// gather is slow there; on this card the gather is the kernel, and its
// taps are exact whatever the motion field.
//
// Bound by memory: C words read per tap and C written, plus the 8-byte
// motion and the 1-byte ok, per pixel (~83 MB at 1080p with C = 4, ~25 us
// at 3.35 TB/s for nearest). What the design does about it: one thread
// per (pixel, vector of V words), V = 4, 2 or 1 (a template parameter the
// wrapper picks from C and the pointers' alignment). Neighbouring threads
// then load and store neighbouring 4V-byte vectors of one tap row and of
// the output, so a warp's store is one contiguous run and its loads are as
// contiguous as the motion field; a pixel costs C / V loads and stores
// instead of C. Bilinear mode keeps one thread per pixel over its C
// channels: measured on an H100 at C = 3, that beat one thread per
// (pixel, channel), whose threads each redo the tap addresses and weights
// (PERF.md). A block covers about kSlots vector slots along a row and
// kRows rows, a 2-D patch whose taps fall into a few source rows where the
// motion is smooth (measured on an H100: within 2% of row-major blocks in
// nearest mode, 5-9% faster in bilinear; PERF.md). A pixel of more than
// kSlots vector slots has a block row to itself, and one of more than 1024
// has each thread loop over several vectors, so any C launches.
// Each thread loads its pixel's motion as one float2; the thread of word
// 0 writes ok. Built with -fmad=false: the bilinear weights round in the
// plain version's order.

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 32;  // vector slots along a row per block
constexpr int kRows = 8;    // rows per block
constexpr int kMaxThreads = 1024;

template <int V> struct Words;
template <> struct Words<1> { using type = int; };
template <> struct Words<2> { using type = int2; };
template <> struct Words<4> { using type = int4; };

__device__ __forceinline__ int clamp_index(float v, int hi) {
  // fmaxf maps NaN to 0; the float clamp keeps out-of-range values out of
  // the int conversion.
  return (int)fminf(fmaxf(v, 0.f), (float)hi);
}

// Block (slots, pixels, rows): threadIdx.x walks a pixel's c / V vector
// slots, so consecutive threads (and lanes of a warp) cover consecutive
// vectors of consecutive pixels, and no thread divides by c / V.
template <int V, bool kBilinear>
__global__ void reproject(const float* __restrict__ src,
                          const float2* __restrict__ motion, int h,
                          int src_h, int row0, int w, int c,
                          float* __restrict__ out,
                          unsigned char* __restrict__ ok) {
  using Vec = typename Words<V>::type;
  const int x = blockIdx.x * blockDim.y + threadIdx.y;
  const int y = blockIdx.y * blockDim.z + threadIdx.z;
  if (x >= w || y >= h) return;
  const size_t i = (size_t)y * w + x;
  const float2 m = motion[i];
  const float px = (float)x + m.x;
  const float py = (float)(row0 + y) + m.y;
  if (threadIdx.x == 0) {
    ok[i] = px >= 0.f && px <= (float)(w - 1) && py >= 0.f &&
            py <= (float)(src_h - 1);
  }
  if (!kBilinear) {
    const int xi = clamp_index(rintf(px), w - 1);
    const int yi = clamp_index(rintf(py), src_h - 1);
    const Vec* row =
        reinterpret_cast<const Vec*>(src + ((size_t)yi * w + xi) * c);
    Vec* dst = reinterpret_cast<Vec*>(out + i * c);
    for (int q = threadIdx.x; q < c / V; q += blockDim.x) dst[q] = row[q];
    return;
  }
  const float y0 = floorf(py), x0 = floorf(px);
  const float fy = py - y0, fx = px - x0;
  const int y0i = clamp_index(y0, src_h - 1), x0i = clamp_index(x0, w - 1);
  const int y1i = min(y0i + 1, src_h - 1), x1i = min(x0i + 1, w - 1);
  const float* r00 = src + ((size_t)y0i * w + x0i) * c;
  const float* r01 = src + ((size_t)y0i * w + x1i) * c;
  const float* r10 = src + ((size_t)y1i * w + x0i) * c;
  const float* r11 = src + ((size_t)y1i * w + x1i) * c;
  for (int k = 0; k < c; ++k) {
    out[i * c + k] = (r00[k] * (1.f - fx) + r01[k] * fx) * (1.f - fy) +
                     (r10[k] * (1.f - fx) + r11[k] * fx) * fy;
  }
}

// per_pixel: the threads that share a pixel (its c / V vector slots in
// nearest mode, 1 in bilinear mode).
template <int V, bool kBilinear>
cudaError_t launch(const float* src, const float* motion, int h, int src_h,
                   int row0, int w, int c, int per_pixel, float* out,
                   unsigned char* ok, cudaStream_t stream) {
  const int slots = min(per_pixel, kMaxThreads);
  const int pixels = max(1, kSlots / slots);
  const int rows = max(1, min(kRows, kMaxThreads / (slots * pixels)));
  const dim3 block(slots, pixels, rows);
  const dim3 grid((w + pixels - 1) / pixels, (h + rows - 1) / rows);
  reproject<V, kBilinear><<<grid, block, 0, stream>>>(
      src, reinterpret_cast<const float2*>(motion), h, src_h, row0, w, c,
      out, ok);
  return cudaGetLastError();
}

}  // namespace

// h output rows (motion and out) of the src_h-row history, starting at
// history row row0 (0 <= row0, row0 + h <= src_h). vec: words per thread
// in nearest mode (1, 2 or 4), dividing c, with src and out aligned to
// 4 * vec bytes and motion to 8; 1 in bilinear mode, where a thread takes
// a pixel's c channels.
extern "C" int drts_reproject(const float* src, const float* motion, int h,
                              int src_h, int row0, int w, int c,
                              int bilinear, int vec, float* out,
                              unsigned char* ok, cudaStream_t stream) {
  if (h <= 0 || w <= 0) return (int)cudaGetLastError();
  if (c <= 0 || c % vec != 0 || (bilinear && vec != 1) || row0 < 0 ||
      row0 + h > src_h) {
    return cudaErrorInvalidValue;
  }
  if (bilinear) {
    return (int)launch<1, true>(src, motion, h, src_h, row0, w, c, 1, out,
                                ok, stream);
  }
  switch (vec) {
    case 4:
      return (int)launch<4, false>(src, motion, h, src_h, row0, w, c, c / 4,
                                   out, ok, stream);
    case 2:
      return (int)launch<2, false>(src, motion, h, src_h, row0, w, c, c / 2,
                                   out, ok, stream);
    case 1:
      return (int)launch<1, false>(src, motion, h, src_h, row0, w, c, c,
                                   out, ok, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

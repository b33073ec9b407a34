// ReSTIR DI initial light-candidate RIS on Hopper (sm_90a).
//
// drts_initial_light_candidates replaces the TPU kernel
// drts_tpu/ops/restir_pallas.py:initial_light_candidates (B3). It is bound
// to PyTorch through a plain C interface and ctypes;
// drts_tpu_torch/ops/restir_kernels.py holds the wrapper and the plain
// PyTorch version it is checked against, which repeats this arithmetic
// operation for operation.
//
// Per pixel, all n_l ReGIR candidate rounds: slot select from the
// prefetched cell rows, light-row fetch, uniform cone sampling of the
// sphere light, the three-lobe BSDF (Burley diffuse, GGX specular,
// transmission) with its mixture pdf, the MIS weight against the BRDF
// candidates, and the sequential reservoir update.
//
// Design: one thread per pixel, every stream planar so each row load and
// store is coalesced. The compact light table ((L, 9) f32, at most 128
// rows = 4.6 KB on the frame's path) sits in shared memory and a
// candidate's row is an indexed load, where the TPU kernel used a one-hot
// matmul on its matrix unit. Bound by memory: (24 + 4 n_l + 2 s + 10)
// words per pixel cross device memory once (0.68 GB at 1080p with
// n_l = s = 8, ~0.2 ms at 3.35 TB/s); the ~300 float operations per
// candidate fit under that.
//
// What held the first form back (PERF.md): each round's select was a
// chain of loads, u_slot from device memory, then the pixel's own
// candidate and weight rows gathered at the slot it picked (a warp's
// load spread over up to s rows), then the light row: 16 serialized
// device-memory round trips per pixel. This form breaks the chain:
// - a block's 2 s slot rows are read row by row, coalesced, into shared
//   memory laid out [row][pixel], so the select is a shared-memory load
//   and the lanes of a warp hit distinct banks;
// - the next round's four uniforms are loaded while this round computes;
// - sin and cos of one angle come from one sincosf;
// - what a thread keeps across its rounds but reads at most a few times a
//   round (the reservoir's winner, the BSDF's colour, geometric-normal,
//   index and lobe terms) lives in shared memory, [row][pixel], and
//   __launch_bounds__ asks for 7 resident blocks of 128 threads: ptxas
//   then fits 72 registers without a spill, where the first form held 100
//   registers at 2 blocks of 256 threads per SM (25% occupancy; PERF.md).
// Slot rows that do not fit the shared-memory budget are staged in tiles
// of kSlotTileBytes: every round restages each tile (with a barrier) and
// picks its slot from the tile that holds it; at s <= 32 there is one
// tile, staged once.
//
// Numbers: built with -fmad=false and without --use_fast_math: every
// multiply and add rounds on its own in the plain version's order, and
// sqrtf and the divisions are IEEE. sincosf is the CUDA library's (2 ulp
// for each of sin and cos), so they may differ from PyTorch's in the last
// bit; the check states a bound on reservoir picks that flip.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // pixels per block
constexpr int kMinBlocks = 7;  // resident blocks per SM asked of ptxas
constexpr int kRowsPerLight = 9;
// Slot rows per tile: 32 slots (64 rows) of 128 pixels.
constexpr size_t kSlotTileBytes = 32 * 1024;
constexpr size_t kDefaultSmem = 48 * 1024;  // above it, opt in
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 0.31830988618379067154f;
constexpr float kTwoPi = 6.28318530717958647692f;

// Surface stream rows (restir_pallas.ROW_*).
enum {
  kPx, kPy, kPz, kNx, kNy, kNz, kGx, kGy, kGz, kVx, kVy, kVz,
  kCr, kCg, kCb, kMetal, kRough, kIorI, kIorO, kTrans, kValid,
  kWd, kWs, kWt, kSurfRows
};

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float len = sqrtf(fmaxf(x * x + y * y + z * z, 0.f));
  const float inv = 1.f / fmaxf(len, 1e-20f);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ float pow5(float x) {
  x = fminf(fmaxf(x, 0.f), 1.f);
  const float x2 = x * x;
  return x2 * x2 * x;
}

// Per-pixel rows of shared memory, [row][pixel] (each thread reads and
// writes its own column only): what a thread keeps across its rounds but
// reads at most a few times a round, held out of its registers: the
// reservoir's winner and the BSDF's colour, geometric-normal, index and
// lobe terms.
enum {
  kRUv0, kRUv1, kRPhat, kRDx, kRDy, kRDz, kRDist, kRIdx, kRAux,  // winner
  kRF0r, kRF0g, kRF0b, kRAlr, kRAlg, kRAlb, kRCr, kRCg, kRCb,
  kRGx, kRGy, kRGz, kRIorI, kRIorO, kRWd, kRWs, kRWt, kRG1v, kPixRows
};

// Copies slot rows [t0, t0 + tile_s) of the block's pixels into shared
// memory, row by row (coalesced): the candidate rows, then the weight rows,
// each [row][kThreads].
__device__ __forceinline__ void stage_slots(const float* __restrict__ slots,
                                            int n, int s, int i0, int t0,
                                            int tile_s, float* s_slot) {
  const int rows = min(tile_s, s - t0);
  for (int k = threadIdx.x; k < 2 * rows * kThreads; k += kThreads) {
    const int row = k / kThreads, col = k % kThreads;
    const int src = row < rows ? t0 + row : s + t0 + row - rows;
    const int dst = row < rows ? row : tile_s + row - rows;
    s_slot[dst * kThreads + col] =
        i0 + col < n ? slots[(size_t)src * n + i0 + col] : 0.f;
  }
}

// Shared memory: the light table, one tile of slot rows, the per-pixel
// rows. kMinBlocks caps the registers at 72, which ptxas meets without a
// spill (PERF.md).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
initial_candidates(const float* __restrict__ surf,
                   const float* __restrict__ uni,
                   const float* __restrict__ slots, int n,
                   const float* __restrict__ table, int n_lights, int n_l,
                   int s, int n_b, int tile_s, float* __restrict__ out_f,
                   int* __restrict__ out_i) {
  extern __shared__ float s_mem[];
  float* s_table = s_mem;  // (n_lights, 9), row-major
  float* s_slot = s_mem + n_lights * kRowsPerLight;
  float* s_pix = s_slot + 2 * tile_s * kThreads + threadIdx.x;
  auto pix = [s_pix](int row) -> float& { return s_pix[row * kThreads]; };
  const int i0 = blockIdx.x * kThreads;
  // Lanes past n compute on pixel n - 1 and store nothing: every thread
  // joins the barriers of the slot tiles.
  const int i = min(i0 + (int)threadIdx.x, n - 1);
  const size_t N = (size_t)n;
#define SURF(row) surf[(row) * N + i]
  const float px = SURF(kPx), py = SURF(kPy), pz = SURF(kPz);
  const float nx = SURF(kNx), ny = SURF(kNy), nz = SURF(kNz);
  const float vx = SURF(kVx), vy = SURF(kVy), vz = SURF(kVz);
  const float cr = SURF(kCr), cg = SURF(kCg), cb = SURF(kCb);
  const float metal = SURF(kMetal), rough = SURF(kRough);
  const float ior_i = SURF(kIorI), ior_o = SURF(kIorO);
  const float wt = SURF(kWt);
  const bool valid = SURF(kValid) > 0.5f;
  pix(kRGx) = SURF(kGx);
  pix(kRGy) = SURF(kGy);
  pix(kRGz) = SURF(kGz);
  pix(kRWd) = SURF(kWd);
  pix(kRWs) = SURF(kWs);
#undef SURF
  float nu_slot = uni[0 * N + i], nu_keep = uni[1 * N + i];
  float nuv0 = uni[2 * N + i], nuv1 = uni[3 * N + i];
  for (int k = threadIdx.x; k < n_lights * kRowsPerLight; k += kThreads) {
    s_table[k] = table[k];
  }
  const int n_tiles = (s + tile_s - 1) / tile_s;
  stage_slots(slots, n, s, i0, 0, tile_s, s_slot);
  __syncthreads();

  // BSDF parameters (bxdf.make_bsdf).
  float f_diel = (ior_i - ior_o) / (ior_i + ior_o);
  f_diel = f_diel * f_diel;
  pix(kRF0r) = f_diel + (cr - f_diel) * metal;
  pix(kRF0g) = f_diel + (cg - f_diel) * metal;
  pix(kRF0b) = f_diel + (cb - f_diel) * metal;
  pix(kRAlr) = cr * (1.f - metal);
  pix(kRAlg) = cg * (1.f - metal);
  pix(kRAlb) = cb * (1.f - metal);
  pix(kRCr) = cr;
  pix(kRCg) = cg;
  pix(kRCb) = cb;
  pix(kRIorI) = ior_i;
  pix(kRIorO) = ior_o;
  pix(kRWt) = wt;

  // View-dependent terms shared by every candidate.
  const float nov = fabsf(dot3(nx, ny, nz, vx, vy, vz));
  const bool is_trans = wt > 0.f;
  const float a_g = rough * rough;
  const float a2_g = a_g * a_g;
  pix(kRG1v) =
      2.f * nov /
      fmaxf(nov + sqrtf(fmaxf(a2_g + (1.f - a2_g) * nov * nov, 0.f)), 1e-8f);
  const float m_total = (float)(n_l + n_b);
  const float rw = 1.f - wt;
  const float p5_v = pow5(1.f - nov);

  for (int k = kRUv0; k <= kRAux; ++k) pix(k) = 0.f;
  float w_sum = 0.f;

  for (int r = 0; r < n_l; ++r) {
    const float u_slot = nu_slot, u_keep = nu_keep, uv0 = nuv0, uv1 = nuv1;
    if (r + 1 < n_l) {
      nu_slot = uni[(4 * r + 4) * N + i];
      nu_keep = uni[(4 * r + 5) * N + i];
      nuv0 = uni[(4 * r + 6) * N + i];
      nuv1 = uni[(4 * r + 7) * N + i];
    }

    const int slot = min((int)(u_slot * (float)s), s - 1);
    float cand_f = 0.f, w_cand = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = t * tile_s;
      if (n_tiles > 1) {
        __syncthreads();
        stage_slots(slots, n, s, i0, t0, tile_s, s_slot);
        __syncthreads();
      }
      const int k = slot - t0;  // the slot's row in this tile
      if (k >= 0 && k < tile_s) {
        cand_f = s_slot[k * kThreads + threadIdx.x];
        w_cand = s_slot[(tile_s + k) * kThreads + threadIdx.x];
      }
    }
    const int cand = min(max((int)cand_f, 0), n_lights - 1);
    const float* row = s_table + cand * kRowsPerLight;
    const float lcx = row[0], lcy = row[1], lcz = row[2], lrad = row[3];
    const float em_r = row[4], em_g = row[5], em_b = row[6];
    const float lpow = row[7], laux = row[8];

    // Cone sampling (light.sample_sphere_light_rows).
    const float tcx = lcx - px, tcy = lcy - py, tcz = lcz - pz;
    const float dist_c =
        fmaxf(sqrtf(fmaxf(dot3(tcx, tcy, tcz, tcx, tcy, tcz), 0.f)), 1e-6f);
    const float wx = tcx / dist_c, wy = tcy / dist_c, wz = tcz / dist_c;
    float sin_max_sq = lrad / dist_c;
    sin_max_sq = fminf(fmaxf(sin_max_sq * sin_max_sq, 0.f), 1.f - 1e-6f);
    const float cos_max = sqrtf(1.f - sin_max_sq);
    const float cos_t = 1.f - uv0 * (1.f - cos_max);
    const float sin_t = sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f));
    const float phi = kTwoPi * uv1;
    // Duff et al. basis (m.orthonormal_basis).
    const float sgn = wz >= 0.f ? 1.f : -1.f;
    const float a = -1.f / (sgn + wz);
    const float b = wx * wy * a;
    const float tx = 1.f + sgn * wx * wx * a, ty = sgn * b, tz = -sgn * wx;
    const float bx = b, by = sgn + wy * wy * a, bz = -wy;
    float sin_phi, cos_phi;
    sincosf(phi, &sin_phi, &cos_phi);
    const float sc = sin_t * cos_phi, ss = sin_t * sin_phi;
    const float ldx = tx * sc + bx * ss + wx * cos_t;
    const float ldy = ty * sc + by * ss + wy * cos_t;
    const float ldz = tz * sc + bz * ss + wz * cos_t;
    const float inv_cone = fmaxf(kTwoPi * (1.f - cos_max), 1e-8f);  // 1/pdf
    const float bq = dot3(-tcx, -tcy, -tcz, ldx, ldy, ldz);
    const float cq = dot3(tcx, tcy, tcz, tcx, tcy, tcz) - lrad * lrad;
    const float disc = fmaxf(bq * bq - cq, 0.f);
    const float ldist = fmaxf(-bq - sqrtf(disc), 1e-4f);

    // Half vector: reflection form, or the refraction form where the
    // transmission lobe is on and L is below the geometric surface.
    const float gx = pix(kRGx), gy = pix(kRGy), gz = pix(kRGz);
    float hx = ldx + vx, hy = ldy + vy, hz = ldz + vz;
    normalize3(hx, hy, hz);
    float rx = ldx * pix(kRIorO) + vx * pix(kRIorI);
    float ry = ldy * pix(kRIorO) + vy * pix(kRIorI);
    float rz = ldz * pix(kRIorO) + vz * pix(kRIorI);
    normalize3(rx, ry, rz);
    if (dot3(gx, gy, gz, rx, ry, rz) < 0.f) {
      rx = -rx;
      ry = -ry;
      rz = -rz;
    }
    const float gol = dot3(gx, gy, gz, ldx, ldy, ldz);
    if (is_trans && gol < 0.f) {
      hx = rx;
      hy = ry;
      hz = rz;
    }
    const float nol = fabsf(dot3(nx, ny, nz, ldx, ldy, ldz));
    const float noh = fabsf(dot3(nx, ny, nz, hx, hy, hz));
    const float voh = fabsf(dot3(vx, vy, vz, hx, hy, hz));
    const bool front = gol > 0.f;

    // Burley diffuse, GGX specular, transmission (brdf.*).
    const float f90 = 0.5f + 2.f * rough * voh * voh;
    const float burley = kInvPi * (1.f + (f90 - 1.f) * pow5(1.f - nol)) *
                         (1.f + (f90 - 1.f) * p5_v);
    const float k_diff = front ? nol * burley * rw : 0.f;
    const float dterm = noh * noh * (a2_g - 1.f) + 1.f;
    const float d_ggx = a2_g / fmaxf(kPi * dterm * dterm, 1e-10f);
    const float gv = nol * sqrtf(fmaxf(nov * nov * (1.f - a2_g) + a2_g, 0.f));
    const float gl = nov * sqrtf(fmaxf(nol * nol * (1.f - a2_g) + a2_g, 0.f));
    const float vis = 0.5f / fmaxf(gv + gl, 1e-8f);
    const float p5 = pow5(1.f - voh);
    const float k_spec = front ? nol * d_ggx * vis * rw : 0.f;
    const float k_trans = nol * pix(kRWt);
    const float f0r = pix(kRF0r), f0g = pix(kRF0g), f0b = pix(kRF0b);
    const float sum_r = k_diff * pix(kRAlr) +
                        k_spec * (f0r + (1.f - f0r) * p5) +
                        k_trans * pix(kRCr);
    const float sum_g = k_diff * pix(kRAlg) +
                        k_spec * (f0g + (1.f - f0g) * p5) +
                        k_trans * pix(kRCg);
    const float sum_b = k_diff * pix(kRAlb) +
                        k_spec * (f0b + (1.f - f0b) * p5) +
                        k_trans * pix(kRCb);
    const float lum = 0.2126f * sum_r * em_r + 0.7152f * sum_g * em_g +
                      0.0722f * sum_b * em_b;
    const float p_hat = (valid && lpow > 0.f) ? lum * inv_cone : 0.f;

    float wi;
    if (n_b > 0) {
      // Mixture pdf of L (bxdf.eval_pdf) in uv measure: the MIS density of
      // the BRDF technique for this light candidate.
      const float pdf_diff = front ? nol * kInvPi : 0.f;
      const float pdf_spec =
          front ? pix(kRG1v) * d_ggx / fmaxf(4.f * nov, 1e-6f) : 0.f;
      const float p_w =
          pix(kRWd) * pdf_diff + pix(kRWs) * pdf_spec + pix(kRWt) * nol;
      const float p_other = p_w * inv_cone;
      const float p_self = 1.f / fmaxf(w_cand, 1e-20f);
      wi = m_total * p_hat /
           fmaxf((float)n_l * p_self + (float)n_b * p_other, 1e-20f);
      wi = w_cand > 0.f ? wi : 0.f;
    } else {
      wi = p_hat * w_cand;
    }

    w_sum = w_sum + wi;
    if (u_keep * w_sum < wi) {
      pix(kRUv0) = uv0;
      pix(kRUv1) = uv1;
      pix(kRPhat) = p_hat;
      pix(kRDx) = ldx;
      pix(kRDy) = ldy;
      pix(kRDz) = ldz;
      pix(kRDist) = ldist;
      pix(kRIdx) = __int_as_float(cand);
      pix(kRAux) = __int_as_float((int)laux);
    }
  }

  if (i0 + (int)threadIdx.x >= n) return;
  out_f[0 * N + i] = pix(kRUv0);
  out_f[1 * N + i] = pix(kRUv1);
  out_f[2 * N + i] = pix(kRPhat);
  out_f[3 * N + i] = w_sum;
  out_f[4 * N + i] = pix(kRDx);
  out_f[5 * N + i] = pix(kRDy);
  out_f[6 * N + i] = pix(kRDz);
  out_f[7 * N + i] = pix(kRDist);
  out_i[0 * N + i] = __float_as_int(pix(kRIdx));
  out_i[1 * N + i] = __float_as_int(pix(kRAux));
}

// Slot rows per shared-memory tile, and the launch's shared-memory bytes.
void slot_tile(int n_lights, int s, int* tile_s, size_t* smem) {
  *tile_s = min(s, max(1, (int)(kSlotTileBytes /
                                (2 * kThreads * sizeof(float)))));
  *smem = ((size_t)n_lights * kRowsPerLight +
           (2 * (size_t)*tile_s + kPixRows) * kThreads) * sizeof(float);
}

// Raises B3's dynamic shared-memory limit on the current device to at
// least `smem`. CUDA keeps the limit for each device, so this does too,
// and calls only when it grows: a launch inside a CUDA graph capture
// then makes no attribute call.
cudaError_t raise_smem_limit(size_t smem) {
  constexpr int kMaxDevices = 64;
  static size_t raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= kDefaultSmem || smem <= raised[dev]) return cudaSuccess;
  rc = cudaFuncSetAttribute(initial_candidates,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem);
  if (rc == cudaSuccess) raised[dev] = smem;
  return rc;
}

}  // namespace

extern "C" int drts_initial_light_candidates(
    const float* surf, const float* uni, const float* slots, int n,
    const float* table, int n_lights, int n_l, int s, int n_b, float* out_f,
    int* out_i, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int tile_s;
  size_t smem;
  slot_tile(n_lights, s, &tile_s, &smem);
  const cudaError_t rc = raise_smem_limit(smem);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = (n + kThreads - 1) / kThreads;
  initial_candidates<<<grid, kThreads, smem, stream>>>(
      surf, uni, slots, n, table, n_lights, n_l, s, n_b, tile_s, out_f,
      out_i);
  return (int)cudaGetLastError();
}

// B3's resources at these sizes: out = [registers per thread, local
// (spill) bytes per thread, shared bytes per block, threads per block,
// resident blocks per SM].
extern "C" int drts_initial_light_candidates_info(int n_lights, int s,
                                                  int* out) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, initial_candidates);
  if (rc != cudaSuccess) return (int)rc;
  int tile_s, blocks = 0;
  size_t smem;
  slot_tile(n_lights, s, &tile_s, &smem);
  rc = raise_smem_limit(smem);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, initial_candidates, kThreads, smem);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = kThreads;
  out[4] = blocks;
  return 0;
}

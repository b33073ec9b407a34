"""The sharded multi-device frame (port of ``drts_tpu/parallel``).

The reference keeps the frame state sharded between frames: it jits the
frame with ``frame_state_sharding`` for its input and output, every
(H, W, ...) buffer split by rows and SHARC's capacity-sized tables by
slot range, the image row-sharded, and GSPMD adds the halos and gathers.
PyTorch has no GSPMD, so the port shards the frame explicitly, one
process (and one card) per rank of a ``torch.distributed`` group
(``RenderPipeline.render_frame(..., group=...)``):

- **State at rest** follows ``mesh.frame_state_placement``, the
  reference's rule (``RenderPipeline.placement``): between frames a
  per-row leaf holds the rank's ``mesh.row_band`` of its rows (TAA's
  history output-height bands), a per-slot leaf the rank's range of the
  SHARC capacity, a replicated leaf (scene, physics, toggles, counters)
  all of it, the same on every rank. Where a height or the capacity does
  not divide by n the rule replicates the leaf, and so does the port; the
  stages still run by bands, one row apart at most.
  ``RenderPipeline.shard_state`` cuts a one-device state into its shards
  and ``gather_state`` puts them back together.
- **On the band** run the stages that read only their own pixel: the
  G-buffer, ReSTIR's initial candidates and final shading, the SHARC
  update trace's rows, the path trace and the debug views. Each makes its
  pixel coordinates, NDC and RNG streams from the band's first row and
  the full height, so a banded pixel computes what it computes in the
  one-device frame.
- **On the band plus a halo** run the stages of a fixed footprint, the
  halo's rows from the neighbours (``mesh.Band.halo``), clamped at the
  frame's edges, never at the band's: ReSTIR spatial reuse (31 rows for
  per-pixel disc offsets, a cyclic halo for the shared rolls), the
  boiling filter's 16-row tiles, the denoiser's 3x3 clamps and a-trous
  passes (2^i - 1 rows for i passes), TAA's taps and clip, sharpen, the
  bloom pyramid (mip l + 1's band is the rows 2y of mip l's, so no mip is
  gathered), chromatic aberration and every bilinear resize.
- **Histories read at pixel + motion** (the packed reservoir rows of
  ReSTIR temporal, the denoiser's fetch mirrors, TAA's history) are
  gathered for the stage alone, and B4 writes only the band's rows
  (``reproject_packed(..., row0)``). The update (physics, pose, the
  Morton accel) and ReSTIR's light table and grid run whole on every
  rank.
- **SHARC by slot range.** Each rank splats its band's rows; the (C, 4)
  sums and counts (SUM) and the fingerprints (MAX) are reduce-scattered
  into the ranks' slot ranges, the dropped rows all-reduced; each rank
  resolves its range, and the query mirror is all-gathered once a frame
  for the path trace.
- **Counters** that sum over pixels are all-reduced, so every rank
  reports what the one-device frame reports.
- **The image** comes back as the rank's band of output rows;
  ``mesh.gather_rows`` gives the whole image.

Every collective is issued by every rank in the same order with the same
sizes, whatever the data: halos are one all-gather of each rank's edge
rows per dtype, the reduce-scatter ``reduce_scatter_tensor`` (an
all-reduce and a slice is its other form, ``Band.reduce_scatter``).
NCCL runs them with one card per rank, gloo on the CPU (the tests) and on
CUDA tensors where ranks share one card (``chip_smoke.py`` phase 22 (b)).
``multihost`` starts the group from arguments or torchrun's variables and
spawns ranks.
"""

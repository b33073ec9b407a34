"""The multi-device frame (port of ``drts_tpu/parallel``).

The reference shards every (H, W, ...) frame buffer over image rows of a
``jax.sharding.Mesh`` and lets GSPMD insert the collectives. PyTorch has
no GSPMD, so the port decomposes the frame explicitly, one process (and
one card) per rank of a ``torch.distributed`` group:

- **Row bands.** Rank r of n owns image rows ``[r*H//n, (r+1)*H//n)``
  (``mesh.row_band``): bands differ by at most one row, so every height
  divides, and a gather pads to the largest band.
- **On the band** run the stages that read only their own pixel: the
  G-buffer, ReSTIR's initial candidates and final shading, the SHARC
  update trace's rows and the path trace. Each makes its pixel
  coordinates, NDC and RNG streams from the band's first row and the full
  height, so a banded pixel computes what it computes in the one-device
  frame.
- **Replicated on every rank** run the stages with no pixel axis: the
  update (physics, pose, the Morton accel) and ReSTIR's light table and
  ReGIR grid.
- **On the gathered full frame**, replicated, run the stages that read
  other pixels: ReSTIR temporal and spatial reuse, the a-trous denoiser,
  TAA and post (``mesh.gather_tree`` before them).
- **SHARC.** Each rank splats its band's rows; one SUM all-reduce of the
  (C, 4) sums and counts, one MAX of the fingerprints and one SUM of the
  dropped rows hand every rank the same splat, which each resolves into
  the same cache.
- **Counters** that sum over pixels are all-reduced, so every rank
  reports what the one-device frame reports.

Every collective is issued by every rank in the same order, whatever the
data. After a frame every tensor of ``FrameState`` is the same on every
rank (``mesh.replica_checksums``). ``multihost`` starts the group from
arguments or torchrun's variables and spawns ranks.
"""

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (drts_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py

Phases, one printed line or more each; any failure exits non-zero:
1. device: the card's name and power limit; build the CUDA kernels from
   drts_tpu_torch/csrc with nvcc (sm_90a).
2. kernels: B1 (Morton closest hit) and B11 (brute-force closest hit)
   against their plain PyTorch versions on the card at the path trace's
   shapes (exact t and index equality), both times from CUDA events. B1
   runs on the primary and bounce-1 rays of the bench frame; its bound
   counts the work of its culled walk (intersect_kernels.
   intersect_morton_work: chunk tests, chunks met, pairs swept, roots
   taken), printed beside the unculled sweep's bound, chunks met per live
   ray and per warp, and pairs and roots per live ray.
3. golden: tests/test_golden.py's recipe rendered by the port on the card
   (no accel, so B11), held to SSIM > 0.97 and |mean diff| < 0.01 against
   tests/golden/demo_64.png.
4. main: the path-trace bench recipe (1920x1080, 1 spp, 8 bounces, the
   438-sphere demo scene with its per-frame Morton accel): frame time,
   Mray/s and the launch counts of this run alone; then one more frame
   whose B1 launches are recorded and each timed (CUDA events) and counted
   on its own rays: B1's kernel time per frame beside its culled and
   unculled bounds, chunks met per live ray and per warp, and pairs and
   roots per live ray.
5. restir kernels: B2 (any-hit occlusion, its three batches), B3 (initial
   light candidates), B4 (reprojection, nearest and bilinear) and B11 (the
   BRDF-candidate light sweep) against their plain versions, on the inputs
   the third ReSTIR frame at 1920x1080 gives them (so the temporal history
   holds two frames' reservoirs, depths and normals), with kernel and plain
   times from CUDA events; B4 bilinear also beside grid_sample. B2's bound
   counts the work its culled sweep needs (intersect_kernels.
   occlusion_morton_work: chunk tests, chunks met, pairs swept), printed
   beside the unculled sweep's pairs and the chunks a warp meets; B3
   prints its time against its bound and its registers, spills, shared
   memory and resident blocks as the card reports them
   (restir_kernels.initial_light_candidates_info); B4 prints its vector
   width; B11's bound counts the work its kernel needs
   (intersect_kernels.intersect_brute_work: the spheres with r > 0 swept,
   the roots of positive discriminants), printed beside the unculled
   sweep's bound.
6. restir: the ReSTIR frame (RenderPipeline.render_frame with physics,
   ReSTIR DI and post, denoiser "None", SHARC off) at 1920x1080 through
   bench.bench_frame, counted from zero: frame time, per-stage times,
   counters and every kernel's launches; the image must be a finite
   (1080, 1920, 3) in [0, 1], and each of B1, B2, B3, B4 and B11 must have
   launched as often as the frames need.
7. restir small: two ReSTIR frames at 64x64 on the card and on the CPU
   (plain versions, which tests/test_torch_pipeline.py holds against the
   JAX package) from the same start state must agree.
8. mesh kernels: B5 (bound scan), B6 (shared-BLAS sweep), B7 (serial
   instance walk) and B11 (the bounds pre-pass at K = 438) against their
   plain versions, bit for bit, on the inputs that the primary rays and the
   bounce-1 rays of the second mesh frame at 1920x1080 give them (every
   round of the candidate loop; some B6 batch must hold neighbouring lanes
   on different instances), and B7 once more on the primary rays before
   any candidate round, where the serial walk carries every live lane (the
   frame's own backstop batches are almost empty); kernel and plain times
   from CUDA events. B7 is also held to its culled walk
   (trimesh_kernels.intersect_mesh_instances_work), and its bound counts
   that walk's sphere tests, instances entered and triangle work, printed
   beside the unculled sweeps' bound. B6 is also held to its culled walk
   (trimesh_kernels.shared_blas_sweep_work, whose fold must equal its
   words), and its bound counts that walk's work (triangle chunks tested
   and met, cones tested, faces guard-tested and swept), printed beside
   the unculled sweep's bound; each launch is also timed at every
   triangle chunk of TRI_CHUNKS. B5's bound counts its culled walk
   (trimesh_kernels.bound_scan_work: chunk tests, chunks met, rows swept,
   roots taken), printed with chunks met per live ray and per warp, rows
   and roots per live ray and the unculled sweep's bound; B11's as in
   phase 5.
9. mesh: the instanced-mesh frame (the demo scene as 438 instances of one
   512-face geosphere, 1920x1080, 1 spp, 8 bounces) through
   bench.bench_mesh, counted from zero: frame time, Mray/s, rays per frame
   and launches; per trace call B5 must launch 4 times, B6 3, B7 1 and B11
   2; the image must be a finite (1080, 1920, 3) and stay near the sphere
   frame of phase 4 (tone-mapped mean within 25%, primary hit mask equal
   on > 85% of pixels: the two differ by the tessellation's chords).
10. mesh any-hit kernels: B8 (shared-BLAS any hit), B9 (serial any-hit
   walk) and the any-hit launches of B5 and B11 (the bounds pre-pass, hit
   bit only) against their plain versions, bit for bit, on the inputs that
   the three occluded_scene calls of the second all-mesh ReSTIR frame at
   1920x1080 give them (the BRDF candidate's occluder test, the initial
   visibility ray, final shading), with kernel and plain times from CUDA
   events; B9 on each of the frame's three backstop batches, each timed
   and printed with its live lanes and bound, and once more on the
   fullest of the three shadow-ray batches before any candidate round,
   where the serial walk carries every live lane, held against its plain
   version and against the loop's result on the same rays (B8 compares t
   in object units, B9 in world units: they may differ on at most
   ANY_LOOP_SHARE of the live lanes); B9 is also held to its culled walk
   and its bound counts that walk's work (trimesh_kernels.
   intersect_mesh_instances_any_work), printed beside the unculled
   sweep's; each B9 batch is also held and timed at every sparse-block
   threshold of B9_SPARSE_SWEEP, its sparse and dense blocks are printed,
   and both kinds must have run. B5 and B11
   print their culled work as in phase 8. B8 is also held to its culled
   walk, and its bound counts that walk's work
   (trimesh_kernels.shared_blas_any_work: triangle chunks tested and met,
   cones tested, faces guard-tested, faces swept), printed with chunks met
   per live lane and per warp, triangles swept per live lane and the
   unculled sweep's bound; each launch is also timed at every triangle
   chunk of TRI_CHUNKS.
11. mesh restir: the all-mesh ReSTIR frame (render_frame on the scene of
   phase 9, physics on, every face of an emissive instance a triangle
   light) at 1920x1080 through bench.bench_frame(mesh=True), counted from
   zero: frame time, per-stage times, counters (lights_dropped is large
   here: 512 faces per emissive instance against a cap of 128) and every
   kernel's launches; a finite (1080, 1920, 3) in [0, 1] whose mean lies
   within 25% of phase 6's; no overflow; per frame 3 any-hit calls of 3 x
   B5, 2 x B8, 1 x B9 and 1 x B11, and per closest-hit call the counts of
   phase 9; B1, B2 and B3 do not run (no sphere table, triangle lights).
   Then two all-mesh frames at 64x64 on the card and on the CPU, as
   phase 7.
12. B10 kernel: the fused candidate closest hit (trimesh.MESH_CAND = 2)
   against its plain version and its culled walk, bit for bit on best,
   binst and key, and the plain version against the multi-launch loop
   (cand_loop: B5 and B6 round by round) on the same rays, on the inputs
   the primary and bounce-1 trace calls of the second fused mesh frame at
   1920x1080 give it; kernel (at the kept triangle chunk and at each of
   TRI_CHUNKS), plain and loop times from CUDA events. Its bound counts
   the walk's work (trimesh_kernels.cand_fused_work: the scans' chunk
   tests, chunks met, rows and roots, the sweeps' chunk tests, chunks
   met, cones tested, faces guard-tested and swept), printed per live
   lane, per sweep and per warp beside the unculled bound.
13. fused mesh: the mesh frame of phase 9 with MESH_CAND = 2 through
   bench.bench_mesh, counted from zero: frame time, Mray/s and launches;
   per trace call B10 once, B7 once, B11 twice and no B5 or B6; the image
   finite and equal to phase 9's (the same last frame index; B10 walks the
   loop's candidates, so the largest difference is expected to be 0).
14. default frame: RenderPipeline(PipelineConfig()) (physics, ReSTIR DI,
   SHARC updated every second frame, ReBLUR, TAA at native size, post) at
   1920x1080: first B4 against its plain version on every reprojection of
   a warm frame (the ReSTIR history, the denoiser's two packed mirrors,
   nearest, and the TAA history, bilinear), with its vector width and
   kernel, plain and grid_sample times, and B1 per frame over a SHARC
   cadence's launches, each timed and counted on its own rays as in phase
   4; then 7 frames through
   bench.bench_frame, counted from zero: frame time, per-stage times,
   counters and launches (B4 by mode; the stages timed over one SHARC
   cadence of two frames); the image a finite (1080, 1920, 3) in [0, 1],
   SHARC hits on the last timed frame, each kernel launched as the stages
   need; then the upscaled frame (render 960x540, output 1920x1080)
   likewise.
15. default frame small: three default frames at 64x64 (3 bounces, a
   4,096-slot cache) on the card and on the CPU from one start state, and
   one ReLAX and one DLSS-RR frame each, must agree within DEFAULT_*.
16. mesh pipeline: the reference's bench_mesh_pipeline recipe
   (bench.mesh_pipeline_config: the default frame graph on the scene of
   phase 9, rendered at 960x540 and upscaled by TAA to 1920x1080, 8
   bounces, block 32,768, physics off, compact_from=1). First its kernels
   at its own inputs, recorded by stage in the second of two frames: the
   bounce-1 segment's compaction in partition mode and as the key sort
   (the same pixel in every slot, both timed); B5, B6, B7 and B11 on every
   closest-hit call of the trace stage (the bounce-1 segment's 519,168
   octant-partitioned slots, dead ones at the tail, then the deep
   segment's bounces in its slot space), B5, B8, B9 and B11 on the three
   shadow batches as in phase 10, B11 on the BRDF candidate's light sweep
   and B4 on the four reprojections as in phase 14, each against its
   plain version (every word equal; B4 bilinear within B4_BILINEAR_REL)
   and timed beside it. Then through
   bench.bench_frame, counted from zero: frame time, per-stage times,
   counters, spill waves per frame, launches (B4 by mode) and every
   compaction the path traces ran (capacity, the sort _compact_slots
   reports it ran, pixel or slot space); the bounce-1 segment must hold
   519,168 slots in partition mode; the image a finite (1080, 1920, 3) in [0, 1], SHARC hits on the
   last timed frame, each of B4, B5, B6, B7, B8, B9 and B11 launched as
   the stages need and B1, B2, B3 and B10 not at all.
17. mesh pipeline small: three frames of that graph at 64x64 output (32x32
   render, 3 bounces, a 4,096-slot cache, oscillator grid 3 as 45
   instances of a 128-face geosphere) with compact_sort_partition_min=0,
   so every compaction sorts by partition, on the card and on the CPU
   from one start state, must agree within DEFAULT_*.
18. fidelity: crosscheck.run(32, 18, 48 spp, 3 bounces) with the port's
   side on the card must meet tests/test_crosscheck.py's bounds (0.97 <
   energy_ratio < 1.03, mean_rel_err < 0.15); then fidelity.run and
   fidelity.run_mesh at 160x90 (32-spp references, 8 real-time frames, no
   cache), each SSIM finite and in (0, 1], printed with its wall time.
19. textured frame: the default frame graph (bench --textured-frame) on
   the mixed textured scene, add_mesh_content(build(oscillator_grid=10),
   tessellation=3): 438 spheres and three geosphere instances (one an
   alpha-tested cutout checker, two alpha rounds) in one trace. First its
   kernels on its own inputs, the second frame's calls recorded by stage:
   B1, B5, B6, B7 and B11 on every closest-hit call of the G-buffer and
   trace stages, its alpha rounds included (sparse batches with t_min > 0
   per lane); B2 and, for the instances, B5, B8, B9 and B11 on the three
   shadow batches; B11 on the light sweep; B4 on its four reprojections;
   each held to its plain version (every word equal; B4 bilinear within
   B4_BILINEAR_REL) and timed. B3 must not run (the instances make the
   light table a triangle table). The primary lanes that the textured
   alpha rejected are counted from the G-buffer's surfaces and must be
   some. Then through bench.bench_frame, counted from zero: frame time,
   per-stage times, launches per kernel (by formula from the closest-hit
   calls), a finite (1080, 1920, 3) image in [0, 1], SHARC hits. Then three
   64x64 textured default frames and one 64x64 ReSTIR frame lit by a
   seeded lat-long environment map (written with the port's write_exr to a
   temporary directory), card against CPU, each within DEFAULT_*.
20. options: the settings window's options. The options frame (bench
   --options-frame: PipelineConfig() with the thin lens, aperture 0.05,
   focused at 15, ReSTIR with raytraced temporal and spatial bias
   correction, the real previous surface and shared offsets): its second
   frame's calls recorded by stage, B1 on the thin-lens primaries (each
   lane its own origin), B2 on its six visibility batches (BRDF
   candidate, initial, the temporal history, the spatial cross terms
   from this surface and from the neighbour's, final), B3, B4 on its four
   reprojections (the ReSTIR history at C = 12) and at C = 5 on that
   history's first five words, B11 on the light sweep, each held to its
   plain version and timed; then through bench.bench_frame, counted from
   zero (per frame 6 x B2, B3, B11, 4 x B4). The ReSTIR frame with
   accel_mode="none" (bench --frame --accel none) likewise: B11 on every
   closest hit, the light sweep and the three shadow batches, B1 and B2
   not at all. Then every option config at 64x64 on the card and on the
   CPU from one start state, within DEFAULT_*: the options frame with and
   without an accel, Power_RIS, Uniform without an accel,
   local_light_samples=0, the candidate batch, the pairwise modes on the
   pseudo previous surface (B4 at C = 5), the all-mesh frame in the
   raytraced modes, and a deforming mesh, whose motion vectors must agree
   within 1e-3 px and move.
21. shell: the port's CLI, Session and checkpoints at the reference's
   GraphicsSettings() (1920x1080 output, SR Auto, so rendered at 960x540
   and upscaled by TAA; ReSTIR DI, SHARC, ReBLUR, post). (a)
   app.main([... "render", "--frames", "4", "--resume", <dir>,
   "--checkpoint-every", "2", "--metrics-out", ...]) counted from zero:
   the PNG, the metrics line with frame_ms and the JSON-lines records,
   LATEST in the checkpoint directory. (b) A Session: three frames, a
   dynamic set (post.exposure: the next frame launches each kernel as
   often as the frame two before it), a static set (raytracing.bounces),
   a realloc set (post.super_resolution_mode Native: render 1920x1080,
   the frame count carried). (c) save_rotating at frame 3, a fresh
   Session through resume_or_init, its next frame against the
   uninterrupted session's: frame_index, frame_count and launches equal,
   the image within DEFAULT_* (the largest difference printed, and
   whether it is bit-exact). (d) Session.step's warm frame time, also at
   the bench's block 32,768, beside bench --upscaled's, for the record. (e) One frame under
   obs.device_trace and obs.pass_scope: the Chrome trace must hold the
   scope and a launch of each of the five kernels. Every frame of (a)-(c)
   is a finite (1080, 1920, 3) image in [0, 1] that launched B1, B2, B3,
   B4 and B11. The phase names the eager form (``app --eager``,
   ``Session(graph=False)``): it counts each frame's launches.
22. banded: the sharded multi-device frame (drts_tpu_torch/parallel) at
   PipelineConfig(), 1920x1080, three frames. (a) One NCCL rank
   (multihost.initialize with a localhost coordinator, world size 1):
   render_frame(group=...) against render_frame(group=None) from the same
   state, bit for bit (the image and every FrameState leaf) on the SHARC
   skip frame and within DEFAULT_* on the update frames, the same
   launches. (c) graft_entry.dryrun_multichip(1, graph=False) on that
   group (its graph form is phase 28's). (b) Two
   gloo ranks on the one card (multihost.spawn; NCCL takes one card per
   rank), every collective on CUDA tensors, from
   RenderPipeline.shard_state of the start state: each rank's band of
   each image within DEFAULT_* of (a)'s rows; after the three frames each
   per-row leaf within DEFAULT_* of (a)'s final state's rows, each
   per-slot leaf of (a)'s slot range (the fingerprints equal on
   DEFAULT_FP_SHARE of the slots filled in either), each leaf shaped as
   the placement says, the replicated leaves equal on both ranks
   (parallel.mesh.replica_checksums over those leaves only); each rank's
   FrameState bytes and peak device memory, its launches of B1, B2, B3,
   B4 and B11 per frame, and both reduce-scatter forms on CUDA tensors;
   then rank RECORD_RANK (1, whose band starts at row 540, so B4 runs at
   a nonzero row offset) records one more frame's kernel calls, holds
   each to its plain version and times it on its band's inputs (B4 on
   the gathered histories, writing its band's rows). (d) The time of
   each.
23. record: python -m drts_tpu_torch.bench --record --eager (the eager
   form: the phase counts eager launches), the reference's
   bench record (bench.py:main: the headline path trace, the full
   pipeline, the upscaled frame, the mesh trace at 2 and 8 bounces, the
   all-mesh pipeline, the port's fidelity record), run as a user runs it,
   in a process of its own with a RECORD_TIMEOUT limit: exit 0, the last
   line's keys the reference's (bench.RECORD_KEYS, fidelity_recorded
   included), no "errors", "device" the card's name, every number finite
   and above zero but the counters (loss counts, zero where nothing is
   lost: finite and >= 0; the SHARC rates in [0, 1], some hit rate above
   zero); each bench's launches from its stderr line as its graph
   launches them (the counts of phases 4, 9, 14 and 16 by frames and
   closest-hit calls). The record is printed on a line of its own, with
   the phase's time.
24. routes: the reference's other two sphere-accel routes. (a) The MXU
   opt-in (clusters._USE_MXU set for the phase and restored after it;
   make_morton_accel then builds the A-matrices): B12a against its plain
   version on the headline frame's 2,073,600 primary rays (hit/miss flips
   only within MXU_GRAZE of grazing and on at most MXU_FLIP_SHARE of the
   live rays; t within MXU_T_RTOL relative plus MXU_T_ATOL and the index
   the plain version's or a tie where no sphere is within MXU_STRICT of
   grazing) and against itself with the chunk cull off (every word
   equal: the cull's margin MXU_CULL_SCALE holds), both timed, its bound
   from intersect_kernels.intersect_morton_mxu_work (the tensor-core
   products at the dense bf16 rate, the tail at the float32 rate), its
   share of the bound and its resources (intersect_morton_mxu_info:
   registers, spill bytes, shared bytes, blocks an SM, the persistent
   grid, the table resident or tiled); the headline frame
   (bench.trace_frame, frame 1 after a warm frame 0) with the opt-in on
   and off, counted from zero: B12a 9 plus 7 a spill wave (the deep
   segment again), B1 0, the frame times and the image difference, then
   B12a summed over that frame's launches, recorded from one more frame 1
   and each timed on its own rays, beside the sum of their bounds; the
   upscaled default frame (960x540 to 1920x1080) over one
   SHARC cadence of two frames with the opt-in on and off from the same
   state: B12a 13.5 a frame (9, and 9 more for the SHARC update every
   second frame) plus 7 a spill wave, B12b 3 a frame, B1 and B2 0 (with the
   opt-in off: B1 likewise, B2 3 a frame), the frame times and the image
   difference, and B12b against its plain version on the first frame's
   three shadow batches (flips as B12a's, every bit equal with the cull
   off), each timed with its bound. (b) The clustered accel
   (clusters.build_plan on the rest pose, make_accel per frame,
   bench.make_trace_setup(accel="clustered")):
   B13 against its plain version on the primary rays, every word equal,
   both timed, its bound from intersect_clustered_work (printed beside
   the bound of every slot of the touched clusters), its share of the
   bound and its resources (intersect_clustered_info); the headline frame
   counted from zero (B13 9 plus 7 a spill wave, no B1 or B11), B13 summed
   over its launches as B12a's, and its image against the Morton route's
   frame of (a). (c) The reference's other two MXU precisions
   (intersect_kernels.MXU_PREC set to "default", then "highest", and
   restored): B12a on the primary rays and B12b on (a)'s three shadow
   batches, each against its plain version (the MXU_* limits; grazing at
   "default" on the plain version's own quadratic) and with its chunk cull
   off (every word equal; "default" runs with it off), timed as a median
   of 10 with its bound (1 or 6 mmas a swept slot), share and resources;
   then at that precision the headline frame and the two upscaled default
   frames counted from zero (B12a and B12b as in (a), no B1 or B2),
   finite images in [0, 1], printed against the opt-in-off frames. Each
   image
   difference is printed as the mean |difference| of the tone-mapped
   images, the share of pixels that differ at all and of those off by
   more than DEFAULT_OFF; the mean must stay under ROUTE_MEAN.
25. graphs: the compiled frame (drts_tpu_torch/graphs.py). (a) The
   1080p default frame from one start: GRAPH_FRAMES eager frames twice
   (their run-to-run spread: SHARC's splat sums with float atomics) and
   through RenderPipeline.render_frame_graph once (both cadence variants
   captured, then replayed); each graph image within DEFAULT_MEAN and
   DEFAULT_OFF_SHARE plus that spread of the eager one; each eager frame's
   launches of B1, B2, B3, B4 and B11 equal to its phase's captured
   frame plus its spill waves' captured launches; the graph frames' spill
   waves the eager frames'. (b) The headline frame (bench.trace_frame)
   eager and through pathtrace.trace_image_graph: the radiance bit for
   bit, the launches against the capture as in (a). (c) The default frame
   with a GRAPH_SPILL_CAPACITY-slot deep segment: as (a), and every frame
   replays its captured spill wave. Each prints the eager and graph
   frame ms (CUDA events at the frame boundaries, GRAPH_FRAMES frames
   after the first: median, min, max), the host launches of a graph frame
   (graph launches and input writes; one host read besides), the kernel
   launches a frame eager and captured, the capture seconds and the peak
   device memory.
26. graphs: the compiled mesh frames, as phase 25 on the all-mesh scene.
   (a) bench_mesh's frame (bench.make_mesh_setup: 1080p, 8 bounces, 438
   instances of a 512-face geosphere) eager and through
   pathtrace.trace_image_graph at MESH_CAND 1 (B5, B6, B7, B11) and 2
   (B10, B7, B11): the radiance bit for bit; (b) the all-mesh ReSTIR
   frame (physics, no SHARC): images bit for bit; (c) the all-mesh
   pipeline (bench.mesh_pipeline_config: 960x540 to 1080p,
   compact_from=1 with the bounce-1 segment in partition mode, SHARC,
   ReBLUR, TAA): images within DEFAULT_MEAN and DEFAULT_OFF_SHARE plus
   two eager runs' spread. Each over GRAPH_FRAMES frames eager and
   through the graph; each eager frame's launches of B4-B11 equal to its
   variant's captured launches plus its spill waves'; each part's
   replays launch every kernel of its path and none of B1, B2, B3. Each
   prints ms, host launches, capture seconds and peak memory.
27. graphs: the rest of the one-device frames, as phase 25, over
   ROUTE_GRAPH_FRAMES frames (the options frame over 4, so that its
   shared offsets move): (a) the textured frame (PipelineConfig() on
   add_mesh_content(build(10), 3)) and (b) the options frame
   (bench.options_frame_config) within DEFAULT_MEAN and
   DEFAULT_OFF_SHARE plus two eager runs' spread; (c) the ReSTIR frame at
   accel_mode="none" bit for bit; (d) at each DRTS_MXU_PREC ("default",
   "high", "highest"; clusters._USE_MXU and intersect_kernels.MXU_PREC
   set, and restored) the MXU headline frame bit for bit and the MXU
   upscaled default frame as (a); (e) the clustered headline frame
   (bench.make_trace_setup(accel="clustered")) bit for bit. Each eager
   frame's launches of B1-B13 equal its variant's captured launches plus
   its spill waves'; each part's replays launch the kernels of
   ROUTE_GRAPH_NEEDS (B12a, B12b and B13 among them) and none of
   ROUTE_GRAPH_NEVER. Each prints ms, host launches, capture seconds and
   peak memory.
28. graphs: the sharded frame. (a) One NCCL rank (a localhost
   coordinator, world size 1), BANDED_GRAPH_FRAMES frames of
   PipelineConfig() at 1920x1080 through render_frame_graph()(...,
   group=), each against the eager render_frame(group=) from the same
   state: the image and every FrameState leaf bit for bit on the SHARC
   skip frame, within DEFAULT_* on the update frames; each eager frame's
   launches of B1, B2, B3, B4 and B11 equal to its phase's captured
   frame plus its spill waves'; an all-reduce (the counters') captured in
   every phase; then BANDED_GRAPH_FRAMES frames of each form timed (CUDA
   events). (b) graft_entry.dryrun_multichip(1) as graph frames, then
   bench_mesh's 1080p frame traced as the rank's band through
   trace_image_graph(cfg, rows=) against the eager banded trace, the
   radiance bit for bit and the launches of B5, B6, B7 and B11 against
   the capture (run_graph_trace). (c) A gloo group on the card refused
   with ValueError. Prints ms, host launches, capture seconds and peak
   memory.
Then a "kernels" JSON line, one entry per kernel and path: B1, B2, B3, B4
and B11 ("intersect_brute", K = 128 lights) with the launches of phase 6
and the times of phases 2 and 5; B5, B6, B7 and B11 once more
("intersect_brute@mesh", K = 438 instance bounds) with the launches of
phase 9 and the times of phase 8; B8, B9 and, once more, B5 and B11
("bound_scan@mesh_restir", "intersect_brute@mesh_restir": their any-hit
launches alone) with the launches of phase 11 and the times of phase 10,
summed over one frame's three calls (B9's are those of the full batch,
and "intersect_mesh_instances_any@backstop" sums the frame's three
backstop batches);
B10 ("cand_fused@mesh_fused") with the launches of phase 13 and the times
of phase 12's primary call; and B1, B2, B3, B4 and B11 once more
("...@default") with the launches of phase 14, B4 with the times of phase
14 (one frame's four reprojections), the others with those of phases 2
and 5 (the default frame's ReSTIR passes and primary rays are the ReSTIR
frame's); and B4, B5, B6, B7, B8, B9 and B11 once more
("...@mesh_pipeline") with the launches and the times of phase 16: B5,
B6, B7 and B11 summed over one frame's trace stage (B7 its own backstop
batches), "bound_scan@mesh_pipeline_any", B8, B9 (the backstop batches)
and "intersect_brute@mesh_pipeline_any" over its three shadow batches,
"intersect_brute@mesh_pipeline_lights" its light sweep, B4 its four
reprojections; and B1, B2, B4, B5, B6, B7, B8, B9 and B11 once more
("...@textured", with "bound_scan@textured_any",
"intersect_brute@textured_any" and "intersect_brute@textured_lights")
with the launches and the times of phase 19: the closest-hit kernels
summed over one frame's G-buffer and trace stages, the any-hit kernels
and B2 over its three shadow batches; and B1, B2, B3, B4 and B11 once
more ("...@options") with the launches and the times of phase 20's
options frame (B1 its thin-lens primaries, B2 its six batches, B4 its
four reprojections, B11 its light sweep), and B11
("intersect_brute@accel_none", "intersect_brute@accel_none_any") with
the launches and the times of phase 20's accel-none frame, summed over
one frame's closest hits and light sweep and over its three shadow
batches; and B1, B2, B3, B4 and B11 once more ("...@banded") with rank
1's launches over phase 22 (b)'s three frames and the times of its
recorded frame (B1 per frame, B2 its three batches, B4 its four
reprojections at row offset 540, B11 its light sweep); and B12a ("intersect_morton_mxu")
with the launches of phase 24's MXU headline frame and the times on its
primary rays, B12b ("occlusion_morton_mxu") with the launches of its two
default frames and the times summed over the three shadow batches, the
same two at "default" and "highest" ("...@default", "...@highest") with
the launches and the median times of phase 24 (c), and
B13 ("intersect_clustered") with the launches of the clustered headline
frame and the times on its primary rays; and B1, B2, B3, B4 and B11 once
more ("...@graph") with the launches the default frame's graph replays
made in phase 25 (a) (the capture's counts a frame, by cadence phase and
spill wave) and the max_abs_err, times and bounds of "...@default": the
script times no kernel inside a replayed graph (``profile_frame``
traces their device times there); and B4-B11 once more
("...@mesh_graph") with the launches all of phase 26's replays made (the
captures' counts) and the readings of "@mesh" (B5, B6, B7, B11: phase
8; B10: phase 12) and "@mesh_pipeline" (B4, B8, B9: phase 16); and
B1, B2, B3, B4 and B11 once more ("...@banded_graph") with the launches
phase 28 (a)'s replays made (the captures' counts) and the readings of
"...@banded", and B5, B6, B7 and B11 once more ("...@banded_graph",
"intersect_brute@banded_mesh_graph") with the launches of phase 28 (b)'s
banded trace replays and the readings of "@mesh" (phase 8); and
once more for each part of phase 27 ("...@textured_graph",
"...@options_graph", "...@accel_none_graph", "...@mxu_graph_<prec>",
"intersect_clustered@clustered_graph") with the launches its replays made
(the captures' counts) and the readings of its eager frame's kernels on
their own inputs (ROUTE_GRAPH_READINGS: phases 19, 20, 2 and 5, 24).
Every bound counts what this run's lanes need (a dead lane reads tmin and
tmax only; an any-hit sweep ends at its first blocking triangle; B1, B2,
B5-B10 count their culled walks and B11 its staged rows and
roots, and their entries also carry "unculled_bound_ms"; B12a and B12b
the filled slots of the chunks each lane meets, their products at the
tensor cores' rate beside their tails at the float32 rate; B13 its
cluster tests, the filled member slots of the clusters each lane
touches, their roots and each slot's |c|^2 - r^2 once), and a kernel
measured under its bound fails the run. B12a's, B12b's and B13's entries
also carry "share_of_bound", the bound over the kernel's time. Then the
card's name and power limit, and, last, {"ok": true, "device": {...}}.
Without a GPU, or without the package beside it, it exits non-zero before
printing any result.
"""

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# The least time the card could take (NVIDIA's data-sheet peaks of an H100
# SXM): device memory at 3.35 TB/s, and float32 outside
# the tensor cores at 67 TFLOP/s, which counts an FMA as two operations;
# the kernels are built with -fmad=false, so each add or multiply issues
# on its own, 33.5e12 per second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
# The tensor cores' dense bf16 rate (B12a, B12b's products).
TC_BF16_FLOPS_PER_S = 989e12
# Operations per unit of work, counted from csrc/*.cu (a sqrt, division,
# sine or cosine counts as one; compares and the integer min as one each).
OPS_B1_PAIR = 25          # ray x table column of the unculled sweep
OPS_B1_SWEPT = 16         # ray x filled slot swept: the discriminant
OPS_B1_ROOT = 11          # ... not negative: root, range test, packed min
OPS_B1_CHUNK = 29         # ray x chunk bound tested (the cull)
OPS_B1_MET = 5            # a met chunk's segment end from the packed best
OPS_B1_RAY = 30           # a live ray's od, oo, cull margin and unpacking
OPS_B11_PAIR = 26         # ray x sphere of the unculled sweep
OPS_B11_SWEPT = 17        # ray x staged sphere (r > 0): the discriminant
OPS_B11_ROOT = 11         # ... positive: root, range test, compare, update
OPS_B11_RAY = 10          # a live ray's od and oo
OPS_B2_PAIR = 22          # ray x filled slot swept before the exit
OPS_B2_CHUNK = 25         # ray x chunk bound tested (the cull)
OPS_B2_RAY = 34           # a live ray's od, oo and cull margin
OPS_B2_RAY_UNCULLED = 10  # od and oo: the unculled sweep's per-ray count
OPS_B3_PIXEL = 40         # BSDF parameters and view terms
OPS_B3_CANDIDATE = 270    # cone sample, three-lobe BSDF, MIS, update
OPS_B4_BILINEAR = 11      # per channel, the tent
OPS_B5_PAIR = 27          # ray x bound-scan row of the unculled sweep
OPS_B5_SWEPT = 17         # ray x row of a met chunk: the discriminant
OPS_B5_ROOT = 12          # ... not negative: root, interval, key, min
OPS_B5_CHUNK = 29         # ray x chunk covering sphere tested (the cull)
OPS_B5_MET = 5            # a met chunk's segment end from the best key
OPS_B5_RAY = 30           # a live ray's od, oo and cull terms
OPS_MT_PAIR = 55          # ray x triangle row (B6, B7)
OPS_TO_OBJECT = 80        # a ray moved into an instance's frame (B6-B10)
OPS_B7_SPHERE = 30        # B7's ray x bounding-sphere test
OPS_B10_SCAN_ROW = OPS_B5_PAIR   # B10's unculled scan: lane x scan row
OPS_B10_SWEEP_ROW = OPS_MT_PAIR  # B10's unculled sweep: lane x triangle row
OPS_TRI_CHUNK = 30        # B6, B8, B10: lane x triangle chunk sphere tested
OPS_TRI_END = 4           # ... B6, B10: the segment end from the best so far
OPS_TRI_CONE = 14         # lane x missed chunk: its guard cone (a sqrt)
OPS_TRI_GUARD = 7         # lane x face of a missed chunk: |dl . A| >= guard
OPS_TRI_RAY = 16          # a sweeping lane's cull terms (segment_cull_tri)
OPS_B12_MMA = 32          # B12: (ray, slot) x a product's mma: 16 MACs; 1,
#                           3 or 6 mmas (intersect_kernels.mxu_products)
OPS_B12_PAIR = 4          # ... its tail's c2, discriminant and test
OPS_B13_CLUSTER = 16      # B13: ray x cluster bound, to its discriminant
OPS_B13_CLUSTER_ROOT = 7  # ... positive: root, the interval's ends, tests
OPS_B13_SLOT = 16         # ... ray x filled member slot of a touched cluster
OPS_B13_ROOT = 12         # ... positive discriminant: root, tests, update
OPS_B13_RAY = 10          # a live ray's od and oo
OPS_B13_STAGED = 7        # a cluster's or slot's |c|^2 - r^2, once
# Triangle chunk sizes timed in phases 8, 10 and 12 beside the kept one.
TRI_CHUNKS = (8, 16, 32, 64)
# B9's sparse-block thresholds timed in phase 10 beside the kept one (0:
# every block dense; 257: every block sparse).
B9_SPARSE_SWEEP = (0, 16, 32, 64, 128, 257)
# Tolerances of phase 5 (set just above what the card showed; see PERF.md).
B3_PICK_SHARE = 1e-4      # share of pixels whose winner differs
B3_REL = 1e-5             # elsewhere, of each output row's largest value
B4_BILINEAR_REL = 1e-6    # of the source's largest magnitude
# Phase 7, card vs CPU (measured on an H100: picks 0 and 0.27%, image mean
# 5.4e-8 and 6.7e-8).
SMALL_PICK_SHARE = 0.01   # share of pixels whose reservoir pick differs
SMALL_MEAN = 1e-6         # mean |image difference|
SMALL_OFF = 1e-4          # a pixel is off beyond this |difference| ...
SMALL_OFF_SHARE = 0.005   # ... on at most this share of pixels
# Phase 8: B7's batch without candidate rounds must hold this many live lanes.
B7_MIN_LIVE = 1000
# Phase 10: B9's batch without candidate rounds must hold this many live
# lanes, and the loop may differ from it on this share of them (the share
# the reference's own tests allow between its any-hit forms; measured on an
# H100: 44 of 504,764).
B9_MIN_LIVE = 1000
ANY_LOOP_SHARE = 1e-3
# Phase 9, mesh frame vs sphere frame (the bars of tests/test_trimesh.py's
# test_as_mesh_scene_renders).
MESH_MEAN_REL = 0.25      # tone-mapped mean, relative
MESH_VALID_AGREE = 0.85   # share of pixels with the same primary hit bit
# Phase 15, default frames card vs CPU: the card's SHARC splat adds in
# another order (atomics) and B3's sinf / cosf pick another sample on a few
# pixels; the denoiser and TAA spread a differing pixel over its
# neighbours. Bounds on the tone-mapped image.
# Set just above what an H100 showed: image mean 5.1e-5 to 8.9e-5, pixels
# off 0 to 0.049%, fingerprints equal on every filled slot (PERF.md).
DEFAULT_MEAN = 2e-4       # mean |image difference|
DEFAULT_OFF = 0.05        # a pixel is off beyond this |difference| ...
DEFAULT_OFF_SHARE = 2e-3  # ... on at most this share of pixels
DEFAULT_FP_SHARE = 0.99   # SHARC slots with the same fingerprint
# Phase 24, B12a and B12b against their plain versions: the tensor cores
# sum the bf16 products in their own order and with their own rounding,
# coarser than the plain version's float32 matmuls. Hit/miss may flip only
# on rays within MXU_GRAZE of grazing a sphere and on at most
# MXU_FLIP_SHARE of the live rays (the reference's share for its MXU
# kernel). MXU_GRAZE is this port's own limit, not the reference's 1e-3
# (tests/test_post_denoise.py:300, a scene of small coordinates): the
# product's error in the discriminant grows with the square of the
# coordinates' scale, and on the demo scene an H100 showed flips up to
# 0.026 (B12a, primary rays) and 0.039 (B12b, shadow rays). Where no
# sphere is within MXU_STRICT of grazing, t agrees within MXU_T_RTOL
# relative plus MXU_T_ATOL absolute, and the object index is the plain
# version's, or one that the plain version's own pair test meets at its
# t within the same tolerance (a tie; the reference's t margins and index
# rule, tests/test_post_denoise.py:304-319). The same limits hold at each
# of the reference's precisions (phase 24 (c)), the kernel and its plain
# version differing by the sums' order alone; at "default" both take the
# same single bf16 pass, which moves each discriminant far from the exact
# one (intersect_kernels.MXU_CULL_SCALE), so grazing there is measured on
# the plain version's own quadratic (own_grazing), not on the spheres, and
# a pair whose root lies within the t tolerance of tmin or tmax counts as
# grazing (tests/test_torch_cuda.py states why).
MXU_GRAZE = 5e-2
MXU_FLIP_SHARE = 5e-3
MXU_STRICT = 3e-2
MXU_T_RTOL = 1e-3
MXU_T_ATOL = 1e-2
# Phase 24, a route's frame against the default route's from the same
# seed: a sanity bound on the mean |difference| of the tone-mapped images
# (the routes differ where a root moves: near grazing, at a bounce ray's
# own sphere, and then along the path).
ROUTE_MEAN = 0.02


def log(msg):
    print(msg, flush=True)


def bound(bytes_moved, ops, tc_flops=0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their rate: float32 operations over the CUDA cores'
    issue rate or tensor-core flops over the dense bf16 rate, whichever
    takes longer (the two units run side by side)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / FP32_OPS_PER_S, tc_flops / TC_BF16_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_FLUSH = None


def cuda_ms(fn, reps, warm=True):
    """Mean device time of fn over reps calls (after one warm call, or
    none where the caller has just run fn), each timed on its own with
    CUDA events after a 256 MB write evicts the 50 MB L2 cache, as the
    frame leaves it between two calls."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    if warm:
        fn()
    total = 0.0
    for _ in range(reps):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def compare_closest(name, kernel, plain, reps, plain_reps):
    """B1/B11 kernel vs plain version on the same inputs: exact equality of
    the index and of t (both truncated identically for B1)."""
    t_k, i_k = kernel()
    t_p, i_p = plain()
    torch.cuda.synchronize()
    fin = torch.isfinite(t_p)
    hit_mismatch = int((torch.isfinite(t_k) != fin).sum())
    idx_mismatch = int((i_k != i_p).sum())
    t_mismatch = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
    both = fin & torch.isfinite(t_k)
    err = float((t_k[both] - t_p[both]).abs().max()) if bool(both.any()) \
        else 0.0
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, plain_reps, warm=False)
    log(f"kernels: {name} rays={t_k.numel()} hits={int(fin.sum())} "
        f"t_mismatch={t_mismatch} idx_mismatch={idx_mismatch} "
        f"hit_mismatch={hit_mismatch} max_abs_err={err!r} "
        f"kernel_ms={ms!r} plain_ms={plain_ms!r}")
    if t_mismatch or idx_mismatch or hit_mismatch:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def live_rays(rays):
    return int((rays[7] >= rays[6]).sum())


def lane_bytes(n, live, live_words, out_words, *tables, dead_words=2):
    """Bytes a per-ray function must move: a live lane's `live_words`
    inputs, a dead lane's two (tmin and tmax decide its result), every
    lane's `out_words` outputs (4 bytes a word) and each table once."""
    return (4 * (live * live_words + (n - live) * dead_words)
            + int(4 * out_words * n)
            + sum(t.numel() * t.element_size() for t in tables))


def b1_unculled_bound(rays, table):
    """The unculled sweep's bound: every live ray x every table column."""
    n, live = rays.shape[1], live_rays(rays)
    return bound(lane_bytes(n, live, 8, 2, table),
                 live * table.shape[1] * OPS_B1_PAIR)


def b1_work(ik, rays, table, bounds, block=262144):
    """B1's culled work on these rays, from intersect_kernels.
    intersect_morton_work (chunk tests, chunks met, pairs swept, roots
    taken, summed over the rays) and warp_chunks_met over its walk, with
    the live rays and the bound of this work and of the unculled sweep."""
    w = dict(zip(("tests", "met", "pairs", "roots"), (
        int(x.sum()) for x in ik.intersect_morton_work(rays, table, bounds,
                                                       block))))
    w["warp_met"], w["warps"] = warp_chunks_met(
        lambda r: ik.closest_chunk_walk(r, table, bounds)[0], rays, block)
    w["live"] = live = live_rays(rays)
    w["bound_ms"], w["bound_by"] = bound(
        lane_bytes(rays.shape[1], live, 8, 2, table, bounds),
        w["tests"] * OPS_B1_CHUNK + w["met"] * OPS_B1_MET
        + w["pairs"] * OPS_B1_SWEPT + w["roots"] * OPS_B1_ROOT
        + live * OPS_B1_RAY)
    w["unculled_bound_ms"] = b1_unculled_bound(rays, table)[0]
    return w


def b1_sums(works, frames=1):
    """B1's work summed over launches and divided by `frames`, with its
    per-lane and per-warp means, as printed by phases 2, 4 and 14.
    Returns (the line, the sums)."""
    tot = {k: sum(w[k] for w in works) / frames for k in
           ("live", "tests", "met", "pairs", "roots", "warp_met", "warps",
            "bound_ms", "unculled_bound_ms")}
    tot["bound_by"] = "+".join(sorted({w["bound_by"] for w in works}))
    live = max(tot["live"], 1)
    return (f"live={tot['live']} chunk_tests={tot['tests']} "
            f"chunks_met={tot['met']} pairs={tot['pairs']} "
            f"chunks_met_per_live_ray={tot['met'] / live!r} "
            f"chunks_met_per_live_warp="
            f"{tot['warp_met'] / max(tot['warps'], 1)!r} "
            f"pairs_per_live_ray={tot['pairs'] / live!r} "
            f"roots_per_live_ray={tot['roots'] / live!r} "
            f"bound_ms={tot['bound_ms']!r} ({tot['bound_by']}) "
            f"unculled_bound_ms={tot['unculled_bound_ms']!r}"), tot


def b1_frame(ik, calls, frames, reps=5):
    """B1 per frame over the launches `recorded` gives: each launch's
    kernel time (CUDA events, L2 flushed) and work on its own rays, summed
    and divided by `frames`. Returns (kernel ms per frame, launches per
    frame, b1_sums' line per frame)."""
    ms = sum(cuda_ms(lambda c=c: ik.intersect_morton(*c[:3]), reps)
             for c in calls)
    line, _ = b1_sums([b1_work(ik, *c[:3]) for c in calls], frames)
    return ms / frames, len(calls) / frames, line


def b11_work(ik, rays, spheres):
    """B11's work on these rays (intersect_kernels.intersect_brute_work:
    pairs swept, roots taken), with the bytes and operations of its bound
    and the operations of the unculled sweep (every live ray x every
    sphere), and its printed line."""
    pairs, roots = (int(x.sum()) for x in ik.intersect_brute_work(
        rays, spheres, 262144))
    n, live = rays.shape[1], live_rays(rays)
    w = {"live": live, "pairs": pairs, "roots": roots,
         "bytes": lane_bytes(n, live, 8, 2, spheres),
         "ops": pairs * OPS_B11_SWEPT + roots * OPS_B11_ROOT
         + live * OPS_B11_RAY,
         "unculled_ops": live * spheres.shape[1] * OPS_B11_PAIR}
    w["line"] = (f"live={live} spheres={spheres.shape[1]} "
                 f"staged={int((spheres[3] > 0).sum())} pairs={pairs} "
                 f"roots={roots} roots_per_live_ray={roots / max(live, 1)!r} "
                 f"bound_ms={bound(w['bytes'], w['ops'])[0]!r} "
                 f"unculled_bound_ms="
                 f"{bound(w['bytes'], w['unculled_ops'])[0]!r}")
    return w


def check_b5(ik, tk, label, args, plain_reps):
    """B5 against its plain version on one recorded call (key words equal)
    and its culled work (trimesh_kernels.bound_scan_work: chunk tests,
    chunks met, rows swept, roots; chunks met per live warp from
    bound_scan_walk). Returns its timed part (plain_ms 0.0 where
    plain_reps is 0) with the operations of the unculled sweep."""
    rays, bscan, cursor, inst_bounds, m_tbl, block = args
    key_k = tk.bound_scan(*args)
    key_p = tk.bound_scan_plain(*args)
    torch.cuda.synchronize()
    mismatch = words_differ((key_k,), (key_p,))
    tests, met, rows, roots = (int(x.sum()) for x in tk.bound_scan_work(
        rays, bscan, cursor, inst_bounds, m_tbl, 262144))
    warp_met, warps = warp_chunks_met(
        lambda r, cur: tk.bound_scan_walk(r, bscan, cur, inst_bounds,
                                          m_tbl)[0], rays, 262144, cursor)
    live = live_rays(rays)
    n, m_pad = rays.shape[1], bscan.shape[0]
    part = {"bytes": lane_bytes(n, live, 8 + 1, 1, bscan, inst_bounds),
            "ops": tests * OPS_B5_CHUNK + met * OPS_B5_MET
            + rows * OPS_B5_SWEPT + roots * OPS_B5_ROOT + live * OPS_B5_RAY,
            "unculled_ops": live * m_pad * OPS_B5_PAIR,
            "ms": cuda_ms(lambda: tk.bound_scan(*args), 10),
            "plain_ms": cuda_ms(lambda: tk.bound_scan_plain(*args),
                                plain_reps, warm=False) if plain_reps
            else 0.0}
    per = max(live, 1)
    log(f"{label} rays={n} live={live} rows={m_pad} instances={m_tbl} "
        f"fresh_cursor={bool((cursor == -1).all())} "
        f"found={int((key_k < ik.INF_BITS).sum())} mismatch={mismatch} "
        f"chunk_tests={tests} chunks_met={met} rows_swept={rows} "
        f"roots={roots} chunks_met_per_live_ray={met / per!r} "
        f"chunks_met_per_live_warp={warp_met / max(warps, 1)!r} "
        f"rows_per_live_ray={rows / per!r} roots_per_live_ray="
        f"{roots / per!r} kernel_ms={part['ms']!r} "
        f"plain_ms={part['plain_ms']!r} "
        f"bound_ms={bound(part['bytes'], part['ops'])[0]!r} "
        f"unculled_bound_ms="
        f"{bound(part['bytes'], part['unculled_ops'])[0]!r}")
    if mismatch:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version on {mismatch} keys")
    return part


def sum_parts(parts):
    """One kernel's kernels-line fields from its timed parts: times summed,
    the bound of the summed work and, where the parts count it, of the
    summed unculled work."""
    byts = sum(p["bytes"] for p in parts)
    b_ms, b_by = bound(byts, sum(p["ops"] for p in parts))
    out = {"max_abs_err": 0.0, "ms": sum(p["ms"] for p in parts),
           "plain_ms": sum(p["plain_ms"] for p in parts),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if all("unculled_ops" in p for p in parts):
        out["unculled_bound_ms"] = bound(
            byts, sum(p["unculled_ops"] for p in parts))[0]
    return out


def occlusion_visited(ik, rays9, table, block=32768):
    """Table columns an unculled B2 visits for these rays: up to and
    including the first blocker of a live ray, all of them where none
    blocks, none for a dead lane. Printed beside the culled kernel's work
    to show what the culls save."""
    cols, visited = table.shape[1], 0
    for s in range(0, rays9.shape[1], block):
        r = rays9[:, s:s + block]
        blocked = ik.occlusion_pair_blocked(r, table)
        first = torch.where(blocked.any(1),
                            blocked.to(torch.uint8).argmax(1) + 1, cols)
        visited += int(torch.where(r[7] >= r[6], first, 0).sum())
    return visited


def warp_chunks_met(chunk_met, rays, block=262144, *per_lane):
    """Chunks that some lane of a warp (32 consecutive rays) meets, summed
    over the warps that meet one, and those warps: a warp runs a chunk's
    sweep when any of its lanes needs it. chunk_met(rays, *per_lane)
    gives the (rays, chunks) bool of a kernel's cull; `per_lane` tensors
    (N,) are cut into the same blocks as the rays."""
    total = warps = 0
    for s in range(0, rays.shape[1], block):
        met = chunk_met(rays[:, s:s + block],
                        *(x[s:s + block] for x in per_lane))
        pad = -met.shape[0] % 32
        met = torch.nn.functional.pad(met, (0, 0, 0, pad))
        per_warp = met.reshape(-1, 32, met.shape[1]).any(1)
        live = per_warp.any(1)
        total += int(per_warp[live].sum())
        warps += int(live.sum())
    return total, warps


@contextlib.contextmanager
def recorded(modules, names, clone=False, keep=None, tag=None):
    """Swap the wrappers `names` of `modules` for recorders. Yields a dict
    name -> list of the positional arguments of each call, in order; with
    `clone`, tensors are copied (for callers that update them in place);
    `keep(seen)` false skips the record; with `tag`, each record is
    (tag(), arguments)."""
    seen = {name: [] for name in names}
    saved = []
    for mod in modules:
        for name in names:
            if hasattr(mod, name):
                orig = getattr(mod, name)
                saved.append((mod, name, orig))

                def rec(*args, _orig=orig, _name=name, **kwargs):
                    if keep is None or keep(seen):
                        kept = tuple(
                            a.clone() if clone and torch.is_tensor(a) else a
                            for a in args)
                        seen[_name].append(kept if tag is None
                                           else (tag(), kept))
                    return _orig(*args, **kwargs)
                setattr(mod, name, rec)
    try:
        yield seen
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def capture_restir_inputs(bench, modules, width=1920, height=1080,
                           warm=2, device="cuda"):
    """`warm` ReSTIR frames (1920x1080 by default), then one that records
    the arguments of every call of the B2, B3, B4 and B11 wrappers, and
    the frame's motion and path-traced radiance."""
    pipe, state, pose = bench.make_frame_setup(width, height, device=device)
    for _ in range(warm):
        state, _ = pipe.render_frame(state, pose)
    frame = {}

    def run(name, fn, *args):
        out = fn(*args)
        if name == "gbuffer":
            frame["motion"] = out.motion
        if name == "trace":
            frame["radiance"] = out.radiance
        return out
    with recorded(modules, ("occlusion_morton", "initial_light_candidates",
                            "reproject_packed", "intersect_brute")) as seen:
        pipe.render_frame(state, pose, _run=run)
        torch.cuda.synchronize()
    return seen, frame


def check_b2(ik, calls, frame, path="",
             labels=("brdf-candidate", "initial", "final")):
    """B2 against its plain version on a frame's visibility batches (by
    default its three: BRDF candidate, initial, final shading; one per
    label), each timed and its culled work counted; `path` heads the
    printed lines. Returns the kernels-line fields, times and bounds
    summed over the batches."""
    if len(calls) != len(labels):
        raise AssertionError(f"B2 ran {len(calls)} times in {frame}, "
                             f"expected {len(labels)}")
    ms = plain_ms = bytes_moved = ops = unculled_ops = 0.0
    for label, (rays9, table, bounds, block) in zip(labels, calls):
        occ_k = ik.occlusion_morton(rays9, table, bounds, block)
        occ_p = ik.occlusion_morton_plain(rays9, table, bounds, block)
        torch.cuda.synchronize()
        mismatch = int((occ_k != occ_p).sum())
        unculled = occlusion_visited(ik, rays9, table)
        tests, met, pairs = (int(x.sum()) for x in
                             ik.occlusion_morton_work(rays9, table, bounds))
        warp_met, warps = warp_chunks_met(
            lambda r: ik.occlusion_chunk_met(r, bounds), rays9)
        warp_met /= max(warps, 1)
        live = live_rays(rays9)
        k_ms = cuda_ms(lambda: ik.occlusion_morton(rays9, table, bounds,
                                                   block), 10)
        p_ms = cuda_ms(lambda: ik.occlusion_morton_plain(rays9, table,
                                                         bounds, block), 2)
        log(f"{path}kernels: B2 {label} rays={rays9.shape[1]} live={live} "
            f"cols={table.shape[1]} chunks={bounds.shape[1]} "
            f"chunk_tests={tests} chunks_met={met} visited_pairs={pairs} "
            f"visited_pairs_unculled={unculled} "
            f"chunks_met_per_live_ray={met / max(live, 1)!r} "
            f"pairs_per_live_ray={pairs / max(live, 1)!r} "
            f"unculled_pairs_per_live_ray={unculled / max(live, 1)!r} "
            f"chunks_met_per_live_warp={warp_met!r} "
            f"occluded={int(occ_k.sum())} mismatch={mismatch} "
            f"kernel_ms={k_ms!r} plain_ms={p_ms!r}")
        if mismatch:
            raise AssertionError(f"B2 {label}: kernel disagrees with its "
                                 f"plain version on {mismatch} rays")
        ms += k_ms
        plain_ms += p_ms
        bytes_moved += lane_bytes(rays9.shape[1], live, 9, 0.25, table,
                                  bounds)
        ops += (tests * OPS_B2_CHUNK + pairs * OPS_B2_PAIR
                + live * OPS_B2_RAY)
        unculled_ops += (unculled * OPS_B2_PAIR
                         + live * OPS_B2_RAY_UNCULLED)
    b_ms, b_by = bound(bytes_moved, ops)
    unculled_ms = bound(bytes_moved, unculled_ops)[0]
    log(f"{path}kernels: B2 {len(labels)} batches kernel_ms={ms!r} "
        f"bound_ms={b_ms!r} ({b_by}) unculled_bound_ms={unculled_ms!r}")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "unculled_bound_ms": unculled_ms}


def check_b3(rk, call, path=""):
    """B3 against its plain version on one recorded call (a frame's n_l
    ReGIR candidate rounds), timed, with its bound and the resources the
    card reports; `path` heads the printed line. Returns the kernels-line
    fields."""
    surf, uni, slots, table, n_l, s, n_b = call
    f_k, i_k = rk.initial_light_candidates(surf, uni, slots, table, n_l, s,
                                           n_b)
    f_p, i_p = rk.initial_light_candidates_plain(surf, uni, slots, table,
                                                 n_l, s, n_b)
    torch.cuda.synchronize()
    same = (i_k == i_p).all(0)
    pick_share = 1.0 - float(same.float().mean())
    diff = (f_k - f_p).abs()[:, same]
    err = float(diff.max())
    # Relative to each output row's largest magnitude.
    rel = float((diff.amax(1) / f_p.abs().amax(1).clamp(min=1e-30)).max())
    n = surf.shape[1]
    k_ms = cuda_ms(lambda: rk.initial_light_candidates(
        surf, uni, slots, table, n_l, s, n_b), 20)
    p_ms = cuda_ms(lambda: rk.initial_light_candidates_plain(
        surf, uni, slots, table, n_l, s, n_b), 2)
    b_ms, b_by = bound(
        (surf.shape[0] + uni.shape[0] + slots.shape[0] + 10) * 4 * n
        + table.numel() * 4,
        n * (OPS_B3_PIXEL + n_l * OPS_B3_CANDIDATE))
    info = rk.initial_light_candidates_info(table.shape[0], s)
    occupancy = info["blocks_per_sm"] * info["threads"] / 2048
    log(f"{path}kernels: B3 pixels={n} n_l={n_l} slots={s} n_b={n_b} "
        f"lights={table.shape[0]} pick_mismatch_share={pick_share!r} "
        f"(bound {B3_PICK_SHARE}) max_rel_err={rel!r} (bound {B3_REL}) "
        f"max_abs_err={err!r} kernel_ms={k_ms!r} plain_ms={p_ms!r} "
        f"bound_ms={b_ms!r} ({b_by}) share_of_bound={b_ms / k_ms!r} "
        f"resources={json.dumps(info)} occupancy={occupancy!r}")
    if pick_share > B3_PICK_SHARE or rel > B3_REL:
        raise AssertionError("B3: kernel disagrees with its plain version")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_restir_kernels(ik, rk, rp, seen, frame):
    """Phase 5: each kernel against its plain version on the frame's own
    inputs. Returns the kernels' JSON fields (launches excepted)."""
    out = {}

    # B2: the frame's three visibility batches (BRDF candidate, initial,
    # final shading); times and bounds are the sum over them.
    out["occlusion_morton"] = check_b2(ik, seen["occlusion_morton"],
                                       "the warm frame")

    # B3: all n_l ReGIR candidate rounds of the frame in one call.
    (call,) = seen["initial_light_candidates"]
    out["initial_light_candidates"] = check_b3(rk, call)

    # B4 nearest: the temporal pass's packed reservoir history. The check
    # means something only where the history differs from pixel to pixel
    # and some taps land on another pixel than their own.
    (packed, motion, mode, *row0), = seen["reproject_packed"]
    h, w, c = packed.shape
    distinct = int(torch.unique(packed.view(torch.int32)).numel())
    moved = int((torch.round(motion).abs().amax(-1) > 0).sum())
    if distinct <= 1000 or moved == 0:
        raise AssertionError(f"B4 nearest: the history is not a warm "
                             f"frame's ({distinct} distinct words, "
                             f"{moved} taps off their pixel)")
    o_k, ok_k = rp.reproject_packed(packed, motion, mode, *row0)
    o_p, ok_p = rp.reproject_packed_plain(packed, motion, mode, *row0)
    torch.cuda.synchronize()
    bits = int((o_k.view(torch.int32) != o_p.view(torch.int32)).sum())
    ok_mismatch = int((ok_k != ok_p).sum())
    k_ms = cuda_ms(lambda: rp.reproject_packed(packed, motion, mode), 50)
    p_ms = cuda_ms(lambda: rp.reproject_packed_plain(packed, motion, mode),
                   10)
    grid = torch.stack([
        (torch.arange(w, device=motion.device)[None, :] + motion[..., 0])
        / (w - 1) * 2 - 1,
        (torch.arange(h, device=motion.device)[:, None] + motion[..., 1])
        / (h - 1) * 2 - 1], dim=-1)[None]
    chw = packed.permute(2, 0, 1)[None].contiguous()

    def library(mode_, src=chw):
        return torch.nn.functional.grid_sample(
            src, grid, mode=mode_, padding_mode="border", align_corners=True)
    lib_ms = cuda_ms(lambda: library("nearest"), 50)
    log(f"kernels: B4 nearest {h}x{w}x{c} mode={mode} "
        f"vector_width={rp.vector_width(c, packed, o_k)} "
        f"word_mismatch={bits} "
        f"ok_mismatch={ok_mismatch} in_frame={int(ok_k.sum())} "
        f"distinct_words={distinct} taps_off_pixel={moved} "
        f"kernel_ms={k_ms!r} plain_ms={p_ms!r} grid_sample_ms={lib_ms!r}")
    if mode != "nearest" or bits or ok_mismatch:
        raise AssertionError("B4 nearest: kernel disagrees with its plain "
                             "version")
    b_ms, b_by = bound((2 * c * 4 + 8 + 1) * h * w, 0)
    out["reproject_packed"] = {"max_abs_err": 0.0, "ms": k_ms,
                               "plain_ms": p_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": lib_ms}

    # B4 bilinear (the next slice's TAA and denoiser mode): the frame's
    # path-traced radiance resampled along its motion.
    rad = frame["radiance"].contiguous()
    mot = frame["motion"]
    rad_chw = rad.permute(2, 0, 1)[None].contiguous()
    b_k, bok_k = rp.reproject_packed(rad, mot, "bilinear")
    b_p, bok_p = rp.reproject_packed_plain(rad, mot, "bilinear")
    lib = library("bilinear", rad_chw)
    torch.cuda.synchronize()
    scale = float(rad.abs().max())
    berr = float((b_k - b_p).abs().max())
    lib_err = float((lib[0].permute(1, 2, 0) - b_p).abs().max())
    k_ms = cuda_ms(lambda: rp.reproject_packed(rad, mot, "bilinear"), 50)
    p_ms = cuda_ms(lambda: rp.reproject_packed_plain(rad, mot, "bilinear"),
                   10)
    lib_ms = cuda_ms(lambda: library("bilinear", rad_chw), 50)
    bb_ms, bb_by = bound((2 * 3 * 4 + 8 + 1) * h * w,
                         h * w * 3 * OPS_B4_BILINEAR)
    log(f"kernels: B4 bilinear {h}x{w}x3 max_abs_err={berr!r} "
        f"(bound {B4_BILINEAR_REL} x {scale!r}) "
        f"ok_mismatch={int((bok_k != bok_p).sum())} "
        f"grid_sample_max_abs_err={lib_err!r} kernel_ms={k_ms!r} "
        f"plain_ms={p_ms!r} library_ms={lib_ms!r} bound_ms={bb_ms!r} "
        f"({bb_by})")
    if berr > B4_BILINEAR_REL * scale or bool((bok_k != bok_p).any()):
        raise AssertionError("B4 bilinear: kernel disagrees with its plain "
                             "version")

    # B11: the BRDF-candidate sweep over the compact light table.
    (rays, spheres, block), = seen["intersect_brute"]
    out["intersect_brute"] = compare_closest(
        "B11 brdf-candidate", lambda: ik.intersect_brute(rays, spheres),
        lambda: ik.intersect_brute_plain(rays, spheres, block),
        reps=20, plain_reps=2)
    w = b11_work(ik, rays, spheres)
    b_ms, b_by = bound(w["bytes"], w["ops"])
    unculled_ms = bound(w["bytes"], w["unculled_ops"])[0]
    log(f"kernels: B11 brdf-candidate {w['line']} "
        f"kernel_ms={out['intersect_brute']['ms']!r}")
    out["intersect_brute"].update(bound_ms=b_ms, bound_by=b_by,
                                  library_ms=None,
                                  unculled_bound_ms=unculled_ms)
    return out


def check_small_frames(pipeline, bench, devices=("cuda", "cpu"), mesh=False):
    """Phases 7 and 11: two 64x64 ReSTIR frames on the card and on the CPU
    from one start state (oscillator grid 3: 45 spheres, 9 lights; with
    `mesh`, as 45 instances of a 128-face geosphere, the brightest 128
    faces the lights), close to the oscillator field. Bounds just above
    what the card showed (see SMALL_*)."""
    label = "mesh restir small" if mesh else "restir small"
    results = []
    for dev in devices:
        pipe, state, _ = bench.make_frame_setup(64, 64, bounces=2,
                                                oscillator_grid=3,
                                                device=dev, mesh=mesh, tess=3)
        eye = torch.tensor([0.0, 2.5, -4.0])
        fwd = torch.tensor([0.0, 0.5, 0.0]) - eye
        pose = pipeline.CameraPose(eye.to(dev), (fwd / fwd.norm()).to(dev),
                                   torch.tensor([0.0, 1.0, 0.0]).to(dev))
        frames = []
        for _ in range(2):
            state, img = pipe.render_frame(state, pose)
            frames.append((state.reservoirs.light_index.cpu(), img.cpu()))
        results.append(frames)
    for i, ((gi, gimg), (ci, cimg)) in enumerate(zip(*results)):
        pick = float((gi != ci).float().mean())
        d = (gimg - cimg).abs()
        mean = float(d.mean())
        off = float((d.amax(-1) > SMALL_OFF).float().mean())
        log(f"{label}: frame {i} pick_mismatch_share={pick!r} "
            f"image_mean_abs_diff={mean!r} image_max_abs_diff="
            f"{float(d.max())!r} pixels_off_{SMALL_OFF}={off!r} "
            f"finite={bool(torch.isfinite(gimg).all())}")
        if (pick > SMALL_PICK_SHARE or mean > SMALL_MEAN
                or off > SMALL_OFF_SHARE):
            raise AssertionError(f"{label}: the frame on the card disagrees "
                                 f"with the plain versions on the CPU")


def capture_mesh_inputs(bench, pathtrace, modules, device="cuda"):
    """One mesh frame at 1920x1080 to warm up, then one that records the
    arguments of every B5, B6, B7 and B11 call of its first two trace calls
    (the primary rays and the bounce-1 rays, both 2,073,600 wide). Tensors
    are copied: the candidate loop tightens its rays in place."""
    scene, cam, cfg = bench.make_mesh_setup(device=device)
    pathtrace.trace_image(scene, cam, cfg, 0)
    with recorded(modules, ("bound_scan", "shared_blas_sweep",
                            "intersect_mesh_instances", "intersect_brute"),
                  clone=True,
                  keep=lambda seen: len(seen["intersect_mesh_instances"]) < 2
                  ) as seen:
        pathtrace.trace_image(scene, cam, cfg, 1)
        torch.cuda.synchronize()
    return seen


def words_differ(kernel_out, plain_out):
    """Number of 32-bit words that differ between two tuples of tensors."""
    return sum(int((k.view(torch.int32) != p.view(torch.int32)).sum())
               for k, p in zip(kernel_out, plain_out))


def check_mesh_kernels(ik, tk, seen):
    """Phase 8: B5, B6, B7 and B11 against their plain versions on the mesh
    frame's own inputs. The kernels-line fields of B5, B6 and B11 (as
    "intersect_brute@mesh") are sums over the launches of the primary trace
    call (4, 3 and 2); B7's are those of the primary rays with no candidate
    round before it, where it carries every live lane (the frame's own
    backstop batches hold almost none, and are logged only)."""
    calls = len(seen["intersect_mesh_instances"])
    if (calls != 2 or len(seen["bound_scan"]) != 4 * calls
            or len(seen["shared_blas_sweep"]) != 3 * calls
            or len(seen["intersect_brute"]) != 2 * calls):
        raise AssertionError(
            "mesh kernels: recorded "
            + json.dumps({k: len(v) for k, v in seen.items()})
            + " calls, expected 8 B5, 6 B6, 2 B7, 4 B11")
    out = {}
    split_any = 0
    for c, label in enumerate(("primary", "bounce-1")):
        timed = c == 0     # the plain versions are timed on the primary call

        # B5: the loop's rounds and the scan that marks the unresolved rays.
        parts = [check_b5(ik, tk, f"mesh kernels: B5 {label} round {r + 1}",
                          args, 1 if timed else 0)
                 for r, args in enumerate(seen["bound_scan"][4 * c:4 * c + 4])]
        if timed:
            out["bound_scan"] = sum_parts(parts)

        # B6: each round's sweep of the rays' own candidates.
        parts = [check_b6(ik, tk, f"{label} round {r + 1}", args, timed)
                 for r, args in enumerate(
                     seen["shared_blas_sweep"][3 * c:3 * c + 3])]
        split_any += sum(p["split"] for p in parts)
        b6 = sum_parts(parts)
        log(f"mesh kernels: B6 {label} the 3 launches: kernel_ms="
            f"{b6['ms']!r} bound_ms={b6['bound_ms']!r} (culled) "
            f"unculled_bound_ms={b6['unculled_bound_ms']!r} kernel_ms by "
            f"triangle chunk: " + " ".join(
                f"chunk{ck}={sum(p['chunk_ms'][ck] for p in parts)!r}"
                for ck in TRI_CHUNKS) + f" (kept: {tk.TRI_CHUNK})")
        if timed:
            out["shared_blas_sweep"] = b6

        # B7: the frame's own backstop batch (few live lanes).
        check_b7(tk, f"{label} backstop",
                 seen["intersect_mesh_instances"][c], timed)

        # B11: the pre-pass's two sweeps over the instance bounds.
        parts = []
        for which, (rays, spheres, block) in zip(
                ("bounds", "inscribed balls"),
                seen["intersect_brute"][2 * c:2 * c + 2]):
            res = compare_closest(
                f"B11 {label} {which} K={spheres.shape[1]}",
                lambda: ik.intersect_brute(rays, spheres),
                lambda: ik.intersect_brute_plain(rays, spheres, block),
                reps=10, plain_reps=1)
            w = b11_work(ik, rays, spheres)
            res.update(bytes=w["bytes"], ops=w["ops"],
                       unculled_ops=w["unculled_ops"])
            parts.append(res)
            log(f"mesh kernels: B11 {label} {which} {w['line']} "
                f"kernel_ms={res['ms']!r}")
        if timed:
            out["intersect_brute@mesh"] = sum_parts(parts)

    if split_any == 0:
        raise AssertionError("B6: no batch holds live neighbours with "
                             "different candidates")

    # B7 where it carries every ray: the primary rays as the pre-pass left
    # them, no candidate round before it (intersect_instances' rounds=0).
    rays = seen["bound_scan"][0][0]
    b7 = check_b7(tk, "primary, no candidate round",
                  (rays, *seen["intersect_mesh_instances"][0][1:]), True)
    if b7["live"] < B7_MIN_LIVE or b7["hits"] == 0:
        raise AssertionError(f"B7: the batch without candidate rounds holds "
                             f"{b7['live']} live lanes and {b7['hits']} hits")
    out["intersect_mesh_instances"] = sum_parts([b7])
    return out


def check_b6(ik, tk, label, args, timed, chunks=TRI_CHUNKS):
    """B6 against its plain version and its culled walk on one recorded
    call (every word equal), its work (trimesh_kernels.
    shared_blas_sweep_work: triangle chunks tested and met, cones tested,
    faces guard-tested and swept) and its times, at the kept chunk and at
    each of `chunks`. Returns its timed part with the operations of the
    unculled sweep, `chunk_ms` and `split` (neighbouring live lanes on
    different candidates)."""
    (rays, cand, best, binst, inst_tbl, tri_tbl, tri_bounds, chunk,
     block) = args
    out_k = tk.shared_blas_sweep(*args)
    out_p = tk.shared_blas_sweep_plain(*args)
    out_w, w = tk.shared_blas_sweep_work(*args[:8], 262144)
    torch.cuda.synchronize()
    mismatch = words_differ(out_k, out_p)
    walk_mismatch = words_differ(out_k, out_w)
    n, f_pad, m_tbl = rays.shape[1], tri_tbl.shape[0], inst_tbl.shape[1]
    trunc = ~((1 << ik.pos_bits(f_pad)) - 1)
    far = torch.minimum(rays[7], (best & trunc).view(torch.float32))
    has_cand = (cand >= 0) & (cand < m_tbl)
    live_mask = (far >= rays[6]) & has_cand
    live = int(live_mask.sum())
    # A lane without a candidate passes its best and instance through
    # (cand, best, binst in); one with a candidate also reads tmin and
    # tmax; a live one the six other ray rows too.
    byts = (lane_bytes(n, live, 8 + 3, 2, inst_tbl, tri_tbl, tri_bounds,
                       dead_words=3)
            + 4 * 2 * (int(has_cand.sum()) - live))
    part = {"bytes": byts,
            "ops": (w["tests"] * (OPS_TRI_CHUNK + OPS_TRI_END)
                    + w["cones"] * OPS_TRI_CONE + w["guards"] * OPS_TRI_GUARD
                    + w["rows"] * OPS_MT_PAIR
                    + live * (OPS_TO_OBJECT + OPS_TRI_RAY)),
            "unculled_ops": live * (f_pad * OPS_MT_PAIR + OPS_TO_OBJECT),
            "ms": cuda_ms(lambda: tk.shared_blas_sweep(*args), 10),
            "plain_ms": cuda_ms(lambda: tk.shared_blas_sweep_plain(*args), 1,
                                warm=False) if timed else 0.0,
            # Neighbouring live lanes that sweep different instances.
            "split": int((live_mask[1:] & live_mask[:-1]
                          & (cand[1:] != cand[:-1])).sum())}
    spheres = tri_tables(tk, tri_tbl, tri_bounds, chunk)
    part["chunk_ms"] = {ck: cuda_ms(lambda ck=ck: tk.shared_blas_sweep(
        rays, cand, best, binst, inst_tbl, tri_tbl, spheres[ck], ck, block),
        10) for ck in chunks}
    per = max(live, 1)
    log(f"mesh kernels: B6 {label} rays={n} live={live} faces={f_pad} "
        f"chunk={chunk} instances={m_tbl} "
        f"improved={int((out_k[0] != best).sum())} "
        f"neighbours_on_other_instance={part['split']} mismatch={mismatch} "
        f"walk_mismatch={walk_mismatch} chunk_tests={w['tests']} "
        f"chunks_met={w['met']} cone_tests={w['cones']} "
        f"guard_tests={w['guards']} triangles_swept={w['rows']} "
        f"chunks_met_per_live_lane={w['met'] / per!r} "
        f"triangles_swept_per_live_lane={w['rows'] / per!r} "
        f"kernel_ms={part['ms']!r} plain_ms={part['plain_ms']!r} "
        f"bound_ms={bound(byts, part['ops'])[0]!r} "
        f"unculled_bound_ms={bound(byts, part['unculled_ops'])[0]!r} "
        f"chunk_ms={json.dumps(part['chunk_ms'])}")
    if mismatch or walk_mismatch:
        raise AssertionError(f"B6 {label}: kernel disagrees with its plain "
                             f"version or its walk on {mismatch}, "
                             f"{walk_mismatch} words")
    return part


def check_b7(tk, label, args, timed):
    """B7 against its plain version and its culled walk on one recorded
    batch (t, face and instance words equal), its work (trimesh_kernels.
    intersect_mesh_instances_work: chunk and instance sphere tests,
    instances swept, triangle chunks tested and met, cones tested, faces
    guard-tested and swept) and its time, with the bound of the culled work
    and of the unculled sweeps (every face of each instance entered).
    Returns its timed part, with `live` and `hits`."""
    (rays, inst_tbl, inst_bounds, tri_tbl, n_ic, tri_bounds, chunk,
     block) = args
    out_k = tk.intersect_mesh_instances(*args)
    out_p = tk.intersect_mesh_instances_plain(*args)
    out_w, w = tk.intersect_mesh_instances_work(*args[:4], tri_bounds, chunk,
                                                n_ic, 1 << 22)
    torch.cuda.synchronize()
    mismatch = words_differ(out_k, out_p)
    walk_mismatch = words_differ(out_k, out_w)
    n, f_pad = rays.shape[1], tri_tbl.shape[0]
    spheres = (w["chunk_tests"] + w["inst_tests"]) * OPS_B7_SPHERE
    part = {
        "bytes": lane_bytes(n, w["live"], 8, 3, inst_tbl, inst_bounds,
                            tri_tbl, tri_bounds),
        "ops": spheres + w["tests"] * (OPS_TRI_CHUNK + OPS_TRI_END)
        + w["cones"] * OPS_TRI_CONE + w["guards"] * OPS_TRI_GUARD
        + w["rows"] * OPS_MT_PAIR
        + w["sweeps"] * (OPS_TO_OBJECT + OPS_TRI_RAY),
        "unculled_ops": spheres
        + w["sweeps"] * (f_pad * OPS_MT_PAIR + OPS_TO_OBJECT),
        "ms": cuda_ms(lambda: tk.intersect_mesh_instances(*args), 10),
        "plain_ms": cuda_ms(lambda: tk.intersect_mesh_instances_plain(*args),
                            1, warm=False) if timed else 0.0,
        "live": w["live"], "hits": int(torch.isfinite(out_k[0]).sum())}
    b_ms = bound(part["bytes"], part["ops"])[0]
    log(f"mesh kernels: B7 {label} rays={n} live={w['live']} "
        f"hits={part['hits']} chunk_tests={w['chunk_tests']} "
        f"instance_tests={w['inst_tests']} "
        f"instance_sweeps={w['sweeps']} faces={f_pad} chunk={chunk} "
        f"tri_chunk_tests={w['tests']} tri_chunks_met={w['met']} "
        f"cone_tests={w['cones']} guard_tests={w['guards']} "
        f"triangles_swept={w['rows']} triangles_unculled={w['tri_tests']} "
        f"mismatch={mismatch} walk_mismatch={walk_mismatch} "
        f"kernel_ms={part['ms']!r} plain_ms={part['plain_ms']!r} "
        f"bound_ms={b_ms!r} unculled_bound_ms="
        f"{bound(part['bytes'], part['unculled_ops'])[0]!r} "
        f"share_of_bound={b_ms / part['ms']!r}")
    if mismatch or walk_mismatch:
        raise AssertionError(f"B7 {label}: kernel disagrees with its plain "
                             f"version or its walk on {mismatch}, "
                             f"{walk_mismatch} words")
    return part


def capture_anyhit_inputs(bench, trimesh, modules, device="cuda"):
    """One all-mesh ReSTIR frame at 1920x1080 to warm up, then one that
    records the arguments of every B5, B8, B9 and B11 call made inside
    trimesh.intersect_instances_any: the frame's three occluded_scene
    calls. The any-hit loop leaves its tensors as they are, so nothing is
    copied."""
    pipe, state, pose = bench.make_frame_setup(device=device, mesh=True)
    state, _ = pipe.render_frame(state, pose)
    inside = [False]
    orig = trimesh.intersect_instances_any

    def any_hit(*args, **kwargs):
        inside[0] = True
        try:
            return orig(*args, **kwargs)
        finally:
            inside[0] = False
    trimesh.intersect_instances_any = any_hit
    try:
        with recorded(modules, ("bound_scan", "shared_blas_any",
                                "intersect_mesh_instances_any",
                                "intersect_brute"),
                      keep=lambda seen: inside[0]) as seen:
            pipe.render_frame(state, pose)
            torch.cuda.synchronize()
    finally:
        trimesh.intersect_instances_any = orig
    return seen


def b9_blocks(rays, below):
    """B9's blocks of 256 lanes with live lanes: (sparse, dense), sparse
    those with fewer than `below`."""
    live = rays[7] >= rays[6]
    pad = torch.zeros(-live.numel() % 256, dtype=torch.bool,
                      device=live.device)
    per = torch.cat([live, pad]).reshape(-1, 256).sum(1)
    return int(((per > 0) & (per < below)).sum()), int((per >= below).sum())


def check_b9(tk, label, args, timed, sweep=B9_SPARSE_SWEEP):
    """B9 against its plain version and its culled walk on one batch:
    every bit equal. Its bound counts the walk's work
    (trimesh_kernels.intersect_mesh_instances_any_work: sphere tests,
    instances entered, triangle chunks tested and met, cones tested, faces
    guard-tested and swept), printed beside the unculled sweep's. Timed at
    the kept B9_SPARSE_LIVE and at each of `sweep`. Returns its
    timed part, with `live`, `blocked`, the kernel's result, `sparse_ms`
    and `blocks` (sparse and dense blocks at the kept threshold)."""
    rays, inst_tbl, inst_bounds, tri_tbl, tri_bounds, chunk, n_ic, block = \
        args
    occ_k = tk.intersect_mesh_instances_any(*args)
    occ_p = tk.intersect_mesh_instances_any_plain(*args)
    n = rays.shape[1]
    occ_w, work = tk.intersect_mesh_instances_any_work(*args[:7], block=n)
    torch.cuda.synchronize()
    mismatch = words_differ((occ_k,), (occ_p,))
    walk_mismatch = words_differ((occ_k,), (occ_w,))
    spheres = ((work["chunk_tests"] + work["inst_tests"]) * OPS_B7_SPHERE
               + work["sweeps"] * OPS_TO_OBJECT)
    part = {
        "bytes": lane_bytes(n, work["live"], 8, 1, inst_tbl, inst_bounds,
                            tri_tbl, tri_bounds),
        "ops": spheres + work["sweeps"] * OPS_TRI_RAY
        + work["tests"] * OPS_TRI_CHUNK + work["cones"] * OPS_TRI_CONE
        + work["guards"] * OPS_TRI_GUARD + work["rows"] * OPS_MT_PAIR,
        "unculled_ops": spheres + work["tri_tests"] * OPS_MT_PAIR,
        "ms": cuda_ms(lambda: tk.intersect_mesh_instances_any(*args), 10),
        "plain_ms": cuda_ms(lambda: tk.intersect_mesh_instances_any_plain(
            *args), 1, warm=False) if timed else 0.0,
        "live": work["live"], "blocked": int(occ_k.sum()), "occ": occ_k,
        "blocks": b9_blocks(rays, tk.B9_SPARSE_LIVE), "sparse_ms": {}}
    kept = tk.B9_SPARSE_LIVE
    try:
        for below in sweep:
            tk.B9_SPARSE_LIVE = below
            if words_differ((tk.intersect_mesh_instances_any(*args),),
                            (occ_p,)):
                raise AssertionError(f"B9 {label}: kernel disagrees with "
                                     f"its plain version at "
                                     f"B9_SPARSE_LIVE = {below}")
            part["sparse_ms"][below] = cuda_ms(
                lambda: tk.intersect_mesh_instances_any(*args), 10)
    finally:
        tk.B9_SPARSE_LIVE = kept
    log(f"mesh any-hit kernels: B9 {label} rays={n} live={work['live']} "
        f"blocked={part['blocked']} chunk_tests={work['chunk_tests']} "
        f"instance_tests={work['inst_tests']} "
        f"instance_sweeps={work['sweeps']} chunk={chunk} "
        f"triangle_chunk_tests={work['tests']} chunks_met={work['met']} "
        f"cone_tests={work['cones']} guard_tests={work['guards']} "
        f"triangles_swept={work['rows']} "
        f"unculled_triangles={work['tri_tests']} "
        f"blocks_sparse={part['blocks'][0]} blocks_dense={part['blocks'][1]} "
        f"(B9_SPARSE_LIVE={kept}) mismatch={mismatch} "
        f"walk_mismatch={walk_mismatch} "
        f"kernel_ms={part['ms']!r} plain_ms={part['plain_ms']!r} "
        f"bound_ms={bound(part['bytes'], part['ops'])[0]!r} "
        f"unculled_bound_ms="
        f"{bound(part['bytes'], part['unculled_ops'])[0]!r} "
        f"kernel_ms_by_B9_SPARSE_LIVE={json.dumps(part['sparse_ms'])}")
    if mismatch or walk_mismatch:
        raise AssertionError(f"B9 {label}: kernel disagrees with its plain "
                             f"version or its walk on {mismatch}, "
                             f"{walk_mismatch} lanes")
    return part


def tri_tables(tk, tri_tbl, tri_bounds, chunk):
    """The triangle table's chunk bounds (spheres and guard cones) at each
    of TRI_CHUNKS (the recorded ones at the kept chunk)."""
    host = tri_tbl.cpu().numpy()
    return {c: tri_bounds if c == chunk else torch.from_numpy(
        tk.tri_chunk_bounds(host, c)).to(tri_tbl.device) for c in TRI_CHUNKS}


def check_b8(tk, label, args, chunks=TRI_CHUNKS):
    """B8 against its plain version and its culled walk on one recorded
    call (every bit equal), its work (trimesh_kernels.shared_blas_any_work:
    chunks tested and met, cones tested, faces guard-tested and swept) and
    its times, at the kept chunk and at each of `chunks`. Returns its
    timed part with the operations of the unculled sweep and `chunk_ms`."""
    rays, cand, occ_in, inst_tbl, tri_tbl, tri_bounds, chunk, block = args
    occ_k = tk.shared_blas_any(*args)
    occ_p = tk.shared_blas_any_plain(*args)
    occ_w, w = tk.shared_blas_any_work(rays, cand, occ_in, inst_tbl, tri_tbl,
                                       tri_bounds, chunk, 262144)
    torch.cuda.synchronize()
    mismatch = words_differ((occ_k,), (occ_p,))
    walk_mismatch = words_differ((occ_k,), (occ_w,))
    n, live = rays.shape[1], w["live"]
    # A live lane reads its ray, cand and occ_in; any other lane at least
    # its occ_in, which it passes through.
    byts = lane_bytes(n, live, 8 + 2, 1, inst_tbl, tri_tbl, tri_bounds,
                      dead_words=1)
    part = {"bytes": byts,
            "ops": w["tests"] * OPS_TRI_CHUNK + w["cones"] * OPS_TRI_CONE
            + w["guards"] * OPS_TRI_GUARD + w["rows"] * OPS_MT_PAIR
            + live * (OPS_TO_OBJECT + OPS_TRI_RAY),
            "unculled_ops": w["faces"] * OPS_MT_PAIR + live * OPS_TO_OBJECT,
            "ms": cuda_ms(lambda: tk.shared_blas_any(*args), 10),
            "plain_ms": cuda_ms(lambda: tk.shared_blas_any_plain(*args), 1,
                                warm=False)}
    spheres = tri_tables(tk, tri_tbl, tri_bounds, chunk)
    part["chunk_ms"] = {c: cuda_ms(lambda c=c: tk.shared_blas_any(
        rays, cand, occ_in, inst_tbl, tri_tbl, spheres[c], c, block), 10)
        for c in chunks}
    per = max(live, 1)
    log(f"mesh any-hit kernels: B8 {label} rays={n} live={live} "
        f"faces={tri_tbl.shape[0]} chunk={chunk} "
        f"instances={inst_tbl.shape[1]} "
        f"bits_in={int((occ_in > 0).sum())} "
        f"bits_out={int((occ_k > 0).sum())} mismatch={mismatch} "
        f"walk_mismatch={walk_mismatch} chunk_tests={w['tests']} "
        f"chunks_met={w['met']} cone_tests={w['cones']} "
        f"guard_tests={w['guards']} triangles_swept={w['rows']} "
        f"unculled_triangles={w['faces']} "
        f"chunks_met_per_live_lane={w['met'] / per!r} "
        f"chunks_met_per_live_warp={w['warp_met'] / max(w['warps'], 1)!r} "
        f"triangles_swept_per_live_lane={w['rows'] / per!r} "
        f"kernel_ms={part['ms']!r} plain_ms={part['plain_ms']!r} "
        f"bound_ms={bound(byts, part['ops'])[0]!r} "
        f"unculled_bound_ms={bound(byts, part['unculled_ops'])[0]!r} "
        f"chunk_ms={json.dumps(part['chunk_ms'])}")
    if mismatch or walk_mismatch:
        raise AssertionError(f"B8 {label}: kernel disagrees with its plain "
                             f"version or its walk on {mismatch}, "
                             f"{walk_mismatch} lanes")
    return part


def check_anyhit_kernels(ik, tk, seen, path=""):
    """Phase 10: B8, B9 and the any-hit launches of B5 and B11 against
    their plain versions on the all-mesh ReSTIR frame's own inputs (phase
    16: the mesh pipeline's, `path` heading every printed label). The
    kernels-line fields of B8, "bound_scan@mesh_restir" and
    "intersect_brute@mesh_restir" are sums over one frame's three
    occluded_scene calls (6, 9 and 3 launches); B9's are those of the
    fullest shadow-ray batch with no candidate round before it (the
    frame's own backstop batches are logged only)."""
    if (len(seen["intersect_mesh_instances_any"]) != 3
            or len(seen["bound_scan"]) != 9
            or len(seen["shared_blas_any"]) != 6
            or len(seen["intersect_brute"]) != 3):
        raise AssertionError(
            "mesh any-hit kernels: recorded "
            + json.dumps({k: len(v) for k, v in seen.items()})
            + " calls, expected 9 B5, 6 B8, 3 B9, 3 B11")
    out = {}
    b5_parts, b8_parts, b9_parts, b11_parts = [], [], [], []
    b8_chunk_ms = {}
    fullest = None
    for c, label in enumerate(("brdf-candidate", "initial", "final")):
        label = path + label
        # B11: the any-hit pre-pass over the instance bounds (hit bit only).
        rays, spheres, block = seen["intersect_brute"][c]
        res = compare_closest(
            f"B11 any-hit pre-pass {label} K={spheres.shape[1]}",
            lambda: ik.intersect_brute(rays, spheres),
            lambda: ik.intersect_brute_plain(rays, spheres, block),
            reps=10, plain_reps=1)
        w = b11_work(ik, rays, spheres)
        res.update(bytes=w["bytes"], ops=w["ops"],
                   unculled_ops=w["unculled_ops"])
        b11_parts.append(res)
        log(f"mesh any-hit kernels: B11 {label} {w['line']} "
            f"kernel_ms={res['ms']!r}")

        # B5: the two rounds and the scan that marks the unresolved rays.
        for r, args in enumerate(seen["bound_scan"][3 * c:3 * c + 3]):
            b5_parts.append(check_b5(
                ik, tk, f"mesh any-hit kernels: B5 {label} round {r + 1}",
                args, 1))
            rays = args[0]
            live = live_rays(rays)
            if r == 0 and (fullest is None or live > fullest[0]):
                fullest = (live, label, rays, c)

        # B8: each round's any-hit sweep of the rays' own candidates.
        for r, args in enumerate(seen["shared_blas_any"][2 * c:2 * c + 2]):
            part = check_b8(tk, f"{label} round {r + 1}", args)
            b8_parts.append(part)
            for chunk, ms in part["chunk_ms"].items():
                b8_chunk_ms[chunk] = b8_chunk_ms.get(chunk, 0.0) + ms

        # B9: the frame's own backstop batch.
        b9_parts.append(check_b9(tk, f"{label} backstop",
                                 seen["intersect_mesh_instances_any"][c],
                                 True))
    out["bound_scan@mesh_restir"] = sum_parts(b5_parts)
    out["shared_blas_any"] = sum_parts(b8_parts)
    log(f"mesh any-hit kernels: {path}B8 kernel_ms summed over the frame's "
        "6 launches by triangle chunk: " + " ".join(
            f"chunk{c}={ms!r}" for c, ms in sorted(b8_chunk_ms.items()))
        + f" (kept: {tk.TRI_CHUNK}; bound_ms={out['shared_blas_any']['bound_ms']!r}"
        f" unculled_bound_ms="
        f"{out['shared_blas_any']['unculled_bound_ms']!r})")
    out["intersect_brute@mesh_restir"] = sum_parts(b11_parts)
    backstop = out["intersect_mesh_instances_any@backstop"] = sum_parts(
        b9_parts)
    log(f"mesh any-hit kernels: {path}B9 the frame's 3 backstop batches: "
        "live="
        + ",".join(str(p["live"]) for p in b9_parts)
        + " kernel_ms=" + ",".join(repr(p["ms"]) for p in b9_parts)
        + " bound_ms=" + ",".join(
            repr(bound(p["bytes"], p["ops"])[0]) for p in b9_parts)
        + f" sum: kernel_ms={backstop['ms']!r} "
        f"bound_ms={backstop['bound_ms']!r} "
        f"unculled_bound_ms={backstop['unculled_bound_ms']!r}; "
        f"kernel_ms by B9_SPARSE_LIVE: " + " ".join(
            f"{below}={sum(p['sparse_ms'][below] for p in b9_parts)!r}"
            for below in B9_SPARSE_SWEEP))
    # B9 where it carries every ray: the fullest batch as the pre-pass left
    # it, no candidate round before it (intersect_instances_any's rounds=0),
    # and the loop's answer on the same rays.
    _, label, rays, c = fullest
    tables = seen["intersect_mesh_instances_any"][c][1:]
    b9 = check_b9(tk, f"{label}, no candidate round", (rays, *tables), True)
    loop = tk.intersect_mesh_instances_any_cand(rays, *tables[:6],
                                                block=tables[6])
    differ = int(((b9["occ"] > 0) != loop).sum())
    log(f"mesh any-hit kernels: B9 {label} alone vs the candidate loop: "
        f"{differ} of {b9['live']} live lanes differ "
        f"(bound {ANY_LOOP_SHARE} of them)")
    if b9["live"] < B9_MIN_LIVE or b9["blocked"] == 0:
        raise AssertionError(f"B9: the batch without candidate rounds holds "
                             f"{b9['live']} live lanes, {b9['blocked']} "
                             f"blocked")
    if differ > ANY_LOOP_SHARE * b9["live"]:
        raise AssertionError("B9 alone disagrees with the candidate loop")
    paths = [sum(p["blocks"][j] for p in (*b9_parts, b9)) for j in (0, 1)]
    if not all(paths):
        raise AssertionError(f"B9: sparse and dense blocks {paths}: a path "
                             f"of the kernel did not run")
    out["intersect_mesh_instances_any"] = sum_parts([b9])
    return out


def capture_fused_inputs(bench, pathtrace, trimesh, modules, device="cuda"):
    """One fused mesh frame (MESH_CAND = 2) at 1920x1080 to warm up, then
    one that records the arguments of the B10 calls of its first two trace
    calls (the primary and the bounce-1 rays)."""
    scene, cam, cfg = bench.make_mesh_setup(device=device)
    pathtrace.trace_image(scene, cam, cfg, 0)
    with recorded(modules, ("cand_fused", "intersect_mesh_instances"),
                  clone=True,
                  keep=lambda seen: len(seen["intersect_mesh_instances"]) < 2
                  ) as seen:
        pathtrace.trace_image(scene, cam, cfg, 1)
        torch.cuda.synchronize()
    return seen


def check_fused_kernel(tk, seen):
    """Phase 12: B10 against its plain version, its culled walk and the
    multi-launch loop, bit for bit, on each recorded call, with its work
    (trimesh_kernels.cand_fused_work: the scan's chunks tested and met,
    rows swept and roots, the sweep's chunks tested and met, faces
    guard-tested and swept) and the times of the kernel at each of
    TRI_CHUNKS, the plain version and the loop; the kernels-line fields
    are the primary call's."""
    calls = seen["cand_fused"]
    if len(calls) != 2 or len(seen["intersect_mesh_instances"]) != 2:
        raise AssertionError(f"B10: recorded {len(calls)} calls, expected 2")
    fields = None
    for label, args in zip(("primary", "bounce-1"), calls):
        (rays, bscan, inst_tbl, inst_bounds, tri_tbl, tri_bounds, chunk,
         rounds, block) = args
        loop_args = (rays, bscan, inst_tbl, inst_bounds, tri_tbl, tri_bounds,
                     chunk, rounds, block)
        work = {}
        out_k = tk.cand_fused(*args)
        out_p = tk.cand_fused_plain(*args, work=work)
        out_l = tk.cand_loop(*loop_args)
        out_w, w = tk.cand_fused_work(*args[:8], 262144)
        torch.cuda.synchronize()
        mismatch = words_differ(out_k, out_p)
        loop_mismatch = words_differ(out_p, out_l)
        walk_mismatch = words_differ(out_k, out_w)
        n, m_pad, f_pad = rays.shape[1], bscan.shape[0], tri_tbl.shape[0]
        live, sweeps = work["live"], work["sweeps"]
        # A live lane reads its ray and writes three words; a dead one
        # reads tmin and tmax; each table once.
        b_bytes = lane_bytes(n, live, 8, 3, bscan, inst_tbl, inst_bounds,
                             tri_tbl, tri_bounds)
        scan_ops = (w["scan_tests"] * OPS_B5_CHUNK + w["scan_met"] * OPS_B5_MET
                    + w["scan_rows"] * OPS_B5_SWEPT
                    + w["scan_roots"] * OPS_B5_ROOT + live * OPS_B5_RAY)
        sweep_ops = (w["tri_tests"] * (OPS_TRI_CHUNK + OPS_TRI_END)
                     + w["cones"] * OPS_TRI_CONE
                     + w["guards"] * OPS_TRI_GUARD + w["faces"] * OPS_MT_PAIR
                     + sweeps * (OPS_TO_OBJECT + OPS_TRI_RAY))
        unculled_ops = (work["scans"] * m_pad * OPS_B10_SCAN_ROW
                        + sweeps * (f_pad * OPS_B10_SWEEP_ROW
                                    + OPS_TO_OBJECT))
        b_ms, b_by = bound(b_bytes, scan_ops + sweep_ops)
        u_ms = bound(b_bytes, unculled_ops)[0]
        scan_ms = bound(0, scan_ops)[0]
        sweep_ms = bound(0, sweep_ops)[0]
        k_ms = cuda_ms(lambda: tk.cand_fused(*args), 10)
        p_ms = cuda_ms(lambda: tk.cand_fused_plain(*args), 1)
        l_ms = cuda_ms(lambda: tk.cand_loop(*loop_args), 10)
        spheres = tri_tables(tk, tri_tbl, tri_bounds, chunk)
        chunk_ms = {c: cuda_ms(lambda c=c: tk.cand_fused(
            rays, bscan, inst_tbl, inst_bounds, tri_tbl, spheres[c], c,
            rounds, block), 10) for c in TRI_CHUNKS}
        found = int((out_k[0] < tk.INF_BITS).sum())
        per, per_sweep = max(live, 1), max(sweeps, 1)
        warps = max(w["warps"], 1)
        log(f"fused kernel: B10 {label} rays={n} live={live} "
            f"rounds={rounds} rows={m_pad} instances={inst_tbl.shape[1]} "
            f"faces={f_pad} chunk={chunk} lane_scans={work['scans']} "
            f"lane_sweeps={sweeps} hits={found} "
            f"unresolved={int((out_k[2] < tk.INF_BITS).sum())} "
            f"mismatch={mismatch} walk_mismatch={walk_mismatch} "
            f"plain_vs_loop_mismatch={loop_mismatch} "
            f"scan: chunk_tests={w['scan_tests']} chunks_met={w['scan_met']} "
            f"rows={w['scan_rows']} roots={w['scan_roots']} "
            f"chunks_met_per_live_lane={w['scan_met'] / per!r} "
            f"chunks_met_per_live_warp={w['scan_warp_met'] / warps!r} "
            f"rows_per_live_lane={w['scan_rows'] / per!r} "
            f"sweep: chunk_tests={w['tri_tests']} chunks_met={w['tri_met']} "
            f"cone_tests={w['cones']} guard_tests={w['guards']} "
            f"triangles_swept={w['faces']} "
            f"chunks_met_per_sweep={w['tri_met'] / per_sweep!r} "
            f"chunks_met_per_live_warp={w['tri_warp_met'] / warps!r} "
            f"triangles_swept_per_live_lane={w['faces'] / per!r} "
            f"triangles_swept_per_sweep={w['faces'] / per_sweep!r} "
            f"kernel_ms={k_ms!r} plain_ms={p_ms!r} "
            f"loop_ms(B5+B6)={l_ms!r} bound_ms={b_ms!r} ({b_by}; scan "
            f"{scan_ms!r}, sweep {sweep_ms!r}) unculled_bound_ms={u_ms!r} "
            f"chunk_ms={json.dumps(chunk_ms)}")
        if mismatch or loop_mismatch or walk_mismatch:
            raise AssertionError(f"B10 {label}: kernel, plain version, walk "
                                 f"and loop disagree ({mismatch}, "
                                 f"{walk_mismatch}, {loop_mismatch} words)")
        if found == 0:
            raise AssertionError(f"B10 {label}: no hit")
        if fields is None:
            fields = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                      "unculled_bound_ms": u_ms}
    return fields


def capture_default_reprojections(bench, ik, rp, device="cuda"):
    """One default frame at 1920x1080 to warm the histories, then one that
    records every B4 call: the ReSTIR history, the denoiser's packed
    mirrors (nearest) and the TAA history (bilinear). Over that frame and
    the next (one SHARC cadence, the update in one of them) it also
    records every B1 launch. Returns (the B4 calls, b1_frame's B1 kernel
    ms, launches and line per frame)."""
    pipe, state, pose = bench.make_frame_setup(
        cfg=bench.default_frame_config(), device=device)
    state, _ = pipe.render_frame(state, pose)
    with recorded((ik,), ("intersect_morton",), clone=True) as b1:
        with recorded((rp,), ("reproject_packed",), clone=True) as seen:
            state, _ = pipe.render_frame(state, pose)
            torch.cuda.synchronize()
        pipe.render_frame(state, pose)
        torch.cuda.synchronize()
    return (seen["reproject_packed"],
            *b1_frame(ik, b1["intersect_morton"], 2))


def check_default_reprojections(rp, calls, label="default"):
    """Phase 14 (first part): B4 against its plain version on each of a
    default frame's reprojections (phase 16: the mesh pipeline frame's,
    `label` "mesh pipeline"); returns the summed kernels-line fields."""
    modes = [call[2] for call in calls]
    if sorted(modes) != ["bilinear", "nearest", "nearest", "nearest"]:
        raise AssertionError(f"B4 in the {label} frame: modes {modes}, "
                             f"expected 3 nearest and 1 bilinear")
    ms = plain_ms = lib_ms = bytes_moved = ops = err = 0.0
    offsets = []
    for src, motion, mode, *rest in calls:
        # A band's rows of the history (the sharded frame): from history
        # row `row0`, h rows.
        row0 = rest[0] if rest else 0
        offsets.append(row0)
        src_h, w, c = src.shape
        h = motion.shape[0]
        o_k, ok_k = rp.reproject_packed(src, motion, mode, row0)
        o_p, ok_p = rp.reproject_packed_plain(src, motion, mode, row0)
        torch.cuda.synchronize()
        ok_mismatch = int((ok_k != ok_p).sum())
        if mode == "nearest":
            bad = int((o_k.view(torch.int32) != o_p.view(torch.int32)).sum())
            distinct = int(torch.unique(src.view(torch.int32)).numel())
            if distinct <= min(1000, src.numel() // 8):
                raise AssertionError(f"B4 nearest {h}x{w}x{c}: the history "
                                     f"is not a warm frame's ({distinct} "
                                     f"distinct words)")
        else:
            e = float((o_k - o_p).abs().max())
            err = max(err, e)
            bad = int(e > B4_BILINEAR_REL * float(src.abs().max()))
            ops += h * w * c * OPS_B4_BILINEAR
        grid = torch.stack([
            (torch.arange(w, device=motion.device)[None, :] + motion[..., 0])
            / (w - 1) * 2 - 1,
            (torch.arange(row0, row0 + h, device=motion.device)[:, None]
             + motion[..., 1]) / (src_h - 1) * 2 - 1], dim=-1)[None]
        chw = src.permute(2, 0, 1)[None].contiguous()
        k = cuda_ms(lambda: rp.reproject_packed(src, motion, mode, row0), 50)
        p = cuda_ms(lambda: rp.reproject_packed_plain(src, motion, mode,
                                                      row0), 10)
        lib = cuda_ms(lambda: torch.nn.functional.grid_sample(
            chw, grid, mode=mode, padding_mode="border", align_corners=True),
            50)
        vec = 1 if mode == "bilinear" else rp.vector_width(c, src, o_k)
        log(f"{label} kernels: B4 {mode} {h}x{w}x{c} of {src_h} rows from "
            f"row {row0} vector_width={vec} "
            f"mismatch={bad} ok_mismatch={ok_mismatch} "
            f"kernel_ms={k!r} plain_ms={p!r} grid_sample_ms={lib!r} "
            f"bound_ms={bound((2 * c * 4 + 8 + 1) * h * w, 0)[0]!r}")
        if bad or ok_mismatch:
            raise AssertionError(f"B4 {mode} {h}x{w}x{c}: kernel disagrees "
                                 f"with its plain version")
        ms, plain_ms, lib_ms = ms + k, plain_ms + p, lib_ms + lib
        bytes_moved += (2 * c * 4 + 8 + 1) * h * w
    b_ms, b_by = bound(bytes_moved, ops)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "row_offsets": offsets}


@contextlib.contextmanager
def mode_tally(rp):
    """Count the main path's B4 calls by mode (the wrapper's own counter
    counts the launches)."""
    tally = {"nearest": 0, "bilinear": 0}
    orig = rp.reproject_packed

    def tallied(src, motion, mode="bilinear", row0=0):
        tally[mode] += 1
        return orig(src, motion, mode, row0)
    rp.reproject_packed = tallied
    try:
        yield tally
    finally:
        rp.reproject_packed = orig


def run_default_frame(bench, backend, rp, smi, label, upscaled, iters, dev):
    """Phase 14: the default (or upscaled) frame through bench.bench_frame,
    counted from zero; checks the image, the SHARC hits and each kernel's
    launches. Returns the launches."""
    cfg = bench.default_frame_config(upscaled=upscaled)
    backend.reset_launches()
    with mode_tally(rp) as tally:
        stats, img = bench.bench_frame(iters=iters, device=dev, cfg=cfg)
    # 1 warm, iters timed, one SHARC cadence stage-timed
    frames = stats["frames"]
    launches = dict(backend.LAUNCHES)
    finite = bool(torch.isfinite(img).all())
    counters = stats["counters"]
    hits = sum(v for k, v in counters.items() if k.startswith("sharc_hits"))
    log(f"{label}: render {cfg.render_width}x{cfg.render_height} output "
        f"{cfg.output_width}x{cfg.output_height} bounces={cfg.bounces} "
        f"frames={frames} frame_ms={stats['frame_ms']!r} "
        f"rays_per_frame={stats['rays_per_frame']!r} "
        f"sharc_hits={hits!r} sharc_splat_dropped_rows="
        f"{counters['sharc_splat_dropped_rows']!r} "
        f"launches={json.dumps(launches)} B4_by_mode={json.dumps(tally)} "
        f"finite={finite} min={float(img.min())!r} "
        f"max={float(img.max())!r} mean={float(img.mean())!r} | {smi}")
    log(f"{label}: counters={json.dumps(counters)}")
    log(f"{label}: passes_ms={json.dumps(stats['passes_ms'])}")
    if (tuple(img.shape) != (cfg.output_height, cfg.output_width, 3)
            or not finite or float(img.min()) < 0.0
            or float(img.max()) > 1.0):
        raise AssertionError(f"the {label} is not a finite image in [0, 1]")
    if hits <= 0:
        raise AssertionError(f"the {label}'s last frame took nothing from "
                             f"the SHARC cache")
    if not {"sharc_update", "denoise", "taa"} <= set(stats["passes_ms"]):
        raise AssertionError(f"the {label} ran without its SHARC, denoise "
                             f"or TAA stage")
    # Per frame: the ReSTIR passes (3 x B2, B3, B11, one reprojection), the
    # denoiser's two reprojections (nearest) and TAA's one (bilinear);
    # B1 at least once per bounce and frame (the G-buffer, bounces 1-8) and
    # as often again per SHARC update (every second frame from frame 0).
    expect = {"occlusion_morton": 3 * frames,
              "initial_light_candidates": frames,
              "intersect_brute": frames, "reproject_packed": 4 * frames,
              "cand_fused": 0, "bound_scan": 0}
    for name, count in expect.items():
        if launches[name] != count:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times in {frames} "
                                 f"frames, expected {count}")
    if tally != {"nearest": 3 * frames, "bilinear": frames}:
        raise AssertionError(f"{label}: B4 modes {tally}")
    updates = -(-frames // cfg.sharc_update_period)
    if launches["intersect_morton"] < (cfg.bounces + 1) * (frames + updates):
        raise AssertionError(f"{label}: B1 launched "
                             f"{launches['intersect_morton']} times")
    return launches


def check_default_small(pipeline, bench, sharc_mod,
                        devices=("cuda", "cpu")):
    """Phase 15: three default frames at 64x64 (3 bounces, oscillator grid
    3, a 4,096-slot cache) on the card and on the CPU from one start
    state, then one ReLAX and one DLSS-RR frame from that start; bounds
    DEFAULT_*."""
    base = bench.default_frame_config(
        output_width=64, output_height=64, render_width=64,
        render_height=64, bounces=3, block_size=4096,
        sharc=sharc_mod.SHARCConfig(capacity_log2=12))
    runs = (("default", base, 3),
            ("ReLAX", dataclasses.replace(base, denoiser="NRDReLAX"), 1),
            ("DLSS-RR", dataclasses.replace(
                base, denoiser="DLSSRayReconstruction"), 1))
    for label, cfg, n_frames in runs:
        results = []
        for dev in devices:
            pipe, state, _ = bench.make_frame_setup(
                oscillator_grid=3, device=dev, cfg=cfg)
            eye = torch.tensor([0.0, 2.5, -4.0])
            fwd = torch.tensor([0.0, 0.5, 0.0]) - eye
            pose = pipeline.CameraPose(eye.to(dev), (fwd / fwd.norm()).to(dev),
                                       torch.tensor([0.0, 1.0, 0.0]).to(dev))
            frames = []
            for _ in range(n_frames):
                state, img = pipe.render_frame(state, pose)
                frames.append((img.cpu(), state.sharc.fingerprint.cpu()))
            results.append(frames)
        for i, ((gimg, gfp), (cimg, cfp)) in enumerate(zip(*results)):
            d = (gimg - cimg).abs()
            off = float((d.amax(-1) > DEFAULT_OFF).float().mean())
            filled = (gfp > 0) | (cfp > 0)
            fp_same = float((gfp == cfp)[filled].float().mean())
            log(f"default small: {label} frame {i} image_mean_abs_diff="
                f"{float(d.mean())!r} image_max_abs_diff="
                f"{float(d.max())!r} pixels_off_{DEFAULT_OFF}={off!r} "
                f"sharc_fingerprints_equal={fp_same!r} "
                f"of {int(filled.sum())} filled slots "
                f"finite={bool(torch.isfinite(gimg).all())}")
            if (float(d.mean()) > DEFAULT_MEAN or off > DEFAULT_OFF_SHARE
                    or fp_same < DEFAULT_FP_SHARE
                    or not bool(torch.isfinite(gimg).all())):
                raise AssertionError(f"default small: the {label} frame on "
                                     f"the card disagrees with the CPU")


@contextlib.contextmanager
def compaction_tally(pathtrace):
    """Count the path traces' compactions by (capacity, the sort that
    _compact_slots reports it ran, input space, wave)."""
    tally = {}
    orig = pathtrace._compact_slots

    def tallied(act, l_dir, pixel_ids, cfg, cap, h, w, wave=0):
        cs = orig(act, l_dir, pixel_ids, cfg, cap, h, w, wave)
        key = (f"cap={cap} sort={cs['sort']} "
               f"{'pixels' if pixel_ids is None else 'slots'} wave={wave}")
        tally[key] = tally.get(key, 0) + 1
        return cs
    pathtrace._compact_slots = tallied
    try:
        yield tally
    finally:
        pathtrace._compact_slots = orig


def capture_pipeline_inputs(bench, pathtrace, trimesh, ik, tk, rp, cfg,
                            device="cuda"):
    """One mesh pipeline frame to warm the histories, then one that
    records, by stage: the arguments of every B5, B6, B7 and B11 call and
    every compaction of the trace stage (the bounce-1 segment on its
    compacted, octant-partitioned slots, then each bounce of the deep
    segment in that segment's slot space); of every B5, B8, B9 and B11
    call inside trimesh.intersect_instances_any (the frame's three shadow
    batches); of the BRDF candidate's B11 light sweep (the ReSTIR initial
    stage outside the any-hit calls); and of every B4 call. Closest-hit,
    compaction and B4 tensors are copied (the candidate loop tightens its
    rays in place). Returns (closest, compactions, shadow, light sweeps,
    B4 calls)."""
    pipe, state, pose = bench.make_frame_setup(device=device, mesh=True,
                                               cfg=cfg)
    state, _ = pipe.render_frame(state, pose)
    stage, inside = [None], [False]

    def run(name, fn, *args):
        stage[0] = name
        try:
            return fn(*args)
        finally:
            stage[0] = None
    orig = trimesh.intersect_instances_any

    def any_hit(*args, **kwargs):
        inside[0] = True
        try:
            return orig(*args, **kwargs)
        finally:
            inside[0] = False

    def in_trace(seen):
        return stage[0] == "trace" and not inside[0]
    trimesh.intersect_instances_any = any_hit
    try:
        with recorded((ik, tk), ("bound_scan", "shared_blas_sweep",
                                 "intersect_mesh_instances",
                                 "intersect_brute"),
                      clone=True, keep=in_trace) as closest, \
                recorded((pathtrace,), ("_compact_slots",), clone=True,
                         keep=in_trace) as packs, \
                recorded((ik, tk), ("bound_scan", "shared_blas_any",
                                    "intersect_mesh_instances_any",
                                    "intersect_brute"),
                         keep=lambda seen: inside[0]) as shadow, \
                recorded((ik,), ("intersect_brute",),
                         keep=lambda seen: stage[0] == "restir_initial"
                         and not inside[0]) as lights, \
                recorded((rp,), ("reproject_packed",), clone=True) as b4:
            pipe.render_frame(state, pose, _run=run)
            torch.cuda.synchronize()
    finally:
        trimesh.intersect_instances_any = orig
    return (closest, packs["_compact_slots"], shadow,
            lights["intersect_brute"], b4["reproject_packed"])


def check_pipeline_closest(ik, tk, seen, cap1):
    """Phase 16: B5, B6, B7 and B11 against their plain versions on every
    closest-hit call of one mesh pipeline frame's trace stage: first the
    bounce-1 segment (cap1 slots, octant-partitioned, the dead slots at
    the tail), then each bounce of the deep segment in that segment's slot
    space. Each launch is timed beside its plain version; the kernels-line
    fields of "...@mesh_pipeline" are sums over all of them (one frame's
    trace stage), B7's over the frame's own backstop batches."""
    calls = len(seen["intersect_mesh_instances"])
    if (calls < 2 or len(seen["bound_scan"]) != 4 * calls
            or len(seen["shared_blas_sweep"]) != 3 * calls
            or len(seen["intersect_brute"]) != 2 * calls):
        raise AssertionError(
            "mesh pipeline kernels: recorded "
            + json.dumps({k: len(v) for k, v in seen.items()})
            + " calls, expected per closest-hit call 4 B5, 3 B6, 1 B7 and "
            "2 B11")
    if seen["intersect_mesh_instances"][0][0].shape[1] != cap1:
        raise AssertionError(f"mesh pipeline kernels: the trace stage's "
                             f"first call is not the {cap1}-slot bounce-1 "
                             f"segment")
    names = ("bound_scan", "shared_blas_sweep", "intersect_mesh_instances",
             "intersect_brute")
    parts = {name: ([], []) for name in names}
    for c in range(calls):
        label = ("pipeline bounce-1 segment" if c == 0
                 else f"pipeline deep segment call {c}")
        seg = min(c, 1)
        for r, args in enumerate(seen["bound_scan"][4 * c:4 * c + 4]):
            parts["bound_scan"][seg].append(check_b5(
                ik, tk, f"mesh kernels: B5 {label} round {r + 1}", args, 1))
        for r, args in enumerate(seen["shared_blas_sweep"][3 * c:3 * c + 3]):
            parts["shared_blas_sweep"][seg].append(
                check_b6(ik, tk, f"{label} round {r + 1}", args, True))
        parts["intersect_mesh_instances"][seg].append(
            check_b7(tk, f"{label} backstop",
                     seen["intersect_mesh_instances"][c], True))
        for which, (rays, spheres, block) in zip(
                ("bounds", "inscribed balls"),
                seen["intersect_brute"][2 * c:2 * c + 2]):
            res = compare_closest(
                f"B11 {label} {which} K={spheres.shape[1]}",
                lambda: ik.intersect_brute(rays, spheres),
                lambda: ik.intersect_brute_plain(rays, spheres, block),
                reps=10, plain_reps=1)
            w = b11_work(ik, rays, spheres)
            res.update(bytes=w["bytes"], ops=w["ops"],
                       unculled_ops=w["unculled_ops"])
            parts["intersect_brute"][seg].append(res)
            log(f"mesh kernels: B11 {label} {which} {w['line']} "
                f"kernel_ms={res['ms']!r}")
    out = {}
    for name in names:
        first, deep = parts[name]
        f1, fd = sum_parts(first), sum_parts(deep)
        out[f"{name}@mesh_pipeline"] = total = sum_parts(first + deep)
        log(f"mesh pipeline kernels: {name} over one frame's trace stage "
            f"({len(first) + len(deep)} launches): kernel_ms="
            f"{total['ms']!r} plain_ms={total['plain_ms']!r} bound_ms="
            f"{total['bound_ms']!r} ({total['bound_by']}); bounce-1 segment "
            f"kernel_ms={f1['ms']!r} bound_ms={f1['bound_ms']!r}; deep "
            f"segment ({calls - 1} calls) kernel_ms={fd['ms']!r} "
            f"bound_ms={fd['bound_ms']!r}")
    return out


def check_pipeline_lights(ik, calls):
    """Phase 16: B11 against its plain version on the mesh pipeline
    frame's BRDF-candidate light sweep; returns its kernels-line fields."""
    if len(calls) != 1:
        raise AssertionError(f"mesh pipeline kernels: {len(calls)} B11 "
                             f"light sweeps in the ReSTIR initial stage, "
                             f"expected 1")
    rays, spheres, block = calls[0]
    res = compare_closest(
        f"B11 pipeline light sweep K={spheres.shape[1]}",
        lambda: ik.intersect_brute(rays, spheres),
        lambda: ik.intersect_brute_plain(rays, spheres, block),
        reps=10, plain_reps=1)
    w = b11_work(ik, rays, spheres)
    res.update(bytes=w["bytes"], ops=w["ops"],
               unculled_ops=w["unculled_ops"])
    log(f"mesh kernels: B11 pipeline light sweep {w['line']} "
        f"kernel_ms={res['ms']!r}")
    return sum_parts([res])


def check_partition_sort(pathtrace, calls, cap1):
    """Phase 16: the bounce-1 segment's compaction on its own input, in
    partition mode and, with compact_sort_partition_min raised past its
    capacity, as the (octant, tile) key sort. In pixel space the two give
    every slot the same pixel, so the rest of the frame is the same work
    and the difference of their times is the frame's."""
    act, l_dir, pixel_ids, cfg, cap, h, w = calls[0]
    if cap != cap1 or pixel_ids is not None:
        raise AssertionError(f"mesh pipeline: the trace stage's first "
                             f"compaction is not the {cap1}-slot bounce-1 "
                             f"segment in pixel space")
    ids = torch.arange(act.numel(), device=act.device)
    runs = {}
    for pmin in (cfg.compact_sort_partition_min, 10 ** 9):
        c = dataclasses.replace(cfg, compact_sort_partition_min=pmin)
        cs = pathtrace._compact_slots(act, l_dir, pixel_ids, c, cap, h, w)
        runs[cs["sort"]] = (cs["gsel"](ids, act.numel()), cuda_ms(
            lambda c=c: pathtrace._compact_slots(act, l_dir, pixel_ids, c,
                                                 cap, h, w), 10))
    if set(runs) != {"partition", "key"}:
        raise AssertionError(f"mesh pipeline: the compaction ran the sorts "
                             f"{sorted(runs)}")
    differ = int((runs["partition"][0] != runs["key"][0]).sum())
    log(f"mesh pipeline: bounce-1 compaction {h}x{w} -> {cap} slots, "
        f"live={int(act.sum())} partition_ms={runs['partition'][1]!r} "
        f"key_sort_ms={runs['key'][1]!r} slots_differing={differ}")
    if differ:
        raise AssertionError("mesh pipeline: the partition and the key "
                             "sort put different pixels in the slots")


def run_mesh_pipeline(bench, backend, pathtrace, rp, smi, iters, dev, cfg):
    """Phase 16: the all-mesh pipeline recipe through bench.bench_frame,
    counted from zero; checks the image, the SHARC hits, the bounce-1
    segment's partition sort and each kernel's launches. Returns the
    launches by kernels-line row: closest-hit and shadow launches of B5
    and B11 apart, and B11's light sweeps."""
    backend.reset_launches()
    with mode_tally(rp) as tally, compaction_tally(pathtrace) as packs:
        stats, img = bench.bench_frame(iters=iters, device=dev, mesh=True,
                                       cfg=cfg)
    frames = stats["frames"]
    launches = dict(backend.LAUNCHES)
    finite = bool(torch.isfinite(img).all())
    counters = stats["counters"]
    hits = sum(v for k, v in counters.items() if k.startswith("sharc_hits"))
    calls = launches["intersect_mesh_instances"]
    log(f"mesh pipeline: render {cfg.render_width}x{cfg.render_height} "
        f"output {cfg.output_width}x{cfg.output_height} "
        f"bounces={cfg.bounces} compact_from={cfg.compact_from} "
        f"frames={frames} frame_ms={stats['frame_ms']!r} "
        f"rays_per_frame={stats['rays_per_frame']!r} sharc_hits={hits!r} "
        f"wavefront_overflow_paths="
        f"{counters['wavefront_overflow_paths']!r} "
        f"spill_waves={stats['spill_waves']} "
        f"spill_waves_per_frame={stats['spill_waves'] / frames!r} "
        f"closest_hit_calls={calls} launches={json.dumps(launches)} "
        f"B4_by_mode={json.dumps(tally)} finite={finite} "
        f"min={float(img.min())!r} max={float(img.max())!r} "
        f"mean={float(img.mean())!r} | {smi}")
    log(f"mesh pipeline: compactions={json.dumps(packs)} (over {frames} "
        f"frames)")
    log(f"mesh pipeline: counters={json.dumps(counters)}")
    log(f"mesh pipeline: passes_ms={json.dumps(stats['passes_ms'])}")
    if (tuple(img.shape) != (cfg.output_height, cfg.output_width, 3)
            or not finite or float(img.min()) < 0.0
            or float(img.max()) > 1.0):
        raise AssertionError("the mesh pipeline frame is not a finite "
                             "image in [0, 1]")
    if hits <= 0:
        raise AssertionError("the mesh pipeline's last frame took nothing "
                             "from the SHARC cache")
    cap1 = pathtrace._compact_capacity(cfg.render_width * cfg.render_height,
                                       1)
    if packs.get(f"cap={cap1} sort=partition pixels wave=0", 0) < frames:
        raise AssertionError(f"the bounce-1 segment did not compact into "
                             f"{cap1} slots in partition mode every frame")
    # Per frame as phase 11 (3 any-hit calls: 3 x B5, 2 x B8, 1 x B9, 1 x
    # B11; the BRDF candidate's light sweep, B11), the four reprojections
    # of phase 14, and per closest-hit call the counts of phase 9.
    expect = {"shared_blas_any": 6 * frames,
              "intersect_mesh_instances_any": 3 * frames,
              "bound_scan": 4 * calls + 9 * frames,
              "shared_blas_sweep": 3 * calls,
              "intersect_brute": 2 * calls + 4 * frames,
              "reproject_packed": 4 * frames, "intersect_morton": 0,
              "occlusion_morton": 0, "initial_light_candidates": 0,
              "cand_fused": 0}
    for name, count in expect.items():
        if launches[name] != count:
            raise AssertionError(f"mesh pipeline: {name} launched "
                                 f"{launches[name]} times in {frames} "
                                 f"frames, expected {count}")
    if tally != {"nearest": 3 * frames, "bilinear": frames}:
        raise AssertionError(f"mesh pipeline: B4 modes {tally}")
    if calls < frames * (cfg.bounces + 1):
        raise AssertionError(f"{calls} closest-hit calls in {frames} frames "
                             f"of {cfg.bounces} bounces")
    rows = {f"{name}@mesh_pipeline": launches[name] for name in (
        "reproject_packed", "shared_blas_sweep", "intersect_mesh_instances",
        "shared_blas_any", "intersect_mesh_instances_any")}
    rows.update({"bound_scan@mesh_pipeline": 4 * calls,
                 "bound_scan@mesh_pipeline_any": 9 * frames,
                 "intersect_brute@mesh_pipeline": 2 * calls,
                 "intersect_brute@mesh_pipeline_any": 3 * frames,
                 "intersect_brute@mesh_pipeline_lights": frames})
    return rows


def check_mesh_pipeline_small(pipeline, bench, sharc_mod,
                              devices=("cuda", "cpu")):
    """Phase 17: three frames of the mesh pipeline graph at 64x64 output
    (32x32 render, 3 bounces, a 4,096-slot cache, oscillator grid 3 as
    45 instances of a 128-face geosphere), every compaction in partition
    mode, on the card and on the CPU from one start state; bounds
    DEFAULT_*."""
    cfg = bench.mesh_pipeline_config(
        output_width=64, output_height=64, render_width=32,
        render_height=32, bounces=3, block_size=4096,
        sharc=sharc_mod.SHARCConfig(capacity_log2=12))
    results = []
    for dev in devices:
        pipe, state, _ = bench.make_frame_setup(
            oscillator_grid=3, device=dev, mesh=True, tess=3, cfg=cfg)
        base = pipe._pt_cfg
        pipe._pt_cfg = lambda base=base: dataclasses.replace(
            base(), compact_sort_partition_min=0)
        eye = torch.tensor([0.0, 2.5, -4.0])
        fwd = torch.tensor([0.0, 0.5, 0.0]) - eye
        pose = pipeline.CameraPose(eye.to(dev), (fwd / fwd.norm()).to(dev),
                                   torch.tensor([0.0, 1.0, 0.0]).to(dev))
        frames = []
        for _ in range(3):
            state, img = pipe.render_frame(state, pose)
            frames.append((img.cpu(), state.sharc.fingerprint.cpu(),
                           {k: float(v) for k, v in state.counters.items()}))
        results.append(frames)
    for i, ((gimg, gfp, gc), (cimg, cfp, cc)) in enumerate(zip(*results)):
        d = (gimg - cimg).abs()
        off = float((d.amax(-1) > DEFAULT_OFF).float().mean())
        filled = (gfp > 0) | (cfp > 0)
        fp_same = float((gfp == cfp)[filled].float().mean())
        log(f"mesh pipeline small: frame {i} image_mean_abs_diff="
            f"{float(d.mean())!r} image_max_abs_diff={float(d.max())!r} "
            f"pixels_off_{DEFAULT_OFF}={off!r} sharc_fingerprints_equal="
            f"{fp_same!r} of {int(filled.sum())} filled slots "
            f"overflow={gc['wavefront_overflow_paths']!r} "
            f"finite={bool(torch.isfinite(gimg).all())}")
        if (float(d.mean()) > DEFAULT_MEAN or off > DEFAULT_OFF_SHARE
                or fp_same < DEFAULT_FP_SHARE
                or gc["wavefront_overflow_paths"]
                != cc["wavefront_overflow_paths"]
                or not bool(torch.isfinite(gimg).all())):
            raise AssertionError("mesh pipeline small: the frame on the "
                                 "card disagrees with the CPU")


def check_fidelity(dev, smi):
    """Phase 18: the independent-tracer crosscheck with the port's side on
    the card, then the static and mesh fidelity runs at 160x90."""
    from drts_tpu_torch import crosscheck, fidelity
    t0 = time.perf_counter()
    cc = crosscheck.run(width=32, height=18, spp=48, bounces=3, device=dev)
    log(f"fidelity: crosscheck={json.dumps(cc)} "
        f"wall_s={time.perf_counter() - t0!r} | {smi}")
    if not (0.97 < cc["energy_ratio"] < 1.03 and cc["mean_rel_err"] < 0.15):
        raise AssertionError("the crosscheck is off the bounds of "
                             "tests/test_crosscheck.py")
    for name, fn in (("static", fidelity.run), ("mesh", fidelity.run_mesh)):
        t0 = time.perf_counter()
        res = fn(160, 90, spp_reference=32, frames_realtime=8,
                 ref_cache=None, device=dev)
        log(f"fidelity: {name} ssim={res['value']!r} "
            f"wall_s={time.perf_counter() - t0!r} result={json.dumps(res)} "
            f"| {smi}")
        if not (np.isfinite(res["value"]) and 0.0 < res["value"] <= 1.0):
            raise AssertionError(f"fidelity: the {name} SSIM is off (0, 1]")


# Phase 19's small frames look at the mesh instances from 4 units away,
# with the sphere field behind them (tests/test_torch_textured_frame.py's
# pose).
TEXTURED_EYE = (0.0, 2.0, -9.5)
TEXTURED_TARGET = (0.0, 1.4, -4.0)


def capture_textured_inputs(bench, trimesh, ik, tk, rk, rp, cfg,
                            device="cuda"):
    """Phase 19: one textured frame to warm the histories, then one that
    records, by stage: the arguments of every B1, B5, B6, B7 and B11 call
    of the closest-hit calls in the G-buffer and trace stages (the primary
    rays, their two alpha rounds, every bounce and its alpha rounds;
    tensors copied, as the candidate loop tightens its rays in place); of
    every B2 call and every B5, B8, B9 and B11 call inside trimesh.
    intersect_instances_any (the shadow batches); the BRDF candidate's B11
    light sweep; every B3 call; every B4 call (copied). Also keeps the
    frame's scene, camera and accel and its G-buffer. Returns (closest,
    shadow, B2 calls, light sweeps, B3 calls, B4 calls, frame)."""
    pipe, state, pose = bench.make_frame_setup(device=device, cfg=cfg,
                                               textured=True)
    state, _ = pipe.render_frame(state, pose)
    stage, inside, frame = [None], [False], {}

    def run(name, fn, *args):
        stage[0] = name
        try:
            out = fn(*args)
        finally:
            stage[0] = None
        if name == "update":
            frame["scene"], frame["cam"], frame["accel"] = out[1:]
        if name == "gbuffer":
            frame["gbuf"] = out
        return out
    orig = trimesh.intersect_instances_any

    def any_hit(*args, **kwargs):
        inside[0] = True
        try:
            return orig(*args, **kwargs)
        finally:
            inside[0] = False

    def in_closest(seen):
        return stage[0] in ("gbuffer", "trace") and not inside[0]
    trimesh.intersect_instances_any = any_hit
    try:
        with recorded((ik, tk), ("intersect_morton", "bound_scan",
                                 "shared_blas_sweep",
                                 "intersect_mesh_instances",
                                 "intersect_brute"),
                      clone=True, keep=in_closest) as closest, \
                recorded((ik, tk), ("bound_scan", "shared_blas_any",
                                    "intersect_mesh_instances_any",
                                    "intersect_brute"),
                         keep=lambda seen: inside[0]) as shadow, \
                recorded((ik,), ("occlusion_morton",)) as b2, \
                recorded((ik,), ("intersect_brute",),
                         keep=lambda seen: stage[0] == "restir_initial"
                         and not inside[0]) as lights, \
                recorded((rk,), ("initial_light_candidates",)) as b3, \
                recorded((rp,), ("reproject_packed",), clone=True) as b4:
            pipe.render_frame(state, pose, _run=run)
            torch.cuda.synchronize()
    finally:
        trimesh.intersect_instances_any = orig
    return (closest, shadow, b2["occlusion_morton"],
            lights["intersect_brute"], b3["initial_light_candidates"],
            b4["reproject_packed"], frame)


def b1_part(ik, label, args):
    """B1 against its plain version on one recorded call (t and index
    words equal), timed, with the work of its culled walk
    (intersect_kernels.intersect_morton_work). Returns its timed part."""
    rays, table, bounds, block = (*args, 16384)[:4]
    res = compare_closest(
        label, lambda: ik.intersect_morton(rays, table, bounds, block),
        lambda: ik.intersect_morton_plain(rays, table, bounds, block),
        reps=5, plain_reps=1)
    tests, met, pairs, roots = (int(x.sum()) for x in
                                ik.intersect_morton_work(rays, table, bounds,
                                                         262144))
    n, live = rays.shape[1], live_rays(rays)
    res.update(bytes=lane_bytes(n, live, 8, 2, table, bounds),
               ops=tests * OPS_B1_CHUNK + met * OPS_B1_MET
               + pairs * OPS_B1_SWEPT + roots * OPS_B1_ROOT
               + live * OPS_B1_RAY,
               unculled_ops=live * table.shape[1] * OPS_B1_PAIR,
               live=live, tmin_positive=int(
                   ((rays[6] > 0) & (rays[7] >= rays[6])).sum()))
    log(f"textured kernels: {label} live={live} live_with_tmin_above_0="
        f"{res['tmin_positive']} chunk_tests={tests} chunks_met={met} "
        f"pairs={pairs} roots={roots} "
        f"bound_ms={bound(res['bytes'], res['ops'])[0]!r}")
    return res


def b11_part(ik, label, args, path="textured kernels"):
    """B11 against its plain version on one recorded call, timed, with
    its work (intersect_kernels.intersect_brute_work); `path` heads the
    printed line."""
    rays, spheres, block = args
    res = compare_closest(
        label, lambda: ik.intersect_brute(rays, spheres),
        lambda: ik.intersect_brute_plain(rays, spheres, block),
        reps=5, plain_reps=1)
    w = b11_work(ik, rays, spheres)
    res.update(bytes=w["bytes"], ops=w["ops"],
               unculled_ops=w["unculled_ops"])
    log(f"{path}: {label} {w['line']}")
    return res


def check_textured_closest(ik, tk, seen, alpha_rounds):
    """Phase 19: B1, B5, B6, B7 and B11 against their plain versions on
    every closest-hit call of one textured frame's G-buffer and trace
    stages: per call one B1 (the spheres, through the Morton accel), two
    B11 (the instance pre-pass), four B5, three B6 and one B7 (the
    instances, bounded by each lane's sphere hit). Each call of the
    primary rays and of the dense bounce is followed by `alpha_rounds`
    re-traces of the rejected lanes (t_min > 0 per lane, the rest dead).
    Returns the "...@textured" fields: sums over all of them."""
    calls = len(seen["intersect_mesh_instances"])
    counts = {k: len(v) for k, v in seen.items()}
    if (calls < 2 * (alpha_rounds + 1)
            or counts["intersect_morton"] != calls
            or counts["bound_scan"] != 4 * calls
            or counts["shared_blas_sweep"] != 3 * calls
            or counts["intersect_brute"] != 2 * calls):
        raise AssertionError(
            "textured kernels: recorded " + json.dumps(counts)
            + " calls, expected per closest-hit call 1 B1, 4 B5, 3 B6, "
            "1 B7 and 2 B11")
    names = ("intersect_morton", "bound_scan", "shared_blas_sweep",
             "intersect_mesh_instances", "intersect_brute")
    parts = {name: [] for name in names}
    sparse = 0
    for c in range(calls):
        r = c % (alpha_rounds + 1)
        label = (f"call {c} ("
                 + ("first trace" if r == 0 else f"alpha round {r}") + ")")
        b1 = b1_part(ik, f"B1 textured {label}",
                     seen["intersect_morton"][c])
        parts["intersect_morton"].append(b1)
        sparse += b1["tmin_positive"] if r else 0
        for i, args in enumerate(seen["bound_scan"][4 * c:4 * c + 4]):
            parts["bound_scan"].append(check_b5(
                ik, tk, f"textured kernels: B5 {label} round {i + 1}", args,
                1))
        for i, args in enumerate(seen["shared_blas_sweep"][3 * c:3 * c + 3]):
            parts["shared_blas_sweep"].append(check_b6(
                ik, tk, f"textured {label} round {i + 1}", args, True,
                chunks=()))
        parts["intersect_mesh_instances"].append(check_b7(
            tk, f"textured {label} backstop",
            seen["intersect_mesh_instances"][c], True))
        for which, args in zip(("bounds", "inscribed balls"),
                               seen["intersect_brute"][2 * c:2 * c + 2]):
            parts["intersect_brute"].append(b11_part(
                ik, f"B11 textured {label} {which}", args))
    if sparse == 0:
        raise AssertionError("textured kernels: no alpha round held a live "
                             "lane with t_min > 0")
    out = {}
    for name in names:
        total = sum_parts(parts[name])
        total["max_abs_err"] = max(p.get("max_abs_err", 0.0)
                                   for p in parts[name])
        out[f"{name}@textured"] = total
        log(f"textured kernels: {name} over one frame's {calls} "
            f"closest-hit calls ({len(parts[name])} launches): kernel_ms="
            f"{total['ms']!r} plain_ms={total['plain_ms']!r} bound_ms="
            f"{total['bound_ms']!r} ({total['bound_by']})")
    log(f"textured kernels: alpha-round B1 lanes live with t_min > 0: "
        f"{sparse}")
    return out


def check_textured_shadow(ik, tk, seen, b2_calls):
    """Phase 19: B2 on the textured frame's three shadow batches (the
    spheres), then B5, B8, B9 and B11 on the same batches' instance half
    (trimesh.intersect_instances_any: the pre-pass, two candidate rounds
    and the scan, the backstop). Returns the "...@textured" fields, each
    summed over one frame's three batches."""
    out = {"occlusion_morton@textured": check_b2(
        ik, b2_calls, "the textured frame", path="textured ")}
    counts = {k: len(v) for k, v in seen.items()}
    if counts != {"bound_scan": 9, "shared_blas_any": 6,
                  "intersect_mesh_instances_any": 3, "intersect_brute": 3}:
        raise AssertionError("textured any-hit kernels: recorded "
                             + json.dumps(counts) + " calls, expected 9 B5, "
                             "6 B8, 3 B9, 3 B11")
    b5, b8, b9, b11 = [], [], [], []
    for c, label in enumerate(("brdf-candidate", "initial", "final")):
        label = "textured " + label
        b11.append(b11_part(ik, f"B11 any-hit pre-pass {label}",
                            seen["intersect_brute"][c]))
        for r, args in enumerate(seen["bound_scan"][3 * c:3 * c + 3]):
            b5.append(check_b5(ik, tk, f"textured any-hit kernels: B5 "
                                       f"{label} round {r + 1}", args, 1))
        for r, args in enumerate(seen["shared_blas_any"][2 * c:2 * c + 2]):
            b8.append(check_b8(tk, f"{label} round {r + 1}", args,
                               chunks=()))
        b9.append(check_b9(tk, f"{label} backstop",
                           seen["intersect_mesh_instances_any"][c], True,
                           sweep=()))
    out["bound_scan@textured_any"] = sum_parts(b5)
    out["shared_blas_any@textured"] = sum_parts(b8)
    out["intersect_mesh_instances_any@textured"] = sum_parts(b9)
    out["intersect_brute@textured_any"] = sum_parts(b11)
    for name in ("bound_scan@textured_any", "shared_blas_any@textured",
                 "intersect_mesh_instances_any@textured",
                 "intersect_brute@textured_any"):
        f = out[name]
        log(f"textured any-hit kernels: {name} over the frame's three "
            f"batches: kernel_ms={f['ms']!r} plain_ms={f['plain_ms']!r} "
            f"bound_ms={f['bound_ms']!r} ({f['bound_by']})")
    return out


def textured_alpha_rejections(trace, shading, camera_mod, frame, block):
    """Phase 19: primary lanes that the textured alpha test rejected,
    counted from the recorded frame's G-buffer: its primary rays traced
    again with no alpha round give each lane's first surface; a lane
    counts where that surface's material alpha passes its cutoff, its
    base-colour map's alpha at level 0 takes it below, and the G-buffer's
    surface lies behind it (or is a miss)."""
    scene, cam, accel, gbuf = (frame[k] for k in ("scene", "cam", "accel",
                                                  "gbuf"))
    h, w = gbuf.linear_depth.shape
    _, _, t_min, t_max = camera_mod.generate_pinhole_rays(
        cam, camera_mod.pixel_ndc(w, h, cam.jitter))
    first = trace.trace_scene(
        scene, gbuf.ray_origin, gbuf.ray_direction,
        torch.broadcast_to(t_min, (h, w)), torch.broadcast_to(t_max, (h, w)),
        block, accel=accel, alpha_rounds=0)
    mat = first.material
    const = mat.base_color[..., 3]
    tex = shading.sample_packed(scene.textures, mat.base_color_map, first.uv,
                                "nearest0").alpha
    by_map = (first.valid & (const >= mat.alpha_cutoff)
              & (const * tex < mat.alpha_cutoff))
    behind = ~gbuf.surf.valid | (gbuf.surf.distance > first.distance)
    return int(by_map.sum()), int((by_map & behind).sum())


def run_textured_frame(bench, backend, rp, smi, iters, dev, cfg):
    """Phase 19: the textured frame through bench.bench_frame, counted
    from zero; checks the image, the SHARC hits and each kernel's
    launches. Returns the launches by kernels-line row."""
    backend.reset_launches()
    with mode_tally(rp) as tally:
        stats, img = bench.bench_frame(iters=iters, device=dev, cfg=cfg,
                                       textured=True)
    frames = stats["frames"]
    launches = dict(backend.LAUNCHES)
    finite = bool(torch.isfinite(img).all())
    counters = stats["counters"]
    hits = sum(v for k, v in counters.items() if k.startswith("sharc_hits"))
    calls = launches["intersect_mesh_instances"]
    log(f"textured frame: render {cfg.render_width}x{cfg.render_height} "
        f"output {cfg.output_width}x{cfg.output_height} "
        f"bounces={cfg.bounces} spheres+instances=438+3 alpha_rounds=2 "
        f"frames={frames} frame_ms={stats['frame_ms']!r} "
        f"rays_per_frame={stats['rays_per_frame']!r} sharc_hits={hits!r} "
        f"spill_waves={stats['spill_waves']} closest_hit_calls={calls} "
        f"closest_hit_calls_per_frame={calls / frames!r} "
        f"launches={json.dumps(launches)} "
        f"launches_per_frame={sum(launches.values()) / frames!r} "
        f"B4_by_mode={json.dumps(tally)} finite={finite} "
        f"min={float(img.min())!r} max={float(img.max())!r} "
        f"mean={float(img.mean())!r} | {smi}")
    log(f"textured frame: counters={json.dumps(counters)}")
    log(f"textured frame: passes_ms={json.dumps(stats['passes_ms'])}")
    if (tuple(img.shape) != (cfg.output_height, cfg.output_width, 3)
            or not finite or float(img.min()) < 0.0
            or float(img.max()) > 1.0):
        raise AssertionError("the textured frame is not a finite image in "
                             "[0, 1]")
    if hits <= 0:
        raise AssertionError("the textured frame's last frame took nothing "
                             "from the SHARC cache")
    # Per closest-hit call the counts of phase 9 and one B1; per frame the
    # three shadow batches (3 x B2, and per batch 3 x B5, 2 x B8, 1 x B9,
    # 1 x B11), the light sweep (B11) and four reprojections. B3 does not
    # run: the mesh instances make the light table a triangle table
    # (restir.initial_sampling takes the loop, as the reference's
    # restir.py does).
    expect = {"intersect_morton": calls,
              "bound_scan": 4 * calls + 9 * frames,
              "shared_blas_sweep": 3 * calls,
              "intersect_brute": 2 * calls + 4 * frames,
              "occlusion_morton": 3 * frames,
              "shared_blas_any": 6 * frames,
              "intersect_mesh_instances_any": 3 * frames,
              "reproject_packed": 4 * frames,
              "initial_light_candidates": 0, "cand_fused": 0}
    for name, count in expect.items():
        if launches[name] != count:
            raise AssertionError(f"textured frame: {name} launched "
                                 f"{launches[name]} times in {frames} "
                                 f"frames, expected {count}")
    if tally != {"nearest": 3 * frames, "bilinear": frames}:
        raise AssertionError(f"textured frame: B4 modes {tally}")
    if calls < frames * (cfg.bounces + 1) * 3:
        raise AssertionError(f"{calls} closest-hit calls in {frames} "
                             f"frames of {cfg.bounces} bounces and two "
                             f"alpha rounds")
    rows = {f"{name}@textured": launches[name] for name in (
        "intersect_morton", "shared_blas_sweep", "intersect_mesh_instances",
        "occlusion_morton", "shared_blas_any",
        "intersect_mesh_instances_any", "reproject_packed")}
    rows.update({"bound_scan@textured": 4 * calls,
                 "bound_scan@textured_any": 9 * frames,
                 "intersect_brute@textured": 2 * calls,
                 "intersect_brute@textured_any": 3 * frames,
                 "intersect_brute@textured_lights": frames})
    return rows


def check_textured_small(pipeline, bench, sharc_mod, image,
                         devices=("cuda", "cpu")):
    """Phase 19: three default frames of the textured scene at 64x64 (3
    bounces, a 4,096-slot cache, oscillator grid 3), then one ReSTIR frame
    of the demo scene lit by a seeded 32x64 lat-long environment map
    (written with image.write_exr to a temporary directory), on the card
    and on the CPU from one start state; bounds DEFAULT_*."""
    import tempfile
    cfg = bench.default_frame_config(
        output_width=64, output_height=64, render_width=64,
        render_height=64, bounces=3, block_size=4096,
        sharc=sharc_mod.SHARCConfig(capacity_log2=12))
    env = np.random.default_rng(19).random((32, 64, 3)).astype(
        np.float32) * 4.0
    with tempfile.TemporaryDirectory() as tmp:
        env_path = os.path.join(tmp, "env.exr")
        image.write_exr(env_path, env)
        results = []
        for dev in devices:
            eye = torch.tensor(TEXTURED_EYE)
            fwd = torch.tensor(TEXTURED_TARGET) - eye
            pose = pipeline.CameraPose(eye.to(dev),
                                       (fwd / fwd.norm()).to(dev),
                                       torch.tensor([0.0, 1.0, 0.0]).to(dev))
            pipe, state, _ = bench.make_frame_setup(
                oscillator_grid=3, device=dev, cfg=cfg, textured=True)
            frames = []
            for _ in range(3):
                state, img = pipe.render_frame(state, pose)
                frames.append((img.cpu(), state.sharc.fingerprint.cpu()))
            pipe, state, pose = bench.make_frame_setup(
                64, 64, bounces=2, oscillator_grid=3, device=dev,
                env_map_path=env_path)
            state, img = pipe.render_frame(state, pose)
            frames.append((img.cpu(), None))
            results.append(frames)
    for i, ((gimg, gfp), (cimg, cfp)) in enumerate(zip(*results)):
        label = (f"textured default frame {i}" if i < 3
                 else "ReSTIR frame with a lat-long environment map")
        d = (gimg - cimg).abs()
        off = float((d.amax(-1) > DEFAULT_OFF).float().mean())
        fp_same = 1.0
        if gfp is not None:
            filled = (gfp > 0) | (cfp > 0)
            fp_same = float((gfp == cfp)[filled].float().mean())
        log(f"textured small: {label} image_mean_abs_diff="
            f"{float(d.mean())!r} image_max_abs_diff={float(d.max())!r} "
            f"pixels_off_{DEFAULT_OFF}={off!r} sharc_fingerprints_equal="
            f"{fp_same!r} image_mean={float(gimg.mean())!r} "
            f"finite={bool(torch.isfinite(gimg).all())}")
        if (float(d.mean()) > DEFAULT_MEAN or off > DEFAULT_OFF_SHARE
                or fp_same < DEFAULT_FP_SHARE
                or not bool(torch.isfinite(gimg).all())):
            raise AssertionError(f"textured small: the {label} on the card "
                                 f"disagrees with the CPU")


def capture_options_inputs(bench, ik, rk, rp, cfg, device="cuda"):
    """Phase 20: one frame of `cfg` (the options frame, or the ReSTIR frame
    with accel_mode="none") to warm the histories and the previous-surface
    rows, then one that records the arguments of every B1, B2, B3, B4 and
    B11 call (copied), each tagged with (its frame-graph stage, whether
    intersect.intersect_spheres_any made it: a shadow ray through B11).
    Returns {name: [((stage, any_hit), args), ...]}."""
    from drts_tpu_torch.ops import intersect
    pipe, state, pose = bench.make_frame_setup(device=device, cfg=cfg)
    state, _ = pipe.render_frame(state, pose)
    stage, inside = [None], [False]
    orig_any = intersect.intersect_spheres_any

    def any_hit(*args, **kwargs):
        inside[0] = True
        try:
            return orig_any(*args, **kwargs)
        finally:
            inside[0] = False

    def run(name, fn, *args):
        stage[0] = name
        try:
            return fn(*args)
        finally:
            stage[0] = None
    intersect.intersect_spheres_any = any_hit
    try:
        with recorded((ik, rk, rp), (
                "intersect_morton", "occlusion_morton",
                "initial_light_candidates", "reproject_packed",
                "intersect_brute"), clone=True,
                tag=lambda: (stage[0], inside[0])) as seen:
            pipe.render_frame(state, pose, _run=run)
            torch.cuda.synchronize()
    finally:
        intersect.intersect_spheres_any = orig_any
    return seen


def check_options_kernels(ik, rk, rp, seen):
    """Phase 20: the options frame's kernels on its own inputs: B1 on the
    thin-lens primaries (every lane its own origin), B2 on its six
    visibility batches (BRDF candidate, initial, the raytraced temporal
    history, the raytraced spatial cross terms from this surface and from
    the neighbour's, final), B3, B4 on its four reprojections (the ReSTIR
    history at C = 12: reservoir, target pdf and the previous surface) and
    once more at C = 5 on that history's first five words (the pseudo
    previous surface's rows), and B11's light sweep; each against its
    plain version and timed. Returns the kernels-line fields."""
    out = {}
    primaries = [a for (st, _), a in seen["intersect_morton"]
                 if st == "gbuffer"]
    if len(primaries) != 1:
        raise AssertionError(f"options kernels: {len(primaries)} B1 calls "
                             f"in the G-buffer, expected 1")
    rays, table, bounds, block = primaries[0]
    origins = torch.unique(rays[0:3].T, dim=0).shape[0]
    res = compare_closest(
        "options B1 thin-lens primaries",
        lambda: ik.intersect_morton(rays, table, bounds),
        lambda: ik.intersect_morton_plain(rays, table, bounds, block),
        reps=20, plain_reps=2)
    line, work = b1_sums([b1_work(ik, rays, table, bounds)])
    log(f"options kernels: B1 thin-lens primaries distinct_origins="
        f"{origins} of {rays.shape[1]} {line}")
    if origins < 0.9 * rays.shape[1]:
        raise AssertionError("options kernels: the primaries do not leave "
                             "their own aperture points")
    res.update(bound_ms=work["bound_ms"], bound_by=work["bound_by"],
               library_ms=None, unculled_bound_ms=work["unculled_bound_ms"])
    out["intersect_morton@options"] = res

    b2 = seen["occlusion_morton"]
    stages = [st for (st, _), _ in b2]
    expect = ["restir_initial", "restir_initial", "restir_temporal",
              "restir_spatial", "restir_spatial", "restir_final"]
    if stages != expect:
        raise AssertionError(f"options kernels: B2 by stage {stages}")
    out["occlusion_morton@options"] = check_b2(
        ik, [a for _, a in b2], "the options frame", path="options ",
        labels=("brdf-candidate", "initial", "temporal-history",
                "spatial-from-surface", "spatial-from-neighbour", "final"))

    (b3,) = [a for _, a in seen["initial_light_candidates"]]
    out["initial_light_candidates@options"] = check_b3(rk, b3,
                                                       path="options ")

    b4 = [a for _, a in seen["reproject_packed"]]
    restir_rows = [a for (st, _), a in seen["reproject_packed"]
                   if st == "restir_temporal"]
    if [a[0].shape[-1] for a in restir_rows] != [12]:
        raise AssertionError("options kernels: the ReSTIR history is not "
                             "one 12-word reprojection")
    out["reproject_packed@options"] = check_default_reprojections(
        rp, b4, label="options")
    src12, motion, *_ = restir_rows[0]
    src5 = src12[..., :5].contiguous()
    h, w, _ = src5.shape
    o_k, ok_k = rp.reproject_packed(src5, motion, "nearest")
    o_p, ok_p = rp.reproject_packed_plain(src5, motion, "nearest")
    torch.cuda.synchronize()
    bad = int((o_k.view(torch.int32) != o_p.view(torch.int32)).sum())
    bad += int((ok_k != ok_p).sum())
    k_ms = cuda_ms(lambda: rp.reproject_packed(src5, motion, "nearest"), 50)
    p_ms = cuda_ms(lambda: rp.reproject_packed_plain(src5, motion,
                                                     "nearest"), 10)
    b_ms = bound((2 * 5 * 4 + 8 + 1) * h * w, 0)[0]
    log(f"options kernels: B4 nearest {h}x{w}x5 (the pairwise rows) "
        f"vector_width={rp.vector_width(5, src5, o_k)} mismatch={bad} "
        f"kernel_ms={k_ms!r} plain_ms={p_ms!r} bound_ms={b_ms!r}")
    if bad:
        raise AssertionError("B4 nearest at C = 5: kernel disagrees with its "
                             "plain version")

    sweeps = [a for _, a in seen["intersect_brute"]]
    if len(sweeps) != 1:
        raise AssertionError(f"options kernels: {len(sweeps)} B11 calls, "
                             f"expected the light sweep alone")
    out["intersect_brute@options"] = sum_parts(
        [b11_part(ik, "B11 light sweep", sweeps[0], path="options kernels")])
    return out


def check_accel_none_kernels(ik, seen):
    """Phase 20: B11 on every call of a ReSTIR frame with
    accel_mode="none": the closest hits (G-buffer, every bounce, the light
    sweep) and the three shadow batches that intersect_spheres_any sends
    through it; each against its plain version, timed. B1 and B2 must not
    run. Returns the kernels-line fields of the closest hits and of the
    shadow rays (sums over one frame)."""
    if seen["intersect_morton"] or seen["occlusion_morton"]:
        raise AssertionError("accel none: B1 or B2 ran without an accel")
    calls = list(enumerate(seen["intersect_brute"]))
    closest = [b11_part(ik, f"B11 {st} closest hit {i}", a,
                        path="accel none kernels")
               for i, ((st, any_hit), a) in calls if not any_hit]
    shadow = [b11_part(ik, f"B11 {st} shadow batch {i}", a,
                       path="accel none kernels")
              for i, ((st, any_hit), a) in calls if any_hit]
    if len(shadow) != 3:
        raise AssertionError(f"accel none: {len(shadow)} shadow batches, "
                             f"expected 3")
    fields = {"intersect_brute@accel_none": sum_parts(closest),
              "intersect_brute@accel_none_any": sum_parts(shadow)}
    for name, f in fields.items():
        log(f"accel none kernels: {name} calls="
            f"{len(closest) if name.endswith('none') else 3} "
            f"kernel_ms={f['ms']!r} plain_ms={f['plain_ms']!r} "
            f"bound_ms={f['bound_ms']!r} ({f['bound_by']})")
    return fields, len(closest)


def run_options_frame(bench, backend, rp, smi, iters, dev, cfg, label):
    """Phase 20: the options frame (or the ReSTIR frame with no accel,
    `label` "accel none") through bench.bench_frame, counted from zero;
    checks the image and each kernel's launches. Returns the launches."""
    backend.reset_launches()
    with mode_tally(rp) as tally:
        stats, img = bench.bench_frame(iters=iters, device=dev, cfg=cfg)
    frames = stats["frames"]
    launches = dict(backend.LAUNCHES)
    finite = bool(torch.isfinite(img).all())
    log(f"{label}: render {cfg.render_width}x{cfg.render_height} "
        f"bounces={cfg.bounces} aperture={cfg.aperture_radius} "
        f"focus={cfg.focus_distance} accel={cfg.accel_mode} "
        f"restir={json.dumps(dataclasses.asdict(cfg.restir))} "
        f"frames={frames} frame_ms={stats['frame_ms']!r} "
        f"rays_per_frame={stats['rays_per_frame']!r} "
        f"spill_waves={stats['spill_waves']} "
        f"launches={json.dumps(launches)} "
        f"launches_per_frame={sum(launches.values()) / frames!r} "
        f"B4_by_mode={json.dumps(tally)} finite={finite} "
        f"min={float(img.min())!r} max={float(img.max())!r} "
        f"mean={float(img.mean())!r} | {smi}")
    log(f"{label}: counters={json.dumps(stats['counters'])}")
    log(f"{label}: passes_ms={json.dumps(stats['passes_ms'])}")
    if (tuple(img.shape) != (cfg.output_height, cfg.output_width, 3)
            or not finite or float(img.min()) < 0.0
            or float(img.max()) > 1.0):
        raise AssertionError(f"the {label} frame is not a finite image in "
                             f"[0, 1]")
    return launches, frames, tally


def check_options_small(pipeline, bench, sharc_mod, myscene,
                        devices=("cuda", "cpu")):
    """Phase 20: every option config at 64x64 on the card and on the CPU
    from one start state, two frames each, bounds DEFAULT_*: the options
    frame (default graph: thin lens, focus, raytraced modes, real
    previous surface, shared offsets) with and without an accel; ReSTIR
    frames in Power_RIS, Uniform (no accel) and with local_light_samples=0,
    the candidate batch (initial_kernel off), the pairwise modes on the
    pseudo previous surface (B4 at C = 5); the all-mesh ReSTIR frame in
    the raytraced modes; and the all-mesh frame with a deforming mesh,
    whose G-buffer motion must agree within 1e-3 px and move."""
    from drts_tpu_torch.ops import restir
    opts = bench.options_frame_config(
        output_width=64, output_height=64, render_width=64,
        render_height=64, bounces=3, block_size=4096,
        sharc=sharc_mod.SHARCConfig(capacity_log2=12))
    rframe = dataclasses.replace(pipeline.restir_frame_config(64, 64, 2),
                                 block_size=4096)

    def with_restir(**kw):
        return dataclasses.replace(rframe, restir=restir.ReSTIRConfig(**kw))
    raytraced = dict(spatial_bias_correction="raytraced",
                     temporal_bias_correction="raytraced",
                     temporal_prev_surface="real")
    runs = (("options", opts, False, False),
            ("options accel none",
             dataclasses.replace(opts, accel_mode="none"), False, False),
            ("Power_RIS", with_restir(local_light_mode="Power_RIS"), False,
             False),
            ("Uniform accel none", dataclasses.replace(
                with_restir(local_light_mode="Uniform"), accel_mode="none"),
             False, False),
            ("local_light_samples=0", with_restir(local_light_samples=0),
             False, False),
            ("candidate_batch", with_restir(candidate_batch=True,
                                            initial_kernel=False),
             False, False),
            ("pairwise pseudo", with_restir(
                spatial_bias_correction="pairwise",
                temporal_bias_correction="pairwise",
                spatial_offset_mode="shared"), False, False),
            ("all-mesh raytraced", with_restir(**raytraced), True, False),
            ("deforming mesh", rframe, True, True))
    for label, cfg, mesh, deform in runs:
        results = []
        for dev in devices:
            pipe = pipeline.RenderPipeline(cfg, dev)
            host = myscene.build(oscillator_grid=3, device=pipe.device)
            if mesh:
                host = myscene.as_mesh_scene(host, tessellation=3)
            if deform:
                m = host.scene.mesh
                vm = torch.tensor([0.12, -0.07, 0.05], device=pipe.device
                                  ).expand(m.positions.shape[0], 3)
                host = dataclasses.replace(host, scene=dataclasses.replace(
                    host.scene, mesh=dataclasses.replace(
                        m, vertex_motion=vm.contiguous())))
            state = pipe.init_state(host)
            eye = torch.tensor([0.0, 2.5, -4.0])
            fwd = torch.tensor([0.0, 0.5, 0.0]) - eye
            pose = pipeline.CameraPose(eye.to(dev), (fwd / fwd.norm()).to(dev),
                                       torch.tensor([0.0, 1.0, 0.0]).to(dev))
            frames = []
            for _ in range(2):
                motion = {}

                def run(name, fn, *args, motion=motion):
                    out = fn(*args)
                    if name == "gbuffer":
                        motion["m"] = out.motion
                        motion["valid"] = out.surf.valid
                    return out
                state, img = pipe.render_frame(state, pose, _run=run)
                frames.append((img.cpu(), motion["m"].cpu(),
                               motion["valid"].cpu()))
            results.append(frames)
        for i, ((gimg, gmo, gval), (cimg, cmo, cval)) in enumerate(
                zip(*results)):
            d = (gimg - cimg).abs()
            off = float((d.amax(-1) > DEFAULT_OFF).float().mean())
            both = gval & cval
            mo_diff = float((gmo - cmo).abs()[both].max()) \
                if bool(both.any()) else 0.0
            moving = float(gmo[both].abs().max()) if bool(both.any()) \
                else 0.0
            log(f"options small: {label} frame {i} image_mean_abs_diff="
                f"{float(d.mean())!r} image_max_abs_diff={float(d.max())!r} "
                f"pixels_off_{DEFAULT_OFF}={off!r} "
                f"motion_max_abs_diff={mo_diff!r} motion_max={moving!r} "
                f"image_mean={float(gimg.mean())!r} "
                f"finite={bool(torch.isfinite(gimg).all())}")
            if (float(d.mean()) > DEFAULT_MEAN or off > DEFAULT_OFF_SHARE
                    or not bool(torch.isfinite(gimg).all())):
                raise AssertionError(f"options small: the {label} frame on "
                                     f"the card disagrees with the CPU")
            if deform and (mo_diff > 1e-3 or moving < 0.05):
                raise AssertionError("options small: the deforming mesh's "
                                     "motion vectors disagree or do not "
                                     "move")


# Phase 21: the shell (app.py, session.py, utils/checkpoint.py) at the
# reference's GraphicsSettings(): 1920x1080 output, SR Auto, so rendered at
# 960x540 and upscaled by TAA. The kernels each of its frames must launch.
SHELL_KERNELS = ("intersect_morton", "occlusion_morton",
                 "initial_light_candidates", "reproject_packed",
                 "intersect_brute")
# Their __global__ functions in csrc/, as a device trace names them.
SHELL_KERNEL_SYMBOLS = ("morton_closest_hit", "morton_occlusion",
                        "initial_candidates", "reproject",
                        "brute_closest_hit")
# Phase 22: the banded frame's kernels (the same five).
BANDED_KERNELS = SHELL_KERNELS


@contextlib.contextmanager
def per_frame_launches(backend, session_mod, frames):
    """Record, for every Session.step, the kernel launches it made and its
    image's shape, finiteness and range (appended to `frames`)."""
    orig = session_mod.Session.step

    def step(self, *args, **kwargs):
        before = dict(backend.LAUNCHES)
        img = orig(self, *args, **kwargs)
        frames.append({
            "launches": {k: backend.LAUNCHES[k] - before[k]
                         for k in backend.LAUNCHES},
            "shape": tuple(img.shape),
            "finite": bool(torch.isfinite(img).all()),
            "min": float(img.min()), "max": float(img.max()),
            "render": (self.pipe.cfg.render_width,
                       self.pipe.cfg.render_height)})
        return img
    session_mod.Session.step = step
    try:
        yield frames
    finally:
        session_mod.Session.step = orig


def shell_launches(frames):
    """The path's kernels' launches of each recorded frame, as JSON."""
    return json.dumps([[f["launches"][k] for k in SHELL_KERNELS]
                       for f in frames])


def check_shell_frames(label, frames):
    """Every frame a finite (1080, 1920, 3) image in [0, 1] that launched
    B1, B2, B3, B4 and B11."""
    for i, f in enumerate(frames):
        missing = [k for k in SHELL_KERNELS if f["launches"][k] <= 0]
        if (f["shape"] != (1080, 1920, 3) or not f["finite"]
                or f["min"] < 0.0 or f["max"] > 1.0 or missing):
            raise AssertionError(f"{label} frame {i}: {f} (not launched: "
                                 f"{missing})")


def shell_session(session_mod, myscene, settings, dev):
    # Eager frames: the phase counts each frame's launches.
    return session_mod.Session(settings, output_width=1920,
                               output_height=1080,
                               host=myscene.build(device=dev), device=dev,
                               graph=False)


def run_shell(backend, bench, smi, dev):
    """Phase 21: (a) `app.main(... render --resume --checkpoint-every 2
    --metrics-out)` at 1920x1080 on GraphicsSettings(), counted from zero;
    (b) a Session taking a dynamic, a static and a realloc set; (c) a
    rotating checkpoint resumed into a fresh Session against the
    uninterrupted one; (d) the session's warm frame time beside
    bench --upscaled's; (e) one frame under obs.device_trace."""
    import io
    import tempfile

    from drts_tpu_torch import app, config, session as session_mod
    from drts_tpu_torch.models import myscene
    from drts_tpu_torch.utils import checkpoint, image, obs

    defaults = config.GraphicsSettings().check()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the CLI --------------------------------------------------
        settings_path = os.path.join(tmp, "graphics.json")
        config.save_settings(defaults, settings_path)
        out, ckpt = os.path.join(tmp, "out"), os.path.join(tmp, "ckpt")
        metrics = os.path.join(tmp, "metrics.jsonl")
        frames = []
        t0 = time.perf_counter()
        backend.reset_launches()
        with per_frame_launches(backend, session_mod, frames), \
                contextlib.redirect_stdout(io.StringIO()) as text:
            app.main(["--eager", "--width", "1920", "--height", "1080",
                      "--settings",
                      settings_path, "render", "--frames", "4", "--out-dir",
                      out, "--resume", ckpt, "--checkpoint-every", "2",
                      "--metrics-out", metrics])
        launches = dict(backend.LAUNCHES)
        wall = time.perf_counter() - t0
        for line in text.getvalue().splitlines():
            log(f"shell cli: | {line[:400]}")
        png = image.read_png(os.path.join(out, "frame_0003.png"))
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
        log(f"shell cli: 4 frames at render {frames[0]['render']} -> "
            f"1920x1080 in {wall:.1f} s (session build included); "
            f"frame_ms={[r['frame_ms'] for r in records]!r} "
            f"launches={json.dumps(launches)} per frame="
            f"{shell_launches(frames)} | {smi}")
        check_shell_frames("shell cli", frames)
        if (png.shape != (1080, 1920, 3) or not np.isfinite(png).all()
                or len(records) != 4
                or not all(r["frame_ms"] > 0 for r in records)
                or '"frame_ms"' not in text.getvalue()
                or "checkpointed frame 2" not in text.getvalue()
                or not os.path.exists(os.path.join(ckpt, "LATEST"))
                or frames[0]["render"] != (960, 540)):
            raise AssertionError("shell cli: the PNG, the metrics or the "
                                 "checkpoint is missing or wrong")

        # (b) a live Session: dynamic, static and realloc sets ---------
        frames = []
        with per_frame_launches(backend, session_mod, frames):
            sess = shell_session(session_mod, myscene, defaults, dev)
            for _ in range(3):
                sess.step()
            hows = [sess.set("post.exposure", "1.5")]
            sess.step()
            hows.append(sess.set("raytracing.bounces", "4"))
            sess.step()
            hows.append(sess.set("post.super_resolution_mode", "Native"))
            render = (sess.pipe.cfg.render_width, sess.pipe.cfg.render_height)
            sess.step()
        log(f"shell session: sets {hows} render after realloc {render} "
            f"frame_count={sess.state.frame_count} launches per frame="
            f"{shell_launches(frames)} | {smi}")
        check_shell_frames("shell session", frames)
        if hows != ["dynamic", "static", "realloc"] or render != (1920,
                                                                  1080):
            raise AssertionError(f"shell session: sets {hows}, render "
                                 f"{render}")
        if frames[3]["launches"] != frames[1]["launches"]:
            raise AssertionError("shell session: the frame after the "
                                 "dynamic set launched otherwise than the "
                                 "frame two before it")
        if frames[5]["render"] != (1920, 1080) or \
                sess.state.frame_count != 6:
            raise AssertionError("shell session: the realloc lost the "
                                 "frame count or the render size")
        del sess

        # (c) resume on the card ---------------------------------------
        k = 3
        frames = []
        with per_frame_launches(backend, session_mod, frames):
            sess = shell_session(session_mod, myscene, defaults, dev)
            for _ in range(k):
                sess.step()
            resume_dir = os.path.join(tmp, "resume")
            checkpoint.save_rotating(sess.state, resume_dir)
            golden = sess.step().cpu()
            fresh = shell_session(session_mod, myscene, defaults, dev)
            fresh.state, ok = checkpoint.resume_or_init(
                fresh.pipe, resume_dir, fresh.host)
            img = fresh.step().cpu()
        d = (img - golden).abs()
        off = float((d.amax(-1) > DEFAULT_OFF).float().mean())
        same = (int(fresh.state.frame_index), fresh.state.frame_count) == (
            int(sess.state.frame_index), sess.state.frame_count)
        log(f"shell resume: saved at frame {k}, resumed={ok} frame_index="
            f"{int(fresh.state.frame_index)} frame_count="
            f"{fresh.state.frame_count} (uninterrupted "
            f"{int(sess.state.frame_index)}, {sess.state.frame_count}) "
            f"image_mean_abs_diff={float(d.mean())!r} image_max_abs_diff="
            f"{float(d.max())!r} pixels_off_{DEFAULT_OFF}={off!r} "
            f"bit_exact={bool(torch.equal(img, golden))} launches "
            f"resumed={shell_launches(frames[-1:])} uninterrupted="
            f"{shell_launches(frames[k:k + 1])} | {smi}")
        check_shell_frames("shell resume", frames)
        if (not ok or not same or float(d.mean()) > DEFAULT_MEAN
                or off > DEFAULT_OFF_SHARE
                or frames[-1]["launches"] != frames[k]["launches"]):
            raise AssertionError("shell resume: the resumed frame differs "
                                 "from the uninterrupted one")

        # (d) frame time, for the record: the session as from_settings
        # builds it (block 16,384), the same at the bench's block 32,768,
        # and bench --upscaled -------------------------------------------
        iters = 4

        def warm_ms(s):
            s.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                s.step()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / iters * 1e3
        sess_ms = warm_ms(sess)
        wide = session_mod.Session(
            defaults, output_width=1920, output_height=1080,
            host=myscene.build(device=dev),
            config_overrides={"block_size": 32768}, device=dev,
            graph=False)
        wide_ms = warm_ms(wide)
        del wide
        stats, _ = bench.bench_frame(
            iters=iters, device=dev,
            cfg=bench.default_frame_config(upscaled=True))
        log(f"shell frame time: Session.step {sess_ms!r} ms (block "
            f"{sess.pipe.cfg.block_size}), {wide_ms!r} ms (block 32768), "
            f"bench --upscaled {stats['frame_ms']!r} ms (block 32768); "
            f"{iters} warm frames each | {smi}")

        # (e) one frame under obs.device_trace ------------------------------
        trace_dir = os.path.join(tmp, "trace")
        with obs.device_trace(trace_dir):
            with obs.pass_scope("shell_frame"):
                sess.step()
        with open(os.path.join(trace_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        hand = {name: sum(name in e.get("name", "") for e in kernels)
                for name in SHELL_KERNEL_SYMBOLS}
        scoped = sum(e.get("name") == "shell_frame" for e in events)
        log(f"shell trace: {len(events)} events, {len(kernels)} kernel "
            f"launches, the hand kernels {json.dumps(hand)}, "
            f"'shell_frame' scopes {scoped} | {smi}")
        if not scoped or not all(hand.values()):
            raise AssertionError("shell trace: the frame's scope or a hand "
                                 "kernel is missing from the trace")


# Phase 22: the sharded frame (drts_tpu_torch/parallel) at PipelineConfig(),
# 1920x1080, three frames (SHARC updates on frames 0 and 2); the rank of
# (b) whose recorded frame gives the @banded kernel fields (its band
# starts at row 540: B4 reads the gathered histories from that row on).
BANDED_FRAMES = 3
RECORD_RANK = 1
# The leaves of 32-bit words (f16 pairs, packed normals, SHARC's meta
# bits): compared by their f16 halves.
WORD_LEAVES = ("denoiser.packed", "denoiser.packed_spec", "taa.packed",
               "sharc.packed", "prev_surface_rows")


def frame_diff(a, b):
    """(mean |difference|, share of pixels off by more than DEFAULT_OFF,
    largest difference) of two images."""
    d = (a.float().cpu() - b.float().cpu()).abs()
    return (float(d.mean()), float((d.amax(-1) > DEFAULT_OFF).float().mean()),
            float(d.max()))


def leaf_diff(path, a, b):
    """(mean |difference| over the mean magnitude (at least 1), share of
    elements off) of a FrameState leaf against another's: floats by value
    (off beyond DEFAULT_OFF times max(1, |value|)), 32-bit words by their
    f16 halves where both are finite (a half finite on one side only is
    off), integers by the share that differ."""
    a, b = a.cpu(), b.cpu()
    if path in WORD_LEAVES:
        a = a.contiguous().view(torch.float16).double()
        b = b.contiguous().view(torch.float16).double()
        both = torch.isfinite(a) & torch.isfinite(b)
        d = torch.where(both, (a - b).abs(), 0.0)
        off = (~both & (torch.isfinite(a) | torch.isfinite(b))) | (
            d > DEFAULT_OFF * torch.clamp(b.abs(), min=1.0))
        scale = max(float(torch.where(both, b.abs(), 0.0).mean()), 1.0)
        return float(d.mean()) / scale, float(off.float().mean())
    if not a.dtype.is_floating_point:
        return 0.0, float((a != b).float().mean())
    a, b = a.double(), b.double()
    d = (a - b).abs()
    scale = max(float(b.abs().mean()), 1.0)
    return (float(d.mean()) / scale,
            float((d > DEFAULT_OFF * torch.clamp(b.abs(), min=1.0))
                  .float().mean()))


def check_shards(r, shards, state_a, placed, n=2):
    """Phase 22 (b): rank r's final shards against the one-rank final
    state's (its band of each per-row leaf, its range of each per-slot
    leaf, each replicated leaf whole). Returns the worst (path, mean,
    share off) and raises where a leaf is off DEFAULT_*."""
    from drts_tpu_torch.parallel import mesh
    from drts_tpu_torch.utils import checkpoint
    full = dict(checkpoint.leaves(state_a))
    worst = ("", 0.0, 0.0)
    for path, leaf in checkpoint.leaves(shards):
        if not isinstance(leaf, torch.Tensor):
            continue
        want = full[path]
        if placed[path] != mesh.REPLICATED:
            s, e = mesh.row_band(want.shape[0], r, n)
            want = want[s:e]
        if path == "sharc.fingerprint":
            filled = (leaf != 0) | (want != 0)
            same = float((leaf == want)[filled].float().mean())
            if same < DEFAULT_FP_SHARE:
                raise AssertionError(f"banded (b) rank {r}: {path} equal "
                                     f"on {same!r} of the filled slots")
            continue
        mean, off = leaf_diff(path, leaf, want)
        if (off, mean) > (worst[2], worst[1]):
            worst = (path, mean, off)
        if mean > DEFAULT_MEAN or off > DEFAULT_OFF_SHARE:
            raise AssertionError(f"banded (b) rank {r}: {path} off the "
                                 f"one-rank state (mean {mean!r}, share "
                                 f"off {off!r})")
    return worst


def banded_kernel_fields(ik, rk, rp, seen):
    """The @banded kernels-line fields from one recorded sharded frame of
    rank RECORD_RANK: B1 over the frame's launches on its band's rays, B2
    on its band's three visibility batches, B3 on its band's pixels, B4 on
    the four reprojections that write its band's rows of the gathered
    histories (a nonzero row offset, required), B11 on its band's light
    sweep; each against its plain version and timed."""
    out = {}
    calls = seen["intersect_morton"]
    rays, table, bounds = calls[0][:3]
    first = compare_closest(
        "banded B1 primary (band)", lambda: ik.intersect_morton(
            rays, table, bounds),
        lambda: ik.intersect_morton_plain(rays, table, bounds, 262144),
        reps=10, plain_reps=2)
    ms, n, line = b1_frame(ik, calls, 1)
    _, work = b1_sums([b1_work(ik, *c[:3]) for c in calls])
    plain_ms = sum(cuda_ms(lambda c=c: ik.intersect_morton_plain(
        *c[:3], 262144), 1) for c in calls)
    log(f"banded kernels: B1 per frame kernel_ms={ms!r} launches={n!r} "
        f"plain_ms={plain_ms!r} {line}")
    out["intersect_morton@banded"] = {
        "max_abs_err": first["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
        "library_ms": None, "unculled_bound_ms": work["unculled_bound_ms"]}
    out["occlusion_morton@banded"] = check_b2(
        ik, seen["occlusion_morton"], "the banded frame", path="banded ")
    (call,) = seen["initial_light_candidates"]
    out["initial_light_candidates@banded"] = check_b3(rk, call,
                                                      path="banded ")
    out["reproject_packed@banded"] = check_default_reprojections(
        rp, seen["reproject_packed"], label="banded")
    offsets = out["reproject_packed@banded"]["row_offsets"]
    if not all(offsets):
        raise AssertionError(f"banded B4: row offsets {offsets}, expected "
                             f"the band's first rows")
    (rays, spheres, block), = seen["intersect_brute"]
    f = compare_closest(
        "banded B11 brdf-candidate", lambda: ik.intersect_brute(rays,
                                                                spheres),
        lambda: ik.intersect_brute_plain(rays, spheres, block),
        reps=20, plain_reps=2)
    w = b11_work(ik, rays, spheres)
    b_ms, b_by = bound(w["bytes"], w["ops"])
    log(f"banded kernels: B11 brdf-candidate {w['line']} "
        f"kernel_ms={f['ms']!r}")
    f.update(bound_ms=b_ms, bound_by=b_by, library_ms=None,
             unculled_bound_ms=bound(w["bytes"], w["unculled_ops"])[0])
    out["intersect_brute@banded"] = f
    return out


def banded_rank(group, out_dir):
    """Phase 22 (b), one of two ranks (gloo) on the one card: the three
    frames of (a) sharded over `group` from shard_state of the start
    state, counted from zero, then one more frame whose kernel calls rank
    RECORD_RANK records, holds to their plain versions and times while
    the other waits; both reduce-scatter forms on CUDA tensors. Saves its
    image bands, launches per frame, replicated leaves' checksums, final
    shards, leaves off their placement, band, frame times, FrameState
    bytes and peak device memory to out_dir/rank<r>.pt."""
    import torch.distributed as dist

    from drts_tpu_torch import backend, graft_entry
    from drts_tpu_torch.models import pipeline
    from drts_tpu_torch.ops import intersect_kernels as ik
    from drts_tpu_torch.ops import reproject_kernels as rp
    from drts_tpu_torch.ops import restir_kernels as rk
    from drts_tpu_torch.parallel import mesh, multihost

    dev = multihost.rank_device("cuda")
    backend.kernels()
    pipe, state0, pose = graft_entry._setup(pipeline.PipelineConfig(), dev)
    r = dist.get_rank(group)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state = pipe.shard_state(state0, group)
    images, launches, frame_ms = [], [], []
    for _ in range(BANDED_FRAMES):
        backend.reset_launches()
        torch.cuda.synchronize()
        dist.barrier(group)
        t0 = time.perf_counter()
        state, img = pipe.render_frame(state, pose, group=group)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(backend.LAUNCHES))
        images.append(img.cpu())
    peak = torch.cuda.max_memory_allocated(dev)
    sums = graft_entry.replicated_checksums(pipe, state, group)
    bad = graft_entry.misplaced(pipe, state0, state, group)
    # Both reduce-scatter forms on CUDA tensors under gloo.
    band = mesh.Band.of(group, 1000)
    x = torch.arange(4000, dtype=torch.float32, device=dev).reshape(
        1000, 4) * (r + 1)
    want = x[band.start:band.end] * 3 / (r + 1)
    forms = {form: bool(torch.equal(band.reduce_scatter(x, form=form), want))
             for form in mesh.REDUCE_SCATTER_FORMS}
    del state0
    with recorded((ik, rk, rp), BANDED_KERNELS, clone=True) as seen:
        pipe.render_frame(state, pose, group=group)
        torch.cuda.synchronize()
    dist.barrier(group)
    fields = (banded_kernel_fields(ik, rk, rp, seen) if r == RECORD_RANK
              else {})
    del seen
    dist.barrier(group)
    torch.save({"images": images, "launches": launches, "checksums": sums,
                "misplaced": bad, "forms": forms,
                "state": mesh.map_tensors(lambda t: t.cpu(), state),
                "placement": pipe.placement(state, 2),
                "state_bytes": mesh.state_bytes(state), "peak_bytes": peak,
                "band": mesh.group_band(pipe.cfg.render_height, group),
                "frame_ms": frame_ms, "fields": fields},
               os.path.join(out_dir, f"rank{r}.pt"))


def run_banded(backend, smi, dev):
    """Phase 22: (a) one NCCL rank at PipelineConfig() 1920x1080, three
    frames through render_frame(group=...), each against
    render_frame(group=None) from the same state: bit for bit (image and
    every FrameState leaf) on the SHARC skip frame, within DEFAULT_* on the
    update frames (the splat's float atomics add in another order); (c)
    dryrun_multichip(1) on that group; (b) two gloo ranks on the one card,
    the same three frames sharded: each image band within DEFAULT_* of
    (a)'s rows, the final shards against (a)'s final state
    (check_shards), every leaf where the placement puts it, the
    replicated leaves equal, each rank's launches of B1, B2, B3, B4 and
    B11 per frame, its FrameState bytes and peak memory, and the @banded
    kernel fields (rank RECORD_RANK, on its band's inputs); (d) the time
    of each. Returns (the kernels-line fields, the launches of rank
    RECORD_RANK over (b)'s three frames)."""
    import tempfile

    import torch.distributed as dist

    from drts_tpu_torch import graft_entry
    from drts_tpu_torch.models import pipeline
    from drts_tpu_torch.parallel import mesh, multihost

    # (a) one NCCL rank -----------------------------------------------------
    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                         device="cuda")
    group = multihost.global_group()
    cfg = pipeline.PipelineConfig()
    pipe, state, pose = graft_entry._setup(cfg, dev)
    bytes_one = mesh.state_bytes(state)
    images_a = []
    for i in range(BANDED_FRAMES):
        update = state.frame_count % cfg.sharc_update_period == 0
        backend.reset_launches()
        s_g, img_g = pipe.render_frame(state, pose, group=group)
        launches_g = dict(backend.LAUNCHES)
        backend.reset_launches()
        s_n, img_n = pipe.render_frame(state, pose)
        launches_n = dict(backend.LAUNCHES)
        torch.cuda.synchronize()
        mean, off, dmax = frame_diff(img_g, img_n)
        same = mesh.replica_checksums(s_g) == mesh.replica_checksums(s_n)
        exact = bool(torch.equal(img_g, img_n))
        log(f"banded (a) nccl 1 rank: frame {i} sharc_update={update} "
            f"image_mean_abs_diff={mean!r} pixels_off_{DEFAULT_OFF}={off!r} "
            f"max_abs_diff={dmax!r} image_bit_exact={exact} "
            f"state_bit_exact={same} counters_banded="
            f"{json.dumps({k: float(v) for k, v in s_g.counters.items()})} "
            f"launches banded={json.dumps(launches_g)} "
            f"unbanded={json.dumps(launches_n)} | {smi}")
        if launches_g != launches_n or not bool(torch.isfinite(img_g).all()):
            raise AssertionError(f"banded (a) frame {i}: launches differ or "
                                 f"the image is not finite")
        if not update and not (exact and same):
            raise AssertionError(f"banded (a) frame {i}: a SHARC skip frame "
                                 f"differs from the unbanded frame")
        if mean > DEFAULT_MEAN or off > DEFAULT_OFF_SHARE:
            raise AssertionError(f"banded (a) frame {i}: off the unbanded "
                                 f"frame")
        state = s_g
        images_a.append(img_g.cpu())
    state_a = mesh.map_tensors(lambda t: t.cpu(), state)
    ta = time.perf_counter() - t0
    del pipe, state, s_g, s_n

    # (c) the dry run on the one-rank group ----------------------------------
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(1, graph=False)
    tc = time.perf_counter() - t0
    dist.destroy_process_group()
    log(f"banded (c) dryrun_multichip(1): passed in {tc:.1f} s | {smi}")

    # (b) two gloo ranks on the one card -------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        multihost.spawn(banded_rank, 2, "cuda", backend_name="gloo",
                        args=(tmp,))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    tb = time.perf_counter() - t0
    oh = cfg.output_height
    for r, res in enumerate(ranks):
        s, e = mesh.row_band(oh, r, 2)
        diffs = [frame_diff(a, b[s:e]) for a, b in zip(res["images"],
                                                       images_a)]
        per_frame = [[f[k] for k in BANDED_KERNELS] for f in res["launches"]]
        worst = check_shards(r, res["state"], state_a, res["placement"])
        log(f"banded (b) gloo rank {r} of 2 on one card: band {res['band']} "
            f"frame_ms={res['frame_ms']!r} image band vs (a)'s rows (mean, "
            f"pixels off, max)={diffs!r} worst leaf vs (a) (path, mean, "
            f"share off)={worst!r} state_bytes={res['state_bytes']} "
            f"(one device {bytes_one}) peak_memory_bytes="
            f"{res['peak_bytes']} reduce_scatter forms={res['forms']} "
            f"launches per frame (B1, B2, B3, B4, B11)="
            f"{json.dumps(per_frame)} | {smi}")
        for i, (mean, off, _) in enumerate(diffs):
            if mean > DEFAULT_MEAN or off > DEFAULT_OFF_SHARE:
                raise AssertionError(f"banded (b) rank {r} frame {i}: off "
                                     f"the one-rank frame's rows")
        for i, f in enumerate(res["launches"]):
            missing = [k for k in BANDED_KERNELS if f[k] <= 0]
            if missing:
                raise AssertionError(f"banded (b) rank {r} frame {i}: "
                                     f"{missing} not launched")
        if res["misplaced"] or not all(res["forms"].values()):
            raise AssertionError(f"banded (b) rank {r}: leaves off their "
                                 f"placement {res['misplaced']} or a "
                                 f"reduce-scatter form wrong {res['forms']}")
    differ = mesh.replicas_differ(ranks[0]["checksums"])
    if differ or ranks[0]["checksums"] != ranks[1]["checksums"]:
        raise AssertionError(f"banded (b): the ranks' replicated leaves "
                             f"differ at {differ}")
    log(f"banded (d): (a) {ta:.1f} s, (b) {tb:.1f} s (two processes "
        f"included), (c) {tc:.1f} s; replicated leaves equal on "
        f"{len(ranks[0]['checksums'])} leaves | {smi}")
    launches = {f"{k}@banded": sum(f[k] for f in
                                    ranks[RECORD_RANK]["launches"])
                for k in BANDED_KERNELS}
    return ranks[RECORD_RANK]["fields"], launches


# Phase 23: the record's limit in seconds, and the kernels each of its
# benches must not launch.
RECORD_TIMEOUT = 600
SPHERE_ONLY = ("bound_scan", "shared_blas_sweep", "intersect_mesh_instances",
               "shared_blas_any", "intersect_mesh_instances_any",
               "cand_fused")
MESH_ONLY = ("intersect_morton", "occlusion_morton",
             "initial_light_candidates", "cand_fused")


def record_numbers(value, path=""):
    """(path, number) of every number in a record, bools aside."""
    if isinstance(value, dict):
        for k, v in value.items():
            yield from record_numbers(v, f"{path}.{k}" if path else k)
    elif isinstance(value, list):
        for i, v in enumerate(value):
            yield from record_numbers(v, f"{path}[{i}]")
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        yield path, value


def expect_launches(name, got, want):
    for kernel, count in want.items():
        if got[kernel] != count:
            raise AssertionError(f"{name}: {kernel} launched "
                                 f"{got[kernel]} times, expected {count}")


def check_record_launches(bench_name, frames, launches):
    """Phase 23: each bench's launches as its graph makes them (phase 4's
    bound for the path traces, phase 14's counts for the sphere frame
    graph, phase 9's per closest-hit call for the mesh traces, phase 16's
    for the all-mesh pipeline)."""
    f = frames
    if bench_name == "trace":
        expect_launches(f"record {bench_name}", launches, dict.fromkeys(
            SPHERE_ONLY + ("occlusion_morton", "initial_light_candidates",
                           "reproject_packed", "intersect_brute"), 0))
        if launches["intersect_morton"] < 8 * f:
            raise AssertionError(f"record trace: B1 launched "
                                 f"{launches['intersect_morton']} times in "
                                 f"{f} frames of 8 bounces")
    elif bench_name in ("full_pipeline", "upscaled"):
        expect_launches(f"record {bench_name}", launches, dict(
            dict.fromkeys(SPHERE_ONLY, 0), occlusion_morton=3 * f,
            initial_light_candidates=f, intersect_brute=f,
            reproject_packed=4 * f))
        updates = -(-f // 2)
        if launches["intersect_morton"] < 9 * (f + updates):
            raise AssertionError(f"record {bench_name}: B1 launched "
                                 f"{launches['intersect_morton']} times in "
                                 f"{f} frames")
    elif bench_name in ("mesh", "mesh8"):
        bounces = 2 if bench_name == "mesh" else 8
        calls = launches["intersect_mesh_instances"]
        if calls < f * (bounces + 1):
            raise AssertionError(f"record {bench_name}: {calls} closest-hit "
                                 f"calls in {f} frames of {bounces} bounces")
        expect_launches(f"record {bench_name}", launches, dict(
            dict.fromkeys(MESH_ONLY + ("reproject_packed", "shared_blas_any",
                                       "intersect_mesh_instances_any"), 0),
            bound_scan=4 * calls, shared_blas_sweep=3 * calls,
            intersect_brute=2 * calls))
    else:
        calls = launches["intersect_mesh_instances"]
        if calls < f * 9:
            raise AssertionError(f"record mesh_pipeline: {calls} closest-hit "
                                 f"calls in {f} frames of 8 bounces")
        expect_launches(f"record {bench_name}", launches, dict(
            dict.fromkeys(MESH_ONLY, 0), shared_blas_any=6 * f,
            intersect_mesh_instances_any=3 * f,
            bound_scan=4 * calls + 9 * f, shared_blas_sweep=3 * calls,
            intersect_brute=2 * calls + 4 * f, reproject_packed=4 * f))


def run_record(bench, smi):
    """Phase 23: the port's bench record as a user runs it (python -m
    drts_tpu_torch.bench --record), in a process of its own; checks its
    exit code, its keys against the reference's, its numbers and each
    bench's launches. Returns the record."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "drts_tpu_torch.bench", "--record",
         "--eager"],
        cwd=HERE, capture_output=True, text=True, timeout=RECORD_TIMEOUT)
    seconds = time.perf_counter() - t0
    notes = [line for line in proc.stderr.splitlines()
             if line.startswith("bench: ")]
    for line in notes:
        log(f"record: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"bench --record exited {proc.returncode} "
                             f"after {seconds:.1f} s:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"record: {json.dumps(rec)}")
    log(f"record: bench --record took {seconds:.1f} s | {smi}")
    if "errors" in rec:
        raise AssertionError(f"bench --record: errors {rec['errors']}")
    if set(rec) != bench.RECORD_KEYS:
        raise AssertionError(f"bench --record: keys {sorted(rec)} are not "
                             f"the reference's {sorted(bench.RECORD_KEYS)}")
    if rec["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench --record: device {rec['device']!r}")
    for path, value in record_numbers(rec):
        counter = path.startswith("counters.")
        if not np.isfinite(value) or value < 0 or (
                value == 0 and not counter):
            raise AssertionError(f"bench --record: {path} = {value!r}")
    rates = [v for k in ("sharc_hit_rate", "sharc_gate_rate",
                         "sharc_entry_rate")
             for v in rec["counters"][k].values()]
    if max(rates) > 1 or max(rec["counters"]["sharc_hit_rate"].values()) \
            <= 0:
        raise AssertionError(f"bench --record: SHARC rates {rates}")
    seen = {}
    for line in notes:
        if line.startswith("bench: launches "):
            entry = json.loads(line[len("bench: launches "):])
            seen[entry["bench"]] = entry
            check_record_launches(entry["bench"], entry["frames"],
                                  entry["launches"])
    if list(seen) != ["trace", "full_pipeline", "upscaled", "mesh",
                      "mesh8", "mesh_pipeline"]:
        raise AssertionError(f"bench --record: launches of {list(seen)}")
    return rec


# ---------------------------------------------------------------------------
# Phase 24: the MXU route (B12a, B12b) and the clustered route (B13)


def table_spheres(table):
    """The filled slots of a Morton table: (centres (K, 3), radii (K,))."""
    filled = table[3] > 0.0
    return table[:3, filled].T.contiguous(), table[3, filled].contiguous()


def own_grazing(ik, rays, table, bounds, mxu_a, step=32768):
    """(N,) float32 on the card: min over the table's filled columns of
    |sqrt(r^2 - disc) - r|, disc the plain version's own discriminant at
    MXU_PREC (for unit directions, disc = r^2 - distance^2); 0 for a
    column whose root (the tail's: near, else far) lies within
    MXU_T_RTOL |t| + MXU_T_ATOL of tmin or tmax."""
    out = torch.empty(rays.shape[1], device=rays.device)
    r = table[3][None, :]
    chunk = table.shape[1] // bounds.shape[1]
    for s in range(0, rays.shape[1], step):
        part = rays[:, s:s + step]
        b2, c2 = ik.mxu_coefficients(part, mxu_a, chunk)
        disc = b2 * b2 - c2
        dist = torch.sqrt(torch.clamp(r * r - disc, min=0.0))
        graze = torch.where(r > 0, (dist - r).abs(), float("inf"))
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        tmin, tmax = part[6][:, None], part[7][:, None]
        t = torch.where(-b2 - sq >= tmin, -b2 - sq, sq - b2)
        tol = MXU_T_RTOL * t.abs() + MXU_T_ATOL
        edge = (disc >= 0) & (((t - tmin).abs() <= tol)
                              | ((t - tmax).abs() <= tol))
        out[s:s + step] = torch.where(edge, 0.0, graze).amin(1)
    return out


def mxu_grazing(ik, rays, table, bounds, mxu_a):
    """The grazing margin the MXU_* limits read at MXU_PREC: the plain
    version's own at "default", the spheres' at the others."""
    if ik.MXU_PREC == "default":
        return own_grazing(ik, rays, table, bounds, mxu_a)
    return grazing(rays, *table_spheres(table))


def cuda_median_ms(fn, reps):
    """Median device time of fn over reps calls after one warm call, each
    timed as cuda_ms times it (CUDA events, L2 flushed)."""
    fn()
    return statistics.median(cuda_ms(fn, 1, warm=False)
                             for _ in range(reps))


def grazing(rays, centers, radii, step=32768):
    """(N,) float32 on the card: min over spheres of |distance(ray line,
    centre) - r|, the margin by which a ray misses or clears a sphere's
    rim."""
    o = rays[:3].T
    d = rays[3:6].T / rays[3:6].T.norm(dim=1, keepdim=True).clamp(min=1e-30)
    out = torch.empty(rays.shape[1], device=rays.device)
    for s in range(0, rays.shape[1], step):
        oc = o[s:s + step, None, :] - centers[None]
        dd = d[s:s + step, None, :]
        perp = oc - (oc * dd).sum(-1, keepdim=True) * dd
        out[s:s + step] = (perp.norm(dim=-1) - radii[None]).abs().amin(1)
    return out


def mxu_flips(label, flip, graze, live):
    """Gate B12's hit/miss flips: grazing rays only, at most
    MXU_FLIP_SHARE of the live ones."""
    n_flip = int(flip.sum())
    worst = float(graze[flip].max()) if n_flip else 0.0
    if n_flip > MXU_FLIP_SHARE * max(live, 1) or worst >= MXU_GRAZE:
        raise AssertionError(f"{label}: {n_flip} hit/miss flips against "
                             f"the plain version (largest grazing margin "
                             f"{worst!r})")
    return n_flip, worst


def mxu_index_off(ik, rays, accel, t_p, i_k, i_p, strict):
    """(mismatches, mismatches off tolerance) of B12a's object index on
    the `strict` rays: a mismatch is within tolerance where the plain
    version's own pair test meets the kernel's object at the plain
    version's t within MXU_T_RTOL plus MXU_T_ATOL (a tie)."""
    diff = strict & (i_k != i_p)
    if not bool(diff.any()):
        return 0, 0
    table = accel.table
    trunc = ~((1 << ik.pos_bits(table.shape[1])) - 1)
    pairs = ik.mxu_closest_pairs(rays[:, diff], table, accel.mxu_a,
                                 accel.chunk, trunc)
    mine = table[4].to(torch.int32)[None, :] == i_k[diff][:, None]
    word = torch.where(mine, pairs, ik.INF_BITS).amin(1)
    t_obj = (word & trunc).view(torch.float32)
    t_ref = t_p[diff]
    tie = (word != ik.INF_BITS) & (
        (t_obj - t_ref).abs() <= MXU_T_RTOL * t_ref + MXU_T_ATOL)
    return int(diff.sum()), int((~tie).sum())


@contextlib.contextmanager
def mxu_cull_off(ik):
    """B12a and B12b with the chunk cull off: an infinite margin lets
    every chunk through, and the walk skips none."""
    saved = dict(ik.MXU_CULL_SCALE)
    ik.MXU_CULL_SCALE[ik.MXU_PREC] = float("inf")
    try:
        yield
    finally:
        ik.MXU_CULL_SCALE.update(saved)


def b12a_bound(ik, rays, table, bounds, mxu_a):
    """B12a's work on `rays` (intersect_morton_mxu_work: chunk tests,
    chunks met, chunks swept by warps, filled slots of the chunks each
    lane meets, slots swept by warps) and its bound: tensor-core products
    and tail operations for the filled slots of the chunks each live lane
    meets, chunk tests, the rays' bytes and the tables."""
    tests, met, swept, pairs, slots = (
        int(x.sum()) for x in ik.intersect_morton_mxu_work(
            rays, table, bounds, mxu_a))
    n, live = rays.shape[1], live_rays(rays)
    b_ms, b_by = bound(
        lane_bytes(n, live, 8, 2, table, bounds, mxu_a),
        tests * OPS_B1_CHUNK + met * OPS_B1_MET + pairs * OPS_B12_PAIR
        + live * OPS_B1_RAY, pairs * OPS_B12_MMA * ik.mxu_products())
    return {"tests": tests, "met": met, "swept": swept, "pairs": pairs,
            "slots": slots, "bound_ms": b_ms, "bound_by": b_by}


def resources(info):
    """A kernel's resources (intersect_kernels.*_info) as printed."""
    return (f"registers={info['registers']} "
            f"spill_bytes={info['local_bytes']} "
            f"shared_bytes={info['shared_bytes']} "
            f"threads={info['threads']} "
            f"blocks_per_sm={info['blocks_per_sm']} grid={info['grid']} "
            f"resident={info['resident']}")


def check_b12a(ik, label, rays, accel, reps=10, timer=cuda_ms):
    """B12a at MXU_PREC against its plain version on `rays` (MXU_*
    tolerances) and against itself with the chunk cull off (every word
    equal), both timed (`timer`: the mean, or cuda_median_ms), with its
    bound (b12a_bound), its share of the bound and its resources."""
    args = (rays, accel.table, accel.bounds, accel.mxu_a)
    t_k, i_k = ik.intersect_morton_mxu(*args)
    t_p, i_p = ik.intersect_morton_mxu_plain(*args)
    with mxu_cull_off(ik):
        t_u, i_u = ik.intersect_morton_mxu(*args)
    torch.cuda.synchronize()
    cull_diff = int(((t_k.view(torch.int32) != t_u.view(torch.int32))
                     | (i_k != i_u)).sum())
    graze = mxu_grazing(ik, *args)
    n, live = rays.shape[1], live_rays(rays)
    fin_k, fin_p = torch.isfinite(t_k), torch.isfinite(t_p)
    flips, worst = mxu_flips(label, fin_k != fin_p, graze, live)
    both = fin_k & fin_p
    strict = both & (graze > MXU_STRICT)
    gap = (t_k - t_p).abs()[strict]
    over = int((gap > MXU_T_RTOL * t_p[strict] + MXU_T_ATOL).sum())
    rel = float((gap / t_p[strict]).max()) if bool(strict.any()) else 0.0
    idx_strict, idx_over = mxu_index_off(ik, rays, accel, t_p, i_k, i_p,
                                         strict)
    err_all = float((t_k - t_p)[both].abs().max()) if bool(both.any()) \
        else 0.0
    err = float(gap.max()) if bool(strict.any()) else 0.0
    same = float((t_k.view(torch.int32) == t_p.view(torch.int32))[both]
                 .float().mean()) if bool(both.any()) else 1.0
    ms = timer(lambda: ik.intersect_morton_mxu(*args), reps)
    plain_ms = cuda_ms(lambda: ik.intersect_morton_mxu_plain(*args), 2,
                       warm=False)
    w = b12a_bound(ik, *args)
    info = ik.intersect_morton_mxu_info(accel.table, accel.bounds, n)
    log(f"routes: {label} rays={n} live={live} hits={int(fin_p.sum())} "
        f"flips={flips} largest_flip_graze={worst!r} "
        f"t_max_rel_non_grazing={rel!r} t_off_tolerance={over} "
        f"idx_mismatch_non_grazing={idx_strict} "
        f"idx_off_tolerance={idx_over} "
        f"idx_mismatch={int((i_k != i_p)[both].sum())} "
        f"cull_off_words_differing={cull_diff} "
        f"max_abs_err_non_grazing={err!r} max_abs_err_all_hits="
        f"{err_all!r} bit_equal_share={same!r} kernel_ms={ms!r} "
        f"plain_ms={plain_ms!r} chunk_tests={w['tests']} "
        f"chunks_met={w['met']} chunks_swept_by_warps={w['swept']} "
        f"pairs_met={w['pairs']} slots_swept_by_warps={w['slots']} "
        f"bound_ms={w['bound_ms']!r} ({w['bound_by']}) "
        f"share_of_bound={w['bound_ms'] / ms!r} {resources(info)}")
    if over:
        raise AssertionError(f"{label}: t of {over} rays off the plain "
                             f"version away from grazing")
    if idx_over:
        raise AssertionError(f"{label}: the object index of {idx_over} "
                             f"rays differs from the plain version's away "
                             f"from grazing, and its sphere is not met at "
                             f"the plain version's t")
    if cull_diff:
        raise AssertionError(f"{label}: {cull_diff} rays change with the "
                             f"chunk cull off")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
            "library_ms": None, "share_of_bound": w["bound_ms"] / ms}


def check_b12b(ik, calls, reps=10, timer=cuda_ms, label="B12b"):
    """B12b at MXU_PREC against its plain version on each recorded batch
    (MXU_* flips) and against itself with the chunk cull off (every bit
    equal), both timed (`timer`, as check_b12a's), and its bound from
    occlusion_morton_mxu_work; times summed over the batches, the bound of
    their summed work."""
    tot = {"ms": 0.0, "plain_ms": 0.0}
    work = [0, 0, 0]   # bytes, float32 operations, tensor-core flops
    flips_all = 0
    for b, call in enumerate(calls):
        args = call[:4]
        rays9, table = args[0], args[1]
        occ_k = ik.occlusion_morton_mxu(*args)
        occ_p = ik.occlusion_morton_mxu_plain(*args)
        with mxu_cull_off(ik):
            cull_diff = int((ik.occlusion_morton_mxu(*args) != occ_k).sum())
        torch.cuda.synchronize()
        if cull_diff:
            raise AssertionError(f"{label} batch {b}: {cull_diff} rays "
                                 f"change with the chunk cull off")
        live = live_rays(rays9)
        graze = mxu_grazing(ik, *args)
        flips, worst = mxu_flips(f"{label} batch {b}", occ_k != occ_p,
                                 graze, live)
        flips_all += flips
        ms = timer(lambda: ik.occlusion_morton_mxu(*args), reps)
        plain_ms = cuda_ms(lambda: ik.occlusion_morton_mxu_plain(*args), 1,
                           warm=False)
        tests, met, swept, pairs, slots = (
            int(x.sum()) for x in ik.occlusion_morton_mxu_work(*args))
        part = (lane_bytes(rays9.shape[1], live, 9, 0.25, *args[1:]),
                tests * OPS_B2_CHUNK + pairs * OPS_B12_PAIR
                + live * OPS_B2_RAY,
                pairs * OPS_B12_MMA * ik.mxu_products())
        work = [a + b for a, b in zip(work, part)]
        b_ms, b_by = bound(*part)
        log(f"routes: {label} batch {b} rays={rays9.shape[1]} live={live} "
            f"occluded={int(occ_p.sum())} flips={flips} "
            f"largest_flip_graze={worst!r} kernel_ms={ms!r} "
            f"plain_ms={plain_ms!r} chunk_tests={tests} chunks_met={met} "
            f"chunks_swept_by_warps={swept} pairs_met={pairs} "
            f"slots_swept_by_warps={slots} bound_ms={b_ms!r} ({b_by})")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
    b_ms, b_by = bound(*work)
    info = ik.occlusion_morton_mxu_info(calls[0][1], calls[0][2],
                                        calls[0][0].shape[1])
    log(f"routes: {label} the {len(calls)} batches: "
        f"kernel_ms={tot['ms']!r} "
        f"bound_ms={b_ms!r} ({b_by}) share_of_bound={b_ms / tot['ms']!r} "
        f"{resources(info)}")
    return dict(tot, max_abs_err=float(flips_all > 0), bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                share_of_bound=b_ms / tot["ms"])


def b13_bound(ik, rays, bounds_tbl, members_tbl, n_clusters, mm):
    """B13's work on `rays` (intersect_clustered_work: cluster tests,
    cluster roots, clusters touched, clusters swept by warps, the filled
    slots of the touched clusters, their roots) and its bound: per live
    ray every cluster's bound test and the root of each positive one, the
    filled slots of the clusters it touches and the roots of their
    positive discriminants, each cluster's and slot's |c|^2 - r^2 once,
    the rays' bytes and the tables. Also the bound of the count that the
    kernel's filled-slot stop and staged constants leave out (every slot
    of a touched cluster, each test and slot computing its own |c|^2 -
    r^2 and each test its root)."""
    w = dict(zip(("tests", "cluster_roots", "touched", "swept", "slots",
                  "roots"), (int(x.sum()) for x in ik.intersect_clustered_work(
                      rays, bounds_tbl, members_tbl, n_clusters, mm))))
    n, live = rays.shape[1], live_rays(rays)
    moved = lane_bytes(n, live, 8, 2, bounds_tbl, members_tbl)
    staged = n_clusters * (mm + 1) * OPS_B13_STAGED
    w["bound_ms"], w["bound_by"] = bound(
        moved, w["tests"] * OPS_B13_CLUSTER
        + w["cluster_roots"] * OPS_B13_CLUSTER_ROOT
        + w["slots"] * OPS_B13_SLOT + w["roots"] * OPS_B13_ROOT
        + live * OPS_B13_RAY + staged)
    w["bound_ms_every_slot"], _ = bound(
        moved, w["tests"] * (OPS_B13_CLUSTER + OPS_B13_CLUSTER_ROOT
                             + OPS_B13_STAGED)
        + w["touched"] * mm * (OPS_B13_SLOT + OPS_B13_STAGED)
        + w["roots"] * OPS_B13_ROOT + live * OPS_B13_RAY)
    w["live"] = live
    return w


def check_b13(ik, rays, accel, reps=10):
    """B13 against its plain version on `rays`, every word equal, both
    timed, with its bound (b13_bound), its share of the bound and its
    resources."""
    args = (rays, accel.bounds_tbl, accel.members_tbl, accel.n_clusters,
            accel.max_members)
    f = compare_closest("B13 primary", lambda: ik.intersect_clustered(*args),
                        lambda: ik.intersect_clustered_plain(*args),
                        reps=reps, plain_reps=1)
    w = b13_bound(ik, *args)
    info = ik.intersect_clustered_info(accel.n_clusters, accel.max_members,
                                       rays.shape[1])
    filled = ik.clustered_filled(accel.members_tbl, accel.n_clusters,
                                 accel.max_members)
    live = max(w["live"], 1)
    log(f"routes: B13 primary clusters={accel.n_clusters} "
        f"members_per_cluster={accel.max_members} "
        f"filled_slots_per_cluster={float(filled.float().mean())!r} "
        f"live={w['live']} cluster_tests={w['tests']} "
        f"cluster_roots={w['cluster_roots']} "
        f"clusters_touched={w['touched']} "
        f"clusters_swept_by_warps={w['swept']} "
        f"touched_per_live_ray={w['touched'] / live!r} "
        f"filled_slots_swept={w['slots']} roots={w['roots']} "
        f"bound_ms={w['bound_ms']!r} ({w['bound_by']}) "
        f"bound_ms_every_slot={w['bound_ms_every_slot']!r} "
        f"share_of_bound={w['bound_ms'] / f['ms']!r} {resources(info)}")
    return dict(f, bound_ms=w["bound_ms"], bound_by=w["bound_by"],
                library_ms=None, share_of_bound=w["bound_ms"] / f["ms"])


def route_frame_sums(label, calls, time_call, work):
    """A kernel summed over one frame's recorded calls: each call timed on
    its own inputs (CUDA events, L2 flushed) beside its bound (`work(args)`
    gives its bound_ms). Prints and returns (ms, bound_ms)."""
    ms = sum(cuda_ms(lambda a=a: time_call(a), 5) for a in calls)
    b_ms = sum(work(a)["bound_ms"] for a in calls)
    log(f"routes: {label} per frame: launches={len(calls)} "
        f"kernel_ms={ms!r} bound_ms={b_ms!r} share_of_bound={b_ms / ms!r}")
    return ms, b_ms


def trace_calls(cfg, spill_waves):
    """Closest-hit calls of one path-trace frame: the G-buffer and the
    bounces, and per spill wave the deep segment's bounces again."""
    return cfg.bounces + 1 + (cfg.bounces - cfg.compact_from + 1) \
        * spill_waves


def timed_trace_frame(bench, backend, setup, index):
    """One warm frame, then frame `index` counted from zero and timed on a
    host clock ending in a synchronize. Returns (tone-mapped image, ms,
    launches, spill waves, rays traced)."""
    from drts_tpu_torch.ops import post
    bench.trace_frame(setup, 0)
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    out = bench.trace_frame(setup, index)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    img = post.tonemap(out.radiance)
    shape = (setup.cfg.height, setup.cfg.width, 3)
    if tuple(img.shape) != shape or not bool(torch.isfinite(img).all()):
        raise AssertionError("the path-trace frame is not a finite image")
    return img, ms, dict(backend.LAUNCHES), out.spill_waves, \
        float(out.rays_traced)


def route_diff(label, img, ref):
    """Print and gate a route's frame against the default route's:
    (mean |difference|, share of pixels that differ at all, share off by
    more than DEFAULT_OFF, largest difference)."""
    mean, off, worst = frame_diff(img, ref)
    differ = float(((img.float() - ref.float()).abs().amax(-1) > 0)
                   .float().mean())
    if mean > ROUTE_MEAN:
        raise AssertionError(f"{label}: mean |difference| {mean!r} to the "
                             f"default route's frame")
    return (f"mean_abs_diff={mean!r} differing_pixel_share={differ!r} "
            f"share_off_by_{DEFAULT_OFF}={off!r} max_abs_diff={worst!r}")


def run_mxu_route(bench, backend, clusters, ik, smi, dev, primary):
    """Phase 24 (a): the MXU opt-in. B12a on the headline frame's primary
    rays; the headline frame and the upscaled default frame counted from
    zero with the opt-in on and off from the same seed (frame time,
    launches, image difference); B12b on the default frame's three shadow
    batches. Returns (fields, launches, the opt-in-off headline image)."""
    setup = bench.make_trace_setup(device=dev)
    scene, cam = setup.scene, setup.cam
    saved = clusters._USE_MXU
    fields, launches = {}, {}
    try:
        clusters._USE_MXU = True
        accel = clusters.make_morton_accel(setup.plan, scene.center,
                                           scene.radius,
                                           sort_origin=cam.position)
        if accel.mxu_a is None:
            raise AssertionError("the MXU opt-in built no A-matrices")
        fields["intersect_morton_mxu"] = check_b12a(
            ik, "B12a primary", primary, accel)
        runs = {}
        for on in (True, False):
            clusters._USE_MXU = on
            runs[on] = timed_trace_frame(bench, backend, setup, 1)
        img, ms, got, spills, rays = runs[True]
        expect_launches("MXU headline frame", got, {
            "intersect_morton_mxu": trace_calls(setup.cfg, spills),
            "intersect_morton": 0, "occlusion_morton": 0,
            "occlusion_morton_mxu": 0})
        expect_launches("opt-in off headline frame", runs[False][2], {
            "intersect_morton_mxu": 0,
            "intersect_morton": trace_calls(setup.cfg, runs[False][3])})
        launches["intersect_morton_mxu"] = got["intersect_morton_mxu"]
        clusters._USE_MXU = True
        with recorded((ik,), ("intersect_morton_mxu",), clone=True) as seen:
            bench.trace_frame(setup, 1)
            torch.cuda.synchronize()
        route_frame_sums("B12a MXU headline frame",
                         seen["intersect_morton_mxu"],
                         lambda a: ik.intersect_morton_mxu(*a[:4]),
                         lambda a: b12a_bound(ik, *a[:4]))
        del seen
        log(f"routes: MXU headline frame {setup.cfg.width}x"
            f"{setup.cfg.height} bounces={setup.cfg.bounces} "
            f"frame_ms={ms!r} opt_in_off_frame_ms={runs[False][1]!r} "
            f"rays={rays!r} opt_in_off_rays={runs[False][4]!r} "
            f"spill_waves={spills} B12a={got['intersect_morton_mxu']} "
            f"B1={got['intersect_morton']} opt_in_off_spill_waves="
            f"{runs[False][3]} opt_in_off_B1="
            f"{runs[False][2]['intersect_morton']} "
            f"{route_diff('MXU headline frame', img, runs[False][0])} "
            f"| {smi}")

        cfg = bench.default_frame_config(upscaled=True)
        pipe, state, pose = bench.make_frame_setup(cfg=cfg, device=dev)
        clusters._USE_MXU = True
        state, _ = pipe.render_frame(state, pose)    # a SHARC update frame
        torch.cuda.synchronize()
        frames = {}
        for on in (True, False):
            clusters._USE_MXU = on
            spills = [0]

            def run(name, fn, *args):
                out = fn(*args)
                if name == "trace":
                    spills[0] += out.spill_waves
                return out
            with recorded((ik,), ("occlusion_morton_mxu",), clone=True,
                          keep=lambda seen: len(
                              seen["occlusion_morton_mxu"]) < 3) as seen:
                backend.reset_launches()
                t0 = time.perf_counter()
                s1, _ = pipe.render_frame(state, pose, _run=run)
                _, img = pipe.render_frame(s1, pose, _run=run)
                torch.cuda.synchronize()
            frames[on] = (img, (time.perf_counter() - t0) * 1e3 / 2,
                          dict(backend.LAUNCHES),
                          seen["occlusion_morton_mxu"], spills[0])
        img, ms, got, calls, spills = frames[True]
        # Two frames: the G-buffer and 8 bounces each, the SHARC update
        # trace (9) on the second, 7 a spill wave.
        closest = 3 * (cfg.bounces + 1) + (cfg.bounces - cfg.compact_from
                                           + 1) * spills
        expect_launches("MXU default frames", got, {
            "intersect_morton_mxu": closest, "occlusion_morton_mxu": 6,
            "intersect_morton": 0, "occlusion_morton": 0,
            "initial_light_candidates": 2, "reproject_packed": 8,
            "intersect_brute": 2})
        expect_launches("opt-in off default frames", frames[False][2], {
            "occlusion_morton_mxu": 0, "intersect_morton_mxu": 0,
            "occlusion_morton": 6, "intersect_morton": 3 * (
                cfg.bounces + 1) + (cfg.bounces - cfg.compact_from + 1)
            * frames[False][4]})
        if (tuple(img.shape) != (cfg.output_height, cfg.output_width, 3)
                or not bool(torch.isfinite(img).all())
                or float(img.min()) < 0.0 or float(img.max()) > 1.0):
            raise AssertionError("the MXU default frame is not a finite "
                                 "image in [0, 1]")
        launches["occlusion_morton_mxu"] = got["occlusion_morton_mxu"]
        log(f"routes: MXU upscaled default frames ({cfg.render_width}x"
            f"{cfg.render_height} to {cfg.output_width}x{cfg.output_height}"
            f", a SHARC cadence) frame_ms={ms!r} opt_in_off_frame_ms="
            f"{frames[False][1]!r} spill_waves={spills} "
            f"opt_in_off_spill_waves={frames[False][4]} B12a_per_frame="
            f"{got['intersect_morton_mxu'] / 2!r} B12b_per_frame="
            f"{got['occlusion_morton_mxu'] / 2!r} launches="
            f"{json.dumps(got)} "
            f"{route_diff('MXU default frame', img, frames[False][0])} "
            f"| {smi}")
        if len(calls) != 3:
            raise AssertionError(f"{len(calls)} B12b batches recorded")
        fields["occlusion_morton_mxu"] = check_b12b(ik, calls)
        clusters._USE_MXU = True
        p_fields, p_launches = run_mxu_precisions(
            bench, backend, ik, smi, setup, accel, primary, calls,
            (pipe, state, pose, cfg, runs[False][0]))
        fields.update(p_fields)
        launches.update(p_launches)
    finally:
        clusters._USE_MXU = saved
    return fields, launches, runs[False][0]


# The reference's other two MXU precisions (DRTS_MXU_PREC), phase 24 (c).
MXU_OTHER_PRECS = ("default", "highest")


def run_mxu_precisions(bench, backend, ik, smi, setup, accel, primary,
                       calls, frame):
    """Phase 24 (c): B12a and B12b at "default" and "highest"
    (intersect_kernels.MXU_PREC set for each and restored after): B12a on
    the headline frame's primary rays and B12b on (a)'s three recorded
    shadow batches, each against its plain version (MXU_* limits) and with
    its chunk cull off (every word equal), timed as a median of 10 with
    its bound, share and resources; then, counted from zero at that
    precision, the headline frame (B12a as in (a), no B1, B2 or B12b) and
    the two upscaled default frames (B12a as in (a), B12b 6), their
    images finite and in [0, 1] and printed against the opt-in-off
    frames. Returns (fields, launches) of the "...@default" and
    "...@highest" entries."""
    pipe, state, pose, cfg, headline_off = frame
    fields, launches = {}, {}
    saved = ik.MXU_PREC
    try:
        for prec in MXU_OTHER_PRECS:
            ik.MXU_PREC = prec
            fields[f"intersect_morton_mxu@{prec}"] = check_b12a(
                ik, f"B12a primary @{prec}", primary, accel,
                timer=cuda_median_ms)
            fields[f"occlusion_morton_mxu@{prec}"] = check_b12b(
                ik, calls, timer=cuda_median_ms, label=f"B12b @{prec}")
            img, ms, got, spills, rays = timed_trace_frame(bench, backend,
                                                           setup, 1)
            expect_launches(f"MXU headline frame @{prec}", got, {
                "intersect_morton_mxu": trace_calls(setup.cfg, spills),
                "intersect_morton": 0, "occlusion_morton": 0,
                "occlusion_morton_mxu": 0})
            waves = [0]

            def run(name, fn, *args):
                out = fn(*args)
                if name == "trace":
                    waves[0] += out.spill_waves
                return out
            backend.reset_launches()
            t0 = time.perf_counter()
            s1, _ = pipe.render_frame(state, pose, _run=run)
            _, dimg = pipe.render_frame(s1, pose, _run=run)
            torch.cuda.synchronize()
            d_ms = (time.perf_counter() - t0) * 1e3 / 2
            d_got = dict(backend.LAUNCHES)
            expect_launches(f"MXU default frames @{prec}", d_got, {
                "intersect_morton_mxu": 3 * (cfg.bounces + 1) + (
                    cfg.bounces - cfg.compact_from + 1) * waves[0],
                "occlusion_morton_mxu": 6, "intersect_morton": 0,
                "occlusion_morton": 0})
            for name, im in (("headline", img), ("default", dimg)):
                if (not bool(torch.isfinite(im).all())
                        or float(im.min()) < 0.0 or float(im.max()) > 1.0):
                    raise AssertionError(f"the MXU {name} frame @{prec} is "
                                         f"not a finite image in [0, 1]")
            mean, off, worst = frame_diff(img, headline_off)
            log(f"routes: MXU @{prec} headline frame frame_ms={ms!r} "
                f"rays={rays!r} spill_waves={spills} "
                f"B12a={got['intersect_morton_mxu']} against the "
                f"opt-in-off frame: mean_abs_diff={mean!r} "
                f"share_off_by_{DEFAULT_OFF}="
                f"{off!r} max_abs_diff={worst!r}; upscaled default frames "
                f"frame_ms={d_ms!r} spill_waves={waves[0]} B12a="
                f"{d_got['intersect_morton_mxu']} B12b="
                f"{d_got['occlusion_morton_mxu']} | {smi}")
            launches[f"intersect_morton_mxu@{prec}"] = \
                got["intersect_morton_mxu"]
            launches[f"occlusion_morton_mxu@{prec}"] = \
                d_got["occlusion_morton_mxu"]
    finally:
        ik.MXU_PREC = saved
    return fields, launches


def run_clustered_route(bench, backend, clusters, ik, smi, dev, primary,
                        morton_img):
    """Phase 24 (b): the headline frame through the clustered accel
    (clusters.build_plan on the rest pose, make_accel per frame): B13 on
    the primary rays, then the frame counted from zero against the Morton
    route's frame of the same seed."""
    setup = bench.make_trace_setup(device=dev, accel="clustered")
    scene = setup.scene
    accel = clusters.make_accel(setup.plan, scene.center, scene.radius)
    fields = {"intersect_clustered": check_b13(ik, primary, accel)}
    img, ms, got, spills, rays = timed_trace_frame(bench, backend, setup, 1)
    with recorded((ik,), ("intersect_clustered",), clone=True) as seen:
        bench.trace_frame(setup, 1)
        torch.cuda.synchronize()
    route_frame_sums("B13 clustered headline frame",
                     seen["intersect_clustered"],
                     lambda a: ik.intersect_clustered(*a[:5]),
                     lambda a: b13_bound(ik, *a[:5]))
    del seen
    expect_launches("clustered headline frame", got, {
        "intersect_clustered": trace_calls(setup.cfg, spills),
        "intersect_morton": 0, "intersect_morton_mxu": 0,
        "intersect_brute": 0})
    log(f"routes: clustered headline frame {setup.cfg.width}x"
        f"{setup.cfg.height} bounces={setup.cfg.bounces} "
        f"clusters={accel.n_clusters} members_per_cluster="
        f"{accel.max_members} frame_ms={ms!r} rays={rays!r} "
        f"spill_waves={spills} "
        f"B13={got['intersect_clustered']} "
        f"{route_diff('clustered headline frame', img, morton_img)} | {smi}")
    return fields, {"intersect_clustered": got["intersect_clustered"]}


# Phase 25: the compiled frame (drts_tpu_torch/graphs.py). The frames
# each run is timed over, the kernels its entries carry, and the deep
# segment's capacity of the forced-spill default frame (the demo frame's
# bounce-2 survivors number ~100,000).
GRAPH_FRAMES = 8
GRAPH_KERNELS = ("intersect_morton", "occlusion_morton",
                 "initial_light_candidates", "reproject_packed",
                 "intersect_brute")
GRAPH_SPILL_CAPACITY = 32768


def frame_marks(step, frames):
    """Run `step` `frames` times; returns each frame's ms between CUDA
    events recorded at the frame boundaries (no synchronize between)."""
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    for _ in range(frames):
        step()
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def spread(ms):
    return (f"median={statistics.median(ms)!r} min={min(ms)!r} "
            f"max={max(ms)!r}")


def eager_frames(backend, pathtrace, step, frames, kernels=GRAPH_KERNELS):
    """`frames` eager frames through step(); returns (each frame's
    launches of `kernels`, each frame's spill waves, the images)."""
    launches, waves, images = [], [], []
    for _ in range(frames):
        before = dict(backend.LAUNCHES)
        ran = []

        def decide(overflow, wave1):
            run = overflow.item() > 0
            if run:
                wave1()
            ran.append(int(run))
            return int(run)
        with pathtrace.spill_hook(decide):
            images.append(step().clone())
        launches.append({k: backend.LAUNCHES[k] - before[k]
                         for k in kernels})
        waves.append(sum(ran))
    return launches, waves, images


def graph_launches_check(label, call, phases, eager_launches, eager_waves,
                         kernels=GRAPH_KERNELS):
    """Each eager frame's launches of `kernels` against its cadence
    phase's captured frame plus its spill waves' captured launches."""
    for i, (got, waves) in enumerate(zip(eager_launches, eager_waves)):
        cap = call.stats.captured_launches[phases[i]]
        want = {k: cap["frame"].get(k, 0)
                + sum(sp.get(k, 0) for sp in cap["spill_waves"][:waves])
                for k in kernels}
        if want != got:
            raise AssertionError(f"graph {label}: frame {i}'s capture "
                                 f"holds {want}, the eager frame launched "
                                 f"{got}")


def image_spread(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.mean()), float((d.amax(-1) > DEFAULT_OFF).float().mean())


def run_graph_pipeline(backend, bench, pathtrace, smi, dev, label, cfg,
                       patch=None, mesh=False, kernels=GRAPH_KERNELS,
                       textured=False, frames=GRAPH_FRAMES):
    """Phase 25 (a): a pipeline frame (`patch` edits its path-trace
    config; `mesh`: on the all-mesh scene, phase 26 (b) and (c);
    `textured`: on the mixed textured scene, phase 27) from one start:
    `frames` eager frames twice and through render_frame_graph once.
    Checks the images (bit for bit without SHARC; with it, within
    DEFAULT_* plus the eager run-to-run spread), each frame's launches of
    `kernels` against its phase's capture, the spill waves. Returns (the
    graph callable's stats, eager ms, graph ms, eager and graph peak
    memory)."""
    pipe, s0, pose = bench.make_frame_setup(cfg=cfg, device=dev, mesh=mesh,
                                            textured=textured)
    if patch is not None:
        base = pipe._pt_cfg
        pipe._pt_cfg = lambda: dataclasses.replace(base(), **patch)
    box = [s0]

    def eager():
        box[0], img = pipe.render_frame(box[0], pose)
        return img
    runs = []
    for _ in range(2):
        box[0] = s0
        torch.cuda.reset_peak_memory_stats()
        runs.append(eager_frames(backend, pathtrace, eager, frames,
                                 kernels))
    eager_peak = torch.cuda.max_memory_allocated()
    box[0] = s0
    eager_ms = frame_marks(eager, frames)
    box[0] = s0
    call = pipe.render_frame_graph()

    def graph():
        box[0], img = call(box[0], pose)
        return img
    torch.cuda.reset_peak_memory_stats()
    graph_images = [graph().clone() for _ in range(frames)]
    box[0] = s0
    graph_ms = frame_marks(graph, frames)
    graph_peak = torch.cuda.max_memory_allocated()
    (e_launch, e_waves, e_img), (_, e_waves2, e_img2) = runs
    phases = [f % call.cycle for f in range(frames)]
    graph_launches_check(label, call, phases, e_launch, e_waves, kernels)
    g_waves = call.stats.spill_waves
    worst = (0.0, 0.0)
    for i, (a, a2, b) in enumerate(zip(e_img, e_img2, graph_images)):
        ee, eg = image_spread(a, a2), image_spread(a, b)
        exact = torch.equal(a.view(torch.int32), b.view(torch.int32))
        worst = max(worst, eg)
        if cfg.sharc_enabled:
            ok = (eg[0] <= DEFAULT_MEAN + ee[0]
                  and eg[1] <= DEFAULT_OFF_SHARE + ee[1])
        else:
            ok = exact
        if not ok or not bool(torch.isfinite(b).all()):
            raise AssertionError(f"graph {label}: frame {i} graph against "
                                 f"eager {eg} (eager twice {ee}, bit for "
                                 f"bit {exact})")
    log(f"graph {label}: {cfg.render_width}x{cfg.render_height} to "
        f"{cfg.output_width}x{cfg.output_height} frames={frames} "
        f"eager_ms {spread(eager_ms)} graph_ms {spread(graph_ms)} "
        f"host_launches_per_graph_frame="
        f"{call.stats.last_host_launches} eager_kernel_launches_per_frame="
        f"{json.dumps(e_launch[0])} captured="
        f"{json.dumps(call.stats.captured_launches)} "
        f"capture_s={json.dumps(call.stats.capture_s)} spill_waves eager="
        f"{sum(e_waves)} eager2={sum(e_waves2)} graph={g_waves} "
        f"worst_graph_vs_eager(mean, share off)={worst!r} "
        f"peak_bytes eager={eager_peak} graph={graph_peak} | {smi}")
    if g_waves != 2 * sum(e_waves):
        raise AssertionError(f"graph {label}: {g_waves} spill waves in "
                             f"{2 * frames} graph frames, the eager "
                             f"frames ran {sum(e_waves)} in "
                             f"{frames}")
    return call.stats, eager_ms, graph_ms, eager_peak, graph_peak


def run_graph_trace(backend, pathtrace, smi, dev, label, eager_frame, call,
                    scene, cam, kernels=GRAPH_KERNELS, frames=GRAPH_FRAMES):
    """Phase 25 (b) and 26 (a): a trace frame eager (eager_frame(index
    tensor) -> TraceOutput) and through the trace_image_graph callable
    `call` on (scene, cam), `frames` each from frame 1 on: the
    radiance bit for bit, each eager frame's launches of `kernels`
    against the capture plus its spill waves', the spill waves. Returns
    the callable's stats."""
    idx = [1]

    def eager():
        out = eager_frame(torch.tensor(idx[0], device=dev))
        idx[0] += 1
        return out.radiance

    def graph():
        out = call(scene, cam, idx[0])
        idx[0] += 1
        return out
    torch.cuda.reset_peak_memory_stats()
    eager_frame(torch.tensor(0, device=dev))   # warm
    e_launch, e_waves, e_img = eager_frames(backend, pathtrace, eager,
                                            frames, kernels)
    eager_peak = torch.cuda.max_memory_allocated()
    idx[0] = 1
    torch.cuda.reset_peak_memory_stats()
    g_img = []
    for _ in range(frames):
        g_img.append(graph().radiance.clone())
    idx[0] = 1
    eager_ms = frame_marks(eager, frames)
    idx[0] = 1
    graph_ms = frame_marks(graph, frames)
    graph_peak = torch.cuda.max_memory_allocated()
    graph_launches_check(label, call, [0] * frames, e_launch, e_waves,
                         kernels)
    for i, (a, b) in enumerate(zip(e_img, g_img)):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"graph {label}: frame {i + 1}'s "
                                 f"radiance differs from the eager frame's "
                                 f"({float((a - b).abs().max())!r})")
    log(f"graph {label}: 1920x1080 bounces=8 frames={frames} "
        f"eager_ms {spread(eager_ms)} graph_ms {spread(graph_ms)} "
        f"host_launches_per_graph_frame="
        f"{call.stats.last_host_launches} eager_kernel_launches_per_frame="
        f"{json.dumps(e_launch[0])} captured="
        f"{json.dumps(call.stats.captured_launches)} "
        f"capture_s={json.dumps(call.stats.capture_s)} spill_waves eager="
        f"{sum(e_waves)} graph={call.stats.spill_waves} "
        f"peak_bytes eager={eager_peak} graph={graph_peak} | {smi}")
    if call.stats.spill_waves != 2 * sum(e_waves):
        raise AssertionError(f"graph {label}: spill waves differ")
    return call.stats


def run_graphs(backend, bench, pathtrace, smi, dev):
    """Phase 25: the default frame and the headline frame as CUDA graph
    replays against eager frames (run_graph_pipeline, run_graph_trace),
    then the default frame with a 32,768-slot deep segment, which spills
    every frame. Returns the launches the default frame's replays made,
    from its capture."""
    stats, *_ = run_graph_pipeline(backend, bench, pathtrace, smi, dev,
                                   "default frame",
                                   bench.default_frame_config())
    setup = bench.make_trace_setup(device=dev)
    run_graph_trace(backend, pathtrace, smi, dev, "headline",
                    lambda index: bench.trace_frame(setup, index),
                    pathtrace.trace_image_graph(setup.cfg, setup.plan),
                    setup.scene, setup.cam)
    del setup
    forced, *_ = run_graph_pipeline(
        backend, bench, pathtrace, smi, dev, "forced-spill default frame",
        bench.default_frame_config(),
        patch={"compact_capacity": GRAPH_SPILL_CAPACITY})
    if forced.spill_waves < 2 * GRAPH_FRAMES or not all(
            cap["spill_waves"] and cap["spill_waves"][0].get(
                "intersect_morton", 0) > 0
            for cap in forced.captured_launches.values()):
        raise AssertionError("graph: the forced-spill frame did not replay "
                             "its spill wave every frame")
    for name in GRAPH_KERNELS:
        if stats.launches.get(name, 0) <= 0:
            raise AssertionError(f"graph: {name} was not launched inside "
                                 f"the default frame's graph")
    return {f"{name}@graph": stats.launches[name] for name in GRAPH_KERNELS}


# Phase 26: the compiled mesh frames. The kernels their entries carry
# (B4-B11), the closest-hit forms the mesh trace runs in (trimesh.
# MESH_CAND: 1 the candidate loop, B5 and B6; 2 the fused loop, B10), the
# kernels each part's replays must launch, and the readings each
# "...@mesh_graph" entry carries (phases 8, 12 and 16).
MESH_GRAPH_KERNELS = ("reproject_packed", "bound_scan", "shared_blas_sweep",
                      "intersect_mesh_instances", "shared_blas_any",
                      "intersect_mesh_instances_any", "cand_fused",
                      "intersect_brute")
MESH_GRAPH_CANDS = (1, 2)
MESH_GRAPH_NEEDS = {
    "mesh trace 1": ("bound_scan", "shared_blas_sweep",
                     "intersect_mesh_instances", "intersect_brute"),
    "mesh trace 2": ("cand_fused", "intersect_mesh_instances",
                     "intersect_brute"),
    "all-mesh restir frame": ("reproject_packed", "bound_scan",
                              "shared_blas_sweep", "intersect_mesh_instances",
                              "shared_blas_any",
                              "intersect_mesh_instances_any",
                              "intersect_brute"),
    "all-mesh pipeline": ("reproject_packed", "bound_scan",
                          "shared_blas_sweep", "intersect_mesh_instances",
                          "shared_blas_any", "intersect_mesh_instances_any",
                          "intersect_brute")}
MESH_GRAPH_READINGS = {
    "reproject_packed": "reproject_packed@mesh_pipeline",
    "bound_scan": "bound_scan", "shared_blas_sweep": "shared_blas_sweep",
    "intersect_mesh_instances": "intersect_mesh_instances",
    "shared_blas_any": "shared_blas_any@mesh_pipeline",
    "intersect_mesh_instances_any":
        "intersect_mesh_instances_any@mesh_pipeline",
    "cand_fused": "cand_fused@mesh_fused",
    "intersect_brute": "intersect_brute@mesh"}


def run_mesh_graphs(backend, bench, pathtrace, trimesh, smi, dev):
    """Phase 26: the mesh frames as CUDA graph replays against eager frames:
    (a) bench_mesh's frame (1080p, 8 bounces, 438 instances of a 512-face
    geosphere) at each MESH_CAND of MESH_GRAPH_CANDS through
    run_graph_trace, (b) the all-mesh ReSTIR frame (bit for bit: no SHARC)
    and (c) the all-mesh pipeline (SHARC: within DEFAULT_* plus the eager
    spread) through run_graph_pipeline. Each part's replays must launch
    the kernels of MESH_GRAPH_NEEDS. Returns the launches of
    MESH_GRAPH_KERNELS all the replays made, from the captures."""
    stats = {}
    scene, cam, cfg = bench.make_mesh_setup(device=dev)
    old = trimesh.MESH_CAND
    try:
        for cand in MESH_GRAPH_CANDS:
            trimesh.MESH_CAND = cand
            stats[f"mesh trace {cand}"] = run_graph_trace(
                backend, pathtrace, smi, dev, f"mesh trace {cand}",
                lambda index: pathtrace.trace_image(scene, cam, cfg, index),
                pathtrace.trace_image_graph(cfg), scene, cam,
                MESH_GRAPH_KERNELS)
    finally:
        trimesh.MESH_CAND = old
    del scene, cam
    for label, cfg in (
            ("all-mesh restir frame", bench.pipeline.restir_frame_config()),
            ("all-mesh pipeline", bench.mesh_pipeline_config())):
        stats[label], *_ = run_graph_pipeline(
            backend, bench, pathtrace, smi, dev, label, cfg, mesh=True,
            kernels=MESH_GRAPH_KERNELS)
    for label, needs in MESH_GRAPH_NEEDS.items():
        for name in needs:
            if stats[label].launches.get(name, 0) <= 0:
                raise AssertionError(f"graph: {name} was not launched inside "
                                     f"the {label}'s graphs")
    for label, st in stats.items():
        for name in ("intersect_morton", "occlusion_morton",
                     "initial_light_candidates"):
            if st.launches.get(name, 0):
                raise AssertionError(f"graph: {name} ran in the {label}")
    return {f"{name}@mesh_graph": sum(st.launches.get(name, 0)
                                      for st in stats.values())
            for name in MESH_GRAPH_KERNELS}


# Phase 27: the compiled frame for the rest of the one-device frames. The
# frames each part runs (fewer than phase 25's: the textured frame takes
# about a second eager), the kernels whose launches each part checks, the
# kernels each part's replays must launch and those they must not, and
# the readings each "...@<part>_graph" entry carries.
ROUTE_GRAPH_FRAMES = 3
ROUTE_GRAPH_OPTIONS_FRAMES = 4      # the shared offsets move every frame
ROUTE_GRAPH_KERNELS = tuple(dict.fromkeys(
    GRAPH_KERNELS + MESH_GRAPH_KERNELS + (
        "intersect_morton_mxu", "occlusion_morton_mxu",
        "intersect_clustered")))
ROUTE_GRAPH_PRECS = ("default", "high", "highest")
ROUTE_GRAPH_NEEDS = {
    "textured": ("intersect_morton", "occlusion_morton", "reproject_packed",
                 "bound_scan", "shared_blas_sweep",
                 "intersect_mesh_instances", "shared_blas_any",
                 "intersect_mesh_instances_any", "intersect_brute"),
    "options": ("intersect_morton", "occlusion_morton",
                "initial_light_candidates", "reproject_packed",
                "intersect_brute"),
    "accel_none": ("intersect_brute", "initial_light_candidates",
                   "reproject_packed"),
    **{f"mxu_{p}": ("intersect_morton_mxu", "occlusion_morton_mxu")
       for p in ROUTE_GRAPH_PRECS},
    "clustered": ("intersect_clustered",)}
ROUTE_GRAPH_NEVER = {
    "textured": ("initial_light_candidates",),
    "options": (),
    "accel_none": ("intersect_morton", "occlusion_morton"),
    **{f"mxu_{p}": ("intersect_morton", "occlusion_morton")
       for p in ROUTE_GRAPH_PRECS},
    "clustered": ("intersect_morton", "intersect_morton_mxu",
                  "intersect_brute")}
# entry -> (part, the reading it carries)
ROUTE_GRAPH_READINGS = {
    **{f"{name}@textured_graph": ("textured", f"{name}@textured")
       for name in ROUTE_GRAPH_NEEDS["textured"]},
    **{f"{name}@options_graph": ("options", f"{name}@options")
       for name in ROUTE_GRAPH_NEEDS["options"]},
    "intersect_brute@accel_none_graph": ("accel_none",
                                         "intersect_brute@accel_none"),
    "initial_light_candidates@accel_none_graph": (
        "accel_none", "initial_light_candidates"),
    "reproject_packed@accel_none_graph": ("accel_none", "reproject_packed"),
    **{f"{name}@mxu_graph_{p}": (f"mxu_{p}",
                                 name if p == "high" else f"{name}@{p}")
       for name in ("intersect_morton_mxu", "occlusion_morton_mxu")
       for p in ROUTE_GRAPH_PRECS},
    "intersect_clustered@clustered_graph": ("clustered",
                                            "intersect_clustered")}


def run_route_graphs(backend, bench, clusters, ik, pathtrace, smi, dev):
    """Phase 27: the textured frame (PipelineConfig() on
    add_mesh_content(build(10), 3)), the options frame
    (bench.options_frame_config) and the ReSTIR frame at
    accel_mode="none" through run_graph_pipeline; at each MXU precision
    (clusters._USE_MXU and intersect_kernels.MXU_PREC set, and restored)
    the headline frame through run_graph_trace and the upscaled default
    frame through run_graph_pipeline; the clustered headline frame
    (bench.make_trace_setup(accel="clustered")) through run_graph_trace.
    Each part's replays must launch the kernels of ROUTE_GRAPH_NEEDS and
    none of ROUTE_GRAPH_NEVER. Returns the launches the replays made, by
    the entries of ROUTE_GRAPH_READINGS."""
    stats = {}
    stats["textured"], *_ = run_graph_pipeline(
        backend, bench, pathtrace, smi, dev, "textured frame",
        bench.default_frame_config(), kernels=ROUTE_GRAPH_KERNELS,
        textured=True, frames=ROUTE_GRAPH_FRAMES)
    stats["options"], *_ = run_graph_pipeline(
        backend, bench, pathtrace, smi, dev, "options frame",
        bench.options_frame_config(), kernels=ROUTE_GRAPH_KERNELS,
        frames=ROUTE_GRAPH_OPTIONS_FRAMES)
    stats["accel_none"], *_ = run_graph_pipeline(
        backend, bench, pathtrace, smi, dev, "accel-none restir frame",
        bench.pipeline.restir_frame_config(accel_mode="none"),
        kernels=ROUTE_GRAPH_KERNELS, frames=ROUTE_GRAPH_FRAMES)
    saved = clusters._USE_MXU, ik.MXU_PREC
    try:
        clusters._USE_MXU = True
        for prec in ROUTE_GRAPH_PRECS:
            ik.MXU_PREC = prec
            setup = bench.make_trace_setup(device=dev)
            trace = run_graph_trace(
                backend, pathtrace, smi, dev, f"MXU headline @{prec}",
                lambda index, setup=setup: bench.trace_frame(setup, index),
                pathtrace.trace_image_graph(setup.cfg, setup.plan),
                setup.scene, setup.cam, ROUTE_GRAPH_KERNELS,
                ROUTE_GRAPH_FRAMES)
            del setup
            frame, *_ = run_graph_pipeline(
                backend, bench, pathtrace, smi, dev,
                f"MXU upscaled default frame @{prec}",
                bench.default_frame_config(upscaled=True),
                kernels=ROUTE_GRAPH_KERNELS, frames=ROUTE_GRAPH_FRAMES)
            stats[f"mxu_{prec}"] = {
                k: trace.launches.get(k, 0) + frame.launches.get(k, 0)
                for k in set(trace.launches) | set(frame.launches)}
    finally:
        clusters._USE_MXU, ik.MXU_PREC = saved
    setup = bench.make_trace_setup(device=dev, accel="clustered")
    stats["clustered"] = run_graph_trace(
        backend, pathtrace, smi, dev, "clustered headline",
        lambda index: bench.trace_frame(setup, index),
        pathtrace.trace_image_graph(setup.cfg, setup.plan, "clustered"),
        setup.scene, setup.cam, ROUTE_GRAPH_KERNELS, ROUTE_GRAPH_FRAMES)
    del setup
    stats = {part: st if isinstance(st, dict) else st.launches
             for part, st in stats.items()}
    for part, needs in ROUTE_GRAPH_NEEDS.items():
        got = stats[part]
        for name in needs:
            if got.get(name, 0) <= 0:
                raise AssertionError(f"graph: {name} was not launched "
                                     f"inside the {part} graphs")
        for name in ROUTE_GRAPH_NEVER[part]:
            if got.get(name, 0):
                raise AssertionError(f"graph: {name} ran in the {part} "
                                     f"graphs")
    return {entry: stats[part][entry.split("@")[0]]
            for entry, (part, _) in ROUTE_GRAPH_READINGS.items()}


# Phase 28: the sharded graph frame. The frames each part compares and
# times, the banded mesh trace's kernels and the readings each
# "...@banded_graph" entry carries.
BANDED_GRAPH_FRAMES = 3
BANDED_MESH_KERNELS = ("bound_scan", "shared_blas_sweep",
                       "intersect_mesh_instances", "intersect_brute")
# entry -> the reading it carries
BANDED_GRAPH_READINGS = {
    **{f"{name}@banded_graph": f"{name}@banded" for name in GRAPH_KERNELS},
    "bound_scan@banded_graph": "bound_scan",
    "shared_blas_sweep@banded_graph": "shared_blas_sweep",
    "intersect_mesh_instances@banded_graph": "intersect_mesh_instances",
    "intersect_brute@banded_mesh_graph": "intersect_brute@mesh"}


@contextlib.contextmanager
def captured_all_reduces(counts):
    """Count into counts[0] every torch.distributed.all_reduce made while
    the current stream captures a CUDA graph."""
    import torch.distributed as dist
    inner = dist.all_reduce

    def counted(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            counts[0] += 1
        return inner(*args, **kw)
    dist.all_reduce = counted
    try:
        yield
    finally:
        dist.all_reduce = inner


def run_banded_graphs(backend, bench, pathtrace, smi, dev):
    """Phase 28: (a) the sharded PipelineConfig() frame at 1920x1080 on one
    NCCL rank through render_frame_graph()(..., group=) against the eager
    sharded frame from the same state, (b) dryrun_multichip(1) as graph
    frames and bench_mesh's frame traced as the rank's band through
    trace_image_graph(cfg, rows=), (c) a gloo group on the card refused.
    Returns the launches of the "...@banded_graph" entries."""
    import torch.distributed as dist

    from drts_tpu_torch import graft_entry
    from drts_tpu_torch.models import pipeline
    from drts_tpu_torch.parallel import mesh, multihost

    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                         device="cuda")
    group = multihost.global_group()
    cfg = pipeline.PipelineConfig()
    pipe, state, pose = graft_entry._setup(cfg, dev)
    call = pipe.render_frame_graph()
    reduces = [0]
    e_launch, e_waves, phases = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(BANDED_GRAPH_FRAMES):
        update = state.frame_count % cfg.sharc_update_period == 0
        phases.append(state.frame_count % call.cycle)
        got = {}

        def eager():
            got["state"], img = pipe.render_frame(state, pose, group=group)
            return img
        launches, waves, (img_e,) = eager_frames(backend, pathtrace, eager,
                                                 1)
        s_e = got.pop("state")
        e_launch += launches
        e_waves += waves
        with captured_all_reduces(reduces):
            s_g, img_g = call(state, pose, group=group)
        torch.cuda.synchronize()
        mean, off, dmax = frame_diff(img_g, img_e)
        exact = bool(torch.equal(img_g.view(torch.int32),
                                 img_e.view(torch.int32)))
        same = mesh.replica_checksums(s_g) == mesh.replica_checksums(s_e)
        log(f"banded graph (a) nccl 1 rank: frame {i} sharc_update={update} "
            f"image_mean_abs_diff={mean!r} pixels_off_{DEFAULT_OFF}={off!r} "
            f"max_abs_diff={dmax!r} image_bit_exact={exact} "
            f"state_bit_exact={same} eager_launches="
            f"{json.dumps(launches[0])} spill_waves={waves[0]} | {smi}")
        if not bool(torch.isfinite(img_g).all()):
            raise AssertionError(f"banded graph (a) frame {i}: not finite")
        if not update and not (exact and same):
            raise AssertionError(f"banded graph (a) frame {i}: a SHARC skip "
                                 f"frame differs from the eager frame")
        if mean > DEFAULT_MEAN or off > DEFAULT_OFF_SHARE:
            raise AssertionError(f"banded graph (a) frame {i}: off the "
                                 f"eager frame")
        state = graphs_clone(s_g)
        del s_e
    graph_launches_check("banded frame", call, phases, e_launch, e_waves)
    if reduces[0] < call.cycle:
        raise AssertionError(f"banded graph (a): {reduces[0]} all-reduces "
                             f"captured in {call.cycle} phases")
    peak = torch.cuda.max_memory_allocated()
    box = [state]

    def graph():
        box[0], img = call(box[0], pose, group=group)
        return img

    def eager():
        box[0], img = pipe.render_frame(box[0], pose, group=group)
        return img
    graph_ms = frame_marks(graph, BANDED_GRAPH_FRAMES)
    box[0] = graphs_clone(box[0])
    eager_ms = frame_marks(eager, BANDED_GRAPH_FRAMES)
    ta = time.perf_counter() - t0
    log(f"banded graph (a): 1920x1080 PipelineConfig() frames="
        f"{BANDED_GRAPH_FRAMES} eager_ms {spread(eager_ms)} graph_ms "
        f"{spread(graph_ms)} host_launches_per_graph_frame="
        f"{call.stats.last_host_launches} captured="
        f"{json.dumps(call.stats.captured_launches)} capture_s="
        f"{json.dumps(call.stats.capture_s)} all_reduces_captured="
        f"{reduces[0]} spill_waves graph={call.stats.spill_waves} "
        f"peak_bytes={peak} in {ta:.1f} s | {smi}")
    out = {f"{name}@banded_graph": call.stats.launches.get(name, 0)
           for name in GRAPH_KERNELS}
    del pipe, state, call, box

    # (b) the dry run and the banded mesh trace as graphs -------------------
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(1)
    scene, cam, mcfg = bench.make_mesh_setup(device=dev)
    rows = mesh.group_band(mcfg.height, group)
    st = run_graph_trace(
        backend, pathtrace, smi, dev, "banded mesh trace",
        lambda index: pathtrace.trace_image(scene, cam, mcfg, index,
                                            rows=rows),
        pathtrace.trace_image_graph(mcfg, rows=rows), scene, cam,
        MESH_GRAPH_KERNELS, BANDED_GRAPH_FRAMES)
    del scene, cam
    for name in BANDED_MESH_KERNELS:
        if st.launches.get(name, 0) <= 0:
            raise AssertionError(f"banded graph (b): {name} was not "
                                 f"launched inside the banded trace")
    out.update({f"{name}@banded_graph": st.launches[name]
                for name in BANDED_MESH_KERNELS[:3]})
    out["intersect_brute@banded_mesh_graph"] = st.launches["intersect_brute"]
    tb = time.perf_counter() - t0

    # (c) a gloo group on the card has no graph form ------------------------
    gloo = dist.new_group([0], backend="gloo")
    pipe, state, pose = graft_entry._setup(
        graft_entry._config(64, 64, bounces=2, spp=1), dev)
    try:
        pipe.render_frame_graph()(state, pose, group=gloo)
    except ValueError as exc:
        refused = str(exc)
    else:
        raise AssertionError("banded graph (c): a gloo group on the card "
                             "was not refused")
    dist.destroy_process_group()
    log(f"banded graph (b): dryrun_multichip(1) and the banded mesh trace "
        f"as graphs in {tb:.1f} s; (c) gloo refused: {refused!r} | {smi}")
    return out


def graphs_clone(tree):
    from drts_tpu_torch import graphs
    return graphs.clone_tree(tree)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no GPU (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from drts_tpu_torch import backend, bench
    from drts_tpu_torch.models import clusters, myscene, pipeline
    from drts_tpu_torch.ops import camera as camera_mod, gbuffer, intersect
    from drts_tpu_torch.ops import intersect_kernels as ik
    from drts_tpu_torch.ops import pathtrace, post
    from drts_tpu_torch.ops import reproject_kernels as rp
    from drts_tpu_torch.ops import restir_kernels as rk
    from drts_tpu_torch.ops import sharc as sharc_mod, trimesh
    from drts_tpu_torch.ops import trimesh_kernels as tk
    from drts_tpu_torch.utils import image, rng as rng_mod

    # 1. device ------------------------------------------------------------
    dev = backend.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    lib = backend.build(verbose=True)
    backend.kernels()
    log(f"device: kernels built in {time.perf_counter() - t0:.1f} s "
        f"({lib})")

    # 2. B1 and B11 at the path trace's shapes -----------------------------
    setup = bench.make_trace_setup(device=dev)
    scene, cam, cfg = setup.scene, setup.cam, setup.cfg
    accel = clusters.make_morton_accel(setup.plan, scene.center,
                                       scene.radius,
                                       sort_origin=cam.position)
    ndc = camera_mod.pixel_ndc(cfg.width, cfg.height, cam.jitter)
    o, d, tmin, tmax = camera_mod.generate_pinhole_rays(cam, ndc)
    n = cfg.width * cfg.height
    primary = intersect.pack_rays(
        o.reshape(n, 3), d.reshape(n, 3),
        torch.broadcast_to(tmin, o.shape[:2]).reshape(n),
        torch.broadcast_to(tmax, o.shape[:2]).reshape(n))
    # Bounce-1 rays: scatter the G-buffer's primary hits as the integrator
    # does at bounce 0.
    gbuf = gbuffer.generate(scene, cam, cfg.width, cfg.height,
                            cfg.block_size, accel=accel)
    py, px = torch.meshgrid(torch.arange(cfg.height, device=dev),
                            torch.arange(cfg.width, device=dev),
                            indexing="ij")
    _, l_dir, _, valid, _, _, _ = pathtrace._shade_and_scatter(
        gbuf.surf, gbuf.ray_direction, rng_mod.init(px, py, 0), mat=gbuf.mat)
    live = gbuf.surf.valid & valid
    origin = intersect.safe_spawn_point(gbuf.surf.position,
                                        gbuf.surf.geometric_normal, l_dir)
    bounce1 = intersect.pack_rays(
        origin.reshape(n, 3), l_dir.reshape(n, 3),
        torch.zeros(n, device=dev),
        torch.where(live, float("inf"), -1.0).reshape(n))
    table, bounds = accel.table, accel.bounds
    b1 = []
    for label, rays in (("B1 primary", primary), ("B1 bounce-1", bounce1)):
        b1.append(compare_closest(
            label, lambda r=rays: ik.intersect_morton(r, table, bounds),
            lambda r=rays: ik.intersect_morton_plain(r, table, bounds,
                                                     cfg.block_size),
            reps=20, plain_reps=2))
        line, work = b1_sums([b1_work(ik, rays, table, bounds)])
        b1[-1].update(bound_ms=work["bound_ms"], bound_by=work["bound_by"],
                      unculled_bound_ms=work["unculled_bound_ms"])
        log(f"kernels: {label} rays={rays.shape[1]} cols={table.shape[1]} "
            f"chunks={bounds.shape[1]} filled_slots="
            f"{int(bounds[4].sum())} {line}")

    golden_host = myscene.build(oscillator_grid=8, device=dev)
    gpos = np.array([0.0, 1.0, -5.0])
    gcam = camera_mod.make_camera(tuple(gpos),
                                  tuple(-gpos / np.linalg.norm(gpos)),
                                  horizontal_fov_deg=90.0, aspect=1.0,
                                  device=dev)
    go, gd, gtmin, gtmax = camera_mod.generate_pinhole_rays(
        gcam, camera_mod.pixel_ndc(64, 64, gcam.jitter))
    grays = intersect.pack_rays(
        go.reshape(-1, 3), gd.reshape(-1, 3),
        torch.broadcast_to(gtmin, (64, 64)).reshape(-1),
        torch.broadcast_to(gtmax, (64, 64)).reshape(-1))
    spheres = intersect.pack_spheres(golden_host.scene.center,
                                     golden_host.scene.radius)
    compare_closest("B11 golden", lambda: ik.intersect_brute(grays, spheres),
                    lambda: ik.intersect_brute_plain(grays, spheres, 4096),
                    reps=50, plain_reps=20)

    # 3. golden recipe, its own launch count -------------------------------
    backend.reset_launches()
    gcfg = pathtrace.PathTraceConfig(width=64, height=64, bounces=3,
                                     samples_per_pixel=4, block_size=4096)
    gout = pathtrace.trace_image(golden_host.scene, gcam, gcfg, 0)
    img = post.tonemap(gout.radiance).cpu().numpy()
    ref = image.read_png(os.path.join(HERE, "tests", "golden",
                                      "demo_64.png"))[..., :3]
    score = image.ssim(img, ref)
    mean_diff = abs(float(img.mean()) - float(ref.mean()))
    golden_b11 = backend.LAUNCHES["intersect_brute"]
    log(f"golden: ssim={score!r} mean_diff={mean_diff!r} "
        f"B11 launches={golden_b11}")
    if not (score > 0.97 and mean_diff < 0.01):
        raise AssertionError("golden frame off the bars")
    if golden_b11 == 0:
        raise AssertionError("B11 was not launched by the golden render")

    # 4. the path-trace frame, counted from zero ----------------------------
    iters = iters_trace = 2
    backend.reset_launches()
    stats, sphere_out = bench.bench_trace(iters=iters, device=dev)
    rad = sphere_out.radiance
    finite = bool(torch.isfinite(rad).all())
    b1_launches = backend.LAUNCHES["intersect_morton"]
    log(f"main: {cfg.width}x{cfg.height} spp=1 bounces={cfg.bounces} "
        f"spheres={scene.center.shape[0]} frame_ms={stats['frame_ms']!r} "
        f"mray_s={stats['mray_s']!r} "
        f"rays_per_frame={stats['rays_per_frame']!r} "
        f"wavefront_overflow_paths={stats['overflow_paths']!r} "
        f"B1 launches={b1_launches} "
        f"B11 launches={backend.LAUNCHES['intersect_brute']} finite={finite} "
        f"mean={float(rad.mean())!r} | {smi}")
    if tuple(rad.shape) != (cfg.height, cfg.width, 3) or not finite:
        raise AssertionError("main path radiance is not a finite frame")
    if b1_launches < (iters + 1) * cfg.bounces:
        raise AssertionError(f"B1 launched {b1_launches} times for "
                             f"{iters + 1} frames of {cfg.bounces} bounces")
    # B1 per frame: one more frame with its launches recorded, then each
    # launch timed and its work counted on its own rays.
    with recorded((ik,), ("intersect_morton",), clone=True) as seen:
        bench.trace_frame(setup, 0)
        torch.cuda.synchronize()
    b1_ms_frame, b1_n, line = b1_frame(ik, seen["intersect_morton"], 1)
    del seen
    log(f"main: B1 per frame kernel_ms={b1_ms_frame!r} launches={b1_n!r} "
        f"{line} | {smi}")

    # 5. B2, B3, B4 and B11 at the ReSTIR frame's own inputs ----------------
    seen, frame = capture_restir_inputs(bench, (ik, rk, rp))
    fields = check_restir_kernels(ik, rk, rp, seen, frame)
    del seen, frame

    # 6. the ReSTIR frame, counted from zero --------------------------------
    iters = 4
    frames = iters + 2   # bench_frame: 1 warm, iters timed, 1 stage-timed
    backend.reset_launches()
    rstats, rimg = bench.bench_frame(iters=iters, device=dev)
    launches = dict(backend.LAUNCHES)
    r_finite = bool(torch.isfinite(rimg).all())
    log(f"restir: 1920x1080 bounces=8 frames={frames} "
        f"frame_ms={rstats['frame_ms']!r} "
        f"rays_per_frame={rstats['rays_per_frame']!r} "
        f"counters={json.dumps(rstats['counters'])} "
        f"launches={json.dumps(launches)} finite={r_finite} "
        f"min={float(rimg.min())!r} max={float(rimg.max())!r} "
        f"mean={float(rimg.mean())!r} | {smi}")
    log(f"restir: passes_ms={json.dumps(rstats['passes_ms'])}")
    if (tuple(rimg.shape) != (1080, 1920, 3) or not r_finite
            or float(rimg.min()) < 0.0 or float(rimg.max()) > 1.0):
        raise AssertionError("the ReSTIR frame is not a finite image in "
                             "[0, 1]")
    per_frame = {"occlusion_morton": 3, "initial_light_candidates": 1,
                 "reproject_packed": 1, "intersect_brute": 1}
    for name, count in per_frame.items():
        if launches[name] != count * frames:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {frames} frames, expected "
                                 f"{count * frames}")
    if launches["intersect_morton"] < frames:
        raise AssertionError("B1 did not launch in every ReSTIR frame")

    # 7. small frames: kernels on the card vs plain versions on the CPU -----
    check_small_frames(pipeline, bench)

    # 8. B5, B6, B7 and B11 at the mesh frame's own inputs ------------------
    seen = capture_mesh_inputs(bench, pathtrace, (ik, tk), device=dev)
    fields.update(check_mesh_kernels(ik, tk, seen))
    del seen

    # 9. the mesh frame, counted from zero ----------------------------------
    # As many timed frames as phase 4, so both last frames share a seed.
    backend.reset_launches()
    mstats, mesh_out = bench.bench_mesh(iters=iters_trace, device=dev)
    mesh_launches = dict(backend.LAUNCHES)
    mrad = mesh_out.radiance
    m_finite = bool(torch.isfinite(mrad).all())
    m_frames = iters_trace + 1
    calls = mesh_launches["intersect_mesh_instances"]
    mean_mesh = float(post.tonemap(mrad).mean())
    mean_sphere = float(post.tonemap(sphere_out.radiance).mean())
    agree = float((mesh_out.primary_valid
                   == sphere_out.primary_valid).float().mean())
    log(f"mesh: 1920x1080 spp=1 bounces=8 instances=438 faces=512 "
        f"frames={m_frames} frame_ms={mstats['frame_ms']!r} "
        f"mray_s={mstats['mray_s']!r} "
        f"rays_per_frame={mstats['rays_per_frame']!r} "
        f"wavefront_overflow_paths={mstats['overflow_paths']!r} "
        f"trace_calls={calls} launches={json.dumps(mesh_launches)} "
        f"finite={m_finite} tonemapped_mean={mean_mesh!r} "
        f"sphere_frame_tonemapped_mean={mean_sphere!r} "
        f"primary_valid_agreement={agree!r} | {smi}")
    if tuple(mrad.shape) != (1080, 1920, 3) or not m_finite:
        raise AssertionError("the mesh frame is not a finite image")
    if calls < m_frames * (8 + 1):
        raise AssertionError(f"{calls} mesh trace calls in {m_frames} frames "
                             f"of 8 bounces")
    per_call = {"bound_scan": 4, "shared_blas_sweep": 3,
                "intersect_mesh_instances": 1, "intersect_brute": 2}
    for name, count in per_call.items():
        if mesh_launches[name] != count * calls:
            raise AssertionError(f"{name} launched {mesh_launches[name]} "
                                 f"times in {calls} trace calls, expected "
                                 f"{count * calls}")
    if (abs(mean_mesh - mean_sphere) > MESH_MEAN_REL * mean_sphere
            or agree <= MESH_VALID_AGREE):
        raise AssertionError("the mesh frame is off the sphere frame")
    # Each path's own counts: B11 is on both, once per path.
    for name in ("bound_scan", "shared_blas_sweep",
                 "intersect_mesh_instances"):
        launches[name] = mesh_launches[name]
    launches["intersect_brute@mesh"] = mesh_launches["intersect_brute"]

    # 10. B8, B9 and the any-hit B5 and B11 at the all-mesh frame's inputs --
    seen = capture_anyhit_inputs(bench, trimesh, (ik, tk), device=dev)
    fields.update(check_anyhit_kernels(ik, tk, seen))
    del seen

    # 11. the all-mesh ReSTIR frame, counted from zero ----------------------
    iters = 2
    frames = iters + 2   # bench_frame: 1 warm, iters timed, 1 stage-timed
    backend.reset_launches()
    xstats, ximg = bench.bench_frame(iters=iters, device=dev, mesh=True)
    x_launches = dict(backend.LAUNCHES)
    x_finite = bool(torch.isfinite(ximg).all())
    calls = x_launches["intersect_mesh_instances"]
    mean_x, mean_r = float(ximg.mean()), float(rimg.mean())
    log(f"mesh restir: 1920x1080 bounces=8 instances=438 faces=512 "
        f"frames={frames} frame_ms={xstats['frame_ms']!r} "
        f"rays_per_frame={xstats['rays_per_frame']!r} "
        f"counters={json.dumps(xstats['counters'])} "
        f"spill_waves={xstats['spill_waves']} "
        f"closest_hit_calls={calls} launches={json.dumps(x_launches)} "
        f"finite={x_finite} min={float(ximg.min())!r} "
        f"max={float(ximg.max())!r} mean={mean_x!r} "
        f"sphere_restir_frame_mean={mean_r!r} | {smi}")
    log(f"mesh restir: passes_ms={json.dumps(xstats['passes_ms'])}")
    if (tuple(ximg.shape) != (1080, 1920, 3) or not x_finite
            or float(ximg.min()) < 0.0 or float(ximg.max()) > 1.0):
        raise AssertionError("the all-mesh ReSTIR frame is not a finite "
                             "image in [0, 1]")
    if abs(mean_x - mean_r) > MESH_MEAN_REL * mean_r:
        raise AssertionError("the all-mesh ReSTIR frame is off the sphere "
                             "ReSTIR frame")
    if xstats["counters"]["wavefront_overflow_paths"] != 0:
        raise AssertionError("the all-mesh ReSTIR frame overflowed its "
                             "wavefront")
    if calls < frames * (8 + 1):
        raise AssertionError(f"{calls} closest-hit calls in {frames} frames "
                             f"of 8 bounces")
    # Per frame: 3 any-hit calls (3 x B5, 2 x B8, 1 x B9, 1 x B11), the BRDF
    # candidate's light sweep (B11) and the temporal history (B4); per
    # closest-hit call the counts of phase 9.
    expect = {"shared_blas_any": 6 * frames,
              "intersect_mesh_instances_any": 3 * frames,
              "bound_scan": 4 * calls + 9 * frames,
              "shared_blas_sweep": 3 * calls,
              "intersect_brute": 2 * calls + 4 * frames,
              "reproject_packed": frames, "intersect_morton": 0,
              "occlusion_morton": 0, "initial_light_candidates": 0}
    for name, count in expect.items():
        if x_launches[name] != count:
            raise AssertionError(f"{name} launched {x_launches[name]} times "
                                 f"in {frames} all-mesh frames, expected "
                                 f"{count}")
    launches["shared_blas_any"] = x_launches["shared_blas_any"]
    launches["intersect_mesh_instances_any"] = \
        x_launches["intersect_mesh_instances_any"]
    launches["intersect_mesh_instances_any@backstop"] = \
        x_launches["intersect_mesh_instances_any"]
    launches["bound_scan@mesh_restir"] = 9 * frames
    launches["intersect_brute@mesh_restir"] = 3 * frames
    check_small_frames(pipeline, bench, mesh=True)

    # 12. B10 at the fused mesh frame's own inputs ---------------------------
    trimesh.MESH_CAND = 2
    seen = capture_fused_inputs(bench, pathtrace, trimesh, (tk,), device=dev)
    fields["cand_fused@mesh_fused"] = check_fused_kernel(tk, seen)
    del seen

    # 13. the fused mesh frame, counted from zero ----------------------------
    backend.reset_launches()
    fstats, fused_out = bench.bench_mesh(iters=iters_trace, device=dev)
    f_launches = dict(backend.LAUNCHES)
    trimesh.MESH_CAND = 1
    frad = fused_out.radiance
    f_finite = bool(torch.isfinite(frad).all())
    calls = f_launches["intersect_mesh_instances"]
    f_diff = float((frad - mrad).abs().max())
    log(f"fused mesh: 1920x1080 spp=1 bounces=8 MESH_CAND=2 "
        f"frames={m_frames} frame_ms={fstats['frame_ms']!r} "
        f"mray_s={fstats['mray_s']!r} "
        f"rays_per_frame={fstats['rays_per_frame']!r} trace_calls={calls} "
        f"launches={json.dumps(f_launches)} finite={f_finite} "
        f"max_abs_diff_to_MESH_CAND_1_frame={f_diff!r} | {smi}")
    if tuple(frad.shape) != (1080, 1920, 3) or not f_finite:
        raise AssertionError("the fused mesh frame is not a finite image")
    if calls < m_frames * (8 + 1):
        raise AssertionError(f"{calls} fused mesh trace calls in {m_frames} "
                             f"frames of 8 bounces")
    per_call = {"cand_fused": 1, "intersect_mesh_instances": 1,
                "intersect_brute": 2, "bound_scan": 0, "shared_blas_sweep": 0}
    for name, count in per_call.items():
        if f_launches[name] != count * calls:
            raise AssertionError(f"{name} launched {f_launches[name]} times "
                                 f"in {calls} fused trace calls, expected "
                                 f"{count * calls}")
    if f_diff != 0.0:
        raise AssertionError("the fused mesh frame differs from the "
                             "MESH_CAND=1 frame")
    launches["cand_fused@mesh_fused"] = f_launches["cand_fused"]

    # 14. the default frame: B4 at its own inputs, then counted from zero ----
    calls, b1_ms_frame, b1_n, line = capture_default_reprojections(
        bench, ik, rp, device=dev)
    log(f"default kernels: B1 per frame kernel_ms={b1_ms_frame!r} "
        f"launches={b1_n!r} {line} (sums over one SHARC cadence of two "
        f"frames, each launch timed and counted on its own rays) | {smi}")
    fields["reproject_packed@default"] = check_default_reprojections(rp,
                                                                     calls)
    del calls
    d_launches = run_default_frame(bench, backend, rp, smi, "default frame",
                                   False, 4, dev)
    run_default_frame(bench, backend, rp, smi, "upscaled frame", True, 2,
                      dev)
    for name in ("intersect_morton", "occlusion_morton",
                 "initial_light_candidates", "reproject_packed",
                 "intersect_brute"):
        launches[f"{name}@default"] = d_launches[name]

    # 15. small default frames: kernels on the card vs the CPU --------------
    check_default_small(pipeline, bench, sharc_mod)

    # 16. the all-mesh pipeline (compact_from=1): each kernel at the
    # frame's own inputs, then counted from zero ---------------------------
    pcfg = bench.mesh_pipeline_config()
    cap1 = pathtrace._compact_capacity(
        pcfg.render_width * pcfg.render_height, 1)
    closest, packs, shadow, sweeps, b4 = capture_pipeline_inputs(
        bench, pathtrace, trimesh, ik, tk, rp, pcfg, device=dev)
    check_partition_sort(pathtrace, packs, cap1)
    fields.update(check_pipeline_closest(ik, tk, closest, cap1))
    any_fields = check_anyhit_kernels(ik, tk, shadow, path="pipeline ")
    for row, name in (
            ("bound_scan@mesh_pipeline_any", "bound_scan@mesh_restir"),
            ("shared_blas_any@mesh_pipeline", "shared_blas_any"),
            ("intersect_mesh_instances_any@mesh_pipeline",
             "intersect_mesh_instances_any@backstop"),
            ("intersect_brute@mesh_pipeline_any",
             "intersect_brute@mesh_restir")):
        fields[row] = any_fields[name]
    fields["intersect_brute@mesh_pipeline_lights"] = check_pipeline_lights(
        ik, sweeps)
    fields["reproject_packed@mesh_pipeline"] = check_default_reprojections(
        rp, b4, label="mesh pipeline")
    del closest, packs, shadow, sweeps, b4, any_fields
    launches.update(run_mesh_pipeline(bench, backend, pathtrace, rp, smi, 2,
                                      dev, pcfg))

    # 17. small mesh pipeline frames in partition mode: card vs CPU ---------
    check_mesh_pipeline_small(pipeline, bench, sharc_mod)

    # 18. fidelity: the crosscheck and the static and mesh SSIM -------------
    check_fidelity(dev, smi)

    # 19. the textured frame: each kernel at the frame's own inputs, the
    # textured alpha's rejections, then counted from zero; small frames --
    from drts_tpu_torch.ops import shading, trace
    t0 = time.perf_counter()
    tcfg = bench.default_frame_config()
    closest, shadow, b2_calls, sweeps, b3_calls, b4, frame = \
        capture_textured_inputs(bench, trimesh, ik, tk, rk, rp, tcfg,
                                device=dev)
    fields.update(check_textured_closest(ik, tk, closest,
                                         frame["scene"].alpha_test_rounds))
    fields.update(check_textured_shadow(ik, tk, shadow, b2_calls))
    lights = [b11_part(ik, "B11 textured light sweep", args)
              for args in sweeps]
    if len(lights) != 1:
        raise AssertionError(f"textured kernels: {len(lights)} B11 light "
                             f"sweeps in the ReSTIR initial stage")
    fields["intersect_brute@textured_lights"] = sum_parts(lights)
    fields["reproject_packed@textured"] = check_default_reprojections(
        rp, b4, label="textured")
    log(f"textured kernels: B3 calls={len(b3_calls)} (the instances make "
        f"the light table a triangle table, whose candidates the fused "
        f"kernel does not sample; the reference gates it off the same way)")
    if b3_calls:
        raise AssertionError("B3 ran on the textured frame")
    by_map, rejected = textured_alpha_rejections(
        trace, shading, camera_mod, frame, tcfg.block_size)
    log(f"textured alpha: primary lanes whose map alpha falls below the "
        f"cutoff={by_map} of them behind in the G-buffer={rejected}")
    if rejected <= 0:
        raise AssertionError("no primary lane was rejected by textured "
                             "alpha")
    del closest, shadow, b2_calls, sweeps, b4, frame
    log(f"textured kernels: checked in {time.perf_counter() - t0:.1f} s")
    launches.update(run_textured_frame(bench, backend, rp, smi, 2, dev,
                                       tcfg))
    check_textured_small(pipeline, bench, sharc_mod, image)
    log(f"textured: phase 19 took {time.perf_counter() - t0:.1f} s")

    # 20. the settings window's options: the options frame's and the
    # accel-none frame's kernels at their own inputs, both frames counted
    # from zero, every option config at 64x64 card vs CPU ---------------
    t0 = time.perf_counter()
    ocfg = bench.options_frame_config()
    seen = capture_options_inputs(bench, ik, rk, rp, ocfg, device=dev)
    fields.update(check_options_kernels(ik, rk, rp, seen))
    del seen
    o_launches, frames, tally = run_options_frame(
        bench, backend, rp, smi, 2, dev, ocfg, "options frame")
    updates = -(-frames // ocfg.sharc_update_period)
    # Per frame: six visibility batches (BRDF candidate, initial, the
    # raytraced temporal history, two spatial cross terms, final), B3, the
    # light sweep and four reprojections (the ReSTIR history at C = 12);
    # B1 as in the default frame.
    expect = {"occlusion_morton": 6 * frames,
              "initial_light_candidates": frames, "intersect_brute": frames,
              "reproject_packed": 4 * frames, "bound_scan": 0,
              "cand_fused": 0}
    for name, count in expect.items():
        if o_launches[name] != count:
            raise AssertionError(f"options frame: {name} launched "
                                 f"{o_launches[name]} times in {frames} "
                                 f"frames, expected {count}")
    if tally != {"nearest": 3 * frames, "bilinear": frames}:
        raise AssertionError(f"options frame: B4 modes {tally}")
    if o_launches["intersect_morton"] < (ocfg.bounces + 1) * (frames
                                                              + updates):
        raise AssertionError(f"options frame: B1 launched "
                             f"{o_launches['intersect_morton']} times")
    for name in ("intersect_morton", "occlusion_morton",
                 "initial_light_candidates", "reproject_packed",
                 "intersect_brute"):
        launches[f"{name}@options"] = o_launches[name]

    ncfg = pipeline.restir_frame_config(accel_mode="none")
    seen = capture_options_inputs(bench, ik, rk, rp, ncfg, device=dev)
    n_fields, n_closest = check_accel_none_kernels(ik, seen)
    fields.update(n_fields)
    del seen
    n_launches, frames, _ = run_options_frame(
        bench, backend, rp, smi, 2, dev, ncfg, "accel none frame")
    expect = {"intersect_morton": 0, "occlusion_morton": 0,
              "initial_light_candidates": frames,
              "reproject_packed": frames,
              "intersect_brute": (n_closest + 3) * frames}
    for name, count in expect.items():
        if n_launches[name] != count:
            raise AssertionError(f"accel none frame: {name} launched "
                                 f"{n_launches[name]} times in {frames} "
                                 f"frames, expected {count}")
    launches["intersect_brute@accel_none"] = n_closest * frames
    launches["intersect_brute@accel_none_any"] = 3 * frames
    check_options_small(pipeline, bench, sharc_mod, myscene)
    log(f"options: phase 20 took {time.perf_counter() - t0:.1f} s")

    # 21. the shell: the CLI, a live Session and a resume at the
    # reference's GraphicsSettings() (1080p, SR Auto) ----------------------
    t0 = time.perf_counter()
    run_shell(backend, bench, smi, dev)
    log(f"shell: phase 21 took {time.perf_counter() - t0:.1f} s")

    # 22. the banded frame: one NCCL rank, the dry run, two gloo ranks on
    # the one card ------------------------------------------------------------
    t0 = time.perf_counter()
    b_fields, b_launches = run_banded(backend, smi, dev)
    fields.update(b_fields)
    launches.update(b_launches)
    log(f"banded: phase 22 took {time.perf_counter() - t0:.1f} s")

    # 23. the reference's bench record through the port's CLI -------------
    t0 = time.perf_counter()
    run_record(bench, smi)
    log(f"record: phase 23 took {time.perf_counter() - t0:.1f} s")

    # 24. the reference's other sphere-accel routes: the MXU opt-in (B12a,
    # B12b) and the clustered accel (B13) ---------------------------------
    t0 = time.perf_counter()
    m_fields, m_launches, morton_img = run_mxu_route(
        bench, backend, clusters, ik, smi, dev, primary)
    c_fields, c_launches = run_clustered_route(
        bench, backend, clusters, ik, smi, dev, primary, morton_img)
    fields.update(m_fields, **c_fields)
    launches.update(m_launches, **c_launches)
    del morton_img
    log(f"routes: phase 24 took {time.perf_counter() - t0:.1f} s")

    # 25. the compiled frame: the default and headline frames as CUDA graph
    # replays against eager frames --------------------------------------
    t0 = time.perf_counter()
    launches.update(run_graphs(backend, bench, pathtrace, smi, dev))
    log(f"graphs: phase 25 took {time.perf_counter() - t0:.1f} s")

    # 26. the compiled mesh frames: the mesh trace, the all-mesh ReSTIR
    # frame and the all-mesh pipeline as CUDA graph replays against eager
    # frames ---------------------------------------------------------------
    t0 = time.perf_counter()
    launches.update(run_mesh_graphs(backend, bench, pathtrace, trimesh, smi,
                                    dev))
    log(f"mesh graphs: phase 26 took {time.perf_counter() - t0:.1f} s")

    # 27. the compiled frame for the rest of the one-device frames: the
    # textured, options and accel-none frames, the MXU route at each
    # precision and the clustered headline frame ---------------------------
    t0 = time.perf_counter()
    launches.update(run_route_graphs(backend, bench, clusters, ik, pathtrace,
                                     smi, dev))
    log(f"route graphs: phase 27 took {time.perf_counter() - t0:.1f} s")

    # 28. the sharded graph frame: one NCCL rank, the dry run and the
    # banded mesh trace as graphs, gloo refused ---------------------------
    t0 = time.perf_counter()
    launches.update(run_banded_graphs(backend, bench, pathtrace, smi, dev))
    log(f"banded graphs: phase 28 took {time.perf_counter() - t0:.1f} s")

    rows = {
        "intersect_morton": ("drts_tpu_torch/csrc/intersect.cu",
                             "drts_tpu/ops/intersect_pallas.py:311"),
        "intersect_brute": ("drts_tpu_torch/csrc/intersect.cu",
                            "drts_tpu/ops/intersect_pallas.py:762"),
        "occlusion_morton": ("drts_tpu_torch/csrc/intersect.cu",
                             "drts_tpu/ops/intersect_pallas.py:509"),
        "initial_light_candidates": ("drts_tpu_torch/csrc/restir.cu",
                                     "drts_tpu/ops/restir_pallas.py:289"),
        "reproject_packed": ("drts_tpu_torch/csrc/reproject.cu",
                             "drts_tpu/ops/reproject_pallas.py:206"),
        "bound_scan": ("drts_tpu_torch/csrc/trimesh.cu",
                       "drts_tpu/ops/trimesh_pallas.py:646"),
        "shared_blas_sweep": ("drts_tpu_torch/csrc/trimesh.cu",
                              "drts_tpu/ops/trimesh_pallas.py:839"),
        "intersect_mesh_instances": ("drts_tpu_torch/csrc/trimesh.cu",
                                     "drts_tpu/ops/trimesh_pallas.py:315"),
        "intersect_brute@mesh": ("drts_tpu_torch/csrc/intersect.cu",
                                 "drts_tpu/ops/intersect_pallas.py:762"),
        "shared_blas_any": ("drts_tpu_torch/csrc/trimesh.cu",
                            "drts_tpu/ops/trimesh_pallas.py:973"),
        "intersect_mesh_instances_any": (
            "drts_tpu_torch/csrc/trimesh.cu",
            "drts_tpu/ops/trimesh_pallas.py:545"),
        "intersect_mesh_instances_any@backstop": (
            "drts_tpu_torch/csrc/trimesh.cu",
            "drts_tpu/ops/trimesh_pallas.py:545"),
        "bound_scan@mesh_restir": ("drts_tpu_torch/csrc/trimesh.cu",
                                   "drts_tpu/ops/trimesh_pallas.py:646"),
        "intersect_brute@mesh_restir": (
            "drts_tpu_torch/csrc/intersect.cu",
            "drts_tpu/ops/intersect_pallas.py:762"),
        "cand_fused@mesh_fused": ("drts_tpu_torch/csrc/trimesh.cu",
                                  "drts_tpu/ops/trimesh_pallas.py:1345"),
        "intersect_morton@default": ("drts_tpu_torch/csrc/intersect.cu",
                                     "drts_tpu/ops/intersect_pallas.py:311"),
        "occlusion_morton@default": ("drts_tpu_torch/csrc/intersect.cu",
                                     "drts_tpu/ops/intersect_pallas.py:509"),
        "initial_light_candidates@default": (
            "drts_tpu_torch/csrc/restir.cu",
            "drts_tpu/ops/restir_pallas.py:289"),
        "reproject_packed@default": ("drts_tpu_torch/csrc/reproject.cu",
                                     "drts_tpu/ops/reproject_pallas.py:206"),
        "intersect_brute@default": ("drts_tpu_torch/csrc/intersect.cu",
                                    "drts_tpu/ops/intersect_pallas.py:762"),
        "reproject_packed@mesh_pipeline": (
            "drts_tpu_torch/csrc/reproject.cu",
            "drts_tpu/ops/reproject_pallas.py:206"),
        "bound_scan@mesh_pipeline": ("drts_tpu_torch/csrc/trimesh.cu",
                                     "drts_tpu/ops/trimesh_pallas.py:646"),
        "shared_blas_sweep@mesh_pipeline": (
            "drts_tpu_torch/csrc/trimesh.cu",
            "drts_tpu/ops/trimesh_pallas.py:839"),
        "intersect_mesh_instances@mesh_pipeline": (
            "drts_tpu_torch/csrc/trimesh.cu",
            "drts_tpu/ops/trimesh_pallas.py:315"),
        "shared_blas_any@mesh_pipeline": (
            "drts_tpu_torch/csrc/trimesh.cu",
            "drts_tpu/ops/trimesh_pallas.py:973"),
        "intersect_mesh_instances_any@mesh_pipeline": (
            "drts_tpu_torch/csrc/trimesh.cu",
            "drts_tpu/ops/trimesh_pallas.py:545"),
        "intersect_brute@mesh_pipeline": (
            "drts_tpu_torch/csrc/intersect.cu",
            "drts_tpu/ops/intersect_pallas.py:762"),
        "bound_scan@mesh_pipeline_any": (
            "drts_tpu_torch/csrc/trimesh.cu",
            "drts_tpu/ops/trimesh_pallas.py:646"),
        "intersect_brute@mesh_pipeline_any": (
            "drts_tpu_torch/csrc/intersect.cu",
            "drts_tpu/ops/intersect_pallas.py:762"),
        "intersect_brute@mesh_pipeline_lights": (
            "drts_tpu_torch/csrc/intersect.cu",
            "drts_tpu/ops/intersect_pallas.py:762"),
        "intersect_morton@textured": ("drts_tpu_torch/csrc/intersect.cu",
                                      "drts_tpu/ops/intersect_pallas.py:311"),
        "occlusion_morton@textured": ("drts_tpu_torch/csrc/intersect.cu",
                                      "drts_tpu/ops/intersect_pallas.py:509"),
        "reproject_packed@textured": ("drts_tpu_torch/csrc/reproject.cu",
                                      "drts_tpu/ops/reproject_pallas.py:206"),
        "bound_scan@textured": ("drts_tpu_torch/csrc/trimesh.cu",
                                "drts_tpu/ops/trimesh_pallas.py:646"),
        "shared_blas_sweep@textured": ("drts_tpu_torch/csrc/trimesh.cu",
                                       "drts_tpu/ops/trimesh_pallas.py:839"),
        "intersect_mesh_instances@textured": (
            "drts_tpu_torch/csrc/trimesh.cu",
            "drts_tpu/ops/trimesh_pallas.py:315"),
        "shared_blas_any@textured": ("drts_tpu_torch/csrc/trimesh.cu",
                                     "drts_tpu/ops/trimesh_pallas.py:973"),
        "intersect_mesh_instances_any@textured": (
            "drts_tpu_torch/csrc/trimesh.cu",
            "drts_tpu/ops/trimesh_pallas.py:545"),
        "intersect_brute@textured": ("drts_tpu_torch/csrc/intersect.cu",
                                     "drts_tpu/ops/intersect_pallas.py:762"),
        "bound_scan@textured_any": ("drts_tpu_torch/csrc/trimesh.cu",
                                    "drts_tpu/ops/trimesh_pallas.py:646"),
        "intersect_brute@textured_any": (
            "drts_tpu_torch/csrc/intersect.cu",
            "drts_tpu/ops/intersect_pallas.py:762"),
        "intersect_brute@textured_lights": (
            "drts_tpu_torch/csrc/intersect.cu",
            "drts_tpu/ops/intersect_pallas.py:762"),
        "intersect_morton@options": ("drts_tpu_torch/csrc/intersect.cu",
                                     "drts_tpu/ops/intersect_pallas.py:311"),
        "occlusion_morton@options": ("drts_tpu_torch/csrc/intersect.cu",
                                     "drts_tpu/ops/intersect_pallas.py:509"),
        "initial_light_candidates@options": (
            "drts_tpu_torch/csrc/restir.cu",
            "drts_tpu/ops/restir_pallas.py:289"),
        "reproject_packed@options": ("drts_tpu_torch/csrc/reproject.cu",
                                     "drts_tpu/ops/reproject_pallas.py:206"),
        "intersect_brute@options": ("drts_tpu_torch/csrc/intersect.cu",
                                    "drts_tpu/ops/intersect_pallas.py:762"),
        "intersect_brute@accel_none": ("drts_tpu_torch/csrc/intersect.cu",
                                       "drts_tpu/ops/intersect_pallas.py:762"),
        "intersect_brute@accel_none_any": (
            "drts_tpu_torch/csrc/intersect.cu",
            "drts_tpu/ops/intersect_pallas.py:762"),
        "intersect_morton@banded": ("drts_tpu_torch/csrc/intersect.cu",
                                    "drts_tpu/ops/intersect_pallas.py:311"),
        "occlusion_morton@banded": ("drts_tpu_torch/csrc/intersect.cu",
                                    "drts_tpu/ops/intersect_pallas.py:509"),
        "initial_light_candidates@banded": (
            "drts_tpu_torch/csrc/restir.cu",
            "drts_tpu/ops/restir_pallas.py:289"),
        "reproject_packed@banded": ("drts_tpu_torch/csrc/reproject.cu",
                                    "drts_tpu/ops/reproject_pallas.py:206"),
        "intersect_brute@banded": ("drts_tpu_torch/csrc/intersect.cu",
                                   "drts_tpu/ops/intersect_pallas.py:762"),
        "intersect_morton_mxu": ("drts_tpu_torch/csrc/intersect.cu",
                                 "drts_tpu/ops/intersect_pallas.py:408"),
        "occlusion_morton_mxu": ("drts_tpu_torch/csrc/intersect.cu",
                                 "drts_tpu/ops/intersect_pallas.py:597"),
        **{f"{name}@{prec}": ("drts_tpu_torch/csrc/intersect.cu",
                              f"drts_tpu/ops/intersect_pallas.py:{line}")
           for prec in MXU_OTHER_PRECS
           for name, line in (("intersect_morton_mxu", 408),
                              ("occlusion_morton_mxu", 597))},
        "intersect_clustered": ("drts_tpu_torch/csrc/intersect.cu",
                                "drts_tpu/ops/intersect_pallas.py:716"),
    }
    rows.update({f"{name}@graph": rows[name] for name in GRAPH_KERNELS})
    rows.update({f"{name}@mesh_graph": rows[reading]
                 for name, reading in MESH_GRAPH_READINGS.items()})
    rows.update({entry: rows[reading]
                 for entry, (_, reading) in ROUTE_GRAPH_READINGS.items()})
    rows.update({entry: rows[reading]
                 for entry, reading in BANDED_GRAPH_READINGS.items()})
    fields["intersect_morton"] = {
        "max_abs_err": max(k["max_abs_err"] for k in b1),
        "ms": b1[0]["ms"], "plain_ms": b1[0]["plain_ms"],
        "bound_ms": b1[0]["bound_ms"], "bound_by": b1[0]["bound_by"],
        "library_ms": None, "unculled_bound_ms": b1[0]["unculled_bound_ms"]}
    # The default frame's ReSTIR passes and primary rays are the ReSTIR
    # frame's: B1, B2, B3 and B11 keep the times of phases 2 and 5.
    for name in ("intersect_morton", "occlusion_morton",
                 "initial_light_candidates", "intersect_brute"):
        fields[f"{name}@default"] = fields[name]
    # The graph frame replays the default frame's kernels on its inputs:
    # its entries carry the @default readings (see the docstring).
    for name in GRAPH_KERNELS:
        fields[f"{name}@graph"] = fields[f"{name}@default"]
    # Likewise the mesh graph frames: the @mesh and @mesh_pipeline readings.
    for name, reading in MESH_GRAPH_READINGS.items():
        fields[f"{name}@mesh_graph"] = fields[reading]
    # And the frames of phase 27: the readings of their eager frames'
    # kernels on their own inputs (phases 2, 5, 19, 20 and 24).
    for entry, (_, reading) in ROUTE_GRAPH_READINGS.items():
        fields[entry] = fields[reading]
    # And phase 28's: the banded frame's (phase 22) and the mesh trace's
    # (phase 8) readings.
    for entry, reading in BANDED_GRAPH_READINGS.items():
        fields[entry] = fields[reading]
    kernels = []
    for name, (src, replaces) in rows.items():
        f = fields[name]
        if f["ms"] < f["bound_ms"]:
            raise AssertionError(f"{name}: measured {f['ms']!r} ms lies "
                                 f"under its bound of {f['bound_ms']!r} ms, "
                                 f"so the bound counts too much")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": f["max_abs_err"], "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": f["library_ms"],
            **{k: f[k] for k in ("unculled_bound_ms", "share_of_bound")
               if k in f}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch port's render and training paths (3DGS, 2DGS,
StopThePop, Mip-Splatting, MCMC, the depth, normal and ground
regularisers, the appearance slice, the density variants, Glossy and the
dynamic scenes), of its fit through the CLI, of 2DGS mesh extraction, of
serving and editing a trained scene (the web and in-training viewers,
the parsers, LPIPS and the tools) and of a city by partitions (the
partition tools and the level-of-detail renderer), of distributed
training and of the quality protocol and stage profile on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) with nvcc; exits nonzero, printing no
result, when torch.cuda.is_available() is False or the gsl_tpu_torch
package is not beside this script. Phases, each fatal on failure:

1. device and build: the card's name and power limit; the nine kernels
   built from gsl_tpu_torch/csrc/ with nvcc, one process per source, in
   parallel, and K3, K6, K7, K2s and K3s a second time without multiply-add
   contraction for the checks of phase 3.
2. scene: the bench scene of __graft_entry__._synthetic_state (numpy seed
   0, 1,000,000 Gaussians, SH degree 3) with shs_rest ~ 0.1 N(0, 1) so the
   higher SH bands run, saved as a PLY with the port's save_gaussian_ply.
3. kernels against their plain PyTorch versions at full width (1088x1920,
   fx = fy = 1600), at the bench pose (identity) and two orbit views:
   K1 expand must equal expand_plain bit for bit (keys, ids, counts) and
   give the same keys and ids when run twice;
   K2 forward must agree with rasterize_fwd_plain on i_stop at >= 99.9% of
   pixels, and on image and alpha within |d| <= 2e-4 + 1e-3 |ref| at all
   but 1e-4 of the values. The kernel contracts multiply-adds and the
   plain version does not, so they round differently; where a splat's
   alpha sits within rounding of the 1/255 skip or the 1e-4 stop, one of
   them composites that splat and the other does not, and the pixel moves
   by up to that splat's weight. At the bench pose (C = 3) and the first
   orbit view (C = 8), with seeded normal cotangents: K3 backward must
   agree with rasterize_bwd_plain within |d| <= 1e-4 max|ref| + 1e-3 |ref|
   at all but 1e-3 of the row values (the same flips move single rows, and
   T / (1 - alpha) walked backwards rounds differently with and without
   contraction), at all but 1e-5 of every column's values when built
   without contraction, and give the same rows when run twice; K4 reduce,
   on the kernel's rows, must give the same sums twice, equal bit for bit
   the float32 sums of each Gaussian's rows taken in slot order (the order
   K4 adds in), and agree with reduce_grads_plain (index_add_) within
   SUM_RTOL of the summed magnitudes everywhere (only the order of the
   float32 additions differs). A small scene through the whole renderer
   on the card must match the CPU renderer (the plain versions) on all
   but 1e-3 of the values, and so must the gradients of a scalar loss for
   all six parameter tensors.
   The surfel (2DGS) kernels, on the same scene with 2-column scales and
   C = 6 channels (rgb + view-space normal) at the bench pose and the first
   orbit view, and once each with C = 3 and C = 9: K5 surfel expand must
   equal surfel_expand_plain bit for bit and give the same keys and ids
   when run twice; K6 surfel forward must agree
   with rasterize_surfels_fwd_plain on i_stop at >= 99.9% of pixels and on
   the channels, T, sum w depth, distortion, A, M1 and M2 within K2's
   tolerance at all but 1e-4 of the values, and on the median depth at all
   but 1e-3 (a pair counts when alpha >= 1/255, rho3d <= rho2d picks the
   branch, depth >= 0.2, and the median is the first T crossing of 0.5:
   compares on rounded values, and a flipped crossing moves a pixel by a
   whole depth step), and built without contraction on i_stop and every
   output value at all but 1e-5; K7 surfel backward, with seeded normal
   cotangents on the channels, alpha, depth and distortion, must agree with
   rasterize_surfels_bwd_plain like K3 and give the same rows twice; K4
   with no absolute columns sums K7's 13 + C columns as it sums K3's. A
   small surfel scene through SurfelRenderer on the card must match the
   CPU on all seven outputs, and the gradients of a loss with the
   distortion and normal-consistency terms on all six parameter tensors.
   The StopThePop kernels, at the bench pose (C = 3) and the first orbit
   view (C = 8), and K1 also at the second orbit view: K1 with stp_resort
   must equal expand_plain bit for bit and give the same output twice;
   K2s must leave i_stop at NEVER_STOPPED everywhere and agree with
   rasterize_fwd_stp_plain on image and alpha within K2's tolerance at all
   but 1e-4 of the values (two slots of a window whose depths at a pixel
   differ by a rounding may swap between the contracted kernel and the
   plain version, and move the pixel by up to one weight; the share is
   printed), and at all but 1e-5 when built without contraction; K3s, on
   the forward's checkpoints with seeded cotangents, must agree with
   rasterize_bwd_stp_plain column by column like K3 (>= 0.99999 of every
   column when built without contraction) and give the same rows twice; K4
   sums K3s's rows as it sums K3's. A small scene through
   TileRenderer(stp_resort=True), card against CPU: every output and all
   six gradients. A tile of 64 near-opaque Gaussians whose T_final
   underflows to 0: image and gradients finite and equal to the CPU's.
   For K1, K4 (in both row layouts), K3, K3s and K7 (the backward
   kernels of csrc/warp_reduce.cuh's transposed sums) and K6 it also
   prints registers, local (spill) bytes, shared bytes and resident blocks
   per SM as the card's runtime reports them, and for the three backward
   kernels the count of (slot, warp)s, 32 pixels of a tile, in which some
   pixel composites the slot: where the kernels sum a row over a warp (the
   plain versions count them).
4. main path: GaussianModelLoader.load(ply) -> ViewerRenderer -> orbit
   frames at 1088x1920 in rgb, then one frame with alpha, exp_depth,
   inverse_depth, normal and hard_inverse_depth (8 composited channels).
   Outputs must be finite, mean alpha above 0, and both kernels' launch
   counters, zeroed just before, above 0. Then one viewer frame for each
   output type. Prints ms per frame, per-stage times from CUDA events,
   and peak memory.
5. training main path: the 1M scene -> Trainer.setup at capacity 1M ->
   targets rendered once from the unperturbed scene at three views -> 20
   train_steps from a seeded perturbation of means, colours and opacities
   (SH degree warm-up shortened so degree 3 runs from step 6), each
   followed by maybe_density_ops as the fit loop calls it; at step 20 one
   density_step (clone + split + prune; the free slots run out, so
   grow_state doubles the capacity and the pass is redone), then more
   steps at the grown capacity and one opacity_reset_step. Fatal unless
   every loss is finite, the mean loss of steps 16-20 is below that of
   steps 1-5, every parameter is finite, the alive count changed at the
   densify and all four kernels' launch counters, zeroed just before, are
   above 0. Prints ms per step, the stage split from CUDA events, the ms
   of the density step and peak memory.
6. 2DGS main path: the scene as 1M surfels (scales[:, :2]) ->
   SurfelRenderer through ViewerRenderer, one orbit frame for each of its
   seven outputs at 1088x1920; then GS2DTrainer.setup at capacity 1M and
   train_steps with the normal-consistency and distortion losses on from
   the first step, each followed by maybe_density_ops, with one densify
   that splits surfels (2-column scales; the capacity grows to 2M), and
   steps after it. Fatal unless the outputs and losses are finite, the
   loss falls, every parameter is finite, surfels were split and K5, K6
   (serving) and K5, K6, K7, K4 (training) were launched, their counters
   zeroed just before each of the two runs.
7. StopThePop main path, at full width: the loader's state and SH degree
   -> ViewerRenderer over TileRendererConfig(stp_resort=True).instantiate()
   (the renderer of gsl_tpu/configs/stp.yaml; the loader itself has no
   switch for it in either package): orbit frames in rgb, one frame with
   all outputs, one viewer frame per output type. Then Trainer.setup at
   capacity 1M over the same renderer config: 12 train_steps with
   maybe_density_ops as phase 5 runs them, a densify at step 12 that grows
   the capacity to 2M, and 3 steps after it (phase 5 takes 20 + 6 and an
   opacity reset; the cut is in depth only). Fatal unless outputs, losses
   and parameters are finite, the mean loss of steps 10-12 is below that of
   steps 1-3, and K1, K2s (serving) and K1, K2s, K3s, K4 (training) were
   launched and no kernel of another path was, the counters zeroed just
   before each run. Prints ms per frame and per step, the stage split, peak
   memory, and the same numbers of phases 4 and 5 beside them.
8. fit main path, through the CLI: 24 views of the bench scene rendered by
   the port at 1088x1920 (the bench pose, then an orbit around TARGET)
   written as images/*.png, and sparse/0/{cameras,images,points3D}.bin
   written by the port's write_model_bin, with 100,000 of the bench means
   and their DC colours as the SfM points. Then
   gsl_tpu_torch.cli.main(["fit", "--config",
   "gsl_tpu_torch/configs/colmap.yaml", ...]) for 300 steps with
   densify_from_iter=100 and densification_interval=100 (every other
   field at the preset's value), and again to 400 steps, which must resume
   at 301; then "validate", and GaussianModelLoader.load on the run, which
   must pick the step-400 checkpoint and render a frame; then 100-step fits
   of gs2d.yaml and stp.yaml on the same data. Each command runs with the
   launch counters zeroed just before: the fits must launch every kernel
   of their path (K1-K4; K5-K7 and K4; K1, K2s, K3s and K4) and no other.
   Fatal on a non-finite loss, a val PSNR at step 400 not above the
   initial cloud's, or a missing checkpoint, PLY or CSV. Prints ms per
   step in each log window (and the median over the windows after each
   run's first), the share of wall time spent waiting on next(loader), ms
   per densify and the rows it cloned, split and pruned, the Gaussian count
   per window, peak memory, the val PSNR
   of the initial cloud and at steps 300 and 400, and each fit's launches.
9. Mip-Splatting and MCMC through K1-K4. (a) At full width, on the bench
   scene: compute_3d_filter over phase 8's 24 cameras (timed); 5 rgb
   frames through ViewerRenderer over MipSplattingRenderer (K1 and K2
   5 times each, nothing else) and the frame's stage ms; then
   Trainer(model=MipSplattingConfig, renderer=MipSplattingRendererConfig)
   at capacity 1M, 10 train_steps from the perturbed scene with the
   filter recomputed after step 5. MCMC: 5% of the rows (seeded) at
   opacity 0.001, Trainer with MCMCMetricsConfig (opacity and scale
   regularisers) and MCMCDensityControllerConfig(cap_max=2,000,000) at
   capacity 1M: 10 train_steps, each followed by the position noise of
   MCMCDensityHook at the step's means learning rate; then one
   relocation and growth round (the hook's density_round: the capacity
   grows to 2,097,152 first), run twice from one generator state, which
   must give identical parameters, moments and alive masks, with exactly
   the 50,000 dead rows relocated and alive 1,000,000 -> 1,050,000; then
   2 steps at the grown capacity. Each step must launch K1-K4 once each
   and no other kernel (counters zeroed before it), the noise, the filter
   and the round none; losses and parameters finite. (b) Through the CLI
   on phase 8's scene (colmap.yaml plus the variant's preset, log every 50
   steps): mip_splatting.yaml for 200 steps (densify from 100 every 100,
   the filter recomputed at step 100), resumed to 300, which must say
   "continuing at 201" and keep the checkpoint's filter_3d on its alive
   rows (different from the initial cloud's); mcmc.yaml for 200 steps
   (relocation from 100 every 50); absgrad.yaml for 100 steps (densify
   from 50 every 50). Each must launch K1-K4 and no other kernel, give
   finite losses, run its number of densify rounds and end with a val
   PSNR above its initial cloud's. Prints the same numbers as phase 8's
   fits, MCMC rounds as dead relocated and added rows.

10. geometry: the depth, normal and ground regularisers and 2DGS mesh
   extraction. (a) On the bench scene: K1-K4 against their plain versions
   at the bench pose, as phase 3 holds them, at C = 1 (the hard inverse
   depth, every splat opaque), C = 4 (rgb + inverse depth) and C = 7 (rgb
   + depth + normal), K2 and K3 timed there; then from phase 5's perturbed
   scene at capacity 1M, 10 train_steps each of DepthTrainer with
   hard_inverse_depth and with inverse_depth (the target: the scene's own
   hard inverse depth at the view), and of Trainer with NormalRegPlugin and
   with GroundRegPlugin (plane z = 0). Each step must launch K1-K4 twice
   (hard inverse depth) or once and nothing else; losses, terms and
   parameters finite; the depth loss at step 10 below step 1's. (b) On
   phase 8's scene: estimated_depths/view_i.npy as the port's rendered
   inverse depth through d = (inv - b) / a, a = 2, b = -0.05; then
   get_depth_scales.main, whose recovered a and b are printed, and its
   solve over the SfM points each map sees at their own depth, which must
   give a within 2% and b within 0.01 in every view (phase 8's SfM cloud is
   a volume, most of whose points are hidden in any view); the scales file
   then holds the known affine. Fits through the CLI: colmap.yaml +
   depth_regularization.yaml for 200 steps, resumed to 300 (must continue
   at 201; every logged step must have had a map, and the depth term must
   fall from the first logged step to the last), normal_reg.yaml,
   ground_reg.yaml and scale_reg.yaml for 100 steps each; each launches
   K1-K4 and nothing else and must end above its initial cloud's val PSNR.
   Prints what phase 9 (b) prints and the launches a step. (c)
   gs2d_mesh_extraction.main on phase 8's gs2d.yaml run at resolution 256
   with --expected-depth: K5 and K6 once a view and nothing else; a PLY
   with vertices and faces, finite. Prints the ms per view of the render
   and of integrate, the ms of extract_mesh (marching tetrahedra), the
   counts, the share of edges two faces share, and the peak memory.
11. appearance: (a) from phase 5's perturbed scene at capacity 1M with 64
   appearance features a Gaussian (N(0, 0.02), seeded), warm-up 0, 1024
   appearance ids, the three views given ids 0-2: 10 steps each of
   AppearanceTrainer (embedding 32, 3 layers of 64), with the SWAG opacity
   head, VisibilityMapAppearanceTrainer with dense grids and with the
   hash grid (4 levels from 16, transient embedding 16, tables of 2^19),
   Trainer with the bilateral-grid and the exposure processors (1024
   images) and GradAccTrainer with k = 5 (it must apply on steps 5 and 10
   only). Each step must launch K1-K4 once and nothing else; losses and
   parameters finite; each network must have taken 10 updates and moved,
   and a processor must have moved the three trained images' parameters
   and no other's. Once, before the SWAG steps, K1-K4 are held against
   their plain versions at the bench pose on the SWAG path's inputs (the
   network's colours, opacities raised by its offset) as phase 10 holds
   them. Prints ms per step beside phase 5's plain step, the loss at the
   first and last step and the peak memory. (b) On phase 8's scene through
   the CLI, each warm-up set to 100 in Python (no config key reaches it):
   colmap.yaml + appearance_embedding.yaml over the PhotoTourism split of
   a written scene.tsv (views 0, 8 and 16 to test, 21 to train) for 200
   steps, whose checkpoint must bring back the network, its Adam and the
   feature rows bit for bit and whose embedding rows of the test views
   must stay untrained, resumed to 300 (must continue at 201, with 201
   network updates at the end); appearance_visibility_map_hash.yaml for
   100 steps at capacity 524,288 = 2^19, where every densify must leave
   the hash tables and both networks' Adam states as they were; swag.yaml,
   bilagrid.yaml, exposure.yaml and grad_acc.yaml for 100 steps each
   (each above the initial cloud's val PSNR; a processor's parameters for
   the 24 train images). Each launches K1-K4 and nothing else. Prints what
   phase 9 (b) prints, beside phase 8's colmap.yaml of the same run.
12. density variants: (a) phase 5's perturbed scene at capacity 1M, its
   three views, statistics from 3 vanilla steps: accumulate_blend_weights
   at the bench pose (K1-K4 once; Sum_i of it / 3 must equal the rendered
   alpha's sum within rtol 1e-4), K1-K4 held against their plain versions
   on Taming's pixel-weight cotangent as phase 10 holds them; at capacity
   2M, Taming's scores over the three views (K1, K2 once a view, K3, K4
   twice) and one round under a budget of the alive count + 50,000 (it
   must add rows and stay under it); one densify each of the static
   (its hook must return the state as it was), Revising (each clone and
   its copy at 1 - sqrt(1 - alpha)), no-culling-big-scale, H3DGS (its
   selection must be its score's), accurate-visibility and
   background-removal controllers (the rows outside phase 8's cameras'
   sphere must sit at raw opacity -15 and be pruned); 10 GNS steps in its
   regularisation phase through GNSHooks, a GNS densify (at most 50,000
   more) on the edge-weighted blend over the three views and a final
   prune that must leave exactly 900,000; a LightGaussian prune over the
   three views that must remove floor(0.6 n); 10 GlossyTrainer steps
   whose env map and metalness must move. Each step launches K1-K4 once
   and nothing else; losses and parameters finite. Prints the ms of each
   step beside phase 5's plain step, and of each score, densify and prune
   pass. (b) On phase 8's scene through the CLI (short schedules by
   overrides): revising.yaml and, by class_path, H3DGS, no-culling-big-
   scale, static (whose count must not change), background removal (from
   step 50) and accurate visibility, 100 steps each with one densify at
   100; taming.yaml with rounds at 200, 300 and 400, each at or under its
   point on the count curve; gns.yaml with a budget of 60,000, densifying
   at 200 and regularising from 300 to 500, fitted to 400 (over the
   budget) and resumed to 500 (must continue at 401 and end at or under
   the budget); light_gaussian.yaml pruning at 200 and 300 (floor(0.6 n)
   and floor(0.36 n) of the rows alive after the densify there);
   glossy.yaml for 150 steps (the env map's Adam at 150 steps). Each fit
   launches K1-K4 and nothing else and must end above the initial cloud's
   val PSNR. Prints what phase 9 (b) prints.
13. dynamic scenes: (a) phase 5's perturbed scene at capacity 1M, its
   three views at times drawn in [0, 1]: DeformTrainer with the MLP at
   gsl_tpu's defaults (8 x 256, skip at 4, frequencies 10 / 6) and with
   the HexPlane field at its defaults (resolutions 32 and 64, 16
   features, 64 neurons), 2 warm-up steps and 5 with the field each (AST
   noise from a card generator), and PVG with velocities N(0, 0.5^2), 5
   steps. Each step launches K1-K4 once and nothing else; losses and
   parameters finite; the field must take 5 updates and move a mean, the
   velocities must move. K1-K4 are held against their plain versions at
   the bench pose on each path's deformed or modulated inputs as phase 10
   holds them. Prints ms per step beside phase 5's plain step, the
   field's forward and backward ms (CUDA events), peak memory and, for
   HexPlane, the share of alive rows outside its fixed bounds of 1.5. (b)
   A Nerfies capture written from the bench scene as a PVG ground truth
   (the rows right of x = 1 vibrate and fade; phase 8's 24 poses at times
   i / 23, rendered by the port at 540x960 as rgb/2x of 1080x1920
   originals; scene scale 0.5 and a centre; 100,000 of the means as
   points.npy; views 4, 12 and 20 to val), parsed at downsample 2:
   deformable.yaml, gs4d.yaml (warm-up 50) and pvg.yaml, densifying from
   50 every 50, each fitted for 100 steps and resumed to 150 (must
   continue at 101; the field must have taken 101 updates). Each launches
   K1-K4 and nothing else and must end above the initial cloud's val
   PSNR (for the deform presets the canonical set's, as gsl_tpu
   validates). Prints what phase 9 (b) prints and, for the deform
   presets, the PSNR of the render deformed at each val view's own time.
14. SpotLess and the distillation stages, on the backward kernels' channel
   groups. (a) At the bench pose (1M, 1088x1920) with seeded normal
   feature channels at C = 32, 64 and 128, K1-K4 are held as phase 10
   holds them (K3 launching once per group of channels, each group's
   geometry columns added in group order; K4 on 8 + C columns), and K2,
   K3 at each group size of 8, 16, 32 and 36 and K4 are timed, with
   their bounds from this run's counts and their launches per call; K3s
   at C = 96 (past its largest group, 88) on the small STP scene and K7 at
   C = 64 (past 60) on the small surfel scene against their plain
   versions column by column, identical in two runs, and both timed by
   channel group (8 and their largest) at the bench pose. (b) The SpotLess
   step (an 800x800 mask MLP over 1280 synthesised SD features [1280,
   50, 50] float16 per view) at capacity 1M on phase 5's scene, 5 steps:
   ms per step beside phase 5's plain step, the mask mean, peak memory,
   K1-K4 once a step. Then a copy of phase 8's scene whose image names
   carry `clutter` (train) and `extra` (every eighth, val), with SD
   features for the train images: spotless.yaml fitted for 150 steps and
   resumed to 200, the specular reset at 120; it prints what phase 9 (b)
   prints. (c) At the bench scene (1M, 1088x1920): three steps each of
   Feature3DGS at C = 128 and with speedup (C = 64) against [64, 64, D]
   teacher maps, and of SegAny at C = 32 with 1024 sampled pixels under
   eight synthesised SAM masks: ms per step, peak memory, K2 / K3
   launches per step. Then `python -m gsl_tpu_torch.seganygs fit` and
   `python -m gsl_tpu_torch.feature3dgs fit [--speedup]` on phase 8's
   colmap.yaml run with SAM masks and [128, 64, 64] teacher maps
   synthesised at the parsers' names, 50 steps each: the loss at the
   first and last step, the files the root scripts write.
   K3s's and K7's bounds at C = 96 and 64 at the bench pose come from
   phase 3's counts of the same walks there (they do not depend on C).
15. serve and edit, on the existing kernels. (a) The web viewer
   (gsl_tpu_torch.viewer.Viewer) on the bench scene's PLY (1M, SH degree
   3) at 1088^2, bound to port 0 and driven over HTTP by urllib from this
   script: the page; /outputs equal to available_output_types(); /render
   for every output type resting (1088^2) and moving (544^2), each PNG
   equal to ViewerRenderer.get_outputs at the same pose and size, K1 and
   K2 launched and no other kernel; /transform with a rotation, a scale
   and a translation equal to transform_state applied directly;
   /edit/delete_box deleting as many as the host counts in the box;
   /measure finite; /path/add twice, /path/save, /path/render.gif of 30
   frames that decode (30 launches each), /path/clear. Then the same on
   phase 8's gs2d.yaml run through SurfelRenderer (K5, K6). Prints ms per
   rgb /render request (median of 5, the HTTP round trip with the PNG
   encode) beside get_outputs alone and the encode alone, ms of
   /transform, seconds of the GIF, peak memory and launches per request;
   four /render requests sent at once must peak no higher (within 1%)
   than the largest of the same poses requested one at a time, since the
   viewer renders under one lock (after a first round at once, which
   gives each server thread its cuBLAS workspace).
   (b) colmap.yaml on phase 8's scene for 100 steps through cli.main with
   --viewer --viewer_port 0 while a client polls /status and fetches new
   /frame JPEGs at the page's cadence, and the same 100 steps without the
   viewer (cuDNN deterministic for both): frames must arrive, the fit
   must stop its server, and every logged loss must be equal. Prints ms
   per step with and without the viewer and the frames served. (c) Phase
   8's 24 views written as an NSVF, an instant-ngp (scene box 8), a
   MatrixCity (no depth files) and a SiLVR capture, each fitted 50 steps
   through the CLI with blender.yaml and the parser's class_path: finite
   losses, K1-K4 only, val PSNR above the initial cloud's; prints ms per
   step and val PSNR. (d) LPIPS with a seeded random-weights file (the
   values show the path, not quality): phase 8's render against its
   image at 1088x1920 on the card and on the CPU within rtol 1e-4, its
   ms, and validate on phase 8's run writing a filled lpips column. (e)
   ckpt2ply, gaussian_transform, fuse_mip_filter and convert2splat on
   phase 8's colmap.yaml run on the card, each file read back by the
   port's readers (the exported means equal to the loader's, the .splat
   holding the run's means); prints seconds per tool.

16. the city-scale slice, on the existing kernels. (a) Four copies of the
   bench scene (4M rows, SH degree 3) 8 apart on a 2 x 2 grid in x and z,
   partitions.npz from build_partitions over 3 x 3 synthesised camera
   centres a copy (one copy a cell), each copy's PLY a partition's finest
   level, prune_partitions --mode opacity --percent 0.6 writing lod1;
   PartitionLoDRenderer(names [".", "lod1"], lod_distances [1.0],
   visibility_filter) over a 40-frame fly-over at 1088x1920 whose
   selection must change at least 3 times and reach all 4M rows; every
   frame finite with alpha, one K1 and one K2 a frame and no other
   kernel; then merge_partitions of the 4M, which must keep every row.
   Prints ms per frame with the selection unchanged, ms per re-assembly,
   rows per selection, peak memory, the merge's seconds. (b) The same
   copies as a COLMAP city: 12 views a copy on a ring around it at
   1088x1920, 100,000 of each copy's means as SfM points, and a copy of
   the model with two strays registered far off, of which
   sfm_outlier_detection must flag exactly the two; the native
   points3D.bin reader against the plain one (equal arrays, seconds);
   train_partitions --n-partitions 4 --max-steps 100 with colmap.yaml and
   fit.capacity_multiplier 1.0 as four concurrent --hosts 4 processes, one
   `cli fit` process a partition on the card, each of which must end
   TRAINED having launched K1-K4 and no other
   kernel (its fit_timing.json); prune_partitions --mode blend (K1-K4);
   finetune_partition of partition 0 from lod1 for 50 steps (K1-K4);
   merge_partitions; eval_scenes over one of the four runs (K1 + K2);
   meganerf2colmap of a Mega-NeRF layout of the same cameras, whose poses
   must come back within 1e-9; val_partition_lod --names . lod1
   --lod-distances 1 --visibility-filter on the val split (one K1 and one
   K2 a frame), whose mean PSNR must be above that of the initial clouds
   through the same renderer, and whose frames must be finite with alpha.
   Prints per partition its images, wall seconds and the
   seconds before its first step, ms per step and val PSNR; the blend
   prune's ms and kept rows; the LoD's PSNR and rows; the readers'
   seconds.
17. distributed training (gsl_tpu_torch.parallel): (a) the sharded step
   of make_mp_train_step on 4 ranks (dp 2 x mp 2) spawned on the one card,
   over gloo with the exchange staged through the host, at phase 5's
   perturbed 1M scene (capacity 1M, 500,000 rows a shard), SH degree 3,
   four views (the bench pose and three orbits) at 1088x1920, one a rank,
   with the compact_k the fit would probe: its first step's loss must
   equal the single-device mean loss of the port's Trainer over the same
   four cameras within 1e-5, and its gathered tap sums and Adam moments
   the Trainer's gradients summed over the four (n_dev times the mean
   loss's, as gsl_tpu applies) within rtol 5e-3 and an atol of 1e-4 of
   each field's own max |ref| (the first moments as g, the second as
   |g|), |g| / |mean-loss g| within 1e-3 of 4; every rank must launch K1,
   K2, K3 and K4 once a step and drop no splat in the exchange. Then one
   step from the same state on four views from inside the scene at the
   least top-K budget that drops no visible splat, which must be below the
   shard: held as the first step, against the Trainer over those views.
   Prints ms per step (host clock, synchronised, the median of
   10 steps after the first), the exchange's forward and backward ms with
   their host staging, exchange_bytes_per_step, peak memory per rank, and
   the same step at world 1 (dp 1 x mp 1, in this process) beside them.
   (b) phase 8's scene through `cli fit` with colmap.yaml +
   distributed.yaml and distributed: {dp: 2, mp: 2} (4 ranks spawned by
   the CLI), densifying every 25 steps, for 50 steps and then resumed to
   75: every rank must launch K1-K4 once a step and nothing else, the
   resume must continue at 51 and its mp_log.csv go on, `cli validate`
   must read the run's checkpoint and score above the initial cloud's
   PSNR; then distributed.yaml as shipped (a world of one on this card)
   for 10 steps. Prints ms per step of each log window, the seconds
   before the first step, each densify and re-balance, the mp_log.csv rows
   and the val PSNR.
18. the quality tools: (a) gsl_tpu_torch.tools.profile_stages at the bench
   scene (__graft_entry__._synthetic_state, 1M, SH degree 3, 1088x1920,
   the bench pose), each stage timed by CUDA events over 5 calls after
   one, printed beside phase 4's stage_times or phase 3's kernel time;
   it must launch K1-K4 and nothing else, and every stage time and e2e
   gradient must be finite. (b) gsl_tpu_torch.tools.quality_benchmark in
   process, cut in views and steps only (QUALITY_ARGV): a 1M SH-3
   teacher's 16 views at 512^2 (and at 256^2 for 2DGS) rendered through
   K1 and K2, a student from 20,000 random points through the vanilla
   schedule for 1,202 steps (one densify, at 600), a 50-step run,
   stp.yaml for 200 steps and gs2d.yaml for 100 at 256^2: every run's val
   PSNR must be above that of its initial cloud through the same
   renderer, its count positive, the report must hold its rows, and all
   nine kernels must be launched. Prints each run's PSNR, SSIM, count and
   seconds.

Bounds in the kernels line: the larger of bytes / 3.35 TB/s and
operations / 67 TFLOP/s (H100 SXM f32 without tensor cores). K1 moves 52
bytes per Gaussian and 12 per slot, and does ~40 operations per real slot
(the tile cull). K2 reads each Gaussian's mean, conic, opacity and C
channels and each sorted id once and writes C + 2 values per pixel; of the
(pixel, splat) pairs that this run's pixels visited up to their stop it
does 12 operations on each (the offsets, sigma and the compare with the
splat's cut), 5 more on each at or below the cut (the exponential, alpha
and its test; the plain version counts them) and 3 + 2C more on each
composited one (counted in csrc/rasterize_fwd.cu). K3 moves the forward's bytes plus one row of 6 + C
values per valid slot; it does 18 operations per (pixel, splat) pair
before the pixel's stop and 35 + 4C more per composited pair (counted in
csrc/rasterize_bwd.cu). K4 reads each valid row, 4 bytes per slot and 8
per Gaussian of indices, writes 8 + C values per Gaussian, and does one
addition per value read. K4's library_ms is one index_add_ of the rows
with the absolute columns attached. K5 moves 28 bytes per surfel and 12 per
slot. K6 reads 52 + 4C bytes per surfel and each sorted id once and writes
C + 8 values per pixel; it does 47 operations per visited (pixel, surfel)
pair and 26 + 2C more per composited pair. K7 moves those bytes, the
cotangents and one row of 13 + C values per valid slot, and does 48
operations per pair before the pixel's stop and 123 + 4C more per
composited pair (both counted in the kernels' sources). K1 with
stp_resort reads 8 more bytes per Gaussian. K2s and K3s have no stop, so
every pixel visits its tile's whole list: pairs = pixels x the tile's valid
slots. K2s does 12 operations per pair, 5 more per pair at or below the
cut, 9 + 2C more per composited pair and n_live^2 compares per (pixel,
window) whose n_live live entries are out of order, counted by the plain
version (csrc/rasterize_fwd_stp.cu). K3s repeats K2s's walk and is
charged what K2s is (12 + 5 at or below the cut + 9 + 2C a composited
pair), 35 + 4C more per composited pair, n_live^2 compares per such
window and 5 + 2C per live entry of it (csrc/rasterize_bwd_stp.cu), and
moves the checkpoints (64 bytes per sorted slot) on top of K3's bytes. A
kernel's `ms`, and a library call's, is the mean of 20 replays of one
wrapper call captured in a CUDA graph, between CUDA events: the host's
per-call cost would pace K1's 0.04 ms and K5's 0.03 ms kernels; the plain
versions read the device from the host and are timed by calls between
CUDA events. In the kernels line, `launches` is a kernel's count
on the training path of its own model (K1-K4: phase 5; K5-K7: phase
6; K2s, K3s: phase 7) and `serving_launches` on the serving path; K4 also
carries its surfel-layout numbers under `surfel_*` keys, and K1 its
StopThePop numbers (phase 7's counts) under `stp_*` keys; every kernel
carries its phase-18 counts under `profile_launches` and
`quality_launches`. All nine kernels (K4 with R = 9 and, under
`surfel_attributes`, R = 19) carry their `attributes` as the card's
runtime reports them.

The last line is {"ok": true, "device": {...}}.
"""
import concurrent.futures
import contextlib
import csv
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
from PIL import Image

from gsl_tpu_torch import cli
from gsl_tpu_torch.data.cameras import make_camera, stack_cameras
from gsl_tpu_torch.data.dataparsers.nerfies import NerfiesDataParserConfig
from gsl_tpu_torch.data.dataset import CachedDataset, image_to_float
from gsl_tpu_torch.data.colmap_io import (ColmapCamera, ColmapImage,
                                          ColmapModel, qvec_to_rotmat,
                                          read_model, read_points3d_bin,
                                          read_points3d_bin_plain,
                                          rotmat_to_qvec, write_model_bin)
from gsl_tpu_torch.ops import cuda_build
from gsl_tpu_torch.parallel import gaussian_sharded as GS
from gsl_tpu_torch.parallel.fit_distributed import (auto_compact_k,
                                                    max_visible_per_shard)
from gsl_tpu_torch.parallel.launch import spawn
from gsl_tpu_torch.ops import lpips as lpips_module
from gsl_tpu_torch.ops import rasterize as R
from gsl_tpu_torch.ops import rasterize_stp as STP
from gsl_tpu_torch.ops import surfel_rasterize as SR
from gsl_tpu_torch.ops.projection import Projections, project_gaussians
from gsl_tpu_torch.ops.sh import sh_to_rgb
from gsl_tpu_torch.ops.surfel import project_surfels
from gsl_tpu_torch.ops.transforms import normalize_quat, quat_to_rotmat
from gsl_tpu_torch.models.gaussian import (PARAM_FIELDS, GaussianParams,
                                           GaussianState,
                                           VanillaGaussianConfig,
                                           inverse_sigmoid)
from gsl_tpu_torch.models.appearance import AppearanceFeatureGaussianConfig
from gsl_tpu_torch.models.gaussian_2d import Gaussian2DConfig
from gsl_tpu_torch.models.mip_splatting import (MipSplattingConfig,
                                                compute_3d_filter)
from gsl_tpu_torch.models.pvg import PVGConfig, PVGRendererConfig
from gsl_tpu_torch.renderers.mip_splatting_renderer import \
    MipSplattingRendererConfig
from gsl_tpu_torch.renderers.partition_lod import (PartitionLoDConfig,
                                                   PartitionLoDRenderer)
from gsl_tpu_torch.renderers.surfel_renderer import SurfelRendererConfig
from gsl_tpu_torch.renderers.tile_renderer import TileRendererConfig
from gsl_tpu_torch.tools import (ckpt2ply, convert2splat, eval_scenes,
                                 finetune_partition, fuse_mip_filter,
                                 gaussian_transform, get_depth_scales,
                                 gs2d_mesh_extraction, meganerf2colmap,
                                 merge_partitions, profile_stages,
                                 prune_partitions, quality_benchmark,
                                 sfm_outlier_detection, train_partitions,
                                 val_partition_lod)
from gsl_tpu_torch.training import fit as fit_module
from gsl_tpu_torch.training.appearance_trainer import (
    AppearanceOptimizationConfig, AppearanceTrainer, leaves_of)
from gsl_tpu_torch import feature3dgs as feature3dgs_main
from gsl_tpu_torch import seganygs as seganygs_main
from gsl_tpu_torch.data.colmap_io import read_model
from gsl_tpu_torch.training.deform_trainer import DeformTrainer
from gsl_tpu_torch.training.feature3dgs import (Feature3DGSConfig,
                                                Feature3DGSTrainer)
from gsl_tpu_torch.training.segany import SegAnyConfig, SegAnyTrainer
from gsl_tpu_torch.training.spotless import (SpotLessMetricsConfig,
                                             init_spotless_state,
                                             spotless_step)
from gsl_tpu_torch.training.density import (
    AccurateVisibilityFilterDensityControllerConfig,
    BackgroundRemovalDensityControllerConfig, H3DGSDensityControllerConfig,
    NoCullingBigScaleDensityControllerConfig,
    RevisingDensityControllerConfig, StaticDensityControllerConfig,
    VanillaDensityControllerConfig, background_removal_step,
    densify_and_prune, densify_masks, mean_grads)
from gsl_tpu_torch.training.depth_trainer import (DepthMetricsConfig,
                                                  DepthTrainer)
from gsl_tpu_torch.training.plugins import (GroundRegPluginConfig,
                                            NormalRegPluginConfig)
from gsl_tpu_torch.training.fit import FitConfig, _init_gaussians, validate
from gsl_tpu_torch.training.glossy_trainer import GlossyTrainer
from gsl_tpu_torch.training.gns import (GNSController,
                                        GNSDensityControllerConfig,
                                        edge_weighted_blend_scores,
                                        final_budget_prune, gns_densify)
from gsl_tpu_torch.training.gs2d import GS2DMetricsConfig, GS2DTrainer
from gsl_tpu_torch.training.hooks import (FitContext, GNSHooks,
                                          MCMCDensityHook, StaticDensityHook)
from gsl_tpu_torch.training.light_gaussian import (accumulate_blend_weights,
                                                   bias_render,
                                                   prune_by_importance)
from gsl_tpu_torch.training.mcmc import (MCMCDensityControllerConfig,
                                         dead_mask, grow_target)
from gsl_tpu_torch.training.metrics import (MCMCMetricsConfig, psnr,
                                           train_loss)
from gsl_tpu_torch.training.opt_strategies import (GradAccConfig,
                                                   GradAccTrainer)
from gsl_tpu_torch.training.output_processors import (BilateralGridConfig,
                                                      ExposureConfig)
from gsl_tpu_torch.training.taming import (
    ScoreCoefficients, Taming3DGSDensityControllerConfig,
    compute_gaussian_scores, get_edges, pixel_weights, taming_densify)
from gsl_tpu_torch.training.trainer import Trainer, TrainerConfig
from gsl_tpu_torch.training.visibility_map_trainer import \
    VisibilityMapAppearanceTrainer
from gsl_tpu_torch.utils.checkpoint import load_checkpoint
from gsl_tpu_torch.utils.convert import (state_from_jax_arrays,
                                         state_from_raw_arrays)
from gsl_tpu_torch.utils.device import float32_math
from gsl_tpu_torch.utils.gaussian_model_loader import GaussianModelLoader
from gsl_tpu_torch.utils.partitioning import (PartitionedScene,
                                              build_partitions)
from gsl_tpu_torch.utils.ply import load_gaussian_ply, save_gaussian_ply
from gsl_tpu_torch.viewer.camera_path import orbit_c2w
from gsl_tpu_torch.viewer.panels import transform_state
from gsl_tpu_torch.viewer.renderer import ViewerRenderer
from gsl_tpu_torch.viewer.training_viewer import TrainingViewer
from gsl_tpu_torch.viewer.viewer import Viewer, png_bytes

H, W, FOCAL = 1088, 1920, 1600.0
N_GAUSSIANS = 1_000_000
SH_DEGREE = 3
TILE = 16
STARTED = time.perf_counter()
# the scenes' PNGs uncompressed: the fits' first epochs wait on decoding
# them, three times faster than at level 1 (lossless either way)
PNG_LEVEL = 0
TARGET = np.array([0.0, 0.0, 5.0])    # middle of the scene's z range
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ATOL, RTOL, STOP_SHARE, OFF_SHARE = 2e-4, 1e-3, 0.999, 1e-4
# K3, K7: per column, GRAD_ATOL of the column's own scale (the 99th
# percentile of the reference's nonzero magnitudes) + GRAD_RTOL |ref|
GRAD_ATOL, GRAD_RTOL, GRAD_SHARE = 1e-4, 1e-3, 0.999
# K7's solve takes hx = px Tw - Tu and the cross product hx x hy, both
# differences of products some 1e3 times their result; the kernel contracts
# them to multiply-adds and the plain version does not, so more pairs round
# apart than in K3
SURFEL_GRAD_SHARE = 0.995
# ... and K7 built without contraction rounds as the plain version does;
# so do K2, K3 and K6, whose skip, stop and keep decisions are compares on
# the same values, and K2s and K3s, where a contracted d_p can swap two
# slots of a window
UNCONTRACTED_SHARE = 0.99999
UNCONTRACTED = ("rasterize_fwd", "rasterize_bwd", "surfel_fwd",
                "surfel_bwd", "rasterize_fwd_stp", "rasterize_bwd_stp")
# K4: of the sum of the magnitudes that went into each sum
SUM_RTOL = 1e-5
K3_COLUMNS = ("dmx", "dmy", "da", "db", "dc", "dop")
K7_COLUMNS = ("Tu0", "Tu1", "Tu2", "Tv0", "Tv1", "Tv2", "Tw0", "Tw1", "Tw2",
              "zc0", "zc1", "zc2", "op")
MEDIAN_OFF_SHARE = 1e-3                                  # K6's median depth
KERNELS = {"expand": R.expand, "rasterize_fwd": R.rasterize_fwd,
           "rasterize_bwd": R.rasterize_bwd, "reduce_grads": R.reduce_grads,
           "surfel_expand": SR.surfel_expand,
           "surfel_fwd": SR.rasterize_surfels_fwd,
           "surfel_bwd": SR.rasterize_surfels_bwd,
           "rasterize_fwd_stp": STP.rasterize_fwd_stp,
           "rasterize_bwd_stp": STP.rasterize_bwd_stp}
GAUSSIAN_KERNELS = ("expand", "rasterize_fwd", "rasterize_bwd",
                    "reduce_grads")
STP_KERNELS = ("expand", "rasterize_fwd_stp", "rasterize_bwd_stp",
               "reduce_grads")
SURFEL_KERNELS = ("surfel_expand", "surfel_fwd", "surfel_bwd",
                  "reduce_grads")
ALL_OUTPUTS = frozenset({"rgb", "alpha", "exp_depth", "inverse_depth",
                         "normal", "hard_inverse_depth"})


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    """Print `msg`; a phase's heading also gets the seconds since the
    script started."""
    if msg.startswith("== phase"):
        msg += f" [{time.perf_counter() - STARTED:.1f} s]"
    print(msg, flush=True)


def scene_arrays(n, seed=0):
    """__graft_entry__._synthetic_state's draws, in its order, then
    shs_rest."""
    rng = np.random.RandomState(seed)
    k_rest = (SH_DEGREE + 1) ** 2 - 1
    means = np.concatenate([rng.uniform(-2, 2, size=(n, 2)),
                            rng.uniform(2, 8, size=(n, 1))],
                           axis=-1).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(-6.5, -4.5, size=(n, 3)).astype(np.float32)
    opacities = rng.uniform(-1, 2, size=(n, 1)).astype(np.float32)
    shs_dc = rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.3
    shs_rest = rng.normal(size=(n, k_rest, 3)).astype(np.float32) * 0.1
    return dict(means=means, scales=scales, rotations=quats,
                opacities=opacities, shs_dc=shs_dc, shs_rest=shs_rest)


def camera(c2w, height=H, width=W, focal=FOCAL, device="cuda"):
    w2c = np.linalg.inv(c2w)
    return make_camera(R=w2c[:3, :3], T=w2c[:3, 3], fx=focal, fy=focal,
                       cx=width / 2, cy=height / 2, width=width,
                       height=height, device=device)


def views():
    return {"bench": np.eye(4),
            "orbit_yaw20": orbit_c2w(20.0, -10.0, 5.0, TARGET),
            "orbit_yaw-35": orbit_c2w(-35.0, 10.0, 5.0, TARGET)}


def cuda_ms(fn, iters, warmup=1):
    """Mean ms per call from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean ms per call of `fn` captured once in a CUDA graph and replayed
    `iters` times between CUDA events: the kernels' time without the host's
    per-call cost, which paces a wrapper whose kernel takes tens of
    microseconds (K1, K5). Every kernel's and library call's `ms` in the
    kernels line is timed so; the plain versions, which read the device
    from the host, with `cuda_ms`."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def channels_for(state, renderer, proj, cam, n_channels):
    """rgb (C=3), or rgb + depth + inverse depth + normal (C=8), as
    TileRenderer.forward composites them."""
    rgb = renderer.get_rgbs(state, cam, SH_DEGREE)
    if n_channels == 3:
        return rgb.contiguous()
    normals = quat_to_rotmat(state.get_rotations())[:, :, 2]
    d = proj.depths[:, None]
    return torch.cat([rgb, d, 1.0 / torch.clamp(d, min=1e-8), normals],
                     1).contiguous()


def compare_raster(name, got, want):
    """got/want: (out, T, i_stop). Returns (max abs err, stop share)."""
    share = float((got[2] == want[2]).float().mean())
    if share < STOP_SHARE:
        fail(f"{name}: i_stop agrees on {share:.5f} of pixels "
             f"< {STOP_SHARE}")
    err = max(off_share(f"{name} image", got[0], want[0], OFF_SHARE),
              off_share(f"{name} alpha", 1 - got[1], 1 - want[1],
                        OFF_SHARE))
    return err, share


def value_share(got, want):
    """The share of values within ATOL + RTOL |want|."""
    bad = (got - want).abs() > ATOL + RTOL * want.abs()
    return 1.0 - float(bad.float().mean())


def off_share(name, got, want, limit):
    """Fails unless all but `limit` of the values are finite and within
    ATOL + RTOL |want|. Returns the largest absolute difference."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    d = (got - want).abs()
    bad = d > ATOL + RTOL * want.abs()
    if float(bad.float().mean()) > limit:
        i = int(torch.argmax(d.flatten()))
        fail(f"{name}: differs beyond tolerance at {int(bad.sum())} of "
             f"{bad.numel()} values; worst {float(got.flatten()[i])} vs "
             f"{float(want.flatten()[i])}")
    return float(d.max())


def visited_pairs(i_stop, bounds, tiles_x):
    """(pixel, splat) pairs the forward visits: up to and including the
    stop, or the tile's whole range."""
    ys = torch.arange(H, device=i_stop.device)[:, None] // TILE
    xs = torch.arange(W, device=i_stop.device)[None, :] // TILE
    tile = ys * tiles_x + xs
    start, end = bounds[tile], bounds[tile + 1]
    stop = i_stop.to(torch.int64)
    last = torch.where(stop < R.NEVER_STOPPED, stop + 1, end)
    return int((last - start).sum())


def warp_steps(i_stop, bounds, tiles_x):
    """A forward kernel's warp walks its tile's list until all 32 of its
    pixels have stopped (K6). Returns the (warp, slot) steps, those in
    which some lane of the warp has already stopped (or lies outside the
    image), and the lane steps that idle in them."""
    height, width = i_stop.shape
    ys = torch.arange(height, device=i_stop.device)[:, None] // TILE
    xs = torch.arange(width, device=i_stop.device)[None, :] // TILE
    tile = ys * tiles_x + xs
    start, end = bounds[tile], bounds[tile + 1]
    stop = i_stop.to(torch.int64)
    visited = torch.where(stop < R.NEVER_STOPPED, stop + 1, end) - start
    lanes = R._image_to_tiles(visited[..., None], tiles_x,
                              -(-height // TILE), TILE)[..., 0]
    lanes = lanes.reshape(lanes.shape[0], -1, 32)
    most, least = lanes.max(-1).values, lanes.min(-1).values
    return {"warp_steps": int(most.sum()),
            "steps_with_stopped_lanes": int((most - least).sum()),
            "idle_lane_steps": int((most[..., None] - lanes).sum())}


def log_attributes(name, C, attrs):
    """A kernel's resources as the card's runtime reports them; C None for
    a kernel without channels."""
    tag = name if C is None else f"{name} C={C}"
    log(f"{tag} attributes: {attrs['registers']} registers, "
        f"{attrs['local_bytes']} local (spill) bytes per thread, "
        f"{attrs['shared_bytes']} dynamic shared bytes per block, "
        f"{attrs['blocks_per_sm']} resident blocks per SM")


def reset_launches():
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def read_launches():
    return {name: w.launches for name, w in KERNELS.items()}


def column_shares(name, got, want):
    """Per column of a backward kernel's rows [n, R]: (scale, share). The
    columns have different units, and a few near-degenerate rows reach
    magnitudes far above a column's typical one, so a column's scale is
    the 99th percentile of the reference's nonzero magnitudes, and its
    share is that of its values within GRAD_ATOL scale + GRAD_RTOL |ref|."""
    d = (got - want).abs()
    pairs = []
    for c in range(want.shape[1]):
        mag = want[:, c].abs()
        nonzero = mag[mag > 0]
        if nonzero.numel() == 0:
            fail(f"{name}: the reference's column {c} is all zero")
        k = max(1, math.ceil(0.99 * nonzero.numel()))
        scale = float(nonzero.kthvalue(k).values)
        bad = d[:, c] > GRAD_ATOL * scale + GRAD_RTOL * mag
        pairs.append((scale, 1.0 - float(bad.float().mean())))
    return pairs


def check_rows(name, got, want, geometry_columns, limit):
    """A backward kernel's rows against its plain version's: every column
    must agree at `limit` of its values (a flipped keep or stop decision
    changes a whole row). Returns (largest absolute difference, smallest
    share)."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite rows")
    n_ch = want.shape[1] - len(geometry_columns)
    columns = tuple(geometry_columns) + tuple(f"ch{i}" for i in range(n_ch))
    pairs = column_shares(name, got, want)
    log(f"{name}: column scale/share " + ", ".join(
        f"{col} {scale:.3g}/{share:.6f}"
        for col, (scale, share) in zip(columns, pairs)))
    for col, (scale, share) in zip(columns, pairs):
        if share < limit:
            fail(f"{name}: column {col} agrees with the plain version on "
                 f"{share:.6f} of its values < {limit} (column scale "
                 f"{scale:.4g})")
    return float((got - want).abs().max()), min(s for _, s in pairs)


def check_sums(name, summed, summed_p, rows, gids, n, n_abs):
    """K4's per-Gaussian sums against reduce_grads_plain's. The two add
    the same float32 rows in different orders, so each sum may differ by a
    rounding of what went into it: SUM_RTOL of the sum of those rows'
    magnitudes, nothing more. Returns the largest absolute difference."""
    into = R.reduce_grads_plain(rows.abs(), gids, n, n_abs=n_abs)
    sd = (summed - summed_p).abs()
    bad = ~(sd <= SUM_RTOL * into)
    if bool(bad.any()):
        i = int(torch.argmax((sd - SUM_RTOL * into).flatten()))
        fail(f"{name}: {int(bad.sum())} sums differ from "
             f"reduce_grads_plain beyond {SUM_RTOL} of their summed "
             f"magnitudes; worst {float(summed.flatten()[i])} vs "
             f"{float(summed_p.flatten()[i])} (magnitudes "
             f"{float(into.flatten()[i])})")
    return float(sd.max())


def check_reduce(name, red, rows, gids, n, n_abs):
    """K4 on one layout of rows: identical in two runs, equal to the sums in
    slot order bit for bit, and within SUM_RTOL of reduce_grads_plain's.
    Returns (sums, plain sums, largest absolute difference from the
    plain)."""
    summed = R.reduce_grads(*red, n_abs=n_abs)
    summed_p = R.reduce_grads_plain(rows, gids, n, n_abs=n_abs)
    torch.cuda.synchronize()
    if not torch.equal(summed, R.reduce_grads(*red, n_abs=n_abs)):
        fail(f"{name}: two runs gave different sums")
    exact = R.reduce_grads_slot_order(rows, *red[2:6], n_abs=n_abs)
    if not torch.equal(summed, exact):
        fail(f"{name}: {int((summed != exact).sum())} sums differ from "
             "the float32 sums in slot order")
    return summed, summed_p, check_sums(name, summed, summed_p, rows, gids,
                                        n, n_abs)


def check_backward(vname, C, bwd, isects, order, n, timed):
    """K3 and K4 against their plain versions; with `timed`, their times
    and bounds too. Returns a dict of what was measured."""
    gids, bounds = bwd[4], bwd[5]
    rows = R.rasterize_bwd(*bwd)
    again = R.rasterize_bwd(*bwd)
    stats = {}
    rows_p = R.rasterize_bwd_plain(*bwd, stats=stats)
    torch.cuda.synchronize()
    if not torch.equal(rows, again):
        fail(f"K3 {vname}: two runs gave different rows")
    bwd_err, share = check_rows(f"K3 {vname} C={C}", rows, rows_p,
                                K3_COLUMNS, GRAD_SHARE)
    _, ushare = check_rows(f"K3 {vname} C={C} built without contraction",
                           R.rasterize_bwd(*bwd, contract=False), rows_p,
                           K3_COLUMNS, UNCONTRACTED_SHARE)
    inv = R.invert_order(order)
    red = (rows, gids, isects.offsets, inv, bounds[-1:], n)
    summed, summed_p, reduce_err = check_reduce(f"K4 {vname} C={C}", red,
                                                rows, gids, n, 2)
    scale, sscale = float(rows_p.abs().max()), float(summed_p.abs().max())
    rec = {"bwd_err": bwd_err, "bwd_share": share,
           "bwd_scale": scale, "reduce_err": reduce_err,
           "reduce_scale": sscale,
           "composited_pairs": stats["composited_pairs"],
           "composited_slot_warps": stats["composited_slot_warps"]}
    log(f"K3 {vname} C={C}: every column agrees on >= {share:.6f} of its "
        f"values (>= {ushare:.7f} when built without contraction), max abs "
        f"err {rec['bwd_err']:.3e} (max |ref| {scale:.3e}); identical in "
        f"two runs. K4: identical in two runs, equal to the sums in slot "
        f"order, max abs err from index_add_ {rec['reduce_err']:.3e} (max "
        f"|ref| {sscale:.3e}); composited pairs {stats['composited_pairs']}; "
        f"(slot, warp)s with a composited pixel "
        f"{stats['composited_slot_warps']}")
    if not timed:
        return rec
    rec["bwd_attributes"] = R.rasterize_bwd_attributes(C, TILE)
    log_attributes("K3", C, rec["bwd_attributes"])
    rec["reduce_attributes"] = R.reduce_grads_attributes(6 + C, 2)
    log_attributes(f"K4 R={6 + C} n_abs=2", None, rec["reduce_attributes"])
    gids64 = gids.long()
    full = torch.cat([rows[:, :6], rows[:, :2].abs(), rows[:, 6:]], 1)
    out = torch.empty((n, full.shape[1]), device=rows.device)
    rec.update(
        bwd_ms=graph_ms(lambda: R.rasterize_bwd(*bwd), 20),
        bwd_plain_ms=cuda_ms(lambda: R.rasterize_bwd_plain(*bwd), 1,
                             warmup=0),
        invert_ms=graph_ms(lambda: R.invert_order(order), 20),
        reduce_ms=graph_ms(lambda: R.reduce_grads(*red), 20),
        reduce_plain_ms=cuda_ms(
            lambda: R.reduce_grads_plain(rows, gids, n), 5),
        reduce_library_ms=graph_ms(
            lambda: out.zero_().index_add_(0, gids64, full), 20))
    return rec


def phase_kernels(state, renderer):
    log("== phase 3: kernels against their plain versions, full width")
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    n_tiles = tiles_x * tiles_y
    n = state.capacity
    rec = {}
    for vi, (vname, c2w) in enumerate(views().items()):
        cam = camera(c2w)
        proj = project_gaussians(
            state.get_means(), state.get_scales(), state.get_rotations(),
            cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
        opac = renderer.get_opacities(state, cam, proj).contiguous()
        C = 3 if vi == 0 else 8
        ch = channels_for(state, renderer, proj, cam, C)
        m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
        depths = proj.depths.contiguous()
        isects = R.isect_encode(proj, H, W, TILE)
        args = (isects, m2d, con, opac, depths, tiles_x, tiles_y, TILE, True)
        keys_k, gids_k = R.expand(*args)
        keys_p, gids_p = R.expand_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(keys_k, keys_p) and torch.equal(gids_k, gids_p)):
            diff = int((keys_k != keys_p).sum())
            fail(f"K1 {vname}: kernel differs from expand_plain at {diff} "
                 "slots")
        if not all(torch.equal(a, b) for a, b in zip(
                (keys_k, gids_k), R.expand(*args))):
            fail(f"K1 {vname}: two runs gave different keys or ids")
        sk_k, gs_k, order = R.sort_slots(keys_k, gids_k)
        sk_p, gs_p, _ = R.sort_slots(keys_p, gids_p)
        if not (torch.equal(sk_k, sk_p) and torch.equal(gs_k, gs_p)):
            fail(f"K1 {vname}: sorted keys/ids differ from the plain "
                 "version's")
        n_valid = int((sk_k != R.INVALID_KEY).sum())
        n_valid_p = int((sk_p != R.INVALID_KEY).sum())
        if n_valid != n_valid_p:
            fail(f"K1 {vname}: valid counts {n_valid} != {n_valid_p}")
        culled = isects.n_isects - n_valid
        log(f"K1 {vname}: bit-identical, identical in two runs; slots "
            f"{isects.total} real {isects.n_isects} valid {n_valid} culled "
            f"{culled}")
        bounds = R.tile_bounds(sk_k, n_tiles)
        gids = gs_k[:n_valid].contiguous()
        fwd = (m2d, con, opac, ch, gids, bounds, H, W, TILE)
        got = R.rasterize_fwd(*fwd)
        again = R.rasterize_fwd(*fwd)
        fstats = {}
        want = R.rasterize_fwd_plain(*fwd, stats=fstats)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K2 {vname}: two runs gave different outputs")
        err, share = compare_raster(f"K2 {vname} C={C}", got, want)
        # the same source built without contraction rounds as the plain
        # version
        loose = R.rasterize_fwd(*fwd, contract=False)
        ustop = float((loose[2] == want[2]).float().mean())
        if ustop < UNCONTRACTED_SHARE:
            fail(f"K2 {vname} C={C} built without contraction: i_stop "
                 f"agrees on {ustop:.6f} of pixels < {UNCONTRACTED_SHARE}")
        off_share(f"K2 {vname} C={C} image, built without contraction",
                  loose[0], want[0], 1.0 - UNCONTRACTED_SHARE)
        off_share(f"K2 {vname} C={C} alpha, built without contraction",
                  1 - loose[1], 1 - want[1], 1.0 - UNCONTRACTED_SHARE)
        ushare = min(value_share(loose[0], want[0]),
                     value_share(loose[1], want[1]))
        log(f"K2 {vname} C={C}: i_stop agrees on {share:.6f}, max abs err "
            f"{err:.3e}; identical in two runs; built without contraction: "
            f"i_stop agrees on {ustop:.7f}, image and T within tolerance at "
            f">= {ushare:.7f} of their values")
        rec["fwd_err"] = max(rec.get("fwd_err", 0.0), err)
        if vi == 2:
            continue
        gen = torch.Generator(device="cuda").manual_seed(vi)
        g_out = torch.randn((H, W, C), generator=gen, device="cuda")
        g_alpha = torch.randn((H, W), generator=gen, device="cuda")
        bwd = (m2d, con, opac, ch, gids, bounds, g_out, g_alpha, got[1],
               got[2], TILE)
        brec = check_backward(vname, C, bwd, isects, order, n, vi == 0)
        for key in ("bwd_err", "reduce_err"):
            rec[key] = max(rec.get(key, 0.0), brec.pop(key))
        if vi != 0:
            continue
        rec.update(brec)
        # timings and bounds at the bench pose, C = 3 (the rgb main path)
        t = {
            "expand_ms": graph_ms(lambda: R.expand(*args), 20),
            "expand_plain_ms": cuda_ms(lambda: R.expand_plain(*args), 3),
            "sort_ms": graph_ms(lambda: R.sort_slots(keys_k, gids_k), 20),
            "ranges_ms": graph_ms(lambda: R.tile_bounds(sk_k, n_tiles), 20),
            "fwd_ms": graph_ms(lambda: R.rasterize_fwd(*fwd), 20),
            "fwd_plain_ms": cuda_ms(lambda: R.rasterize_fwd_plain(*fwd), 1,
                                    warmup=0),
        }
        pairs = visited_pairs(got[2], bounds, tiles_x)
        # the backward visits the positions before each pixel's stop
        pairs_bwd = pairs - int((got[2] < R.NEVER_STOPPED).sum())
        fwd_bytes = (n * (24 + 4 * C) + 4 * n_valid + 8 * (n_tiles + 1)
                     + H * W * (4 * C + 8))
        t["bwd_bound"] = bound(
            fwd_bytes + 4 * H * W + 4 * (6 + C) * n_valid,
            18 * pairs_bwd + (35 + 4 * C) * rec["composited_pairs"])
        t["reduce_bound"] = bound(
            4 * (6 + C) * n_valid + 4 * isects.total + 8 * n
            + 4 * (8 + C) * n, (8 + C) * n_valid)
        t["pairs_bwd"] = pairs_bwd
        t["expand_bound"] = bound(52 * n + 12 * isects.total,
                                  40 * isects.n_isects)
        # 12 operations a visited pair, 5 more at or below the cut, 3 + 2C
        # more a composited one (K3's plain version counts those)
        near = fstats["near_pairs"]
        t["fwd_bound"] = bound(
            fwd_bytes,
            12 * pairs + 5 * near + (3 + 2 * C) * rec["composited_pairs"])
        t.update(n_isects=isects.n_isects, slots=isects.total,
                 n_valid=n_valid, pairs=pairs, near_pairs=near)
        log("bench-pose timings " + json.dumps(t))
        t["fwd_attributes"] = R.rasterize_fwd_attributes(C, TILE)
        log_attributes("K2", C, t["fwd_attributes"])
        t["expand_attributes"] = R.expand_attributes()
        log_attributes("K1", None, t["expand_attributes"])
        rec.update(t)
    return rec


def check_stp_kernels(vname, C, state, renderer, cam, seed, timed):
    """K1 with stp_resort, K2s, K3s and K4 on K3s's rows against their
    plain versions at one view; with `timed`, their times and bounds."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    n_tiles = tiles_x * tiles_y
    n = state.capacity
    tag = f"{vname} C={C}"
    proj = project_gaussians(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    opac = renderer.get_opacities(state, cam, proj).contiguous()
    ch = channels_for(state, renderer, proj, cam, C)
    m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
    depths, kz = proj.depths.contiguous(), proj.depth_grads.contiguous()
    isects = R.isect_encode(proj, H, W, TILE)
    args = (isects, m2d, con, opac, depths, tiles_x, tiles_y, TILE, True,
            True, kz)
    keys_k, gids_k = R.expand(*args)
    keys_p, gids_p = R.expand_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(keys_k, keys_p) and torch.equal(gids_k, gids_p)):
        fail(f"K1 stp {tag}: kernel differs from expand_plain at "
             f"{int((keys_k != keys_p).sum())} slots")
    if not all(torch.equal(a, b) for a, b in zip((keys_k, gids_k),
                                                 R.expand(*args))):
        fail(f"K1 stp {tag}: two runs gave different keys or ids")
    plain_keys, _ = R.expand(*args[:9])
    moved = int((plain_keys != keys_k).sum())
    sk, gs, order = R.sort_slots(keys_k, gids_k)
    bounds = R.tile_bounds(sk, n_tiles)
    n_valid = int(bounds[-1])
    counts = bounds[1:] - bounds[:-1]
    off16 = int(((bounds[:-1] % STP.STP_WINDOW != 0) & (counts > 0)).sum())
    n_windows = int(torch.where(
        counts > 0, (bounds[1:] - 1) // STP.STP_WINDOW
        - bounds[:-1] // STP.STP_WINDOW + 1, 0).sum())
    log(f"K1 stp {tag}: bit-identical, identical in two runs; slots "
        f"{isects.total} real "
        f"{isects.n_isects} valid {n_valid}; {moved} keys differ from the "
        f"centre-depth keys; longest tile list {int(counts.max())}, mean "
        f"{float(counts.float().mean()):.1f}; {off16} of {n_tiles} tile "
        f"ranges start off a multiple of 16; {n_windows} (tile, window)s")

    fwd = (m2d, con, opac, ch, depths, kz, gs, bounds, H, W, TILE)
    got = STP.rasterize_fwd_stp(*fwd, checkpoints=True)
    stats = {}
    t0 = time.perf_counter()
    want = STP.rasterize_fwd_stp_plain(*fwd, checkpoints=True, stats=stats)
    torch.cuda.synchronize()
    fwd_plain_ms = (time.perf_counter() - t0) * 1e3
    if not bool((got[2] == R.NEVER_STOPPED).all()):
        fail(f"K2s {tag}: i_stop is not NEVER_STOPPED everywhere")
    fwd_err = max(
        off_share(f"K2s {tag} image", got[0], want[0], OFF_SHARE),
        off_share(f"K2s {tag} alpha", 1 - got[1], 1 - want[1], OFF_SHARE))
    share = 1.0 - float(((got[0] - want[0]).abs()
                         > ATOL + RTOL * want[0].abs()).float().mean())
    loose = STP.rasterize_fwd_stp(*fwd, checkpoints=True, contract=False)
    off_share(f"K2s {tag} image, built without contraction", loose[0],
              want[0], 1.0 - UNCONTRACTED_SHARE)
    off_share(f"K2s {tag} alpha, built without contraction", 1 - loose[1],
              1 - want[1], 1.0 - UNCONTRACTED_SHARE)
    ushare = 1.0 - float(((loose[0] - want[0]).abs()
                          > ATOL + RTOL * want[0].abs()).float().mean())
    if not all(torch.equal(a, b) for a, b in zip(
            got[:3], STP.rasterize_fwd_stp(*fwd)[:3])):
        fail(f"K2s {tag}: two runs gave different outputs")
    log(f"K2s {tag}: image within tolerance at {share:.7f} of values "
        f"({ushare:.7f} when built without contraction), max abs err "
        f"{fwd_err:.3e}; identical in two runs; i_stop never stopped; "
        f"pixels with T_final == 0: {int((got[1] == 0).sum())}, "
        f"T_final < 1e-4: {int((got[1] < 1e-4).sum())}; (pixel, window) "
        f"pairs out of order {stats['unordered_windows']} of "
        f"{stats['pixel_windows']}, (window, warp)s with one "
        f"{stats['unordered_warp_windows']}; live entries "
        f"{stats['live_entries']}, {stats['unordered_live_entries']} of "
        f"them in out-of-order windows (sum of squares "
        f"{stats['unordered_live_squares']}); pairs at or below the cut "
        f"{stats['near_pairs']}")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_out = torch.randn((H, W, C), generator=gen, device="cuda")
    g_alpha = torch.randn((H, W), generator=gen, device="cuda")
    bwd = fwd[:8] + (g_out, g_alpha, got[1], got[3], TILE)
    rows = STP.rasterize_bwd_stp(*bwd)
    again = STP.rasterize_bwd_stp(*bwd)
    t0 = time.perf_counter()
    rows_p = STP.rasterize_bwd_stp_plain(
        *fwd[:8], g_out, g_alpha, want[1], want[3], TILE, stats=stats)
    torch.cuda.synchronize()
    bwd_plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(rows, again):
        fail(f"K3s {tag}: two runs gave different rows")
    bwd_err, gshare = check_rows(f"K3s {tag}", rows, rows_p, K3_COLUMNS,
                                 GRAD_SHARE)
    rows_u = STP.rasterize_bwd_stp(*fwd[:8], g_out, g_alpha, loose[1],
                                   loose[3], TILE, contract=False)
    _, gushare = check_rows(f"K3s {tag} built without contraction", rows_u,
                            rows_p, K3_COLUMNS, UNCONTRACTED_SHARE)
    red = (rows, gs, isects.offsets, R.invert_order(order), bounds[-1:], n)
    _, _, reduce_err = check_reduce(f"K4 on K3s's rows {tag}", red, rows, gs,
                                    n, 2)
    composited = stats["composited_pairs"]
    log(f"K3s {tag}: every column agrees on >= {gshare:.6f} of its values "
        f"(>= {gushare:.7f} when built without contraction), max abs err "
        f"{bwd_err:.3e} (max |ref| {float(rows_p.abs().max()):.3e}); "
        f"identical in two runs. K4: identical in two runs, equal to the "
        f"sums in slot order, max abs err from index_add_ {reduce_err:.3e}; "
        f"composited pairs {composited}; (slot, warp)s with a composited "
        f"pixel {stats['composited_slot_warps']}")
    rec = {"fwd_err": fwd_err, "bwd_err": bwd_err}
    if not timed:
        return rec
    attrs = STP.rasterize_bwd_stp_attributes(C, TILE)
    log_attributes("K3s", C, attrs)
    fwd_attrs = STP.rasterize_fwd_stp_attributes(C, TILE)
    log_attributes("K2s", C, fwd_attrs)
    # with no stop every pixel visits its tile's whole list
    ys = torch.arange(H, device="cuda")[:, None] // TILE
    xs = torch.arange(W, device="cuda")[None, :] // TILE
    pairs = int(counts[ys * tiles_x + xs].sum())
    unordered = stats["unordered_windows"]
    ckpt_bytes = 4 * got[3].numel()
    fwd_bytes = (n * (36 + 4 * C) + 4 * n_valid + 8 * (n_tiles + 1)
                 + H * W * (4 * C + 8))
    rec.update(
        fwd_plain_ms=fwd_plain_ms, bwd_plain_ms=bwd_plain_ms,
        expand_ms=graph_ms(lambda: R.expand(*args), 20),
        expand_plain_ms=cuda_ms(lambda: R.expand_plain(*args), 3),
        fwd_ms=graph_ms(lambda: STP.rasterize_fwd_stp(*fwd), 20),
        fwd_checkpoints_ms=graph_ms(
            lambda: STP.rasterize_fwd_stp(*fwd, checkpoints=True), 20),
        bwd_ms=graph_ms(lambda: STP.rasterize_bwd_stp(*bwd), 20),
        reduce_ms=graph_ms(lambda: R.reduce_grads(*red), 20),
        expand_bound=bound(60 * n + 12 * isects.total,
                           48 * isects.n_isects),
        fwd_bound=bound(fwd_bytes, 12 * pairs + 5 * stats["near_pairs"]
                        + (9 + 2 * C) * composited
                        + stats["unordered_live_squares"]),
        bwd_bound=stp_bwd_bound(C, n, dict(
            n_valid=n_valid, checkpoint_bytes=ckpt_bytes, pairs=pairs,
            near_pairs=stats["near_pairs"], composited_pairs=composited,
            unordered_live_squares=stats["unordered_live_squares"],
            unordered_live_entries=stats["unordered_live_entries"])),
        slots=isects.total, n_isects=isects.n_isects, n_valid=n_valid,
        pairs=pairs, composited_pairs=composited,
        unordered_windows=unordered, checkpoint_bytes=ckpt_bytes,
        composited_slot_warps=stats["composited_slot_warps"],
        unordered_warp_windows=stats["unordered_warp_windows"],
        live_entries=stats["live_entries"], near_pairs=stats["near_pairs"],
        unordered_live_squares=stats["unordered_live_squares"],
        unordered_live_entries=stats["unordered_live_entries"],
        bwd_attributes=attrs, fwd_attributes=fwd_attrs)
    log(f"stp {tag} timings " + json.dumps(
        {k: v for k, v in rec.items() if not k.endswith("_err")}))
    return rec


def stp_bwd_bound(C, n, c):
    """K3s's bound at C channels from a walk's counts `c` (n_valid,
    checkpoint_bytes, pairs, near_pairs, composited_pairs,
    unordered_live_squares, unordered_live_entries), which do not depend
    on C: K2s's bytes and walk, then the backward's."""
    n_tiles = -(-W // TILE) * -(-H // TILE)
    fwd_bytes = (n * (36 + 4 * C) + 4 * c["n_valid"] + 8 * (n_tiles + 1)
                 + H * W * (4 * C + 8))
    comp = c["composited_pairs"]
    return bound(
        fwd_bytes + c["checkpoint_bytes"] + 4 * H * W
        + 4 * (6 + C) * c["n_valid"],
        12 * c["pairs"] + 5 * c["near_pairs"] + (9 + 2 * C) * comp
        + (35 + 4 * C) * comp + c["unordered_live_squares"]
        + (5 + 2 * C) * c["unordered_live_entries"])


def phase_stp_kernels(state, renderer):
    log("== phase 3 (StopThePop): K1 with stp_resort, K2s, K3s and K4 "
        "against their plain versions, full width")
    named = views()
    rec = {}
    for seed, (vname, C, timed) in enumerate((("bench", 3, True),
                                              ("orbit_yaw20", 8, False),
                                              ("orbit_yaw-35", 3, False))):
        r = check_stp_kernels(vname, C, state, renderer,
                              camera(named[vname]), 20 + seed, timed)
        for k in ("fwd_err", "bwd_err"):
            rec[k] = max(rec.get(k, 0.0), r.pop(k))
        rec.update(r)
    return rec


def phase_stp_saturated():
    """A tile whose T_final underflows to 0, on the card: 64 Gaussians of
    opacity 0.99 on one spot. Outputs and every gradient must be finite
    and match the CPU's (the plain versions)."""
    rng = np.random.RandomState(5)
    n = 64
    arrays = dict(
        means2d=(8.0 + 0.05 * rng.randn(n, 2)), depths=rng.rand(n) * 3 + 1,
        conics=np.tile([0.05, 0.0, 0.05], (n, 1)), kz=rng.rand(n, 2) * 0.2,
        opac=np.full(n, 0.99), ch=rng.rand(n, 3))
    grads, finals = {}, {}
    for dev in ("cuda", "cpu"):
        t = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in arrays.items()}
        leaves = [t[k].requires_grad_(True)
                  for k in ("means2d", "conics", "opac", "ch")]
        proj = Projections(
            means2d=leaves[0], depths=t["depths"],
            radii=torch.full((n,), 8, dtype=torch.int32, device=dev),
            conics=leaves[1], compensations=None, mask=None,
            depth_grads=t["kz"])
        with torch.enable_grad():
            img, alpha, aux = R.rasterize(proj, leaves[2], leaves[3], 16, 16,
                                          TILE, True, stp_resort=True)
            wr = torch.rand((16, 16, 3), generator=torch.Generator(
                ).manual_seed(1)).to(dev)
            ((img * wr).sum() + alpha.sum()).backward()
        grads[dev] = [x.grad.cpu() for x in leaves]
        finals[dev] = (img.detach().cpu(), aux.t_final.cpu())
    n_zero = int((finals["cuda"][1] == 0).sum())
    if n_zero == 0:
        fail("saturated tile: T_final never reached 0 on the card")
    if not bool(torch.isfinite(finals["cuda"][0]).all()):
        fail("saturated tile: non-finite image")
    for name, g, w in zip(("means2d", "conics", "opacities", "channels"),
                          grads["cuda"], grads["cpu"]):
        scale = float(w.abs().max())
        bad = (g - w).abs() > 1e-3 * scale + 1e-2 * w.abs()
        if not bool(torch.isfinite(g).all()) or bool(bad.any()):
            fail(f"saturated tile d / d {name}: non-finite, or differs from "
                 f"the CPU's at {int(bad.sum())} values (max |ref| {scale})")
    log(f"saturated tile (64 Gaussians of opacity 0.99, 16x16): T_final is "
        f"0 at {n_zero} pixels; image and all four gradients finite and "
        "equal to the CPU's")


def phase_small_reference(stp=False):
    """The whole renderer on a small scene, card vs CPU (plain versions);
    with `stp`, the StopThePop renderer."""
    config = TileRendererConfig(stp_resort=stp)
    tag = "small STP scene" if stp else "small scene"
    arrays = scene_arrays(400, seed=1)
    arrays["means"][:, 2] -= 2.0  # nearer: larger splats, longer lists
    c2w = np.eye(4)
    outs = {}
    for dev in ("cuda", "cpu"):
        state = state_from_raw_arrays(arrays, device=dev)
        renderer = config.instantiate()
        cam = camera(c2w, 96, 128, 120.0, device=dev)
        bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
        outs[dev] = renderer.forward(state, cam, 96, 128, bg, SH_DEGREE,
                                     render_types=ALL_OUTPUTS)
    for key in ("render", "alpha", "exp_depth", "inverse_depth", "normal",
                "hard_inverse_depth"):
        g = getattr(outs["cuda"], key).cpu()
        w = getattr(outs["cpu"], key)
        bad = (g - w).abs() > ATOL + RTOL * w.abs()
        share = 1.0 - float(bad.float().mean())
        if not bool(torch.isfinite(g).all()) or share < STOP_SHARE:
            fail(f"{tag} {key}: card matches the CPU renderer at "
                 f"{share:.5f} of values")
    log(f"{tag} (400 Gaussians, 128x96): card renderer matches the CPU "
        "renderer on every output")
    grads = {}
    for dev in ("cuda", "cpu"):
        state = state_from_raw_arrays(arrays, device=dev)
        state.params = state.params.map(
            lambda _, x: x.requires_grad_(True))
        target = torch.rand((96, 128, 3), generator=torch.Generator(
            ).manual_seed(3)).to(dev)
        with torch.enable_grad():
            out = config.instantiate().forward(
                state, camera(c2w, 96, 128, 120.0, device=dev), 96, 128,
                torch.tensor([0.1, 0.2, 0.3], device=dev), SH_DEGREE)
            loss, _ = train_loss(out.render, target)
            loss.backward()
        grads[dev] = {k: getattr(state.params, k).grad.cpu()
                      for k in PARAM_FIELDS}
    for key, g in grads["cuda"].items():
        w = grads["cpu"][key]
        scale = float(w.abs().max())
        bad = (g - w).abs() > 1e-3 * scale + 1e-2 * w.abs()
        share = 1.0 - float(bad.float().mean())
        if (not bool(torch.isfinite(g).all()) or scale <= 0.0
                or share < STOP_SHARE):
            fail(f"{tag} d loss / d {key}: card matches the CPU at "
                 f"{share:.5f} of values (max |ref| {scale})")
    log(f"{tag}: the gradients of the L1 + SSIM loss for all six "
        "parameter tensors match the CPU's")


def surfel_arrays(arrays):
    """The scene as surfels: the first two scale columns (bench.py's
    2DGS line)."""
    return dict(arrays, scales=arrays["scales"][:, :2])


def surfel_inputs(state, cam, n_channels):
    """What SurfelRenderer.forward hands the rasterizer: the projection,
    geom [N, 13] and the channels: rgb (C = 3), rgb + view-space normal
    (C = 6), or those and the surfel's depth coefficients (C = 9)."""
    proj = project_surfels(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    viewdirs = state.get_means() - cam.camera_center
    rgb = torch.clamp(sh_to_rgb(state.get_shs(), viewdirs, SH_DEGREE) + 0.5,
                      min=0.0)
    ch = torch.cat([rgb, proj.normals, proj.zcoef][:n_channels // 3], 1)
    geom = SR.pack_surfels(proj.Tu, proj.Tv, proj.Tw, proj.zcoef,
                           state.get_opacities())
    return proj, geom, ch.contiguous()


def check_surfel_kernels(vname, C, state, cam, seed, timed):
    """K5, K6, K7 and K4 (no absolute columns) against their plain
    versions at one view; with `timed`, their times and bounds too."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    n_tiles = tiles_x * tiles_y
    n = state.capacity
    tag = f"{vname} C={C}"
    proj, geom, ch = surfel_inputs(state, cam, C)
    isects = SR.surfel_isect_encode(proj.means2d, proj.depths, proj.radii,
                                    H, W, TILE)
    args = (isects, proj.depths.contiguous(), tiles_x, tiles_y)
    keys_k, gids_k = SR.surfel_expand(*args)
    again = SR.surfel_expand(*args)
    keys_p, gids_p = SR.surfel_expand_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(keys_k, keys_p) and torch.equal(gids_k, gids_p)):
        fail(f"K5 {tag}: kernel differs from surfel_expand_plain at "
             f"{int((keys_k != keys_p).sum())} slots")
    if not (torch.equal(keys_k, again[0]) and torch.equal(gids_k, again[1])):
        fail(f"K5 {tag}: two runs gave different keys or ids")
    sk, gs, order = R.sort_slots(keys_k, gids_k)
    bounds = R.tile_bounds(sk, n_tiles)
    n_valid = int(bounds[-1])
    if n_valid != isects.n_isects:
        fail(f"K5 {tag}: {n_valid} valid keys for {isects.n_isects} "
             "intersections")
    counts = bounds[1:] - bounds[:-1]
    log(f"K5 {tag}: bit-identical, identical in two runs; slots "
        f"{isects.total} real "
        f"{isects.n_isects} (no cull); longest tile list "
        f"{int(counts.max())}, mean {float(counts.float().mean()):.1f}")

    fwd = (geom, ch, gs, bounds, H, W, TILE)
    out, aux, stop = SR.rasterize_surfels_fwd(*fwd)
    out_p, aux_p, stop_p = SR.rasterize_surfels_fwd_plain(*fwd)
    torch.cuda.synchronize()
    share = float((stop == stop_p).float().mean())
    if share < STOP_SHARE:
        fail(f"K6 {tag}: i_stop agrees on {share:.5f} of pixels "
             f"< {STOP_SHARE}")
    err = off_share(f"K6 {tag} channels", out, out_p, OFF_SHARE)
    names = ("T", "sum w depth", "median depth", "distortion", "A", "M1",
             "M2")
    plane_err = {}
    for i, name in enumerate(names):
        limit = MEDIAN_OFF_SHARE if i == SR.AUX_MEDIAN else OFF_SHARE
        plane_err[name] = off_share(f"K6 {tag} {name}", aux[i], aux_p[i],
                                    limit)
    fwd_err = max(err, *(v for k, v in plane_err.items()
                         if k != "median depth"))
    # the same source built without contraction rounds as the plain version
    out_u, aux_u, stop_u = SR.rasterize_surfels_fwd(*fwd, contract=False)
    ustop = float((stop_u == stop_p).float().mean())
    if ustop < UNCONTRACTED_SHARE:
        fail(f"K6 {tag} built without contraction: i_stop agrees on "
             f"{ustop:.6f} of pixels < {UNCONTRACTED_SHARE}")
    ulimit = 1.0 - UNCONTRACTED_SHARE
    off_share(f"K6 {tag} channels, built without contraction", out_u, out_p,
              ulimit)
    for i, name in enumerate(names):
        off_share(f"K6 {tag} {name}, built without contraction", aux_u[i],
                  aux_p[i], ulimit)
    ushare = min(value_share(out_u, out_p),
                 *(value_share(aux_u[i], aux_p[i]) for i in range(7)))
    log(f"K6 {tag}: i_stop agrees on {share:.6f}; max abs err channels "
        f"{err:.3e}, " + ", ".join(f"{k} {v:.3e}"
                                   for k, v in plane_err.items())
        + f"; mean alpha {float(1 - aux[0].mean()):.4f}, mean distortion "
        f"{float(aux[3].mean()):.3e}; built without contraction: i_stop "
        f"agrees on {ustop:.7f}, every output within tolerance at >= "
        f"{ushare:.7f} of its values")
    if timed:
        attrs = SR.rasterize_surfels_fwd_attributes(C, TILE)
        log_attributes("K6", C, attrs)
        expand_attrs = SR.surfel_expand_attributes()
        log_attributes("K5", None, expand_attrs)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_out = torch.randn((H, W, C), generator=gen, device="cuda")
    g_aux = torch.randn((3, H, W), generator=gen, device="cuda")
    bwd = (geom, ch, gs, bounds, g_out, g_aux, aux, stop, TILE)
    rows = SR.rasterize_surfels_bwd(*bwd)
    again = SR.rasterize_surfels_bwd(*bwd)
    stats = {}
    rows_p = SR.rasterize_surfels_bwd_plain(*bwd, stats=stats)
    torch.cuda.synchronize()
    if not torch.equal(rows, again):
        fail(f"K7 {tag}: two runs gave different rows")
    bwd_err, gshare = check_rows(f"K7 {tag}", rows, rows_p, K7_COLUMNS,
                                 SURFEL_GRAD_SHARE)
    uncontracted = SR.rasterize_surfels_bwd(*bwd, contract=False)
    _, ushare = check_rows(f"K7 {tag} built without contraction",
                           uncontracted, rows_p, K7_COLUMNS,
                           UNCONTRACTED_SHARE)
    if timed:
        # the tolerance must fail a wrong backward: one without the depth
        # and distortion terms
        g_alpha_only = torch.cat([g_aux[:1], torch.zeros_like(g_aux[1:])])
        partial = SR.rasterize_surfels_bwd(*bwd[:5], g_alpha_only, *bwd[6:])
        missed = [K7_COLUMNS[c] for c, (_, s) in enumerate(
            column_shares(tag, partial, rows_p)[:13])
            if s < SURFEL_GRAD_SHARE]
        log(f"K7 {tag}: without g_depth and g_dist these columns fail the "
            f"tolerance: {missed}")
        if len(missed) < 13:
            fail(f"K7 {tag}: the tolerance passes the geometry columns "
                 f"other than {missed} of a backward without the depth "
                 "and distortion terms")
    red = (rows, gs, isects.offsets, R.invert_order(order), bounds[-1:], n)
    summed, summed_p, reduce_err = check_reduce(f"K4 surfel {tag}", red,
                                                rows, gs, n, 0)
    scale, sscale = float(rows_p.abs().max()), float(summed_p.abs().max())
    composited = stats["composited_pairs"]
    log(f"K7 {tag}: every column agrees on >= {gshare:.6f} of its values "
        f"(>= {ushare:.7f} when built without contraction), "
        f"max abs err {bwd_err:.3e} (max |ref| {scale:.3e}); identical in "
        f"two runs. K4 with 13 + C columns: identical in two runs, equal "
        f"to the sums in slot order, max abs err from index_add_ "
        f"{reduce_err:.3e} "
        f"(max |ref| {sscale:.3e}); composited pairs {composited}; (slot, "
        f"warp)s with a composited pixel {stats['composited_slot_warps']}")
    rec = {"fwd_err": fwd_err, "median_err": plane_err["median depth"],
           "bwd_err": bwd_err, "reduce_err": reduce_err}
    if not timed:
        return rec
    log_attributes("K7", C, SR.rasterize_surfels_bwd_attributes(C, TILE))
    gids64 = gs.long()
    sums = torch.empty((n, rows.shape[1]), device=rows.device)
    pairs = visited_pairs(stop, bounds, tiles_x)
    pairs_bwd = pairs - int((stop < R.NEVER_STOPPED).sum())
    in_bytes = n * (52 + 4 * C) + 4 * n_valid + 8 * (n_tiles + 1)
    R_ = 13 + C
    rec.update(
        bwd_scale=scale, reduce_scale=sscale,
        expand_ms=graph_ms(lambda: SR.surfel_expand(*args), 20),
        expand_plain_ms=cuda_ms(lambda: SR.surfel_expand_plain(*args), 3),
        sort_ms=graph_ms(lambda: R.sort_slots(keys_k, gids_k), 20),
        fwd_ms=graph_ms(lambda: SR.rasterize_surfels_fwd(*fwd), 20),
        fwd_plain_ms=cuda_ms(
            lambda: SR.rasterize_surfels_fwd_plain(*fwd), 1, warmup=0),
        bwd_ms=graph_ms(lambda: SR.rasterize_surfels_bwd(*bwd), 20),
        bwd_plain_ms=cuda_ms(
            lambda: SR.rasterize_surfels_bwd_plain(*bwd), 1, warmup=0),
        reduce_ms=graph_ms(lambda: R.reduce_grads(*red, n_abs=0), 20),
        reduce_plain_ms=cuda_ms(
            lambda: R.reduce_grads_plain(rows, gs, n, n_abs=0), 5),
        reduce_library_ms=graph_ms(
            lambda: sums.zero_().index_add_(0, gids64, rows), 20),
        expand_bound=bound(28 * n + 12 * isects.total, 6 * isects.n_isects),
        fwd_bound=bound(in_bytes + H * W * (4 * C + 32),
                        47 * pairs + (26 + 2 * C) * composited),
        bwd_bound=surfel_bwd_bound(C, n, dict(
            n_valid=n_valid, pairs_bwd=pairs_bwd,
            composited_pairs=composited)),
        reduce_bound=bound(4 * R_ * n_valid + 4 * isects.total + 8 * n
                           + 4 * R_ * n, R_ * n_valid),
        slots=isects.total, n_isects=isects.n_isects, pairs=pairs,
        pairs_bwd=pairs_bwd, composited_pairs=composited, n_valid=n_valid,
        composited_slot_warps=stats["composited_slot_warps"],
        bwd_attributes=SR.rasterize_surfels_bwd_attributes(C, TILE),
        fwd_attributes=attrs, expand_attributes=expand_attrs,
        reduce_attributes=R.reduce_grads_attributes(13 + C, 0))
    log_attributes(f"K4 R={13 + C} n_abs=0", None, rec["reduce_attributes"])
    log(f"surfel {tag} timings " + json.dumps(
        {k: v for k, v in rec.items() if k.endswith(("_ms", "_bound"))
         or k in ("slots", "n_isects", "pairs", "pairs_bwd",
                  "composited_pairs")}))
    return rec


def surfel_bwd_bound(C, n, c):
    """K7's bound at C channels from a walk's counts `c` (n_valid,
    pairs_bwd, composited_pairs), which do not depend on C."""
    n_tiles = -(-W // TILE) * -(-H // TILE)
    in_bytes = n * (52 + 4 * C) + 4 * c["n_valid"] + 8 * (n_tiles + 1)
    return bound(in_bytes + H * W * (4 * C + 44)
                 + 4 * (13 + C) * c["n_valid"],
                 48 * c["pairs_bwd"] + (123 + 4 * C) * c["composited_pairs"])


def phase_surfel_kernels(state):
    log("== phase 3 (surfels): K5, K6, K7 and K4 against their plain "
        "versions, full width")
    named = views()
    cases = (("bench", 6, True), ("orbit_yaw20", 6, False),
             ("bench", 3, False), ("bench", 9, False))
    rec = {}
    for seed, (vname, C, timed) in enumerate(cases):
        r = check_surfel_kernels(vname, C, state, camera(named[vname]),
                                 10 + seed, timed)
        errs = {k: r.pop(k) for k in ("fwd_err", "median_err", "bwd_err",
                                      "reduce_err")}
        if C == 6:   # the main path's width: what the kernels line reports
            for k, v in errs.items():
                rec[k] = max(rec.get(k, 0.0), v)
        rec.update(r)
    return rec


def phase_small_surfel_reference():
    """SurfelRenderer on a small scene, card vs CPU (plain versions): the
    seven outputs, and the gradients of a loss with the distortion and
    normal-consistency terms."""
    arrays = surfel_arrays(scene_arrays(400, seed=1))
    arrays["means"][:, 2] -= 2.0  # nearer: larger surfels, longer lists
    outs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        state = state_from_raw_arrays(arrays, device=dev)
        state.params = state.params.map(
            lambda _, x: x.requires_grad_(True))
        target = torch.rand((96, 128, 3), generator=torch.Generator(
            ).manual_seed(3)).to(dev)
        with torch.enable_grad():
            out = SurfelRendererConfig().instantiate().forward(
                state, camera(np.eye(4), 96, 128, 120.0, device=dev), 96,
                128, torch.tensor([0.1, 0.2, 0.3], device=dev), SH_DEGREE)
            loss, _ = train_loss(out.render, target)
            normal_err = 1.0 - (out.rend_normal * out.surf_normal).sum(-1)
            loss = (loss + 0.05 * normal_err.mean()
                    + 100.0 * out.rend_dist.mean())
            loss.backward()
        outs[dev] = out
        grads[dev] = {k: getattr(state.params, k).grad.cpu()
                      for k in PARAM_FIELDS}
    for key in ("render", "alpha", "rend_normal", "view_normal",
                "rend_dist", "surf_depth", "surf_normal"):
        g = getattr(outs["cuda"], key).detach().cpu()
        w = getattr(outs["cpu"], key).detach()
        bad = (g - w).abs() > ATOL + RTOL * w.abs()
        share = 1.0 - float(bad.float().mean())
        # a finite-difference normal reads four neighbouring depths
        floor = 0.99 if key == "surf_normal" else STOP_SHARE
        if not bool(torch.isfinite(g).all()) or share < floor:
            fail(f"small surfel scene {key}: card matches the CPU renderer "
                 f"at {share:.5f} of values")
    for key, g in grads["cuda"].items():
        w = grads["cpu"][key]
        scale = float(w.abs().max())
        bad = (g - w).abs() > 1e-3 * scale + 1e-2 * w.abs()
        share = 1.0 - float(bad.float().mean())
        if (not bool(torch.isfinite(g).all()) or scale <= 0.0
                or share < STOP_SHARE):
            fail(f"small surfel scene d loss / d {key}: card matches the "
                 f"CPU at {share:.5f} of values (max |ref| {scale})")
    log("small surfel scene (400 surfels, 128x96): the card's seven "
        "outputs and the gradients of the L1 + SSIM + normal + distortion "
        "loss for all six parameter tensors match the CPU's")


def phase_main_path(ply, stp=False):
    """The serving main path; with `stp` over the StopThePop renderer.
    Returns (launches of the path's kernels, its numbers)."""
    what = "StopThePop serving" if stp else "main path"
    fwd_kernel = "rasterize_fwd_stp" if stp else "rasterize_fwd"
    log(f"== phase {'7: StopThePop' if stp else '4:'} main path "
        "GaussianModelLoader -> ViewerRenderer -> TileRenderer"
        f"{'(stp_resort=True)' if stp else ''} at 1088x1920")
    state, renderer, sh_degree = GaussianModelLoader.load(ply,
                                                          device="cuda")
    if stp:
        # the loader builds the default renderer; stp.yaml's is this one
        renderer = TileRendererConfig(stp_resort=True).instantiate()
    vr = ViewerRenderer(state, renderer, sh_degree)
    fov_y = math.degrees(2.0 * math.atan(0.5 * H / FOCAL))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frame_ms = []
    for yaw in (0.0, 10.0, 20.0, 30.0, 40.0):
        c2w = orbit_c2w(yaw, 0.0, 5.0, TARGET)
        t0 = time.perf_counter()
        img = vr.get_outputs(c2w, W, H, fov_y)   # ends in a host copy
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if img.shape != (H, W, 3) or img.dtype != np.uint8:
            fail(f"{what}: frame at yaw {yaw}: shape {img.shape} "
                 f"{img.dtype}")
        if int(img.max()) == 0:
            fail(f"{what}: frame at yaw {yaw} is black")
    bg = torch.zeros(3, device="cuda")
    cam = camera(np.eye(4))
    out = renderer.forward(state, cam, H, W, bg, sh_degree,
                           render_types=ALL_OUTPUTS)
    for key in ("render", "alpha", "exp_depth", "inverse_depth", "normal",
                "hard_inverse_depth"):
        v = getattr(out, key)
        if v is None or not bool(torch.isfinite(v).all()):
            fail(f"{what} {key}: missing or non-finite")
    mean_alpha = float(out.alpha.mean())
    if not mean_alpha > 0.0:
        fail(f"{what}: mean alpha is 0")
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items()
                if k in ("expand", fwd_kernel)}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, count in launches.items():
        if count <= 0:
            fail(f"{what} never launched kernel {name}")
    stray = {k: v for k, v in read_launches().items()
             if v and k not in launches}
    if stray:
        fail(f"{what} launched kernels of another path: {stray}")
    log(f"{what}: {len(frame_ms)} rgb frames, ms per frame "
        f"{[round(x, 3) for x in frame_ms]}; all-outputs frame at the bench "
        f"pose: n_isects {out.n_isects}, mean alpha {mean_alpha:.4f}; "
        f"launches {launches}; peak memory {peak_gb:.3f} GiB")
    # one frame per output type through the viewer (after the counts were
    # read): visualized and quantized on the card, one uint8 copy
    output_ms = {}
    for i, name in enumerate(renderer.get_available_outputs()):
        vr.output_type = name
        c2w = orbit_c2w(8.0 * i, 0.0, 5.0, TARGET)
        t0 = time.perf_counter()
        img = vr.get_outputs(c2w, W, H, fov_y)
        output_ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        if (img.shape != (H, W, 3) or img.dtype != np.uint8
                or int(img.max()) == 0):
            fail(f"{what}: {name} frame {img.shape} {img.dtype} is wrong "
                 "or black")
    log(f"{what}: one viewer frame per output, ms per frame {output_ms}")
    stage_ms = stage_times(state, renderer, sh_degree, cam, stp=stp)
    rgb_ms = [1e3 * t for t in timed_frames(renderer, state, cam, bg,
                                            sh_degree)]
    log(f"{what}: bench-pose rgb frame, host clock ms " + json.dumps(rgb_ms))
    log(f"{what}: bench-pose stage ms (CUDA events, median of 5) "
        + json.dumps(stage_ms))
    return launches, {"rgb_frame_ms": rgb_ms, "stage_ms": stage_ms,
                      "viewer_ms": output_ms, "peak_gib": peak_gb}


def timed_frames(renderer, state, cam, bg, sh_degree, reps=5):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renderer.forward(state, cam, H, W, bg, sh_degree)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def stage_times(state, renderer, sh_degree, cam, reps=5, stp=False):
    """The rgb render's stages, as TileRenderer.forward runs them (through
    the renderer's seams, so a variant's filtered scales and opacities are
    part of "project")."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    rows = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        proj = project_gaussians(
            renderer.get_means(state, cam), renderer.get_scales(state, cam),
            state.get_rotations(), cam.world_to_camera, cam.fx, cam.fy,
            cam.cx, cam.cy, W, H,
            filter_2d=renderer.config.filter_2d_kernel_size)
        opac = renderer.get_opacities(state, cam, proj).contiguous()
        ev[1].record()
        rgb = renderer.get_rgbs(state, cam, sh_degree).contiguous()
        ev[2].record()
        isects = R.isect_encode(proj, H, W, TILE)
        m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
        depths, kz = proj.depths.contiguous(), proj.depth_grads.contiguous()
        keys, gids = R.expand(isects, m2d, con, opac, depths, tiles_x,
                              tiles_y, TILE, True, stp, kz)
        ev[3].record()
        sk, gs, _ = R.sort_slots(keys, gids)
        ev[4].record()
        bounds = R.tile_bounds(sk, tiles_x * tiles_y)
        ev[5].record()
        if stp:
            STP.rasterize_fwd_stp(m2d, con, opac, rgb, depths, kz, gs,
                                  bounds, H, W, TILE)
        else:
            R.rasterize_fwd(m2d, con, opac, rgb, gs, bounds, H, W, TILE)
        ev[6].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(6)])
    med = np.median(np.asarray(rows), axis=0)
    names = ("project", "sh", "expand", "sort", "ranges", "forward")
    return {k: float(v) for k, v in zip(names, med)}


TRAIN_STEPS, DENSIFY_AT, RESET_AT, STEPS_AFTER = 20, 20, 24, 6
STP_TRAIN_STEPS, STP_STEPS_AFTER = 12, 3   # phase 7: densify at step 12
TRAIN_EXTENT = 0.5   # puts percent_dense * extent inside the scene's scales


def perturbed(arrays, seed=1):
    """The scene, moved off its optimum: what training has to undo."""
    rng = np.random.RandomState(seed)
    out = dict(arrays)
    for key, std in (("means", 1e-3), ("shs_dc", 0.1), ("opacities", 0.3)):
        out[key] = (arrays[key] + std * rng.normal(
            size=arrays[key].shape)).astype(np.float32)
    return out


def train_stage_times(trainer, state, cam, target, bg, loss_of=None,
                      reps=3):
    """One training step's stages, as Trainer.train_step runs them,
    after one repetition that is not counted (it pays for the allocator's
    first blocks). `loss_of(out)`: the loss of a render; L1 + SSIM when
    None."""
    if loss_of is None:
        def loss_of(out):
            return train_loss(out.render, target)[0]
    rows = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        leaves = state.params.map(
            lambda _, x: x.detach().requires_grad_(True))
        tap = torch.zeros((state.params.capacity, 2), device="cuda",
                          requires_grad=True)
        ev[0].record()
        out = trainer.renderer.forward(
            GaussianState(params=leaves, alive=state.alive), cam, H, W, bg,
            SH_DEGREE, means2d_tap=tap)
        ev[1].record()
        loss = loss_of(out)
        ev[2].record()
        grads = torch.autograd.grad(
            loss, [getattr(leaves, k) for k in PARAM_FIELDS] + [tap])
        ev[3].record()
        with torch.no_grad():
            updates, _ = trainer.tx.update(
                GaussianParams(**dict(zip(PARAM_FIELDS, grads))),
                state.opt_state)
            state.params.map(lambda k, x: x + getattr(updates, k))
        ev[4].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    med = np.median(np.asarray(rows[1:]), axis=0)
    names = ("render_forward", "loss", "backward", "adam")
    return {k: float(v) for k, v in zip(names, med)}


def phase_training(arrays, raster_ms, stp=False):
    """The training main path; with `stp` over the StopThePop renderer,
    cut to STP_TRAIN_STEPS steps, a densify and STP_STEPS_AFTER more.
    `raster_ms`: the backward's kernels as phase 3 timed them. Returns
    (launches of the path's kernels, its numbers)."""
    what = "StopThePop training" if stp else "training"
    n_steps, densify_at, reset_at, after = (
        (STP_TRAIN_STEPS, STP_TRAIN_STEPS, None, STP_STEPS_AFTER) if stp
        else (TRAIN_STEPS, DENSIFY_AT, RESET_AT, STEPS_AFTER))
    n_mean = 5 if n_steps >= 15 else 3     # steps in the two loss means
    log(f"== phase {'7: StopThePop' if stp else '5:'} training main path, "
        "Trainer.train_step + maybe_density_ops at 1088x1920")
    model = VanillaGaussianConfig(sh_degree=SH_DEGREE)
    trainer = Trainer(
        model=model, renderer=TileRendererConfig(stp_resort=stp),
        density=VanillaDensityControllerConfig(
            densify_from_iter=5, densification_interval=densify_at,
            densify_until_iter=100, opacity_reset_interval=reset_at or 1000,
            cull_opacity_threshold=0.3),
        config=TrainerConfig(max_steps=n_steps + after,
                             sh_degree_interval=2))
    bg = torch.zeros(3, device="cuda")
    cams = [camera(c2w) for c2w in views().values()]
    truth = state_from_raw_arrays(arrays, device="cuda")
    with torch.no_grad():
        targets = [trainer.renderer.forward(truth, cam, H, W, bg,
                                            SH_DEGREE).render
                   for cam in cams]
    del truth
    state = trainer.setup(
        state_from_raw_arrays(perturbed(arrays), device="cuda"),
        cameras_extent=TRAIN_EXTENT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stage = train_stage_times(trainer, state, cams[0], targets[0], bg)
    # the backward's kernels as phase 3 timed them at this pose; the rest
    # is autograd through projection, SH and the loss
    stage["backward_split"] = dict(
        raster_ms, autograd_rest=stage["backward"] - sum(raster_ms.values()))
    log(f"{what} stage ms at capacity {state.params.capacity} (CUDA "
        "events, median of 3) " + json.dumps(stage))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms, density_ms, alive = [], [], {}, {}
    for step in range(1, n_steps + after + 1):
        view = step % len(cams)
        t0 = time.perf_counter()
        state, scalars = trainer.train_step(
            state, cams[view], targets[view], H, W,
            trainer.sh_degree_at(step), bg)
        losses.append(float(scalars["loss"]))       # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == densify_at:
            # a tenth of the seen Gaussians above the threshold
            d = state.density
            stat = (d.grad_accum / d.denom.clamp(min=1.0))[d.denom > 0]
            k = max(int(0.9 * stat.numel()), 1)
            trainer.density_cfg.densify_grad_threshold = float(
                stat.kthvalue(k).values)
        alive[step] = state.gaussians.n_alive
        prev = state
        t0 = time.perf_counter()
        state = trainer.maybe_density_ops(state, gen, step)
        torch.cuda.synchronize()
        if step in (densify_at, reset_at):
            density_ms[step] = (time.perf_counter() - t0) * 1e3
            cap = prev.params.capacity
            was, now = prev.alive, state.alive[:cap]
            # a split original stays in its slot with smaller scales
            split = (was & now & (state.params.scales[:cap]
                                  != prev.params.scales).any(-1))
            log(f"step {step}: density ops {density_ms[step]:.1f} ms; "
                f"alive {alive[step]} -> {state.gaussians.n_alive} (born "
                f"{int(state.alive.sum() - now.sum() + (~was & now).sum())}"
                f", of them second children of {int(split.sum())} splits; "
                f"pruned {int((was & ~now).sum())}), capacity {cap} -> "
                f"{state.params.capacity}; opacity max "
                f"{float(state.gaussians.get_opacities().max()):.4f}")
        del prev
    counts = read_launches()
    launches = {k: counts[k] for k in (STP_KERNELS if stp
                                       else GAUSSIAN_KERNELS)}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss in {losses}")
    first, last = (float(np.mean(losses[:n_mean])),
                   float(np.mean(losses[n_steps - n_mean:n_steps])))
    if not last < first:
        fail(f"{what}: mean loss of steps {n_steps - n_mean + 1}-{n_steps} "
             f"{last} is not below that of steps 1-{n_mean} {first}")
    for k in PARAM_FIELDS:
        if not bool(torch.isfinite(getattr(state.params, k)).all()):
            fail(f"{what}: non-finite {k}")
    if alive[densify_at + 1] == alive[densify_at]:
        fail(f"{what}: the densify changed no alive count")
    if (reset_at is not None and float(
            state.opt_state.exp_avg["opacities"].abs().max()) == 0.0):
        fail(f"{what}: no step after the opacity reset")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{what} path never launched kernel {name}")
    stray = {k: v for k, v in counts.items() if v and k not in launches}
    if stray:
        fail(f"{what} launched kernels of another path: {stray}")
    log(f"{what}: losses {[round(x, 5) for x in losses]}")
    log(f"{what}: mean loss steps 1-{n_mean} {first:.5f}, steps "
        f"{n_steps - n_mean + 1}-{n_steps} {last:.5f}; SH degree 3 from "
        f"step 6; launches {launches} in {len(losses)} steps; peak memory "
        f"{peak_gb:.3f} GiB")
    log(f"{what}: ms per step (host clock, synchronised) "
        + json.dumps([round(x, 2) for x in step_ms]))
    grown = train_stage_times(trainer, state, cams[0], targets[0], bg)
    log(f"{what} stage ms at capacity {state.params.capacity} (CUDA "
        "events, median of 3) " + json.dumps(grown))
    return launches, {"step_ms": step_ms, "stage_ms": stage,
                      "density_ms": density_ms, "peak_gib": peak_gb}


S2D_STEPS, S2D_DENSIFY_AT, S2D_STEPS_AFTER = 12, 12, 3
# both extra losses act when step > from_iter: -1 turns them on at step 0
S2D_METRICS = dict(lambda_normal=0.05, lambda_dist=100.0,
                   normal_from_iter=-1, dist_from_iter=-1)


def surfel_stage_times(state, cam, reps=5):
    """A surfel frame's stages, as SurfelRenderer.forward runs them."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    rows = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        proj, geom, ch = surfel_inputs(state, cam, 6)
        ev[1].record()
        isects = SR.surfel_isect_encode(proj.means2d, proj.depths,
                                        proj.radii, H, W, TILE)
        keys, gids = SR.surfel_expand(isects, proj.depths.contiguous(),
                                      tiles_x, tiles_y)
        ev[2].record()
        sk, gs, _ = R.sort_slots(keys, gids)
        ev[3].record()
        bounds = R.tile_bounds(sk, tiles_x * tiles_y)
        ev[4].record()
        SR.rasterize_surfels_fwd(geom, ch, gs, bounds, H, W, TILE)
        ev[5].record()
        torch.cuda.synchronize()
        rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(5)])
    med = np.median(np.asarray(rows), axis=0)
    names = ("project_sh_pack", "expand", "sort", "ranges", "forward")
    return {k: float(v) for k, v in zip(names, med)}


def phase_surfel_main_path(arrays):
    log("== phase 6: 2DGS main path, ViewerRenderer -> SurfelRenderer and "
        "GS2DTrainer at 1088x1920")
    arrays = surfel_arrays(arrays)
    state = state_from_raw_arrays(arrays, device="cuda")
    renderer = SurfelRendererConfig().instantiate()
    vr = ViewerRenderer(state, renderer, SH_DEGREE)
    fov_y = math.degrees(2.0 * math.atan(0.5 * H / FOCAL))
    bg = torch.zeros(3, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    frame_ms = {}
    for i, name in enumerate(renderer.get_available_outputs()):
        vr.output_type = name
        c2w = orbit_c2w(8.0 * i, 0.0, 5.0, TARGET)
        t0 = time.perf_counter()
        img = vr.get_outputs(c2w, W, H, fov_y)   # ends in a host copy
        frame_ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        if img.shape != (H, W, 3) or img.dtype != np.uint8:
            fail(f"surfel frame {name}: shape {img.shape} {img.dtype}")
        if int(img.max()) == 0:
            fail(f"surfel frame {name} is black")
    if len(frame_ms) != 7:
        fail(f"SurfelRenderer offers {len(frame_ms)} outputs, not 7")
    torch.cuda.synchronize()
    serving = {k: v for k, v in read_launches().items()
               if k in ("surfel_expand", "surfel_fwd")}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, count in serving.items():
        if count <= 0:
            fail(f"2DGS serving path never launched kernel {name}")
    cam = camera(np.eye(4))
    with torch.no_grad():
        out = renderer.forward(state, cam, H, W, bg, SH_DEGREE)
    for key in ("render", "alpha", "rend_normal", "view_normal",
                "rend_dist", "surf_depth", "surf_normal"):
        if not bool(torch.isfinite(getattr(out, key)).all()):
            fail(f"2DGS main path {key}: non-finite")
    mean_alpha = float(out.alpha.mean())
    if not mean_alpha > 0.0:
        fail("2DGS main path: mean alpha is 0")
    log(f"2DGS serving: one frame per output, ms per frame {frame_ms}; "
        f"bench pose: n_isects {out.n_isects}, mean alpha {mean_alpha:.4f}, "
        f"mean distortion {float(out.rend_dist.mean()):.3e}; launches "
        f"{serving}; peak memory {peak_gb:.3f} GiB")
    with torch.no_grad():
        rgb_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            renderer.forward(state, cam, H, W, bg, SH_DEGREE)
            torch.cuda.synchronize()
            rgb_ms.append((time.perf_counter() - t0) * 1e3)
        log("2DGS bench-pose frame (all seven outputs), host clock ms "
            + json.dumps(rgb_ms))
        log("2DGS bench-pose stage ms (CUDA events, median of 5) "
            + json.dumps(surfel_stage_times(state, cam)))

    # training
    trainer = GS2DTrainer(
        model=Gaussian2DConfig(sh_degree=SH_DEGREE),
        density=VanillaDensityControllerConfig(
            densify_from_iter=5, densification_interval=S2D_DENSIFY_AT,
            densify_until_iter=100, opacity_reset_interval=1000,
            cull_opacity_threshold=0.3),
        metrics=GS2DMetricsConfig(**S2D_METRICS),
        config=TrainerConfig(max_steps=S2D_STEPS + S2D_STEPS_AFTER,
                             sh_degree_interval=2))
    cams = [camera(c2w) for c2w in views().values()]
    with torch.no_grad():
        targets = [trainer.renderer.forward(state, c, H, W, bg,
                                            SH_DEGREE).render for c in cams]
    del state, vr, out
    state = trainer.setup(
        state_from_raw_arrays(perturbed(arrays), device="cuda"),
        cameras_extent=TRAIN_EXTENT)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def loss_of(out):
        loss, _ = train_loss(out.render, targets[0])
        normal_err = 1.0 - (out.rend_normal * out.surf_normal).sum(-1)
        return (loss + S2D_METRICS["lambda_normal"] * normal_err.mean()
                + S2D_METRICS["lambda_dist"] * out.rend_dist.mean())

    stage = train_stage_times(trainer, state, cams[0], targets[0], bg,
                              loss_of)
    log(f"2DGS training stage ms at capacity {state.params.capacity} (CUDA "
        "events, median of 3) " + json.dumps(stage))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, extra, step_ms, alive = [], [], [], {}
    n_split = 0
    for step in range(1, S2D_STEPS + S2D_STEPS_AFTER + 1):
        view = step % len(cams)
        t0 = time.perf_counter()
        state, scalars = trainer.train_step(
            state, cams[view], targets[view], H, W,
            trainer.sh_degree_at(step), bg)
        losses.append(float(scalars["loss"]))       # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        extra.append((float(scalars["normal_loss"]),
                      float(scalars["dist_loss"])))
        if step == S2D_DENSIFY_AT:
            # a tenth of the seen surfels above the threshold
            d = state.density
            stat = (d.grad_accum / d.denom.clamp(min=1.0))[d.denom > 0]
            k = max(int(0.9 * stat.numel()), 1)
            trainer.density_cfg.densify_grad_threshold = float(
                stat.kthvalue(k).values)
        alive[step] = state.gaussians.n_alive
        prev = state
        t0 = time.perf_counter()
        state = trainer.maybe_density_ops(state, gen, step)
        torch.cuda.synchronize()
        if step == S2D_DENSIFY_AT:
            ms = (time.perf_counter() - t0) * 1e3
            cap = prev.params.capacity
            was, now = prev.alive, state.alive[:cap]
            n_split = int((was & now & (state.params.scales[:cap]
                                        != prev.params.scales).any(-1)).sum())
            log(f"step {step}: density ops {ms:.1f} ms; alive {alive[step]} "
                f"-> {state.gaussians.n_alive}, {n_split} surfels split in "
                f"place, pruned {int((was & ~now).sum())}, capacity {cap} "
                f"-> {state.params.capacity}, scales "
                f"{tuple(state.params.scales.shape)}")
        del prev
    launches = {k: v for k, v in read_launches().items()
                if k in SURFEL_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(x) for x in losses):
        fail(f"2DGS training: non-finite loss in {losses}")
    first = float(np.mean(losses[:3]))
    last = float(np.mean(losses[S2D_STEPS - 3:S2D_STEPS]))
    if not last < first:
        fail(f"2DGS training: mean loss of steps {S2D_STEPS - 2}-"
             f"{S2D_STEPS} {last} is not below that of steps 1-3 {first}")
    if not all(n > 0.0 and d > 0.0 for n, d in extra):
        fail(f"2DGS training: a normal or distortion loss is 0 in {extra}")
    for k in PARAM_FIELDS:
        if not bool(torch.isfinite(getattr(state.params, k)).all()):
            fail(f"2DGS training: non-finite {k}")
    if n_split <= 0 or state.params.scales.shape[1] != 2:
        fail("2DGS training: the densify split no surfel")
    for name, count in launches.items():
        if count <= 0:
            fail(f"2DGS training path never launched kernel {name}")
    log(f"2DGS training: losses {[round(x, 5) for x in losses]}")
    log("2DGS training: (normal, distortion) loss terms "
        f"{[(round(n, 5), round(d, 5)) for n, d in extra]}")
    log(f"2DGS training: mean loss steps 1-3 {first:.5f}, steps "
        f"{S2D_STEPS - 2}-{S2D_STEPS} {last:.5f}; launches {launches} in "
        f"{len(losses)} steps; peak memory {peak_gb:.3f} GiB")
    log("2DGS training: ms per step (host clock, synchronised) "
        + json.dumps([round(x, 2) for x in step_ms]))
    return serving, launches


FIT_VIEWS, SFM_POINTS = 24, 100_000
FIT_STEPS, RESUME_STEPS, VARIANT_STEPS = 300, 400, 100
LOG_INTERVAL = 100                 # FitConfig's, which the presets keep
FIT_OVERRIDES = ("model.density.init_args.densify_from_iter=100",
                 "model.density.init_args.densification_interval=100")
PRESETS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "gsl_tpu_torch", "configs")
SH_C0 = 0.28209479177387814


class Tee(io.TextIOBase):
    """Standard output that is also kept, to read what a command said."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, s):
        self.kept.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def fit_poses():
    """The FIT_VIEWS camera-to-world poses of phase 8's scene: the bench
    pose, then an orbit around TARGET."""
    return [np.eye(4)] + [
        orbit_c2w(yaw, 8.0 * math.sin(i), 5.0, TARGET)
        for i, yaw in enumerate(np.linspace(-40.0, 40.0, FIT_VIEWS - 1))]


def write_colmap_scene(root, arrays):
    """FIT_VIEWS views of the bench scene rendered by the port at HxW (the
    bench pose, then an orbit around TARGET) as images/*.png, and
    sparse/0/{cameras,images,points3D}.bin with SFM_POINTS of the bench
    means and their DC colours as the SfM cloud."""
    state = state_from_raw_arrays(arrays, device="cuda")
    renderer = TileRendererConfig().instantiate()
    bg = torch.zeros(3, device="cuda")
    os.makedirs(os.path.join(root, "images"))
    images = {}
    for i, c2w in enumerate(fit_poses()):
        with torch.no_grad():
            out = renderer.forward(state, camera(c2w), H, W, bg, SH_DEGREE)
        img = (out.render.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        name = f"view_{i:03d}.png"
        Image.fromarray(img).save(os.path.join(root, "images", name),
                                  compress_level=PNG_LEVEL)
        w2c = np.linalg.inv(c2w)
        images[i + 1] = ColmapImage(i + 1, rotmat_to_qvec(w2c[:3, :3]),
                                    w2c[:3, 3], 1, name)
    pick = np.random.RandomState(3).choice(N_GAUSSIANS, SFM_POINTS,
                                           replace=False)
    rgb = np.clip(0.5 + SH_C0 * arrays["shs_dc"][pick, 0], 0.0, 1.0)
    write_model_bin(ColmapModel(
        cameras={1: ColmapCamera(1, "PINHOLE", W, H,
                                 np.array([FOCAL, FOCAL, W / 2, H / 2]))},
        images=images, points_xyz=arrays["means"][pick].astype(np.float64),
        points_rgb=(rgb * 255 + 0.5).astype(np.uint8),
        points_err=np.zeros(SFM_POINTS)), os.path.join(root, "sparse", "0"))


def run_cli(argv, kernels):
    """cli.main(argv), the launch counters zeroed just before and read just
    after; fails unless every kernel in `kernels` was launched. Returns a
    dict: state, results, launches, peak_gib, said (standard output) and,
    for a fit, timing (its fit_timing.json) and rows (train_log.csv)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        state, results = cli.main(argv)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    for name in kernels:
        if launches.get(name, 0) <= 0:
            fail(f"{' '.join(argv)}: kernel {name} was never launched")
    if set(launches) - set(kernels):
        fail(f"{' '.join(argv)}: launched {launches}, a kernel of another "
             "path among them")
    out = {"state": state, "results": results, "launches": launches,
           "said":
           tee.kept.getvalue(),
           "peak_gib": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)}
    if argv[0] == "fit":
        run = os.path.join(argv[argv.index("--output") + 1],
                           argv[argv.index("-n") + 1])
        with open(os.path.join(run, "fit_timing.json")) as f:
            out["timing"] = json.load(f)
        with open(os.path.join(run, "train_log.csv")) as f:
            out["rows"] = list(csv.reader(f))[1:]
        if not all(math.isfinite(float(r[1])) for r in out["rows"]):
            fail(f"{run}: a non-finite loss in {out['rows']}")
    return out


def log_fit(tag, fits, warm=()):
    """A fit's numbers: ms per step in each log window (the median over
    the windows `warm` after warm-up), Gaussians and loss per window, the
    share of wall time waiting on next(loader), ms per densify and its
    counts (alive before, cloned, split, pruned, alive after), peak memory
    and launches, for each run in `fits`."""
    rows = fits[-1]["rows"]
    ms = {int(r[0]): round(1e3 / float(r[3]), 2) for r in rows}
    log(f"{tag}: ms per step in each log window {ms}" + (
        f"; median over the windows ending {list(warm)} "
        f"{float(np.median([ms[s] for s in warm])):.2f}" if warm else ""))
    log(f"{tag}: Gaussians per log window "
        f"{ {int(r[0]): int(r[2]) for r in rows} }; loss "
        f"{ {int(r[0]): round(float(r[1]), 5) for r in rows} }")
    for f in fits:
        t = f["timing"]
        n = t["end_step"] - t["start_step"] + 1
        log(f"{tag}: steps {t['start_step']}-{t['end_step']}: "
            f"{1e3 * t['wall_s'] / n:.2f} ms per step over the loop; "
            f"waiting on next(loader) {t['loader_wait_s']:.3f} of "
            f"{t['wall_s']:.2f} s "
            f"({100 * t['loader_wait_s'] / t['wall_s']:.2f}%); ms per "
            f"densify {[round(x, 2) for x in t['densify_ms']]}; peak "
            f"memory {f['peak_gib']} GiB; launches {f['launches']}")
        for d in t["densify"]:
            if "dead" in d:     # an MCMC relocation and growth round
                log(f"{tag}: relocation at step {d['step']}: {d['before']} "
                    f"alive, {d['dead']} dead relocated, {d['added']} added "
                    f"-> {d['after']}")
                continue
            if "net" in d:      # a GNS round: its split and opacity prune
                log(f"{tag}: densify at step {d['step']}: {d['before']} "
                    f"alive, budget {d['budget']}, net change {d['net']} "
                    f"-> {d['after']}")
                continue
            budget = f" (budget {d['budget']})" if "budget" in d else ""
            log(f"{tag}: densify at step {d['step']}: {d['before']} alive, "
                f"{d['clone']} cloned, {d['split']} split, {d['pruned']} "
                f"pruned -> {d['after']}{budget}")


def phase_fit(arrays, tmp):
    """Phase 8 in the directory `tmp`; its scene stays there for phase 9."""
    log("== phase 8: a synthesised COLMAP scene fitted through "
        "gsl_tpu_torch.cli at 1088x1920")
    colmap = os.path.join(PRESETS, "colmap.yaml")
    data, runs = os.path.join(tmp, "scene"), os.path.join(tmp, "runs")
    t0 = time.perf_counter()
    write_colmap_scene(data, arrays)
    log(f"fit: {FIT_VIEWS} views at {H}x{W} and {SFM_POINTS} SfM points "
        f"written in {time.perf_counter() - t0:.1f} s")

    def argv(sub, name, steps, preset=colmap, extra=FIT_OVERRIDES):
        return [sub, "--config", preset, "--data.path", data,
                "--output", runs, "-n", name, "--max_steps",
                str(steps), *extra]

    # the initial cloud, initialised as the fit initialises it
    trainer, dp_cfg, fit_cfg = cli.build_components(cli.load_config(
        [colmap], cli.parse_overrides(FIT_OVERRIDES
                                      + (f"data.path={data}",))))
    outputs = dp_cfg.instantiate().get_outputs()
    fit_cfg.output_dir = os.path.join(tmp, "initial")
    with contextlib.redirect_stdout(io.StringIO()):
        psnr0 = validate(trainer, trainer.setup(
            _init_gaussians(trainer, outputs, fit_cfg, "cuda"),
            outputs.camera_extent), outputs, fit_cfg)["psnr"]
    del trainer

    first = run_cli(argv("fit", "colmap", FIT_STEPS), GAUSSIAN_KERNELS)
    second = run_cli(argv("fit", "colmap", RESUME_STEPS),
                     GAUSSIAN_KERNELS)
    if f"-> continuing at {FIT_STEPS + 1}" not in second["said"]:
        fail(f"the second fit did not continue at {FIT_STEPS + 1}")
    run = os.path.join(runs, "colmap")
    for rel in [f"checkpoints/step_{s}/{f}"
                for s in (FIT_STEPS, RESUME_STEPS)
                for f in ("state.pt", "fit_meta.json")] + [
            f"point_cloud/iteration_{s}/point_cloud.ply"
            for s in (FIT_STEPS, RESUME_STEPS)] + [
            "train_log.csv", "metrics/val.csv", "config.yaml"]:
        if not os.path.isfile(os.path.join(run, rel)):
            fail(f"the fit wrote no {rel}")
    if [int(r[0]) for r in second["rows"]] != list(
            range(LOG_INTERVAL, RESUME_STEPS + 1, LOG_INTERVAL)) \
            or second["rows"][:len(first["rows"])] != first["rows"]:
        fail(f"train_log.csv holds {second['rows']}, not the first "
             f"run's {first['rows']} and then the resumed run's")
    val = run_cli(["validate", "--output", runs, "-n", "colmap"],
                  ("expand", "rasterize_fwd"))
    psnr = val["results"]["psnr"]
    if not psnr > psnr0:
        fail(f"val PSNR at step {RESUME_STEPS}, {psnr:.3f} dB, is not "
             f"above the initial cloud's {psnr0:.3f}")
    picked = GaussianModelLoader.search_load_file(run)
    if picked != os.path.join(run, "checkpoints", f"step_{RESUME_STEPS}"):
        fail(f"GaussianModelLoader picked {picked}")
    loaded, renderer, sh_degree = GaussianModelLoader.load(run)
    with torch.no_grad():
        frame = renderer.forward(loaded, camera(np.eye(4)), H, W,
                                 torch.zeros(3, device="cuda"),
                                 sh_degree).render
    if not (bool(torch.isfinite(frame).all())
            and float(frame.mean()) > 0.0):
        fail("the loaded model renders no finite frame")
    log(f"fit: val PSNR of the initial cloud {psnr0:.3f} dB, at step "
        f"{FIT_STEPS} {first['results']['psnr']:.3f}, at step "
        f"{RESUME_STEPS} {second['results']['psnr']:.3f} (validate "
        f"command {psnr:.3f}, SSIM {val['results']['ssim']:.4f}); the "
        f"loader took step_{RESUME_STEPS}, {loaded.capacity} Gaussians, "
        f"frame mean {float(frame.mean()):.4f}")
    del loaded, frame
    # a run's first window holds its warm-up and first image decodes
    warm = [s for s in range(LOG_INTERVAL, RESUME_STEPS + 1,
                             LOG_INTERVAL)
            if s not in (LOG_INTERVAL, FIT_STEPS + LOG_INTERVAL)]
    log_fit("fit colmap.yaml", [first, second], warm)
    ms = {int(r[0]): 1e3 / float(r[3]) for r in second["rows"]}
    colmap_fit = {"psnr0": psnr0, "psnr": first["results"]["psnr"],
                  "ms": float(np.median([ms[s] for s in warm])),
                  "loader_share": first["timing"]["loader_wait_s"]
                  / first["timing"]["wall_s"]}

    for preset, kernels in (("gs2d.yaml", SURFEL_KERNELS),
                            ("stp.yaml", STP_KERNELS)):
        name = preset.split(".")[0]
        f = run_cli(argv("fit", name, VARIANT_STEPS,
                         preset=os.path.join(PRESETS, preset), extra=()),
                    kernels)
        log(f"fit {preset}: val PSNR {f['results']['psnr']:.3f} dB at "
            f"step {VARIANT_STEPS}")
        log_fit(f"fit {preset}", [f])
    return colmap_fit


VARIANT_TRAIN_STEPS, FILTER_AT = 10, 5       # phase 9 (a): steps, recompute
MCMC_DEAD_SHARE, MCMC_CAP_MAX = 0.05, 2_000_000
MCMC_STEPS_AFTER = 2                          # steps at the grown capacity
VARIANT_FIT_STEPS, MIP_RESUME_STEPS, ABSGRAD_STEPS = 200, 300, 100
VARIANT_LOG_INTERVAL = 50


def fit_cameras():
    """Phase 8's FIT_VIEWS cameras as one batch on the card."""
    return stack_cameras([camera(c2w) for c2w in fit_poses()])


def check_step_launches(what, step):
    """Fails unless the step just run launched K1-K4 once each and no
    other kernel (the counters were zeroed just before it)."""
    counts = read_launches()
    want = {k: (1 if k in GAUSSIAN_KERNELS else 0) for k in counts}
    if counts != want:
        fail(f"{what} step {step}: launches {counts}, not K1-K4 once each")


def variant_steps(what, trainer, state, cams, targets, bg, first_step,
                  n_steps, after=None):
    """`n_steps` train_steps from `first_step`, each checked for its
    launches, and `after(state, step)` (untimed in the step, launching no
    kernel) after each. Returns (state, losses, ms per step, ms of after)."""
    losses, step_ms, after_ms = [], [], []
    for step in range(first_step, first_step + n_steps):
        view = step % len(cams)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, scalars = trainer.train_step(
            state, cams[view], targets[view], H, W, SH_DEGREE, bg)
        losses.append(float(scalars["loss"]))       # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check_step_launches(what, step)
        if after is not None:
            t0 = time.perf_counter()
            state = after(state, step)
            torch.cuda.synchronize()
            after_ms.append((time.perf_counter() - t0) * 1e3)
            check_step_launches(f"{what} (and the pass after it)", step)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss in {losses}")
    for k in PARAM_FIELDS:
        if not bool(torch.isfinite(getattr(state.params, k)).all()):
            fail(f"{what}: non-finite {k}")
    return state, losses, step_ms, after_ms


def phase_mip(arrays):
    """Phase 9 (a), Mip-Splatting at full width."""
    log("== phase 9 (a): Mip-Splatting at 1088x1920: compute_3d_filter, "
        "ViewerRenderer -> MipSplattingRenderer, Trainer.train_step")
    state = state_from_raw_arrays(arrays, device="cuda")
    fcams = fit_cameras()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f3d = compute_3d_filter(state.params.means, state.alive, fcams)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not (bool(torch.isfinite(f3d).all()) and float(f3d.min()) > 0.0):
        fail("compute_3d_filter: non-finite or non-positive filter")
    log(f"Mip-Splatting: compute_3d_filter over {len(fcams)} cameras at "
        f"{N_GAUSSIANS} Gaussians, host clock ms (synchronised) "
        f"{[round(x, 3) for x in times]}; filter_3d from "
        f"{float(f3d.min()):.3e} to {float(f3d.max()):.3e}")
    state.extra = {"filter_3d": f3d}
    renderer = MipSplattingRendererConfig().instantiate()
    vr = ViewerRenderer(state, renderer, SH_DEGREE)
    fov_y = math.degrees(2.0 * math.atan(0.5 * H / FOCAL))
    torch.cuda.synchronize()
    reset_launches()
    frame_ms = []
    for yaw in (0.0, 10.0, 20.0, 30.0, 40.0):
        t0 = time.perf_counter()
        img = vr.get_outputs(orbit_c2w(yaw, 0.0, 5.0, TARGET), W, H, fov_y)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if img.shape != (H, W, 3) or int(img.max()) == 0:
            fail(f"Mip-Splatting serving: frame at yaw {yaw} is wrong")
    launches = {k: v for k, v in read_launches().items() if v}
    if launches != {"expand": 5, "rasterize_fwd": 5}:
        fail(f"Mip-Splatting serving: launches {launches}")
    cam = camera(np.eye(4))
    stage_ms = stage_times(state, renderer, SH_DEGREE, cam)
    log(f"Mip-Splatting serving: 5 rgb frames, host clock ms per frame "
        f"{[round(x, 3) for x in frame_ms]}; launches {launches}; "
        "bench-pose stage ms (CUDA events, median of 5) "
        + json.dumps(stage_ms))

    trainer = Trainer(model=MipSplattingConfig(sh_degree=SH_DEGREE),
                      renderer=MipSplattingRendererConfig())
    bg = torch.zeros(3, device="cuda")
    cams = [camera(c2w) for c2w in views().values()]
    with torch.no_grad():
        targets = [renderer.forward(state, c, H, W, bg, SH_DEGREE).render
                   for c in cams]
    start = state_from_raw_arrays(perturbed(arrays), device="cuda")
    start.extra = {"filter_3d": f3d}
    del state, vr
    tstate = trainer.setup(start, cameras_extent=TRAIN_EXTENT)

    def recompute(st, step):
        if step != FILTER_AT:
            return st
        return dataclasses.replace(st, extra={"filter_3d": compute_3d_filter(
            st.params.means, st.alive, fcams)})

    tstate, losses, step_ms, after_ms = variant_steps(
        "Mip-Splatting training", trainer, tstate, cams, targets, bg, 1,
        VARIANT_TRAIN_STEPS, recompute)
    moved = float((tstate.extra["filter_3d"] - f3d).abs().max())
    if tstate.gaussians.n_alive != N_GAUSSIANS or not moved > 0.0:
        fail(f"Mip-Splatting training: alive {tstate.gaussians.n_alive}, "
             f"filter moved by {moved}")
    log(f"Mip-Splatting training at capacity {tstate.params.capacity}: "
        f"losses {[round(x, 5) for x in losses]}; ms per step (host "
        f"clock, synchronised) {[round(x, 2) for x in step_ms]}, median "
        f"{float(np.median(step_ms[1:])):.2f} over steps 2-"
        f"{VARIANT_TRAIN_STEPS}; filter recompute at step {FILTER_AT} "
        f"{after_ms[FILTER_AT - 1]:.2f} ms (moved by up to {moved:.3e}); "
        f"each step launched K1-K4 once; alive {tstate.gaussians.n_alive}")


def phase_mcmc(arrays):
    """Phase 9 (a), MCMC at full width."""
    log("== phase 9 (a): MCMC at 1088x1920: train_step with the MCMC "
        "regularisers, the position noise, a relocation and growth round "
        "through a capacity growth")
    cfg = MCMCDensityControllerConfig(cap_max=MCMC_CAP_MAX)
    trainer = Trainer(model=VanillaGaussianConfig(sh_degree=SH_DEGREE),
                      density=cfg, metrics=MCMCMetricsConfig())
    bg = torch.zeros(3, device="cuda")
    cams = [camera(c2w) for c2w in views().values()]
    with torch.no_grad():
        truth = state_from_raw_arrays(arrays, device="cuda")
        targets = [trainer.renderer.forward(truth, c, H, W, bg,
                                            SH_DEGREE).render for c in cams]
        del truth
    start = perturbed(arrays)
    n_dead = int(MCMC_DEAD_SHARE * N_GAUSSIANS)
    dead_rows = np.random.RandomState(5).choice(N_GAUSSIANS, n_dead,
                                                replace=False)
    start["opacities"] = start["opacities"].copy()
    start["opacities"][dead_rows] = math.log(0.001 / 0.999)
    state = trainer.setup(state_from_raw_arrays(start, device="cuda"),
                          cameras_extent=TRAIN_EXTENT)
    hook = MCMCDensityHook(FitContext(
        trainer=trainer, outputs=None, dataset=None,
        cfg=FitConfig(max_steps=1000), bg=bg))
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, losses, step_ms, noise_ms = variant_steps(
        "MCMC training", trainer, state, cams, targets, bg, 1,
        VARIANT_TRAIN_STEPS, lambda st, step: hook.noise(st, gen, step))
    dead = int(dead_mask(state.gaussians, cfg).sum())
    n_alive = state.gaussians.n_alive
    target = grow_target(n_alive, cfg)
    if dead != n_dead or n_alive != N_GAUSSIANS:
        fail(f"MCMC: {dead} dead of {n_alive} alive before the round, "
             f"predicted {n_dead} of {N_GAUSSIANS}")

    rounds, ms = [], []
    saved = gen.get_state()
    for _ in range(2):                 # the same generator state twice
        gen.set_state(saved)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rounds.append(hook.density_round(state, gen))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if any(read_launches().values()):
            fail(f"MCMC round launched {read_launches()}")
    a, b = rounds
    same = (all(torch.equal(getattr(a.params, k), getattr(b.params, k))
                and torch.equal(a.opt_state.exp_avg[k], b.opt_state.exp_avg[k])
                and torch.equal(a.opt_state.exp_avg_sq[k],
                                b.opt_state.exp_avg_sq[k])
                for k in PARAM_FIELDS)
            and torch.equal(a.alive, b.alive))
    if not same:
        fail("MCMC: two rounds from the same generator state differ")
    after = a.gaussians.n_alive
    relocated = int((a.params.opacities[:state.params.capacity, 0]
                     != state.params.opacities[:, 0])[
                         torch.from_numpy(dead_rows).cuda()].sum())
    if (after != target or a.params.capacity != 1 << 21
            or hook.n_new != target - n_alive or relocated != n_dead):
        fail(f"MCMC round: alive {n_alive} -> {after} (predicted "
             f"{target}), capacity {a.params.capacity}, added "
             f"{hook.n_new}, relocated {relocated} of {n_dead} dead")
    del b, rounds
    state, after_losses, after_ms, _ = variant_steps(
        "MCMC training", trainer, a, cams, targets, bg,
        VARIANT_TRAIN_STEPS + 1, MCMC_STEPS_AFTER,
        lambda st, step: hook.noise(st, gen, step))
    log(f"MCMC training at capacity {N_GAUSSIANS}: losses "
        f"{[round(x, 5) for x in losses]}; ms per step (host clock, "
        f"synchronised) {[round(x, 2) for x in step_ms]}, median "
        f"{float(np.median(step_ms[1:])):.2f} over steps 2-"
        f"{VARIANT_TRAIN_STEPS}; noise step ms "
        f"{[round(x, 2) for x in noise_ms]}; each step launched K1-K4 once")
    log(f"MCMC round: {dead} dead relocated ({relocated} rewritten), "
        f"{hook.n_new} added, alive {n_alive} -> {after}, capacity "
        f"{N_GAUSSIANS} -> {a.params.capacity}; ms (host clock, "
        f"synchronised) {[round(x, 2) for x in ms]}; the two rounds from "
        "one generator state are identical")
    log(f"MCMC training at capacity {state.params.capacity}: losses "
        f"{[round(x, 5) for x in after_losses]}; ms per step "
        f"{[round(x, 2) for x in after_ms]}")


def initial_psnr(configs, overrides, tmp, name):
    """Val PSNR of the initial cloud, built as the fit builds it."""
    trainer, dp_cfg, fit_cfg = cli.build_components(cli.load_config(
        configs, cli.parse_overrides(overrides)))
    outputs = dp_cfg.instantiate().get_outputs()
    fit_cfg.output_dir = os.path.join(tmp, f"initial_{name}")
    with contextlib.redirect_stdout(io.StringIO()):
        gaussians = _init_gaussians(trainer, outputs, fit_cfg, "cuda")
        psnr0 = validate(trainer, trainer.setup(
            gaussians, outputs.camera_extent), outputs, fit_cfg)["psnr"]
    return psnr0, gaussians.extra


def phase_variant_fits(tmp):
    """Phase 9 (b): the Mip-Splatting, MCMC and AbsGS presets fitted
    through the CLI on phase 8's scene."""
    log("== phase 9 (b): mip_splatting.yaml, mcmc.yaml and absgrad.yaml "
        "fitted through gsl_tpu_torch.cli on phase 8's scene")
    data, runs = os.path.join(tmp, "scene"), os.path.join(tmp, "runs")
    colmap = os.path.join(PRESETS, "colmap.yaml")
    windows = (f"fit.log_interval={VARIANT_LOG_INTERVAL}",)
    fits = {
        "mip_splatting": (VARIANT_FIT_STEPS, windows + (
            "model.density.init_args.densify_from_iter=100",
            "model.density.init_args.densification_interval=100",
            "model.gaussian.init_args.filter_3d_update_interval=100")),
        "mcmc": (VARIANT_FIT_STEPS, windows + (
            "model.density.init_args.densify_from_iter=100",
            "model.density.init_args.densification_interval=50")),
        "absgrad": (ABSGRAD_STEPS, windows + (
            "model.density.init_args.densify_from_iter=50",
            "model.density.init_args.densification_interval=50")),
    }
    for name, (steps, extra) in fits.items():
        configs = [colmap, os.path.join(PRESETS, f"{name}.yaml")]
        psnr0, extra0 = initial_psnr(configs, extra + (f"data.path={data}",),
                                     tmp, name)

        def argv(n_steps):
            return ["fit", "--config", configs[0], "--config", configs[1],
                    "--data.path", data, "--output", runs, "-n", name,
                    "--max_steps", str(n_steps), *extra]

        f = run_cli(argv(steps), GAUSSIAN_KERNELS)
        fitted = [f]
        psnr = f["results"]["psnr"]
        if not psnr > psnr0:
            fail(f"fit {name}.yaml: val PSNR {psnr:.3f} dB at step {steps} "
                 f"is not above the initial cloud's {psnr0:.3f}")
        n_rounds = len(f["timing"]["densify"])
        if n_rounds != (2 if name == "mcmc" else 1):
            fail(f"fit {name}.yaml: {n_rounds} densify rounds")
        said = f"val PSNR initial cloud {psnr0:.4f} dB, at step {steps} " \
            f"{psnr:.4f}"
        if name == "mip_splatting":
            ckpt = torch.load(os.path.join(
                runs, name, "checkpoints", f"step_{steps}", "state.pt"),
                map_location="cuda", weights_only=True)
            kept = ckpt["extra"]["filter_3d"]
            del f["state"]
            r = run_cli(argv(MIP_RESUME_STEPS), GAUSSIAN_KERNELS)
            if f"-> continuing at {steps + 1}" not in r["said"]:
                fail(f"the Mip-Splatting resume did not continue at "
                     f"{steps + 1}")
            rows = ckpt["alive"]
            got = r["state"].extra["filter_3d"][:rows.numel()]
            init = extra0["filter_3d"][:rows.numel()]
            if not (torch.equal(got[rows], kept[rows])
                    and not torch.equal(kept[rows], init[rows])):
                fail("the Mip-Splatting resume did not keep the "
                     "checkpoint's filter_3d")
            fitted.append(r)
            said += (f", at step {MIP_RESUME_STEPS} "
                     f"{r['results']['psnr']:.3f}; the resume continued at "
                     f"{steps + 1} and kept the checkpoint's filter_3d on "
                     f"its {int(rows.sum())} alive rows")
            del ckpt, kept, got, init
        for fr in fitted:
            fr.pop("state", None)
        log(f"fit {name}.yaml: {said}")
        last = fitted[-1]["rows"]
        warm = [int(row[0]) for row in last][1:]
        warm = [s for s in warm if s not in (steps + VARIANT_LOG_INTERVAL,)]
        log_fit(f"fit {name}.yaml", fitted, warm)

# ---- phase 10: geometry ---------------------------------------------------

GEOMETRY_WIDTHS = (1, 4, 7)       # hard inverse depth; + rgb; rgb, depth, n
GEOMETRY_STEPS = 10
DEPTH_A, DEPTH_B = 2.0, -0.05     # estimated d = (inverse depth - b) / a > 0
DEPTH_FIT_STEPS, DEPTH_RESUME_STEPS = 200, 300
MESH_RESOLUTION = 256
CARD = "the card"     # nvidia-smi's name and power limit, set by main


def geometry_channels(state, renderer, cam, proj, C):
    """(opacities, channels) as TileRenderer.forward composites them for
    the depth and normal regularisers: C = 1, the hard-inverse-depth pass
    (every splat opaque); C = 4, rgb + inverse depth; C = 7, rgb + depth +
    the normal facing the camera."""
    op = renderer.get_opacities(state, cam, proj)
    d = proj.depths[:, None]
    inv = 1.0 / torch.clamp(d, min=1e-8)
    if C == 1:
        return (op > 0.0).to(op.dtype).contiguous(), inv.contiguous()
    rgb = renderer.get_rgbs(state, cam, SH_DEGREE)
    if C == 4:
        return op.contiguous(), torch.cat([rgb, inv], 1).contiguous()
    normals = quat_to_rotmat(normalize_quat(state.get_rotations()))[:, :, 2]
    away = torch.sum(normals * (state.get_means() - cam.camera_center),
                     -1) > 0.0
    normals = normals * torch.where(away, -1.0, 1.0)[:, None]
    return op.contiguous(), torch.cat([rgb, d, normals], 1).contiguous()


def hold_raster_kernels(vname, proj, opac, ch, n, seed, cotangents=None,
                        record=None):
    """K1-K4 at the bench pose on the opacities `opac` and channels `ch`
    of a projection, held against their plain versions as phase 3 holds
    them (K1 bit for bit, K2's stops and values at its shares, K3's
    columns, K4's sums), K2 twice and built without contraction. K3 takes
    the (image [H, W, C], alpha [H, W]) `cotangents`, or random ones drawn
    from `seed`. Returns the (K2, K3) ms of a CUDA graph replay; `record`
    (a dict) gets the kernels' inputs and the counts of the plain
    versions."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    C = ch.shape[1]
    tag = f"{vname} C={C}"
    m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
    depths = proj.depths.contiguous()
    isects = R.isect_encode(proj, H, W, TILE)
    args = (isects, m2d, con, opac, depths, tiles_x, tiles_y, TILE, True)
    keys, gids = R.expand(*args)
    keys_p, gids_p = R.expand_plain(*args)
    if not (torch.equal(keys, keys_p) and torch.equal(gids, gids_p)):
        fail(f"K1 {tag}: kernel differs from expand_plain")
    sk, gs, order = R.sort_slots(keys, gids)
    n_valid = int((sk != R.INVALID_KEY).sum())
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    gids = gs[:n_valid].contiguous()
    fwd = (m2d, con, opac, ch, gids, bounds, H, W, TILE)
    got = R.rasterize_fwd(*fwd)
    fstats = {}
    want = R.rasterize_fwd_plain(*fwd, stats=fstats)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, R.rasterize_fwd(
            *fwd))):
        fail(f"K2 {tag}: two runs gave different outputs")
    err, share = compare_raster(f"K2 {tag}", got, want)
    loose = R.rasterize_fwd(*fwd, contract=False)
    ustop = float((loose[2] == want[2]).float().mean())
    if ustop < UNCONTRACTED_SHARE:
        fail(f"K2 {tag} built without contraction: i_stop agrees on "
             f"{ustop:.6f} of pixels < {UNCONTRACTED_SHARE}")
    off_share(f"K2 {tag} image, built without contraction", loose[0],
              want[0], 1.0 - UNCONTRACTED_SHARE)
    off_share(f"K2 {tag} alpha, built without contraction",
              1 - loose[1], 1 - want[1], 1.0 - UNCONTRACTED_SHARE)
    log(f"K2 bench {tag}: i_stop agrees on {share:.6f}, max abs err "
        f"{err:.3e}; identical in two runs; built without contraction "
        f"i_stop agrees on {ustop:.7f}; {n_valid} valid slots")
    if cotangents is None:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        cotangents = (torch.randn((H, W, C), generator=gen, device="cuda"),
                      torch.randn((H, W), generator=gen, device="cuda"))
    bwd = (m2d, con, opac, ch, gids, bounds, *cotangents, got[1], got[2],
           TILE)
    brec = check_backward(vname, C, bwd, isects, order, n, False)
    if record is not None:
        record.update(brec, fwd=fwd, bwd=bwd, isects=isects, order=order,
                      n_valid=n_valid, near_pairs=fstats["near_pairs"])
    return (graph_ms(lambda: R.rasterize_fwd(*fwd), 20),
            graph_ms(lambda: R.rasterize_bwd(*bwd), 20))


def phase_geometry_kernels(state, renderer):
    """Phase 10 (a): K1-K4 against their plain versions at the bench pose
    at the widths the geometry losses train at, held as phase 3 holds them
    at C = 3. Returns {C: (K2 ms, K3 ms)}."""
    log("== phase 10 (a): K1-K4 against their plain versions at C = 1, 4 "
        f"and 7, full width; times on {CARD}")
    cam = camera(np.eye(4))
    proj = project_gaussians(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    times = {}
    for C in GEOMETRY_WIDTHS:
        opac, ch = geometry_channels(state, renderer, cam, proj, C)
        times[C] = hold_raster_kernels("bench", proj, opac, ch,
                                       state.capacity, 10 + C)
    log("K2 and K3 ms at the bench pose (CUDA graph, mean of 20 replays) "
        + json.dumps({f"C={C}": {"K2": round(f, 4), "K3": round(b, 4)}
                      for C, (f, b) in times.items()}))
    return times


def phase_geometry_training(arrays, plain_step_ms):
    """Phase 10 (a): DepthTrainer (hard and blended inverse depth), and
    Trainer with NormalRegPlugin and with GroundRegPlugin, 10 steps each
    at capacity 1M from phase 5's perturbed scene; the depth target is the
    scene's own hard inverse depth."""
    log("== phase 10 (a): depth, normal and ground regularisers at "
        f"1088x1920, capacity 1M; times on {CARD}")
    bg = torch.zeros(3, device="cuda")
    cams = [camera(c2w) for c2w in views().values()]
    truth = state_from_raw_arrays(arrays, device="cuda")
    renderer = TileRendererConfig().instantiate()
    with torch.no_grad():
        outs = [renderer.forward(truth, c, H, W, bg, SH_DEGREE,
                                 render_types=frozenset(
                                     {"rgb", "hard_inverse_depth"}))
                for c in cams]
    targets = [o.render for o in outs]
    depth_targets = [o.hard_inverse_depth for o in outs]
    del truth, outs
    model = VanillaGaussianConfig(sh_degree=SH_DEGREE)
    runs = {
        "depth hard_inverse_depth": (DepthTrainer, dict(
            metrics=DepthMetricsConfig(
                depth_output_key="hard_inverse_depth")), 2, "depth_loss"),
        "depth inverse_depth": (DepthTrainer, dict(
            metrics=DepthMetricsConfig(depth_output_key="inverse_depth")),
            1, "depth_loss"),
        "normal_reg": (Trainer, dict(plugins=(
            NormalRegPluginConfig().instantiate(),)), 1, "normal_loss"),
        "ground_reg z=0": (Trainer, dict(plugins=(
            GroundRegPluginConfig().instantiate(),)), 1, "ground"),
    }
    for what, (cls, kw, per_step, term_key) in runs.items():
        trainer = cls(model=model, **kw)
        state = trainer.setup(
            state_from_raw_arrays(perturbed(arrays), device="cuda"),
            cameras_extent=TRAIN_EXTENT)
        depth = cls is DepthTrainer
        want = {k: (per_step if k in GAUSSIAN_KERNELS else 0)
                for k in KERNELS}
        losses, terms, step_ms = [], [], []
        for step in range(1, GEOMETRY_STEPS + 1):
            view = step % len(cams)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            state, sc = trainer.train_step(
                state, cams[view], targets[view], H, W, SH_DEGREE, bg,
                **({"aux_inputs": depth_targets[view]} if depth else {}))
            losses.append(float(sc["loss"]))        # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            terms.append(float(sc[term_key]))
            if read_launches() != want:
                fail(f"{what} step {step}: launches {read_launches()}, not "
                     f"K1-K4 {per_step} times each")
        if not all(math.isfinite(x) for x in losses + terms):
            fail(f"{what}: non-finite loss in {losses} or term in {terms}")
        if depth and not terms[-1] < terms[0]:
            fail(f"{what}: the depth loss did not fall: {terms}")
        for k in PARAM_FIELDS:
            if not bool(torch.isfinite(getattr(state.params, k)).all()):
                fail(f"{what}: non-finite {k}")
        log(f"{what}: ms per step (host clock, synchronised) "
            f"{[round(x, 2) for x in step_ms]}, median "
            f"{float(np.median(step_ms[1:])):.2f} over steps 2-"
            f"{GEOMETRY_STEPS} (phase 5's plain step in this run "
            f"{plain_step_ms:.2f}); {term_key} at step 1 {terms[0]:.6g}, "
            f"at step {GEOMETRY_STEPS} {terms[-1]:.6g}; losses "
            f"{[round(x, 5) for x in losses]}; K1-K4 launched {per_step}x "
            "a step, nothing else")
        del trainer, state
        torch.cuda.empty_cache()


def write_depth_maps(root, arrays):
    """estimated_depths/<stem>.npy for phase 8's views: the port's rendered
    (blended) inverse depth mapped through d = (inv - b) / a."""
    state = state_from_raw_arrays(arrays, device="cuda")
    renderer = TileRendererConfig().instantiate()
    bg = torch.zeros(3, device="cuda")
    os.makedirs(os.path.join(root, "estimated_depths"))
    for i, c2w in enumerate(fit_poses()):
        with torch.no_grad():
            inv = renderer.forward(
                state, camera(c2w), H, W, bg, SH_DEGREE,
                render_types=frozenset({"rgb", "inverse_depth"})
            ).inverse_depth
        np.save(os.path.join(root, "estimated_depths", f"view_{i:03d}.npy"),
                ((inv - DEPTH_B) / DEPTH_A).cpu().numpy())


def visible_solve(root):
    """The tool's solve per view over the SfM points that the map sees at
    their own depth (the map's inverse depth within 1% of 1/z at their
    pixel, as a point tracked in that image would be): -> [(a, b)]."""
    model = read_model(os.path.join(root, "sparse", "0"))
    xyz = torch.as_tensor(model.points_xyz, device="cuda")
    out = []
    for im in model.images.values():
        stem = im.name.rsplit(".", 1)[0]
        d_est = torch.as_tensor(np.load(os.path.join(
            root, "estimated_depths", stem + ".npy")), device="cuda").double()
        R_ = torch.as_tensor(qvec_to_rotmat(im.qvec), device="cuda")
        t_ = torch.as_tensor(im.tvec, device="cuda")
        cam = model.cameras[im.camera_id]
        p = xyz @ R_.T + t_
        z = p[:, 2]
        u = torch.round(float(cam.fx) * p[:, 0] / z + float(cam.cx)).long()
        v = torch.round(float(cam.fy) * p[:, 1] / z + float(cam.cy)).long()
        ok = (z > 0.01) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        inv = d_est[v.clamp(0, H - 1), u.clamp(0, W - 1)] * DEPTH_A + DEPTH_B
        seen = ok & ((inv - 1.0 / z).abs() < 0.01 / z)
        ab = get_depth_scales.solve_scale(xyz[seen], R_, t_, cam, d_est, 10)
        out.append((ab, int(seen.sum()), int(ok.sum())))
    return out


def phase_depth_fits(arrays, tmp):
    """Phase 10 (b): estimated depth on phase 8's scene, the depth-scale
    tool, and the geometry presets fitted through the CLI."""
    log("== phase 10 (b): get_depth_scales and depth_regularization.yaml, "
        "normal_reg.yaml, ground_reg.yaml and scale_reg.yaml through "
        f"gsl_tpu_torch.cli on phase 8's scene; times on {CARD}")
    data, runs = os.path.join(tmp, "scene"), os.path.join(tmp, "runs")
    t0 = time.perf_counter()
    write_depth_maps(data, arrays)
    log(f"depth: {FIT_VIEWS} maps d = (inverse depth - ({DEPTH_B})) / "
        f"{DEPTH_A} written in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        solved = get_depth_scales.main([data])
    tool_s = time.perf_counter() - t0
    a = np.array([v["scale"] for v in solved.values()])
    b = np.array([v["offset"] for v in solved.values()])
    log(f"get_depth_scales: {len(solved)} of {FIT_VIEWS} views solved in "
        f"{tool_s:.2f} s; known a {DEPTH_A}, b {DEPTH_B}; recovered a "
        f"median {np.median(a):.6g} (from {a.min():.6g} to {a.max():.6g}),"
        f" b median {np.median(b):.6g} (from {b.min():.6g} to "
        f"{b.max():.6g})")
    vis = visible_solve(data)
    va = np.array([ab[0] for ab, _, _ in vis if ab is not None])
    vb = np.array([ab[1] for ab, _, _ in vis if ab is not None])
    log(f"get_depth_scales' solve over the SfM points each map sees at "
        f"their own depth ({[s for _, s, _ in vis]} of "
        f"{[o for _, _, o in vis]} in view): a from {va.min():.6g} to "
        f"{va.max():.6g}, b from {vb.min():.6g} to {vb.max():.6g} (known "
        f"{DEPTH_A}, {DEPTH_B}) in {len(va)} views")
    if len(va) < FIT_VIEWS or not (np.abs(va - DEPTH_A).max() < 0.02
                                   * DEPTH_A
                                   and np.abs(vb - DEPTH_B).max() < 0.01):
        fail("the depth-scale solve over the visible points did not "
             "recover the known affine")
    # the fit reads the affine the maps were made with: the tool's solve
    # over all SfM points of this volumetric scene is printed above
    with open(os.path.join(data, "estimated_depth_scales.json"), "w") as f:
        json.dump({f"view_{i:03d}.png": {"scale": DEPTH_A,
                                         "offset": DEPTH_B}
                   for i in range(FIT_VIEWS)}, f)

    colmap = os.path.join(PRESETS, "colmap.yaml")
    windows = (f"fit.log_interval={VARIANT_LOG_INTERVAL}",
               "model.density.init_args.densify_from_iter=100",
               "model.density.init_args.densification_interval=100")
    depth_terms = {}
    step_of = DepthTrainer.train_step

    def spy(self, state, *args, **kw):
        new, sc = step_of(self, state, *args, **kw)
        if new.step % VARIANT_LOG_INTERVAL == 0 or new.step == 1:
            depth_terms[new.step] = (None if "depth_loss" not in sc
                                     else float(sc["depth_loss"]))
        return new, sc

    fits = {"depth_regularization": DEPTH_FIT_STEPS, "normal_reg":
            VARIANT_STEPS, "ground_reg": VARIANT_STEPS, "scale_reg":
            VARIANT_STEPS}
    for name, steps in fits.items():
        configs = [colmap, os.path.join(PRESETS, f"{name}.yaml")]
        psnr0, _ = initial_psnr(configs, windows + (f"data.path={data}",),
                                tmp, name)

        def argv(n_steps):
            return ["fit", "--config", configs[0], "--config", configs[1],
                    "--data.path", data, "--output", runs, "-n", name,
                    "--max_steps", str(n_steps), *windows]

        DepthTrainer.train_step = spy
        try:
            fitted = [run_cli(argv(steps), GAUSSIAN_KERNELS)]
            if name == "depth_regularization":
                r = run_cli(argv(DEPTH_RESUME_STEPS), GAUSSIAN_KERNELS)
                if f"-> continuing at {steps + 1}" not in r["said"]:
                    fail(f"the depth fit's resume did not continue at "
                         f"{steps + 1}")
                fitted.append(r)
        finally:
            DepthTrainer.train_step = step_of
        psnr = fitted[-1]["results"]["psnr"]
        if not psnr > psnr0:
            fail(f"fit {name}.yaml: val PSNR {psnr:.3f} dB is not above "
                 f"the initial cloud's {psnr0:.3f}")
        n_steps = sum(f["timing"]["end_step"] - f["timing"]["start_step"]
                      + 1 for f in fitted)
        per_step = {k: round(sum(f["launches"].get(k, 0) for f in fitted)
                             / n_steps, 3) for k in GAUSSIAN_KERNELS}
        said = (f"val PSNR initial cloud {psnr0:.4f} dB, at step "
                f"{fitted[-1]['timing']['end_step']} {psnr:.4f}; launches a "
                f"step, validation included {per_step}")
        if name == "depth_regularization":
            logged = sorted(depth_terms)
            if any(depth_terms[s] is None for s in logged):
                fail(f"the depth fit stepped without a map: {depth_terms}")
            first, last = depth_terms[logged[0]], depth_terms[logged[-1]]
            if not (math.isfinite(first) and math.isfinite(last)
                    and last < first):
                fail(f"the depth fit's depth term did not fall: "
                     f"{depth_terms}")
            said += (f"; depth term at step {logged[0]} {first:.6g}, at "
                     f"step {logged[-1]} {last:.6g} (every logged step "
                     f"{ {s: round(v, 6) for s, v in depth_terms.items()} })")
        for f in fitted:
            f.pop("state", None)
        log(f"fit {name}.yaml: {said}")
        warm = [int(row[0]) for row in fitted[-1]["rows"]][1:]
        warm = [s for s in warm if s != steps + VARIANT_LOG_INTERVAL]
        log_fit(f"fit {name}.yaml", fitted, warm)
        torch.cuda.empty_cache()


def phase_mesh(tmp):
    """Phase 10 (c): python -m gsl_tpu_torch.tools.gs2d_mesh_extraction on
    phase 8's gs2d.yaml run, expected depth, resolution 256."""
    log(f"== phase 10 (c): gs2d_mesh_extraction of phase 8's gs2d.yaml run "
        f"at resolution {MESH_RESOLUTION} with --expected-depth; times on "
        f"{CARD}")
    run = os.path.join(tmp, "runs", "gs2d")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        got = gs2d_mesh_extraction.main([run, "--resolution",
                                         str(MESH_RESOLUTION),
                                         "--expected-depth"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: v for k, v in read_launches().items() if v}
    if launches != {"surfel_expand": FIT_VIEWS, "surfel_fwd": FIT_VIEWS}:
        fail(f"mesh extraction launched {launches}, not K5 and K6 once a "
             "view")
    verts, faces = got["verts"], got["faces"]
    if not (len(verts) > 0 and len(faces) > 0
            and bool(torch.isfinite(verts).all())
            and int(faces.min()) >= 0 and int(faces.max()) < len(verts)):
        fail(f"mesh extraction: {len(verts)} vertices, {len(faces)} faces")
    e = torch.cat([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    key = e.min(1).values * len(verts) + e.max(1).values
    _, counts = torch.unique(key, return_counts=True)
    shared = float((counts == 2).float().mean())
    with open(got["path"], "rb") as f:
        head = f.read(300)
    if not (head.startswith(b"ply") and b"element face" in head):
        fail(f"{got['path']} is not a PLY mesh")
    log(f"mesh: {len(verts)} vertices, {len(faces)} faces, {shared:.4f} of "
        f"{len(counts)} edges shared by two faces; ms per view (host clock, "
        f"synchronised): render median "
        f"{float(np.median(got['render_ms'])):.2f}, integrate median "
        f"{float(np.median(got['integrate_ms'])):.2f} (from "
        f"{min(got['integrate_ms']):.2f} to {max(got['integrate_ms']):.2f}) "
        f"over {len(got['integrate_ms'])} views of "
        f"{MESH_RESOLUTION ** 3} voxels; marching tetrahedra (extract_mesh) "
        f"{got['extract_ms']:.1f} ms; the tool {wall:.1f} s; peak memory "
        f"{peak:.3f} GiB; launches {launches}")


# ---- phase 11: appearance ---------------------------------------------------

APPEARANCE_STEPS = 10
APPEARANCE_IMAGES = 1024     # gsl_tpu's visibility network's image count
GRAD_ACC_K = 5
APPEARANCE_WARM_UP = 100     # set in Python: no config key reaches it
APPEARANCE_FIT_STEPS, APPEARANCE_RESUME_STEPS = 200, 300
SLICE_FIT_STEPS = 100
TEST_VIEWS = (0, 8, 16)      # colmap.yaml's own val views (eval_step 8)


def appearance_state(arrays):
    """Phase 5's perturbed scene at capacity 1M with the appearance
    model's 64 features a Gaussian, N(0, 0.02) from a seeded generator on
    the card (its "normal" init)."""
    g = state_from_raw_arrays(perturbed(arrays), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = 0.02 * torch.randn((g.capacity, 64), generator=gen,
                               device="cuda")
    return dataclasses.replace(g, params=dataclasses.replace(
        g.params, appearance_features=feats))


def appearance_inputs(trainer, state, cam):
    """The SWAG path's inputs to the rasterizer at `cam`, as
    TileRenderer.forward makes them: the network's colours, and the
    opacities min(sigmoid(op) + offset, 1) times the compensations."""
    gs = state.gaussians
    rgbs, offset = trainer._rgbs(gs, cam, SH_DEGREE,
                                 state.extra["__net__"]["params"], False)
    proj = project_gaussians(
        gs.get_means(), gs.get_scales(), gs.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    op = gs.get_opacities() + offset * gs.alive
    op = torch.minimum(op, op.new_ones(())) * proj.compensations
    return proj, op.contiguous(), rgbs.contiguous()


def phase_appearance_training(arrays, plain_step_ms):
    """Phase 11 (a): the appearance slice's steps at full width."""
    log("== phase 11 (a): appearance, SWAG, visibility maps (dense, hash), "
        "bilateral grids, exposure and gradient accumulation at 1088x1920, "
        f"capacity 1M; times on {CARD}")
    bg = torch.zeros(3, device="cuda")
    cams = [dataclasses.replace(camera(c2w), appearance_id=torch.tensor(
        i, dtype=torch.int32, device="cuda"))
        for i, c2w in enumerate(views().values())]
    truth = state_from_raw_arrays(arrays, device="cuda")
    renderer = TileRendererConfig().instantiate()
    with torch.no_grad():
        targets = [renderer.forward(truth, c, H, W, bg, SH_DEGREE).render
                   for c in cams]
    del truth
    appearance = AppearanceFeatureGaussianConfig(sh_degree=SH_DEGREE)
    plain = VanillaGaussianConfig(sh_degree=SH_DEGREE)

    def with_network(cls, **kw):
        return lambda: cls(model=appearance, n_appearances=APPEARANCE_IMAGES,
                           appearance_opt=AppearanceOptimizationConfig(
                               warm_up=0), **kw)

    runs = {
        "appearance": with_network(AppearanceTrainer),
        "SWAG opacity head": with_network(AppearanceTrainer,
                                          with_opacity=True),
        "visibility dense": with_network(VisibilityMapAppearanceTrainer,
                                         n_images=APPEARANCE_IMAGES),
        "visibility hash": with_network(VisibilityMapAppearanceTrainer,
                                        n_images=APPEARANCE_IMAGES,
                                        grid_type="hash"),
        "bilagrid": lambda: Trainer(model=plain,
                                    output_processor=BilateralGridConfig()),
        "exposure": lambda: Trainer(model=plain,
                                    output_processor=ExposureConfig()),
        f"grad_acc k={GRAD_ACC_K}": lambda: GradAccTrainer(
            model=plain, grad_acc=GradAccConfig(stages=((0, GRAD_ACC_K),))),
    }
    for what, build in runs.items():
        trainer = build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with_net = isinstance(trainer, AppearanceTrainer)
        state = trainer.setup(
            appearance_state(arrays) if with_net else state_from_raw_arrays(
                perturbed(arrays), device="cuda"),
            cameras_extent=TRAIN_EXTENT)
        if trainer.output_processor is not None:
            state = trainer.init_output_processor(state, APPEARANCE_IMAGES)
        if what == "SWAG opacity head":
            with torch.no_grad():
                k2, k3 = hold_raster_kernels(
                    "appearance", *appearance_inputs(trainer, state,
                                                     cams[0]),
                    state.params.capacity, 31)
            log(f"K2 and K3 ms on the SWAG path's inputs at the bench pose "
                f"(CUDA graph, mean of 20 replays): K2 {k2:.4f}, K3 "
                f"{k3:.4f}")
        first = state
        buffer = (trainer.init_grad_buffer(state)
                  if isinstance(trainer, GradAccTrainer) else None)
        losses, step_ms, applied = [], [], []
        for step in range(1, APPEARANCE_STEPS + 1):
            view = step % len(cams)
            args = (cams[view], targets[view], H, W, SH_DEGREE, bg)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            prev = state
            if with_net:
                state, sc = trainer.train_step_appearance(state, *args,
                                                          warm_up=False)
            elif buffer is not None:
                state, buffer, sc = trainer.train_step_accumulate(
                    state, buffer, *args, apply=step % GRAD_ACC_K == 0,
                    inv_k=1.0 / GRAD_ACC_K)
                applied.append(state.params is not prev.params)
            else:
                state, sc = trainer.train_step(state, *args,
                                               image_idx=view)
            losses.append(float(sc["loss"]))       # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check_step_launches(what, step)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(math.isfinite(x) for x in losses):
            fail(f"{what}: non-finite loss in {losses}")
        for k in state.params.fields():
            if not bool(torch.isfinite(getattr(state.params, k)).all()):
                fail(f"{what}: non-finite {k}")
        said = ""
        for name in ("__net__", "__vis__"):
            if name in (state.extra or {}):
                net = state.extra[name]
                moved = max(float((net["params"][k] - first.extra[name][
                    "params"][k]).abs().max()) for k in net["params"])
                if net["opt"]["count"] != APPEARANCE_STEPS or not (
                        moved > 0.0 and all(
                            bool(torch.isfinite(v).all())
                            for v in net["params"].values())):
                    fail(f"{what}: {name} took {net['opt']['count']} "
                         f"updates, moved by up to {moved}")
                said += f"; {name} moved by up to {moved:.3g}"
        if trainer.output_processor is not None:
            d = (state.extra["__outproc__"] - first.extra["__outproc__"]
                 ).abs().flatten(1).max(1).values
            if not (bool((d[:len(cams)] > 0).all())
                    and float(d[len(cams):].max()) == 0.0):
                fail(f"{what}: the processor moved images "
                     f"{torch.nonzero(d).flatten().tolist()}, not the "
                     f"{len(cams)} trained")
            said += (f"; the {len(cams)} trained images' parameters moved "
                     f"by up to {float(d.max()):.3g}, the other "
                     f"{APPEARANCE_IMAGES - len(cams)} not at all")
        if buffer is not None:
            want = [s % GRAD_ACC_K == 0
                    for s in range(1, APPEARANCE_STEPS + 1)]
            if applied != want or state.opt_state.count != \
                    APPEARANCE_STEPS // GRAD_ACC_K:
                fail(f"{what}: applied at {applied}, Adam count "
                     f"{state.opt_state.count}")
            said += (f"; applied on steps "
                     f"{[i + 1 for i, a in enumerate(applied) if a]}")
        log(f"{what}: ms per step (host clock, synchronised) "
            f"{[round(x, 2) for x in step_ms]}, median "
            f"{float(np.median(step_ms[1:])):.2f} over steps 2-"
            f"{APPEARANCE_STEPS} (phase 5's plain step in this run "
            f"{plain_step_ms:.2f}); loss at step 1 {losses[0]:.6g}, at step "
            f"{APPEARANCE_STEPS} {losses[-1]:.6g}; peak {peak:.3f} GiB; "
            f"K1-K4 launched once a step, nothing else{said}")
        del trainer, state, first, prev, buffer
        torch.cuda.empty_cache()


def write_phototourism_tsv(data):
    """<scene>/scene.tsv: phase 8's 24 views, TEST_VIEWS to test and the
    other 21 to train. Returns its path."""
    path = os.path.join(data, "scene.tsv")
    with open(path, "w") as f:
        f.write("filename\tid\tsplit\tdataset\n")
        for i in range(FIT_VIEWS):
            split = "test" if i in TEST_VIEWS else "train"
            f.write(f"view_{i:03d}.png\t{i}\t{split}\tscene\n")
    return path


def phase_appearance_fits(tmp, colmap_fit):
    """Phase 11 (b): the seven appearance-slice presets through the CLI on
    phase 8's scene."""
    log("== phase 11 (b): appearance_embedding.yaml (PhotoTourism split, "
        "resumed), appearance_visibility_map_hash.yaml, swag.yaml, "
        "bilagrid.yaml, exposure.yaml and grad_acc.yaml through "
        f"gsl_tpu_torch.cli on phase 8's scene; times on {CARD}")
    data, runs = os.path.join(tmp, "scene"), os.path.join(tmp, "runs")
    tsv = write_phototourism_tsv(data)
    colmap = os.path.join(PRESETS, "colmap.yaml")
    windows = (f"fit.log_interval={VARIANT_LOG_INTERVAL}",
               "model.density.init_args.densify_from_iter=50",
               "model.density.init_args.densification_interval=50")
    build = cli.build_components

    def with_warm_up(cfg):
        trainer, dp_cfg, fit_cfg = build(cfg)
        if isinstance(trainer, AppearanceTrainer):
            trainer.appearance_opt = dataclasses.replace(
                trainer.appearance_opt, warm_up=APPEARANCE_WARM_UP)
        return trainer, dp_cfg, fit_cfg

    def argv(name, preset, steps, extra=()):
        return ["fit", "--config", colmap, "--config",
                os.path.join(PRESETS, preset), "--data.path", data,
                "--output", runs, "-n", name, "--max_steps", str(steps),
                *windows, *extra]

    densify_checks = []
    density_step = Trainer.density_step

    def held(self, state, *args, **kw):
        # every densify must leave both networks and their Adam states as
        # they were, at a capacity equal to the hash tables' rows
        new, n_trunc = density_step(self, state, *args, **kw)
        for name in ("__net__", "__vis__"):
            if not all(torch.equal(a, b) for a, b in zip(
                    tensors_of(state.extra[name]),
                    tensors_of(new.extra[name]))):
                fail(f"a densify at capacity {state.params.capacity} "
                     f"changed {name}")
        densify_checks.append((state.params.capacity, int(
            state.alive.sum()), int(new.alive.sum())))
        return new, n_trunc

    cli.build_components = with_warm_up
    try:
        # appearance_embedding.yaml over the PhotoTourism split, resumed
        pt = ("data.parser.class_path=PhotoTourism",)
        first = run_cli(argv("appearance", "appearance_embedding.yaml",
                             APPEARANCE_FIT_STEPS, pt), GAUSSIAN_KERNELS)
        state = first.pop("state")
        emb = state.extra["__net__"]["params"]["embedding.weight"]
        moments = state.extra["__net__"]["opt"]["exp_avg"][
            "embedding.weight"].abs().sum(1)
        trained = [i for i in range(FIT_VIEWS) if i not in TEST_VIEWS]
        if emb.shape[0] != FIT_VIEWS or float(moments[list(
                TEST_VIEWS)].max()) != 0.0 or not bool(
                (moments[trained] > 0).all()):
            fail(f"PhotoTourism: embedding of {emb.shape[0]} rows, moments "
                 f"{moments.tolist()}: the test views' ids must stay "
                 "untrained, the train views' move")
        ckpt = os.path.join(runs, "appearance", "checkpoints",
                            f"step_{APPEARANCE_FIT_STEPS}")
        back = load_checkpoint(ckpt, state)
        if not (all(torch.equal(a, b) for a, b in zip(
                tensors_of(back.extra), tensors_of(state.extra)))
                and torch.equal(back.params.appearance_features,
                                state.params.appearance_features)
                and torch.equal(
                    back.opt_state.exp_avg["appearance_features"],
                    state.opt_state.exp_avg["appearance_features"])):
            fail("the appearance checkpoint did not bring back the "
                 "network, its Adam and the feature rows")
        del state, back
        second = run_cli(argv("appearance", "appearance_embedding.yaml",
                              APPEARANCE_RESUME_STEPS, pt),
                         GAUSSIAN_KERNELS)
        count = second.pop("state").extra["__net__"]["opt"]["count"]
        want = APPEARANCE_RESUME_STEPS - APPEARANCE_WARM_UP + 1
        if f"-> continuing at {APPEARANCE_FIT_STEPS + 1}" not in \
                second["said"] or count != want:
            fail(f"the appearance resume: network count {count}, not "
                 f"{want}")
        log(f"fit appearance_embedding.yaml (PhotoTourism, {FIT_VIEWS - 3} "
            f"train and 3 test views, warm-up {APPEARANCE_WARM_UP}): val "
            f"PSNR at step {APPEARANCE_FIT_STEPS} "
            f"{first['results']['psnr']:.4f}, at step "
            f"{APPEARANCE_RESUME_STEPS} {second['results']['psnr']:.4f} "
            f"dB; the checkpoint at {APPEARANCE_FIT_STEPS} brought back "
            f"the network, its Adam and the feature rows bit for bit, the "
            f"resume continued at {APPEARANCE_FIT_STEPS + 1} with "
            f"{count} network updates at the end; the embedding rows of "
            f"the test views {list(TEST_VIEWS)} untrained")
        log_fit("fit appearance_embedding.yaml", [first, second],
                [int(r[0]) for r in second["rows"][1:]
                 if int(r[0]) != APPEARANCE_FIT_STEPS
                 + VARIANT_LOG_INTERVAL])

        Trainer.density_step = held
        try:
            f = run_cli(argv("visibility_hash",
                             "appearance_visibility_map_hash.yaml",
                             SLICE_FIT_STEPS), GAUSSIAN_KERNELS)
        finally:
            Trainer.density_step = density_step
        tables = [v.shape[0] for k, v in f.pop("state").extra["__vis__"][
            "params"].items() if k.startswith("encoding.table_")]
        if not densify_checks or any(
                cap != 1 << 19 for cap, _, _ in densify_checks) \
                or tables != [17 ** 3] + [1 << 19] * 3:
            fail(f"visibility hash: densifies {densify_checks}, tables "
                 f"{tables}: not at a capacity equal to the table rows")
        log(f"fit appearance_visibility_map_hash.yaml: val PSNR "
            f"{f['results']['psnr']:.4f} dB at step {SLICE_FIT_STEPS}; "
            f"{len(densify_checks)} densifies at capacity "
            f"{densify_checks[0][0]} (alive before -> after "
            f"{[(a, b) for _, a, b in densify_checks]}) left the hash "
            f"tables ({tables} rows) and both networks' Adam states as "
            "they were")
        log_fit("fit appearance_visibility_map_hash.yaml", [f],
                [int(r[0]) for r in f["rows"]][1:])
        for preset in ("swag.yaml", "bilagrid.yaml", "exposure.yaml",
                       "grad_acc.yaml"):
            f = run_cli(argv(preset.split(".")[0], preset, SLICE_FIT_STEPS),
                        GAUSSIAN_KERNELS)
            state = f.pop("state")
            psnr = f["results"]["psnr"]
            if not psnr > colmap_fit["psnr0"]:
                fail(f"fit {preset}: val PSNR {psnr:.3f} dB is not above "
                     f"the initial cloud's {colmap_fit['psnr0']:.3f}")
            said = ""
            if preset in ("bilagrid.yaml", "exposure.yaml"):
                ops = state.extra["__outproc__"]
                if ops.shape[0] != FIT_VIEWS or \
                        state.extra["__outproc_opt__"]["count"] != \
                        SLICE_FIT_STEPS:
                    fail(f"fit {preset}: {ops.shape[0]} images' parameters, "
                         f"{state.extra['__outproc_opt__']['count']} steps")
                said = f"; the processor's parameters for {FIT_VIEWS} images"
            del state
            log(f"fit {preset}: val PSNR {psnr:.4f} dB at step "
                f"{SLICE_FIT_STEPS}{said}")
            log_fit(f"fit {preset}", [f], [int(r[0]) for r in f["rows"]][1:])
            torch.cuda.empty_cache()
    finally:
        cli.build_components = build
        Trainer.density_step = density_step
        os.remove(tsv)
    log(f"phase 8's colmap.yaml in this run, for comparison: "
        f"{colmap_fit['ms']:.2f} ms a step (median of its windows after "
        f"each run's first), {100 * colmap_fit['loader_share']:.2f}% of "
        f"its first 300-step loop waiting on the loader, val PSNR of the "
        f"initial cloud {colmap_fit['psnr0']:.4f} dB, at step {FIT_STEPS} "
        f"{colmap_fit['psnr']:.4f}")


# ---- phase 12: density variants --------------------------------------------

DENSITY_STEPS = 3            # vanilla steps whose statistics phase 12 uses
DENSITY_CAPACITY = 1 << 21   # the densify passes' capacity (2x the rows)
DENSITY_ROOM = 50_000        # rows a Taming round and a GNS densify may add
GNS_STEPS, GNS_BUDGET = 10, 900_000
GLOSSY_STEPS = 10
BLEND_RTOL = 1e-4            # Sum_i blend_i / 3 against Sum_pixels alpha
SHORT_FIT_STEPS = 100
TAMING_FIT_STEPS, GNS_FIT_STEPS, GNS_RESUME_STEPS = 400, 400, 500
GNS_FIT_BUDGET = 60_000
LG_FIT_STEPS, LG_FIT_PRUNES, GLOSSY_FIT_STEPS = 300, (200, 300), 150


def expect_launches(what, want):
    """Fails unless the launches since the counters were zeroed are `want`
    (kernel -> count) and nothing else."""
    counts = read_launches()
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        fail(f"{what}: launches {counts}, not {want}")


def timed(fn):
    """(fn(), ms by host clock around it, synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_density_variants(arrays, plain_step_ms):
    """Phase 12 (a): the blend weights and their kernels, Taming, the six
    density controllers, GNS, LightGaussian and Glossy at full width."""
    log("== phase 12 (a): blend weights, Taming, the six density "
        "controllers, GNS, LightGaussian and Glossy at 1088x1920, capacity "
        f"1M; times on {CARD}")
    bg = torch.zeros(3, device="cuda")
    cams = [camera(c2w) for c2w in views().values()]
    renderer = TileRendererConfig().instantiate()
    truth = state_from_raw_arrays(arrays, device="cuda")
    with torch.no_grad():
        targets = [renderer.forward(truth, c, H, W, bg, SH_DEGREE).render
                   for c in cams]
    del truth
    model = VanillaGaussianConfig(sh_degree=SH_DEGREE)
    trainer = Trainer(model=model)
    state = trainer.setup(state_from_raw_arrays(perturbed(arrays),
                                                device="cuda"),
                          cameras_extent=TRAIN_EXTENT)
    state, _, step_ms, _ = variant_steps("statistics", trainer, state, cams,
                                         targets, bg, 1, DENSITY_STEPS)
    gs = state.gaussians
    n = gs.n_alive

    # the blend weights at the bench pose, and the identity they obey
    render = bias_render(renderer, SH_DEGREE, bg)
    reset_launches()
    blend, blend_ms = timed(lambda: accumulate_blend_weights(
        render, gs, [cams[0]]))
    expect_launches("blend weights", {k: 1 for k in GAUSSIAN_KERNELS})
    with torch.no_grad():
        alpha = renderer.forward(gs, cams[0], H, W, bg, SH_DEGREE,
                                 render_types=frozenset({"rgb", "alpha"})
                                 ).alpha
    got, want = float(blend.double().sum()) / 3.0, \
        float(alpha.double().sum())
    if not abs(got - want) <= BLEND_RTOL * want:
        fail(f"blend weights: Sum_i blend_i / 3 = {got}, Sum alpha = {want}")
    log(f"blend weights at the bench pose: Sum_i blend_i / 3 = {got:.6f}, "
        f"Sum_pixels alpha = {want:.6f} (relative difference "
        f"{abs(got - want) / want:.3e}); {blend_ms:.2f} ms, K1-K4 once")

    # K1-K4 on Taming's pixel-weight cotangent at the bench pose
    coeffs = ScoreCoefficients()
    cam = cams[0]
    with torch.no_grad():
        proj = project_gaussians(
            gs.get_means(), gs.get_scales(), gs.get_rotations(),
            cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
        img = renderer.forward(gs, cam, H, W, bg, SH_DEGREE).render
        weights = pixel_weights(img, targets[0], coeffs)
        k2, k3 = hold_raster_kernels(
            "taming pixel weights", proj,
            renderer.get_opacities(gs, cam, proj).contiguous(),
            renderer.get_rgbs(gs, cam, SH_DEGREE).contiguous(),
            gs.capacity, 0, cotangents=(
                weights[..., None].expand(H, W, 3).contiguous(),
                torch.zeros((H, W), device="cuda")))
    log(f"K2 and K3 ms on Taming's pixel weights at the bench pose (CUDA "
        f"graph, mean of 20 replays): K2 {k2:.4f}, K3 {k3:.4f}")
    del proj, img, weights

    # Taming: the scores over the three views and one budgeted round
    grown = trainer.grow_state(state, DENSITY_CAPACITY)
    gen = torch.Generator(device="cuda").manual_seed(12)
    def score():
        return compute_gaussian_scores(
            renderer, grown.gaussians, cams, targets,
            mean_grads(grown.density), bg, SH_DEGREE, coeffs)

    reset_launches()
    _, first_score_ms = timed(score)
    expect_launches("Taming scores", {
        "expand": 3, "rasterize_fwd": 3, "rasterize_bwd": 6,
        "reduce_grads": 6})
    scores, score_ms = timed(score)
    budget = n + DENSITY_ROOM
    taming = Taming3DGSDensityControllerConfig()
    clone, split = densify_masks(grown.gaussians, grown.density, taming,
                                 TRAIN_EXTENT)
    (tstate, _, _, n_trunc), taming_ms = timed(lambda: taming_densify(
        gen, grown.gaussians, grown.opt_state, grown.density, taming,
        scores, budget, TRAIN_EXTENT, TRAIN_EXTENT, False))
    n_taming = tstate.n_alive
    if int(n_trunc) or not n < n_taming <= budget:
        fail(f"Taming: {n} -> {n_taming} alive under a budget of {budget}")
    log(f"Taming: scores over {len(cams)} views {score_ms:.2f} ms (the "
        f"first call {first_score_ms:.2f}; K1, K2 once a view, K3, K4 "
        f"twice), positive in {int((scores > 0).sum())}"
        f" rows; a round under the budget {budget} from {n} alive "
        f"({int(clone.sum())} clone and {int(split.sum())} split "
        f"candidates) {taming_ms:.2f} ms -> {n_taming} alive")
    del tstate, scores

    # the six controllers, one densify each from the same statistics
    d = grown.density
    gs2 = grown.gaussians
    ms = {}
    static = StaticDensityControllerConfig(densify_from_iter=0,
                                           densification_interval=1)
    hook = StaticDensityHook(FitContext(
        trainer=Trainer(density=static), outputs=None, dataset=None,
        cfg=FitConfig(), bg=bg))
    if hook(grown, gen, 100) is not grown or hook.densifies_at(100):
        fail("the static hook changed the state")
    ms["static"] = 0.0
    said = []
    for name, cfg in (
            ("Revising", RevisingDensityControllerConfig()),
            ("no-culling-big-scale",
             NoCullingBigScaleDensityControllerConfig()),
            ("H3DGS", H3DGSDensityControllerConfig()),
            ("accurate visibility",
             AccurateVisibilityFilterDensityControllerConfig()),
            ("background removal",
             BackgroundRemovalDensityControllerConfig())):
        src_state = gs2
        if name == "background removal":
            centers = np.stack([c2w[:3, 3] for c2w in fit_poses()])
            center = centers.mean(0)
            radius = float(np.linalg.norm(centers - center, axis=-1).max())
            src_state = background_removal_step(gs2, center, radius)
            dist = torch.linalg.norm(gs2.params.means - torch.tensor(
                center, dtype=torch.float32, device="cuda"), dim=-1)
            outside = (dist > radius) & gs2.alive
            op = src_state.params.opacities[:, 0]
            if not (bool((op[outside] == -15.0).all()) and torch.equal(
                    op[~outside], gs2.params.opacities[~outside, 0])):
                fail("background removal: the rows outside the sphere are "
                     "not the ones at raw opacity -15")
        clone, split = densify_masks(src_state, d, cfg, TRAIN_EXTENT)
        (out, _, _, n_trunc), ms[name] = timed(lambda: densify_and_prune(
            gen, src_state, grown.opt_state, d, cfg, TRAIN_EXTENT,
            TRAIN_EXTENT, True))
        n_sel = int(clone.sum() + split.sum())
        if int(n_trunc):
            fail(f"{name}: truncated {int(n_trunc)}")
        line = (f"{name}: {int(clone.sum())} cloned, {int(split.sum())} "
                f"split, {n} -> {out.n_alive} alive, {ms[name]:.2f} ms")
        if name == "Revising":
            # the children fill the first free slots in their sources'
            # order, each a copy of its source as the pass left it
            free = torch.nonzero(~gs2.alive).flatten()[:n_sel]
            src = torch.nonzero(clone | split).flatten()
            new = out.params.opacities[:, 0]
            alpha_now = torch.sigmoid(gs2.params.opacities[:, 0])
            raw_hat = inverse_sigmoid(torch.clamp(1.0 - torch.sqrt(
                torch.clamp(1.0 - alpha_now, min=1e-8)), 1e-6, 1.0 - 1e-6))
            if not (torch.equal(new[clone], raw_hat[clone])
                    and torch.equal(new[free], new[src])):
                fail("Revising: a clone and its copy do not both hold "
                     "1 - sqrt(1 - alpha)")
            line += "; each clone and its copy at 1 - sqrt(1 - alpha)"
        elif name == "H3DGS":
            op = torch.sigmoid(gs2.params.opacities[:, 0])
            score = (d.grad_accum * d.max_radii
                     * torch.pow(torch.clamp(op, min=1e-8), 0.2))
            want = ((score >= cfg.densify_grad_threshold)
                    & (op > cfg.clone_min_opacity) & gs2.alive)
            if not torch.equal(clone | split, want) or n_sel == 0:
                fail(f"H3DGS: selected {n_sel} rows, not its score's "
                     f"{int(want.sum())}")
            vc, vs = densify_masks(gs2, d, VanillaDensityControllerConfig(),
                                   TRAIN_EXTENT)
            line += (f"; selected by its score, {n_sel} rows where the "
                     f"vanilla gate selects {int((vc | vs).sum())}")
        elif name == "background removal":
            if bool((out.alive & outside).any()):
                fail("background removal: rows outside the sphere survived")
            line += (f"; the {int(outside.sum())} rows outside the cameras' "
                     f"sphere (radius {radius:.3f}) pruned")
        said.append(line)
        del out
    for line in ["static: the state unchanged"] + said:
        log(f"densify {line}")
    del grown, gs2, d

    # GNS: steps in the regularisation phase through its hook, a densify
    # and the final prune
    gns_cfg = GNSDensityControllerConfig(
        budget=GNS_BUDGET, opacity_reg_from=1, opacity_reg_until=10_000)
    gtrainer = Trainer(model=model, density=gns_cfg)
    gstate = gtrainer.setup(state_from_raw_arrays(perturbed(arrays),
                                                  device="cuda"),
                            cameras_extent=TRAIN_EXTENT)
    ghooks = GNSHooks(FitContext(trainer=gtrainer, outputs=None,
                                 dataset=None, cfg=FitConfig(), bg=bg))
    gstate = ghooks.init_state(gstate, None)
    gns_ms, losses = [], []
    for step in range(1, GNS_STEPS + 1):
        view = step % len(cams)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        gstate, sc = ghooks(gstate, gen, step, SH_DEGREE, cams[view], "v",
                            targets[view], None, H, W)
        losses.append(float(sc["loss"]))
        gns_ms.append((time.perf_counter() - t0) * 1e3)
        check_step_launches("GNS", step)
    ctl = GNSController.from_extra(gns_cfg, gstate.extra["__gns__"])
    if not (all(math.isfinite(x) for x in losses)
            and ctl.opacity_min is not None
            and ctl.opacity_update_factor(GNS_STEPS, n) == 4.0):
        fail(f"GNS steps: losses {losses}, controller {ctl}")
    ggrown = gtrainer.grow_state(gstate, DENSITY_CAPACITY)
    reset_launches()
    importance, edge_ms = timed(lambda: edge_weighted_blend_scores(
        renderer, ggrown.gaussians, cams, [get_edges(t) for t in targets],
        bg, SH_DEGREE))
    expect_launches("GNS edge-weighted blend", {
        k: len(cams) for k in GAUSSIAN_KERNELS})
    (dense, opt2, _, n_trunc), gdensify_ms = timed(lambda: gns_densify(
        gen, ggrown.gaussians, ggrown.opt_state, ggrown.density, gns_cfg,
        importance, n + DENSITY_ROOM))
    n_dense = dense.n_alive
    (pruned, _), prune_ms = timed(lambda: final_budget_prune(
        gen, dense, opt2, GNS_BUDGET))
    if int(n_trunc) or n_dense > n + DENSITY_ROOM \
            or pruned.n_alive != GNS_BUDGET:
        fail(f"GNS: densify {n} -> {n_dense} (budget {n + DENSITY_ROOM}), "
             f"final prune -> {pruned.n_alive}, not {GNS_BUDGET}")
    log(f"GNS: ms per step (regulariser in the loss, opacity update x4) "
        f"{[round(x, 2) for x in gns_ms]}, median "
        f"{float(np.median(gns_ms[1:])):.2f} (phase 5's plain step in this "
        f"run {plain_step_ms:.2f}); reg weight {ctl.reg_weight:.3g}, "
        f"opacity goal start {ctl.opacity_min:.4f}; edge-weighted blend "
        f"over {len(cams)} views {edge_ms:.2f} ms; densify {n} -> "
        f"{n_dense} in {gdensify_ms:.2f} ms; final prune -> "
        f"{pruned.n_alive} in {prune_ms:.2f} ms")
    del gstate, ggrown, dense, opt2, pruned, importance, ghooks

    # LightGaussian: one prune over the three views
    reset_launches()
    imp, lg_imp_ms = timed(lambda: accumulate_blend_weights(render, gs,
                                                            cams))
    expect_launches("LightGaussian importance",
                    {k: len(cams) for k in GAUSSIAN_KERNELS})
    (lstate, _, n_pruned), lg_ms = timed(lambda: prune_by_importance(
        gs, state.opt_state, imp, 0.6))
    want = int(np.float32(n) * np.float32(0.6))
    if int(n_pruned) != want or want != math.floor(n * 0.6) \
            or lstate.n_alive != n - want:
        fail(f"LightGaussian: pruned {int(n_pruned)} of {n}, not {want}")
    log(f"LightGaussian: importance over {len(cams)} views "
        f"{lg_imp_ms:.2f} ms, prune {lg_ms:.2f} ms: {want} of {n} rows "
        f"(floor(0.6 n))")
    del lstate, imp, state, gs

    # Glossy
    glossy = GlossyTrainer(model=model)
    gl = glossy.setup(state_from_raw_arrays(perturbed(arrays), device="cuda"),
                      cameras_extent=TRAIN_EXTENT)
    first = gl
    gl_ms, losses = [], []
    for step in range(1, GLOSSY_STEPS + 1):
        view = step % len(cams)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        gl, sc = glossy.train_step_glossy(gl, cams[view], targets[view], H,
                                          W, SH_DEGREE, bg)
        losses.append(float(sc["loss"]))
        gl_ms.append((time.perf_counter() - t0) * 1e3)
        check_step_launches("Glossy", step)
    env_moved = float((gl.extra["__glossy__"]["envmap"]
                       - first.extra["__glossy__"]["envmap"]).abs().max())
    metal_moved = float((gl.params.metalness
                         - first.params.metalness).abs().max())
    if not (all(math.isfinite(x) for x in losses) and env_moved > 0
            and metal_moved > 0 and all(
                bool(torch.isfinite(getattr(gl.params, k)).all())
                for k in gl.params.fields())):
        fail(f"Glossy: losses {losses}, env map moved {env_moved}, "
             f"metalness {metal_moved}")
    log(f"Glossy: ms per step {[round(x, 2) for x in gl_ms]}, median "
        f"{float(np.median(gl_ms[1:])):.2f} (phase 5's plain step in this "
        f"run {plain_step_ms:.2f}); loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g}; env map moved by up to {env_moved:.3g}, "
        f"metalness by up to {metal_moved:.3g}; K1-K4 once a step")
    log(f"statistics steps (vanilla) ms {[round(x, 2) for x in step_ms]}")


def phase_density_fits(tmp, colmap_fit):
    """Phase 12 (b): the density variants and Glossy through the CLI on
    phase 8's scene."""
    log("== phase 12 (b): revising.yaml, taming.yaml, gns.yaml (resumed), "
        "light_gaussian.yaml, glossy.yaml and five controllers by "
        f"class_path through gsl_tpu_torch.cli on phase 8's scene; times on "
        f"{CARD}")
    data, runs = os.path.join(tmp, "scene"), os.path.join(tmp, "runs")
    colmap = os.path.join(PRESETS, "colmap.yaml")
    windows = (f"fit.log_interval={VARIANT_LOG_INTERVAL}",)
    short = windows + ("model.density.init_args.densify_from_iter=50",
                       "model.density.init_args.densification_interval=50")
    every_100 = windows + (
        "model.density.init_args.densify_from_iter=100",
        "model.density.init_args.densification_interval=100")
    psnr0 = colmap_fit["psnr0"]

    def argv(name, steps, presets=(), extra=()):
        configs = [a for p in presets for a in (
            "--config", os.path.join(PRESETS, p))]
        return ["fit", "--config", colmap, *configs, "--data.path", data,
                "--output", runs, "-n", name, "--max_steps", str(steps),
                *extra]

    def fitted(name, f, steps, said=""):
        psnr = f["results"]["psnr"]
        if not psnr > psnr0:
            fail(f"fit {name}: val PSNR {psnr:.3f} dB at step {steps} is "
                 f"not above the initial cloud's {psnr0:.3f}")
        log(f"fit {name}: val PSNR {psnr:.4f} dB at step {steps}{said}")

    runs_by = {}
    for name, class_path, extra in (
            ("revising.yaml", None, ()),
            ("H3DGS", "H3DGSDensityController", ()),
            ("NoCullingBigScale", "NoCullingBigScaleDC", ()),
            ("Static", "StaticDensityController", ()),
            ("BackgroundRemoval", "BackgroundRemoval",
             ("model.density.init_args.background_removal_from=50",)),
            ("AccurateVisibility",
             "AccurateVisibilityFilterDensityController", ())):
        presets = (name,) if class_path is None else ()
        over = short + extra + ((f"model.density.class_path={class_path}",)
                                if class_path else ())
        f = run_cli(argv(name.split(".")[0], SHORT_FIT_STEPS, presets, over),
                    GAUSSIAN_KERNELS)
        counts = [int(r[2]) for r in f["rows"]]
        rounds = f["timing"]["densify"]
        if name == "Static":
            if rounds or set(counts) != {SFM_POINTS}:
                fail(f"fit Static: densify rounds {rounds}, counts {counts}")
        elif len(rounds) != 1:
            fail(f"fit {name}: {len(rounds)} densify rounds")
        state = f.pop("state")
        fitted(name, f, SHORT_FIT_STEPS,
               f"; the count stayed at {SFM_POINTS}" if name == "Static"
               else "")
        del state
        log_fit(f"fit {name}", [f])
        runs_by[name] = f
        torch.cuda.empty_cache()

    # Taming: rounds at 200, 300 and 400, each at or under its point
    f = run_cli(argv("taming", TAMING_FIT_STEPS, ("taming.yaml",),
                     every_100 + ("model.density.init_args."
                                  "densify_until_iter=401",)),
                GAUSSIAN_KERNELS)
    f.pop("state")
    rounds = f["timing"]["densify"]
    if [r["step"] for r in rounds] != [200, 300, 400] or any(
            r["after"] > r["budget"] for r in rounds):
        fail(f"fit taming.yaml: rounds {rounds}")
    fitted("taming.yaml", f, TAMING_FIT_STEPS, "; rounds (step, budget, "
           "alive after) " + str([(r["step"], r["budget"], r["after"])
                                  for r in rounds]))
    log_fit("fit taming.yaml", [f])
    torch.cuda.empty_cache()

    # GNS: to 400, resumed to 500 across its regularisation phase
    gns = every_100 + (
        f"model.density.init_args.budget={GNS_FIT_BUDGET}",
        "model.density.init_args.densify_until_iter=300",
        "model.density.init_args.opacity_reg_from=300",
        "model.density.init_args.opacity_reg_until=500")
    first = run_cli(argv("gns", GNS_FIT_STEPS, ("gns.yaml",), gns),
                    GAUSSIAN_KERNELS)
    n_first = first.pop("state").gaussians.n_alive
    second = run_cli(argv("gns", GNS_RESUME_STEPS, ("gns.yaml",), gns),
                     GAUSSIAN_KERNELS)
    end = second.pop("state")
    if f"-> continuing at {GNS_FIT_STEPS + 1}" not in second["said"] \
            or not n_first > GNS_FIT_BUDGET \
            or end.gaussians.n_alive > GNS_FIT_BUDGET:
        fail(f"fit gns.yaml: {n_first} alive at {GNS_FIT_STEPS}, "
             f"{end.gaussians.n_alive} at {GNS_RESUME_STEPS} after the "
             "resume")
    fitted("gns.yaml", second, GNS_RESUME_STEPS,
           f"; {n_first} alive at step {GNS_FIT_STEPS}, resumed at "
           f"{GNS_FIT_STEPS + 1}, {end.gaussians.n_alive} alive at the end "
           f"(budget {GNS_FIT_BUDGET}); controller {end.extra['__gns__']}")
    del end
    log_fit("fit gns.yaml", [first, second])
    torch.cuda.empty_cache()

    # LightGaussian: prunes at 200 and 300, after the densify there
    f = run_cli(argv("light_gaussian", LG_FIT_STEPS, ("light_gaussian.yaml",),
                     every_100 + ("fit.lg_prune_steps="
                                  f"{list(LG_FIT_PRUNES)}",)),
                GAUSSIAN_KERNELS)
    f.pop("state")
    after = {r["step"]: r["after"] for r in f["timing"]["densify"]}
    pruned = {int(m[1]): int(m[0]) for m in re.findall(
        r"\[fit\] LightGaussian pruned (\d+) at (\d+)", f["said"])}
    want = {s: int(np.float32(after[s]) * np.float32(0.6 * 0.6 ** i))
            for i, s in enumerate(LG_FIT_PRUNES)}
    if pruned != want:
        fail(f"fit light_gaussian.yaml: pruned {pruned}, not {want} of "
             f"{after}")
    fitted("light_gaussian.yaml", f, LG_FIT_STEPS,
           f"; pruned (step: rows of the alive after the densify there) "
           f"{ {s: (pruned[s], after[s]) for s in LG_FIT_PRUNES} }")
    log_fit("fit light_gaussian.yaml", [f])
    torch.cuda.empty_cache()

    # Glossy
    f = run_cli(argv("glossy", GLOSSY_FIT_STEPS, ("glossy.yaml",), short),
                GAUSSIAN_KERNELS)
    state = f.pop("state")
    env = state.extra["__glossy__"]
    metal = state.params.metalness[state.alive]
    if env["opt"]["count"] != GLOSSY_FIT_STEPS or not float(
            metal.std()) > 0:
        fail(f"fit glossy.yaml: env Adam count {env['opt']['count']}")
    fitted("glossy.yaml", f, GLOSSY_FIT_STEPS,
           f" (SH colours, no specular term, as gsl_tpu validates); "
           f"metalness mean {float(torch.sigmoid(metal).mean()):.4f}, "
           f"env map in [{float(env['envmap'].min()):.3f}, "
           f"{float(env['envmap'].max()):.3f}]")
    del state, env, metal
    log_fit("fit glossy.yaml", [f])
    log(f"phase 8's colmap.yaml in this run, for comparison: "
        f"{colmap_fit['ms']:.2f} ms a step (median of its windows after "
        f"each run's first), val PSNR of the initial cloud "
        f"{colmap_fit['psnr0']:.4f} dB")


# ---- phase 13: dynamic scenes ----------------------------------------------

DYNAMIC_WARM, DYNAMIC_STEPS = 2, 5    # warm-up steps, then deformed ones
PVG_STEPS = 5
HEXPLANE_BOUNDS = 1.5                  # gsl_tpu's fixed normalisation
NERFIES_H, NERFIES_W = 540, 960        # a capture's 2x images of 1080x1920
NERFIES_SCALE = 0.5
NERFIES_CENTER = np.array([0.2, -0.1, 0.3])
NERFIES_VAL = (4, 12, 20)              # the views dataset.json gives val
DYNAMIC_FIT_STEPS, DYNAMIC_RESUME_STEPS = 100, 150
DYNAMIC_WARM_UP = 50                   # the deform presets' warm-up, cut


def at_time(cam, t):
    return dataclasses.replace(cam, time=torch.tensor(
        float(t), dtype=torch.float32, device=cam.R.device))


def deform_steps(what, trainer, state, cams, targets, bg, gen):
    """DYNAMIC_WARM warm-up steps and DYNAMIC_STEPS with the field, each
    checked for K1-K4 once and nothing else. Returns (state, losses, ms
    per step)."""
    losses, step_ms = [], []
    for step in range(1, DYNAMIC_WARM + DYNAMIC_STEPS + 1):
        view = step % len(cams)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, sc = trainer.train_step_deform(
            state, cams[view], targets[view], H, W, SH_DEGREE, bg,
            warm_up=step <= DYNAMIC_WARM, generator=gen)
        losses.append(float(sc["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check_step_launches(what, step)
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss in {losses}")
    for k in PARAM_FIELDS:
        if not bool(torch.isfinite(getattr(state.params, k)).all()):
            fail(f"{what}: non-finite {k}")
    return state, losses, step_ms


def field_ms(trainer, state, t):
    """CUDA-event ms of the field's forward at the state's capacity, and
    of its backward (the gradients of the outputs' sum in its weights)."""
    params = leaves_of(state.extra["__deform__"], True)
    xyz = state.params.means.detach()

    def forward():
        return torch.func.functional_call(trainer.deform_net, params,
                                          (xyz, t))

    def both():
        outs = forward()
        torch.autograd.grad(sum(o.sum() for o in outs),
                            list(params.values()))

    with float32_math():
        fwd = cuda_ms(forward, 3)
        return fwd, cuda_ms(both, 3) - fwd


def hold_dynamic_kernels(vname, gs, renderer, cam):
    """K1-K4 against their plain versions (hold_raster_kernels) on a
    dynamic path's inputs at `cam`: the renderer's means, opacities and
    colours of the deformed or modulated state `gs`."""
    with torch.no_grad():
        proj = project_gaussians(
            renderer.get_means(gs, cam), renderer.get_scales(gs, cam),
            gs.get_rotations(), cam.world_to_camera, cam.fx, cam.fy,
            cam.cx, cam.cy, W, H)
        return hold_raster_kernels(
            vname, proj, renderer.get_opacities(gs, cam, proj).contiguous(),
            renderer.get_rgbs(gs, cam, SH_DEGREE).contiguous(),
            gs.capacity, 13)


def pvg_state(arrays, seed=14):
    """Phase 5's perturbed scene with PVG's properties: life peaks as
    PVGConfig draws them, lifespan 1, velocities N(0, 0.5^2)."""
    n = len(arrays["means"])
    gs = state_from_raw_arrays(perturbed(arrays), device="cuda")
    t0 = np.random.RandomState(3).uniform(0, 1, n).astype(np.float32)
    vel = (np.random.RandomState(seed).normal(size=(n, 3)) * 0.5).astype(
        np.float32)
    return dataclasses.replace(gs, params=dataclasses.replace(
        gs.params, t_centers=torch.from_numpy(t0[:, None]).cuda(),
        t_scales=torch.zeros((n, 1), device="cuda"),
        velocities=torch.from_numpy(vel).cuda()))


def phase_dynamic_training(arrays, plain_step_ms):
    """Phase 13 (a): DeformTrainer with the MLP and the HexPlane field,
    and PVG, at full width."""
    log("== phase 13 (a): DeformTrainer (MLP 8 x 256, HexPlane 32/64 x 16) "
        f"and PVG at 1088x1920, capacity 1M, camera times in [0, 1]; times "
        f"on {CARD}")
    bg = torch.zeros(3, device="cuda")
    times = np.random.RandomState(13).uniform(0, 1, 3)
    cams = [at_time(camera(c2w), t) for c2w, t in zip(views().values(),
                                                      times)]
    plain = TileRendererConfig().instantiate()
    truth = state_from_raw_arrays(arrays, device="cuda")
    with torch.no_grad():
        targets = [plain.forward(truth, c, H, W, bg, SH_DEGREE).render
                   for c in cams]
    del truth
    model = VanillaGaussianConfig(sh_degree=SH_DEGREE)
    gen = torch.Generator(device="cuda").manual_seed(13)
    results = {}
    for field in ("mlp", "hexplane"):
        trainer = DeformTrainer(model=model, field=field)
        state = trainer.setup(state_from_raw_arrays(perturbed(arrays),
                                                    device="cuda"),
                              cameras_extent=TRAIN_EXTENT)
        torch.cuda.reset_peak_memory_stats()
        state, losses, step_ms = deform_steps(
            f"deform {field}", trainer, state, cams, targets, bg, gen)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        net = state.extra["__deform__"]
        if net["opt"]["count"] != DYNAMIC_STEPS:
            fail(f"deform {field}: {net['opt']['count']} field updates")
        fwd, bwd = field_ms(trainer, state, cams[0].time)
        with torch.no_grad():
            moved = trainer.deform(net["params"], state.gaussians,
                                   cams[0].time)
            shift = float((moved.params.means - state.params.means)[
                state.alive].norm(dim=-1).max())
        if not shift > 0:
            fail(f"deform {field}: the trained field moves no row")
        k2, k3 = hold_dynamic_kernels(f"deform {field}", moved,
                                      trainer.renderer, cams[0])
        del moved
        said = ""
        if field == "hexplane":
            xyz = state.params.means[state.alive]
            clip = float((xyz.abs() > HEXPLANE_BOUNDS).any(-1).float()
                         .mean())
            said = (f"; rows outside gsl_tpu's fixed bounds +-"
                    f"{HEXPLANE_BOUNDS} (their coordinates clipped to "
                    f"the border): {clip:.4f} of the alive rows")
        results[field] = float(np.median(step_ms[DYNAMIC_WARM + 1:]))
        log(f"deform {field}: ms per step {[round(x, 2) for x in step_ms]}"
            f" (the first {DYNAMIC_WARM} in the warm-up), median after it "
            f"{results[field]:.2f}, in it "
            f"{float(np.median(step_ms[1:DYNAMIC_WARM])):.2f} (phase 5's "
            f"plain step in this run {plain_step_ms:.2f}); the field at "
            f"capacity {state.params.capacity}: forward {fwd:.2f} ms, "
            f"backward {bwd:.2f} ms (CUDA events); loss {losses[0]:.6g} "
            f"-> {losses[-1]:.6g}; the trained field moves a mean by up to "
            f"{shift:.3g}; peak {peak:.3f} GiB; K1-K4 once a step; K2 / K3 "
            f"on its deformed inputs {k2:.4f} / {k3:.4f} ms{said}")
        del state, trainer, net
        torch.cuda.empty_cache()

    trainer = Trainer(model=PVGConfig(sh_degree=SH_DEGREE),
                      renderer=PVGRendererConfig())
    state = trainer.setup(pvg_state(arrays), cameras_extent=TRAIN_EXTENT)
    first_vel = state.params.velocities.clone()
    torch.cuda.reset_peak_memory_stats()
    state, losses, step_ms, _ = variant_steps("PVG", trainer, state, cams,
                                              targets, bg, 1, PVG_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vel_moved = float((state.params.velocities - first_vel).abs().max())
    if not vel_moved > 0 or state.opt_state.count_of("velocities") \
            != PVG_STEPS:
        fail(f"PVG: velocities moved by {vel_moved}")
    k2, k3 = hold_dynamic_kernels("PVG", state.gaussians, trainer.renderer,
                                  cams[0])
    results["pvg"] = float(np.median(step_ms[1:]))
    log(f"PVG: ms per step {[round(x, 2) for x in step_ms]}, median "
        f"{results['pvg']:.2f} (phase 5's plain step in this run "
        f"{plain_step_ms:.2f}); loss {losses[0]:.6g} -> {losses[-1]:.6g}; "
        f"velocities moved by up to {vel_moved:.3g}; peak {peak:.3f} GiB; "
        f"K1-K4 once a step; K2 / K3 on its modulated inputs {k2:.4f} / "
        f"{k3:.4f} ms")
    return results


def dynamic_truth(arrays):
    """The bench scene as a PVG ground truth: the rows right of x = 1
    vibrate (velocities N(0, 3^2)) and live around their own life peaks
    (spans 0.3); the others are static (span e^3, no velocity)."""
    n = len(arrays["means"])
    rng = np.random.RandomState(15)
    moving = arrays["means"][:, 0] > 1.0
    out = dict(arrays)
    out["t_centers"] = np.where(moving, rng.uniform(0, 1, n),
                                0.5)[:, None].astype(np.float32)
    out["t_scales"] = np.where(moving, np.log(0.3), 3.0)[:, None].astype(
        np.float32)
    out["velocities"] = (rng.normal(size=(n, 3)) * 3.0
                         * moving[:, None]).astype(np.float32)
    return out, float(moving.mean())


def write_nerfies_scene(root, arrays):
    """FIT_VIEWS views of dynamic_truth (phase 8's poses) rendered by the
    port's PVGRenderer at their times i / (FIT_VIEWS - 1) as a Nerfies
    capture: rgb/2x/<id>.png at 540x960, camera/<id>.json for the
    1080x1920 originals (focal 1600), dataset.json (val: NERFIES_VAL),
    scene.json (scale 0.5, a centre), metadata.json (the time ids) and
    points.npy (SFM_POINTS of the means). Positions and points are written
    as the capture holds them, before the scene's normalisation."""
    truth, moving = dynamic_truth(arrays)
    state = state_from_jax_arrays(truth, np.ones(N_GAUSSIANS, bool),
                                  device="cuda")
    renderer = PVGRendererConfig().instantiate()
    bg = torch.zeros(3, device="cuda")
    ids = [f"frame_{i:03d}" for i in range(FIT_VIEWS)]
    for sub in ("camera", os.path.join("rgb", "2x")):
        os.makedirs(os.path.join(root, sub))
    for i, (iid, c2w) in enumerate(zip(ids, fit_poses())):
        t = i / (FIT_VIEWS - 1)
        cam = at_time(camera(c2w, NERFIES_H, NERFIES_W, FOCAL / 2), t)
        with torch.no_grad():
            out = renderer.forward(state, cam, NERFIES_H, NERFIES_W, bg,
                                   SH_DEGREE)
        img = (out.render.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        Image.fromarray(img).save(os.path.join(root, "rgb", "2x",
                                               f"{iid}.png"),
                                  compress_level=PNG_LEVEL)
        w2c = np.linalg.inv(c2w)
        with open(os.path.join(root, "camera", f"{iid}.json"), "w") as f:
            json.dump({"orientation": w2c[:3, :3].tolist(),
                       "position": (c2w[:3, 3] / NERFIES_SCALE
                                    + NERFIES_CENTER).tolist(),
                       "focal_length": FOCAL, "pixel_aspect_ratio": 1.0,
                       "principal_point": [W / 2, 1080 / 2],
                       "image_size": [W, 1080],
                       "radial_distortion": [0.0, 0.0, 0.0],
                       "tangential_distortion": [0.0, 0.0]}, f)
    val = [ids[i] for i in NERFIES_VAL]
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"count": FIT_VIEWS, "ids": ids, "val_ids": val,
                   "train_ids": [i for i in ids if i not in val]}, f)
    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"scale": NERFIES_SCALE,
                   "center": NERFIES_CENTER.tolist()}, f)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({iid: {"time_id": i, "warp_id": i, "appearance_id": i,
                         "camera_id": 0} for i, iid in enumerate(ids)}, f)
    pick = np.random.RandomState(3).choice(N_GAUSSIANS, SFM_POINTS,
                                           replace=False)
    np.save(os.path.join(root, "points.npy"),
            arrays["means"][pick] / NERFIES_SCALE + NERFIES_CENTER)
    return moving


def deformed_val_psnr(trainer, state, outputs):
    """Mean PSNR over the val views of the render deformed by the trained
    field at each view's own time (validation renders the canonical
    set)."""
    dataset = CachedDataset(outputs.val_set)
    bg = torch.zeros(3, device="cuda")
    psnrs = []
    with torch.no_grad(), float32_math():
        for i in range(len(dataset)):
            cam, _, img_u8, _ = dataset.get(i)
            cam = cam.to("cuda")
            gt = image_to_float(img_u8.to("cuda"))
            gs = trainer.deform(state.extra["__deform__"]["params"],
                                state.gaussians, cam.time)
            out = trainer.renderer.forward(gs, cam, gt.shape[0],
                                           gt.shape[1], bg, SH_DEGREE)
            psnrs.append(float(psnr(out.render, gt)))
    return float(np.mean(psnrs))


def phase_dynamic_fits(tmp):
    """Phase 13 (b): deformable.yaml, gs4d.yaml and pvg.yaml through the
    CLI on a synthesised Nerfies capture, each fitted and resumed."""
    log("== phase 13 (b): deformable.yaml, gs4d.yaml and pvg.yaml through "
        "gsl_tpu_torch.cli on a synthesised Nerfies capture (24 views at "
        f"540x960 over times 0-1), each resumed; times on {CARD}")
    data, runs = os.path.join(tmp, "nerfies"), os.path.join(tmp, "runs")
    t0 = time.perf_counter()
    moving = write_nerfies_scene(data, scene_arrays(N_GAUSSIANS))
    outputs = NerfiesDataParserConfig(path=data, downsample=2).instantiate(
        ).get_outputs()
    times = outputs.train_set.cameras.time
    if not (len(outputs.train_set) == FIT_VIEWS - len(NERFIES_VAL)
            and outputs.train_set.cameras.width[0] == NERFIES_W
            and float(times.min()) == 0.0 and float(times.max()) == 1.0):
        fail(f"Nerfies parser: {len(outputs.train_set)} train views, times "
             f"{times.tolist()}")
    log(f"Nerfies capture written in {time.perf_counter() - t0:.1f} s: "
        f"{FIT_VIEWS} views, {moving:.4f} of the {N_GAUSSIANS} rows moving; "
        f"parsed at downsample 2: {len(outputs.train_set)} train views at "
        f"{NERFIES_W}x{NERFIES_H}, times {times.min():.3f}-"
        f"{times.max():.3f}, {len(outputs.point_cloud.xyz)} points")
    common = ("data.parser.class_path=Nerfies",
              "data.parser.init_args.downsample=2",
              f"fit.log_interval={VARIANT_LOG_INTERVAL}",
              "model.density.init_args.densify_from_iter=50",
              "model.density.init_args.densification_interval=50")
    for preset in ("deformable.yaml", "gs4d.yaml", "pvg.yaml"):
        name = preset.split(".")[0]
        over = common + ((f"model.deform.init_args.warm_up="
                          f"{DYNAMIC_WARM_UP}",)
                         if preset != "pvg.yaml" else ())
        path = os.path.join(PRESETS, preset)
        psnr0, _ = initial_psnr([path], over + (f"data.path={data}",), tmp,
                                name)

        def argv(steps):
            return ["fit", "--config", path, "--data.path", data,
                    "--output", runs, "-n", name, "--max_steps",
                    str(steps), *over]

        first = run_cli(argv(DYNAMIC_FIT_STEPS), GAUSSIAN_KERNELS)
        first.pop("state")
        second = run_cli(argv(DYNAMIC_RESUME_STEPS), GAUSSIAN_KERNELS)
        state = second.pop("state")
        got = second["results"]["psnr"]
        if f"-> continuing at {DYNAMIC_FIT_STEPS + 1}" not in second["said"] \
                or not got > psnr0:
            fail(f"fit {preset}: val PSNR {got:.3f} dB (initial cloud "
                 f"{psnr0:.3f}) after the resume")
        said = ""
        if preset == "pvg.yaml":
            v = state.params.velocities[state.alive]
            said = (f"; velocities of the alive rows up to "
                    f"{float(v.abs().max()):.3g}")
        else:
            count = state.extra["__deform__"]["opt"]["count"]
            if count != DYNAMIC_RESUME_STEPS - DYNAMIC_WARM_UP + 1:
                fail(f"fit {preset}: {count} field updates")
            trainer, _, _ = cli.build_components(cli.load_config(
                [path], cli.parse_overrides(over)))
            said = (f" (the canonical set, as gsl_tpu validates); the "
                    f"render deformed by the field at each val view's time "
                    f"{deformed_val_psnr(trainer, state, outputs):.4f} dB; "
                    f"{count} field updates")
        log(f"fit {preset}: val PSNR {got:.4f} dB at step "
            f"{DYNAMIC_RESUME_STEPS} after the resume at "
            f"{DYNAMIC_FIT_STEPS + 1}, from the initial cloud's "
            f"{psnr0:.4f}{said}")
        log_fit(f"fit {preset}", [first, second])
        del state
        torch.cuda.empty_cache()


# ---- phase 14: SpotLess and the distillation stages ------------------------

WIDE_WIDTHS = (32, 64, 128)     # SegAny; Feature3DGS with speedup; without
BWD_GROUPS = (8, 16, 32, 36)    # K3's channel groups timed (36: its largest)
STP_WIDE, SURFEL_WIDE = 96, 64  # past K3s's 88 and K7's 60 at tile 16
K2_GROUP = 8                    # channels per K2 launch (csrc's kMaxGroup)
SPOTLESS_STEPS, DISTILL_STEPS, ENTRY_STEPS = 5, 3, 50
SPOTLESS_FIT_STEPS, SPOTLESS_RESUME_STEPS, SPOTLESS_RESET = 150, 200, 120
SD_SHAPE = (1280, 50, 50)       # tools/sd_feature_extraction.py's features
N_SAM_MASKS, TEACHER_HW = 8, 64


def raster_launches(C, bwd=True):
    """K1-K4's launches in one render (and with `bwd` its backward) of C
    channels: K2 once per group of K2_GROUP, K3 once per group of
    min(K3_GROUP, its largest)."""
    k3 = -(-C // min(R.K3_GROUP, R.rasterize_bwd_max_group(TILE)))
    want = {k: 0 for k in KERNELS}
    want.update(expand=1, rasterize_fwd=-(-C // K2_GROUP))
    if bwd:
        want.update(rasterize_bwd=k3, reduce_grads=1)
    return want


def phase_wide_kernels(arrays, trec, srec):
    """Phase 14 (a): K1-K4 at C = 32, 64 and 128 at the bench pose, K3 at
    each group size, and K3s and K7 past their largest groups on the small
    scenes, and timed by group at the bench pose, with their bounds there
    from phase 3's counts of the same walks (`trec`, `srec`: the bench
    pose's). Returns {C: times, launches and bounds}."""
    state = state_from_raw_arrays(arrays, device="cuda")
    renderer = TileRendererConfig().instantiate()
    log("== phase 14 (a): the backward kernels past their channel "
        f"ceilings: K1-K4 at C = {WIDE_WIDTHS}, full width; K3s at C = "
        f"{STP_WIDE} and K7 at C = {SURFEL_WIDE} on the small scenes; times "
        f"on {CARD}")
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    n_tiles, n = tiles_x * tiles_y, state.capacity
    log(f"largest channel groups at tile {TILE}: K3 "
        f"{R.rasterize_bwd_max_group(TILE)}, K3s "
        f"{STP.rasterize_bwd_stp_max_group(TILE)}, K7 "
        f"{SR.rasterize_surfels_bwd_max_group(TILE)}; K3_GROUP "
        f"{R.K3_GROUP}")
    cam = camera(np.eye(4))
    proj = project_gaussians(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    opac = renderer.get_opacities(state, cam, proj).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    for C in WIDE_WIDTHS:
        ch = torch.randn((n, C), generator=gen, device="cuda")
        rec = {}
        k2_ms, k3_ms = hold_raster_kernels("bench", proj, opac, ch, n,
                                           140 + C, record=rec)
        fwd, bwd, isects = rec["fwd"], rec["bwd"], rec["isects"]
        n_valid, bounds, i_stop = rec["n_valid"], bwd[5], bwd[9]
        torch.cuda.synchronize()
        reset_launches()
        R.rasterize_fwd(*fwd)
        rows = R.rasterize_bwd(*bwd)
        red = (rows, bwd[4], isects.offsets, R.invert_order(rec["order"]),
               bounds[-1:], n)
        R.reduce_grads(*red)
        torch.cuda.synchronize()
        per_call = {k: v for k, v in read_launches().items() if v}
        want = {k: v for k, v in raster_launches(C).items()
                if v and k != "expand"}
        if per_call != want:
            fail(f"wide C={C}: launches per call {per_call}, not {want}")
        group_ms = {g: graph_ms(lambda g=g: R.rasterize_bwd(*bwd, group=g),
                                10) for g in BWD_GROUPS}
        k4_ms = graph_ms(lambda: R.reduce_grads(*red), 20)
        pairs = visited_pairs(i_stop, bounds, tiles_x)
        pairs_bwd = pairs - int((i_stop < R.NEVER_STOPPED).sum())
        comp = rec["composited_pairs"]
        fwd_bytes = (n * (24 + 4 * C) + 4 * n_valid + 8 * (n_tiles + 1)
                     + H * W * (4 * C + 8))
        k2_bound = bound(fwd_bytes, 12 * pairs + 5 * rec["near_pairs"]
                         + (3 + 2 * C) * comp)
        k3_bound = bound(fwd_bytes + 4 * H * W + 4 * (6 + C) * n_valid,
                         18 * pairs_bwd + (35 + 4 * C) * comp)
        k4_bound = bound(4 * (6 + C) * n_valid + 4 * isects.total + 8 * n
                         + 4 * (8 + C) * n, (8 + C) * n_valid)
        out[C] = {"K2_ms": round(k2_ms, 4), "K3_ms": round(k3_ms, 4),
                  "K3_ms_by_group": {g: round(v, 4)
                                     for g, v in group_ms.items()},
                  "K4_ms": round(k4_ms, 4), "launches_per_call": per_call,
                  "K2_bound": k2_bound, "K3_bound": k3_bound,
                  "K4_bound": k4_bound, "pairs": pairs,
                  "pairs_bwd": pairs_bwd, "composited_pairs": comp,
                  "near_pairs": rec["near_pairs"], "n_valid": n_valid,
                  "K3_max_abs_err": rec["bwd_err"],
                  "K4_max_abs_err": rec["reduce_err"]}
        log(f"wide C={C}: " + json.dumps(out[C]))
        del ch, rec, fwd, bwd, rows, red
        torch.cuda.empty_cache()
    out["stp"] = wide_small_stp()
    out["stp"]["bench_ms_by_group"] = wide_bench_stp(state, renderer)
    out["stp"]["bound_ms"], out["stp"]["bound_by"] = stp_bwd_bound(
        STP_WIDE, n, trec)
    del state
    torch.cuda.empty_cache()
    out["surfel"] = wide_small_surfel()
    out["surfel"]["bench_ms_by_group"] = wide_bench_surfel(arrays)
    out["surfel"]["bound_ms"], out["surfel"]["bound_by"] = surfel_bwd_bound(
        SURFEL_WIDE, n, srec)
    for key, name, C in (("stp", "K3s", STP_WIDE),
                         ("surfel", "K7", SURFEL_WIDE)):
        best = min(out[key]["bench_ms_by_group"].values())
        log(f"{name} bench C={C}: bound {out[key]['bound_ms']:.4f} ms "
            f"({out[key]['bound_by']}, from phase 3's counts at the bench "
            f"pose), {best / out[key]['bound_ms']:.1f}x at its best group")
    return out


def wide_bench_stp(state, renderer):
    """K3s at C = STP_WIDE at the bench pose, timed by channel group (8 and
    its largest); held on the small scene by `wide_small_stp`."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    cam = camera(np.eye(4))
    proj = project_gaussians(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    op = renderer.get_opacities(state, cam, proj).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(20)
    ch = torch.randn((state.capacity, STP_WIDE), generator=gen,
                     device="cuda")
    m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
    depths, kz = proj.depths.contiguous(), proj.depth_grads.contiguous()
    keys, gids = R.expand(R.isect_encode(proj, H, W, TILE), m2d, con, op,
                          depths, tiles_x, tiles_y, TILE, True, True, kz)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    fwd = (m2d, con, op, ch, depths, kz, gs, bounds, H, W, TILE)
    _, t_fin, _, ckpt = STP.rasterize_fwd_stp(*fwd, checkpoints=True)
    g_out = torch.randn((H, W, STP_WIDE), generator=gen, device="cuda")
    g_alpha = torch.randn((H, W), generator=gen, device="cuda")
    bwd = (*fwd[:8], g_out, g_alpha, t_fin, ckpt, TILE)
    ms = {g: round(graph_ms(lambda g=g: STP.rasterize_bwd_stp(
        *bwd, group=g), 5), 4)
        for g in (8, STP.rasterize_bwd_stp_max_group(TILE))}
    log(f"K3s bench C={STP_WIDE}: ms by group {ms}")
    return ms


def wide_bench_surfel(arrays):
    """K7 at C = SURFEL_WIDE at the bench pose on the surfel scene, timed
    by channel group (8 and its largest); held on the small scene by
    `wide_small_surfel`."""
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    state = state_from_raw_arrays(surfel_arrays(arrays), device="cuda")
    cam = camera(np.eye(4))
    proj = project_surfels(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, W, H)
    geom = SR.pack_surfels(proj.Tu, proj.Tv, proj.Tw, proj.zcoef,
                           state.get_opacities())
    gen = torch.Generator(device="cuda").manual_seed(21)
    ch = torch.randn((state.capacity, SURFEL_WIDE), generator=gen,
                     device="cuda")
    isects = SR.surfel_isect_encode(proj.means2d, proj.depths, proj.radii,
                                    H, W, TILE)
    keys, gids = SR.surfel_expand(isects, proj.depths.contiguous(), tiles_x,
                                  tiles_y)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    _, aux, stop = SR.rasterize_surfels_fwd(geom, ch, gs, bounds, H, W,
                                            TILE)
    g_out = torch.randn((H, W, SURFEL_WIDE), generator=gen, device="cuda")
    g_aux = torch.randn((3, H, W), generator=gen, device="cuda")
    bwd = (geom, ch, gs, bounds, g_out, g_aux, aux, stop, TILE)
    ms = {g: round(graph_ms(lambda g=g: SR.rasterize_surfels_bwd(
        *bwd, group=g), 5), 4)
        for g in (8, SR.rasterize_surfels_bwd_max_group(TILE))}
    log(f"K7 bench C={SURFEL_WIDE}: ms by group {ms}")
    return ms


def small_scene_arrays():
    """phase_small_reference's scene: 400 Gaussians, nearer the camera."""
    arrays = scene_arrays(400, seed=1)
    arrays["means"][:, 2] -= 2.0
    return arrays


def wide_small_stp():
    """K3s at C = STP_WIDE on the small scene (128x96): rows against the
    plain version column by column on the same inputs, identical twice,
    launches per call; ms per call by group."""
    h, w = 96, 128
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    state = state_from_raw_arrays(small_scene_arrays(), device="cuda")
    cam = camera(np.eye(4), h, w, 120.0)
    proj = project_gaussians(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, w, h)
    op = TileRendererConfig().instantiate().get_opacities(
        state, cam, proj).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(15)
    ch = torch.rand((state.capacity, STP_WIDE), generator=gen,
                    device="cuda")
    m2d, con = proj.means2d.contiguous(), proj.conics.contiguous()
    depths, kz = proj.depths.contiguous(), proj.depth_grads.contiguous()
    isects = R.isect_encode(proj, h, w, TILE)
    keys, gids = R.expand(isects, m2d, con, op, depths, tiles_x, tiles_y,
                          TILE, True, True, kz)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    fwd = (m2d, con, op, ch, depths, kz, gs, bounds, h, w, TILE)
    _, t_fin, _, ckpt = STP.rasterize_fwd_stp(*fwd, checkpoints=True)
    g_out = torch.randn((h, w, STP_WIDE), generator=gen, device="cuda")
    g_alpha = torch.randn((h, w), generator=gen, device="cuda")
    bwd = (*fwd[:8], g_out, g_alpha, t_fin, ckpt, TILE)
    before = STP.rasterize_bwd_stp.launches
    rows = STP.rasterize_bwd_stp(*bwd)
    launches = STP.rasterize_bwd_stp.launches - before
    want = -(-STP_WIDE // STP.rasterize_bwd_stp_max_group(TILE))
    if launches != want:
        fail(f"K3s C={STP_WIDE}: {launches} launches, not {want}")
    rows_p = STP.rasterize_bwd_stp_plain(*bwd)
    torch.cuda.synchronize()
    if not torch.equal(rows, STP.rasterize_bwd_stp(*bwd)):
        fail(f"K3s C={STP_WIDE}: two runs gave different rows")
    err, share = check_rows(f"K3s small STP scene C={STP_WIDE}", rows,
                            rows_p, K3_COLUMNS, GRAD_SHARE)
    ms = {g: round(graph_ms(lambda g=g: STP.rasterize_bwd_stp(
        *bwd, group=g), 10), 4)
        for g in (8, STP.rasterize_bwd_stp_max_group(TILE))}
    log(f"K3s small STP scene C={STP_WIDE}: every column agrees on >= "
        f"{share:.6f} of its values, max abs err {err:.3e}; identical in "
        f"two runs; {launches} launches a call; ms by group {ms}")
    return {"launches": launches, "share": share, "max_abs_err": err,
            "ms_by_group": ms}


def wide_small_surfel():
    """K7 at C = SURFEL_WIDE on the small surfel scene, as
    `wide_small_stp` holds K3s."""
    h, w = 96, 128
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    state = state_from_raw_arrays(surfel_arrays(small_scene_arrays()),
                                  device="cuda")
    cam = camera(np.eye(4), h, w, 120.0)
    proj = project_surfels(
        state.get_means(), state.get_scales(), state.get_rotations(),
        cam.world_to_camera, cam.fx, cam.fy, cam.cx, cam.cy, w, h)
    geom = SR.pack_surfels(proj.Tu, proj.Tv, proj.Tw, proj.zcoef,
                           state.get_opacities())
    gen = torch.Generator(device="cuda").manual_seed(16)
    ch = torch.rand((state.capacity, SURFEL_WIDE), generator=gen,
                    device="cuda")
    isects = SR.surfel_isect_encode(proj.means2d, proj.depths, proj.radii,
                                    h, w, TILE)
    keys, gids = SR.surfel_expand(isects, proj.depths.contiguous(), tiles_x,
                                  tiles_y)
    sk, gs, _ = R.sort_slots(keys, gids)
    bounds = R.tile_bounds(sk, tiles_x * tiles_y)
    _, aux, stop = SR.rasterize_surfels_fwd(geom, ch, gs, bounds, h, w,
                                            TILE)
    g_out = torch.randn((h, w, SURFEL_WIDE), generator=gen, device="cuda")
    g_aux = torch.randn((3, h, w), generator=gen, device="cuda")
    bwd = (geom, ch, gs, bounds, g_out, g_aux, aux, stop, TILE)
    before = SR.rasterize_surfels_bwd.launches
    rows = SR.rasterize_surfels_bwd(*bwd)
    launches = SR.rasterize_surfels_bwd.launches - before
    want = -(-SURFEL_WIDE // SR.rasterize_surfels_bwd_max_group(TILE))
    if launches != want:
        fail(f"K7 C={SURFEL_WIDE}: {launches} launches, not {want}")
    rows_p = SR.rasterize_surfels_bwd_plain(*bwd)
    torch.cuda.synchronize()
    if not torch.equal(rows, SR.rasterize_surfels_bwd(*bwd)):
        fail(f"K7 C={SURFEL_WIDE}: two runs gave different rows")
    err, share = check_rows(f"K7 small surfel scene C={SURFEL_WIDE}", rows,
                            rows_p, K7_COLUMNS, SURFEL_GRAD_SHARE)
    ms = {g: round(graph_ms(lambda g=g: SR.rasterize_surfels_bwd(
        *bwd, group=g), 10), 4)
        for g in (8, SR.rasterize_surfels_bwd_max_group(TILE))}
    log(f"K7 small surfel scene C={SURFEL_WIDE}: every column agrees on >= "
        f"{share:.6f} of its values, max abs err {err:.3e}; identical in "
        f"two runs; {launches} launches a call; ms by group {ms}")
    return {"launches": launches, "share": share, "max_abs_err": err,
            "ms_by_group": ms}


def bench_targets(arrays, cams, bg):
    """The bench scene rendered by the port at `cams` (phase 5's targets)."""
    truth = state_from_raw_arrays(arrays, device="cuda")
    plain = TileRendererConfig().instantiate()
    with torch.no_grad():
        return [plain.forward(truth, c, H, W, bg, SH_DEGREE).render
                for c in cams]


def phase_spotless_training(arrays, plain_step_ms):
    """Phase 14 (b): the SpotLess step at capacity 1M."""
    log("== phase 14 (b): the SpotLess step (mask MLP at 800x800 over "
        f"{SD_SHAPE} SD features) at 1088x1920, capacity 1M; times on "
        f"{CARD}")
    bg = torch.zeros(3, device="cuda")
    cams = [camera(c2w) for c2w in views().values()]
    targets = bench_targets(arrays, cams, bg)
    cfg = SpotLessMetricsConfig(opacity_reg=0.01)
    trainer = Trainer(model=VanillaGaussianConfig(sh_degree=SH_DEGREE),
                      metrics=cfg)
    state = trainer.setup(state_from_raw_arrays(perturbed(arrays),
                                                device="cuda"),
                          cameras_extent=TRAIN_EXTENT)
    state = dataclasses.replace(state, extra=dict(
        state.extra or {}, __spotless__=init_spotless_state(
            cfg, "cuda", torch.Generator().manual_seed(14))))
    rng = np.random.RandomState(14)
    feats = [torch.from_numpy(rng.randn(*SD_SHAPE).astype(np.float16)).to(
        "cuda").float() for _ in cams]
    gen = torch.Generator(device="cuda").manual_seed(14)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, masks = [], [], []
    for step in range(SPOTLESS_STEPS):
        view = step % len(cams)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        state, sc = spotless_step(trainer, cfg, state, cams[view],
                                  targets[view], feats[view], bg, H, W,
                                  SH_DEGREE, generator=gen)
        losses.append(float(sc["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        masks.append(round(float(sc["mask_mean"]), 5))
        check_step_launches("SpotLess", step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sls = state.extra["__spotless__"]
    if not (all(math.isfinite(x) for x in losses)
            and sls["opt"]["count"] == SPOTLESS_STEPS
            and float(sls["hist"].sum()) > 0):
        fail(f"SpotLess: losses {losses}, {sls['opt']['count']} MLP "
             "updates")
    ms = float(np.median(step_ms[1:]))
    log(f"SpotLess: ms per step {[round(x, 2) for x in step_ms]}, median "
        f"after the first {ms:.2f} (phase 5's plain step in this run "
        f"{plain_step_ms:.2f}); loss {losses[0]:.6g} -> {losses[-1]:.6g}; "
        f"mask mean per step {masks}; peak {peak:.3f} GiB; K1-K4 once a "
        "step")
    return {"ms": ms, "peak_gib": peak, "mask_mean": masks}


def write_keyword_scene(src, dst):
    """A copy of phase 8's scene whose image names carry SpotLess's
    keywords (every eighth, from the fifth, `extra_*`, val; the others
    `clutter_*`, train), with SD features SD/<stem>.npy [1280, 50, 50]
    float16 for the train images. Returns (train, val) counts."""
    model = read_model(os.path.join(src, "sparse", "0"))
    os.makedirs(os.path.join(dst, "images"))
    os.makedirs(os.path.join(dst, "SD"))
    rng = np.random.RandomState(17)
    images, n_val = {}, 0
    for i, (k, img) in enumerate(sorted(model.images.items())):
        val = i % 8 == 4
        n_val += val
        name = ("extra_" if val else "clutter_") + img.name
        os.link(os.path.join(src, "images", img.name),
                os.path.join(dst, "images", name))
        images[k] = dataclasses.replace(img, name=name)
        if not val:
            np.save(os.path.join(dst, "SD", name[:-4] + ".npy"),
                    rng.randn(*SD_SHAPE).astype(np.float16))
    write_model_bin(dataclasses.replace(model, images=images),
                    os.path.join(dst, "sparse", "0"))
    return len(images) - n_val, n_val


def phase_spotless_fit(tmp):
    """Phase 14 (b): spotless.yaml through the CLI on a keyword-split copy
    of phase 8's scene, fitted and resumed."""
    log("== phase 14 (b): spotless.yaml through gsl_tpu_torch.cli on a "
        "keyword-split copy of phase 8's scene, resumed")
    data, runs = os.path.join(tmp, "spotless_scene"), os.path.join(tmp,
                                                                   "runs")
    n_train, n_val = write_keyword_scene(os.path.join(tmp, "scene"), data)
    preset = os.path.join(PRESETS, "spotless.yaml")
    over = (f"fit.log_interval={VARIANT_LOG_INTERVAL}",
            "model.density.init_args.densify_from_iter=100",
            "model.density.init_args.densification_interval=50",
            f"model.metric.init_args.reset_sh={SPOTLESS_RESET}")
    psnr0, _ = initial_psnr([preset], over + (f"data.path={data}",), tmp,
                            "spotless")

    def argv(steps):
        return ["fit", "--config", preset, "--data.path", data, "--output",
                runs, "-n", "spotless", "--max_steps", str(steps), *over]

    first = run_cli(argv(SPOTLESS_FIT_STEPS), GAUSSIAN_KERNELS)
    first.pop("state")
    second = run_cli(argv(SPOTLESS_RESUME_STEPS), GAUSSIAN_KERNELS)
    state = second.pop("state")
    psnr = second["results"]["psnr"]
    sls = state.extra["__spotless__"]
    if (f"-> continuing at {SPOTLESS_FIT_STEPS + 1}" not in second["said"]
            or not psnr > psnr0
            or sls["opt"]["count"] != SPOTLESS_RESUME_STEPS):
        fail(f"fit spotless.yaml: val PSNR {psnr:.3f} dB (initial cloud "
             f"{psnr0:.3f}), {sls['opt']['count']} MLP updates after the "
             "resume")
    log(f"fit spotless.yaml: {n_train} clutter (train) and {n_val} extra "
        f"(val) views; val PSNR initial cloud {psnr0:.4f} dB, at step "
        f"{SPOTLESS_FIT_STEPS} {first['results']['psnr']:.4f}, at step "
        f"{SPOTLESS_RESUME_STEPS} {psnr:.4f} after the resume at "
        f"{SPOTLESS_FIT_STEPS + 1}; {sls['opt']['count']} MLP updates; "
        f"the specular reset at {SPOTLESS_RESET}")
    log_fit("fit spotless.yaml", [first, second])
    del state
    torch.cuda.empty_cache()


def sam_masks(m, h, w, seed):
    """[m, h, w] bool rectangles, as SAM's masks cover objects; a corner
    under none."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((m, h, w), bool)
    for i in range(m):
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        masks[i, y0:y0 + rng.randint(h // 8, h // 2),
              x0:x0 + rng.randint(w // 8, w // 2)] = True
    masks[:, :h // 16, :w // 16] = False
    return masks


def distill_steps(what, step, n_channels):
    """`DISTILL_STEPS` calls of `step()` -> loss, each checked for its
    launches (K1-K4 at `n_channels`). Returns (ms per step, losses, peak
    GiB, launches per step)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    want = raster_launches(n_channels)
    for _ in range(DISTILL_STEPS):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        losses.append(float(step()))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if read_launches() != want:
            fail(f"{what}: launches {read_launches()}, not {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss in {losses}")
    return (step_ms, losses, torch.cuda.max_memory_allocated() / 2 ** 30,
            {k: v for k, v in want.items() if v})


def phase_distill(arrays):
    """Phase 14 (c): Feature3DGS (C = 128, speedup C = 64) and SegAny
    (C = 32) steps on the bench scene at 1M."""
    log("== phase 14 (c): Feature3DGS at C = 128 and with speedup (64), "
        "SegAny at C = 32 with 1024 samples, on the frozen bench scene "
        f"(1M, 1088x1920); times on {CARD}")
    state = state_from_raw_arrays(arrays, device="cuda")
    cam = camera(np.eye(4))
    gen = torch.Generator(device="cuda").manual_seed(18)
    out = {}
    for speedup in (False, True):
        cfg = Feature3DGSConfig(speedup=speedup)
        trainer = Feature3DGSTrainer(cfg, state)
        box = list(trainer.init(torch.Generator().manual_seed(0)))
        teacher = torch.randn((TEACHER_HW, TEACHER_HW, cfg.n_feature_dims),
                              generator=gen, device="cuda")

        def step():
            box[0], box[1], loss = trainer.train_step(box[0], box[1], cam,
                                                      teacher, H, W)
            return loss

        what = f"Feature3DGS C={cfg.actual_dims}" + (
            " (speedup)" if speedup else "")
        ms, losses, peak, launches = distill_steps(what, step,
                                                   cfg.actual_dims)
        out[what] = {"ms": ms, "peak_gib": peak, "launches": launches}
        log(f"{what}: ms per step {[round(x, 2) for x in ms]}; loss "
            f"{losses[0]:.6g} -> {losses[-1]:.6g}; peak {peak:.3f} GiB; "
            f"launches per step {launches}")
        del box, trainer, teacher
        torch.cuda.empty_cache()
    cfg = SegAnyConfig()
    trainer = SegAnyTrainer(cfg, state)
    box = list(trainer.init(torch.Generator().manual_seed(0)))
    masks = torch.from_numpy(sam_masks(N_SAM_MASKS, H, W, 18)).to("cuda")
    scales = torch.ones(N_SAM_MASKS, device="cuda")

    def step():
        box[0], box[1], loss = trainer.train_step(
            box[0], box[1], cam, masks, scales, 1.0, H, W, generator=gen)
        return loss

    what = f"SegAny C={cfg.feature_dims}"
    ms, losses, peak, launches = distill_steps(what, step, cfg.feature_dims)
    out[what] = {"ms": ms, "peak_gib": peak, "launches": launches}
    log(f"{what}, {cfg.n_sampled_pixels} samples, {N_SAM_MASKS} masks: ms "
        f"per step {[round(x, 2) for x in ms]}; loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g}; peak {peak:.3f} GiB; launches per step "
        f"{launches}")
    return out


def phase_distill_entry_points(tmp):
    """Phase 14 (c): the two entry points on phase 8's colmap.yaml run,
    with SAM masks and teacher maps synthesised at the parsers' names."""
    log("== phase 14 (c): gsl_tpu_torch.seganygs and gsl_tpu_torch."
        "feature3dgs (and --speedup) on phase 8's colmap.yaml run, "
        f"{ENTRY_STEPS} steps each")
    data, run = os.path.join(tmp, "scene"), os.path.join(tmp, "runs",
                                                         "colmap")
    for d in ("semantic/masks", "semantic/sam_features"):
        os.makedirs(os.path.join(data, d), exist_ok=True)
    rng = np.random.RandomState(19)
    names = sorted(os.listdir(os.path.join(data, "images")))
    for i, name in enumerate(names):
        np.savez_compressed(os.path.join(
            data, "semantic/masks", os.path.splitext(name)[0] + ".npz"),
            masks=sam_masks(N_SAM_MASKS, H, W, i))
        np.save(os.path.join(data, "semantic/sam_features", name + ".npy"),
                rng.randn(128, TEACHER_HW, TEACHER_HW).astype(np.float32))
    for tag, main_fn, extra, written in (
            ("seganygs", seganygs_main.main, (), "scene_features.npy"),
            ("feature3dgs", feature3dgs_main.main, (), "features.npz"),
            ("feature3dgs --speedup", feature3dgs_main.main,
             ("--speedup",), "features.npz")):
        out = os.path.join(tmp, "distill", tag.replace(" --", "_"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            _, losses = main_fn(["fit", run, "--data.path", data,
                                 "--max_steps", str(ENTRY_STEPS),
                                 "--output", out, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in read_launches().items() if v}
        if set(launches) != set(GAUSSIAN_KERNELS):
            fail(f"{tag}: launches {launches}")
        steps = sorted(losses)
        if (not os.path.isfile(os.path.join(out, written))
                or len(steps) < ENTRY_STEPS // 2
                or not all(math.isfinite(v) for v in losses.values())):
            fail(f"{tag}: {len(steps)} steps, losses {losses}")
        log(f"{tag}: {len(steps)} steps in {wall:.1f} s; loss at step "
            f"{steps[0]} {losses[steps[0]]:.6g}, at step {steps[-1]} "
            f"{losses[steps[-1]]:.6g}; wrote {written}; peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
            f"launches {launches}")


# ---- phase 15: serve and edit ----------------------------------------------

VIEWER_SIZE = 1088          # the served frame's side when the camera rests
RENDER_REPS = 5             # /render requests timed, and get_outputs calls
GIF_FRAMES = 30             # the viewer's camera-path GIF (its length)
CONCURRENT = 4              # /render requests sent at once
SERVE_KERNELS = ("expand", "rasterize_fwd")
SURFEL_SERVE_KERNELS = ("surfel_expand", "surfel_fwd")
VIEWER_FIT_STEPS = 100
PAGE_POLL_S = 0.5           # the training viewer page's /status interval
PARSER_FIT_STEPS = 50       # cut from 100 to make room for phase 16
LPIPS_RTOL = 1e-4
PARSER_CAPTURES = ("NSVF", "NGP", "MatrixCity", "SILVR")


def http_get(base, path, timeout=600):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.read()


def decode_png(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def host_ms(fn):
    """(result, ms) of fn(), synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def serve_and_edit(tag, model_path, kernels, tmp):
    """Phase 15 (a) on one model: the web viewer at VIEWER_SIZE on port 0,
    every route driven over HTTP from this script."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    v = Viewer(model_path, host="127.0.0.1", port=0,
               image_size=VIEWER_SIZE, max_fps=1e9, moving_window_s=0.0)
    v.start(block=False)
    base = f"http://127.0.0.1:{v.port}"
    n_rows = v.renderer.state.n_alive
    try:
        if b"gsl_tpu_torch viewer" not in http_get(base, "/"):
            fail(f"{tag}: / did not serve the viewer's page")
        names = json.loads(http_get(base, "/outputs"))
        if names != v.renderer.available_output_types():
            fail(f"{tag}: /outputs gave {names}, not "
                 f"{v.renderer.available_output_types()}")
        per_request = {}
        for output in names:
            for moving in (False, True):
                # the camera rests (full size) or moves (half size)
                v.moving_window_s = 1e9 if moving else 0.0
                size = VIEWER_SIZE // 2 if moving else VIEWER_SIZE
                yaw = 12.0 + 0.5 * moving
                torch.cuda.synchronize()
                reset_launches()
                png = http_get(base, f"/render?yaw={yaw}&pitch=-10&dist=6"
                               f"&output={output}")
                torch.cuda.synchronize()
                per = {k: c for k, c in read_launches().items() if c}
                if set(per) != set(kernels):
                    fail(f"{tag} /render {output} at {size}: launched "
                         f"{per}, not {kernels}")
                per_request[f"{output}@{size}"] = per
                v.renderer.output_type = output
                want = v.renderer.get_outputs(
                    orbit_c2w(yaw, -10.0, 6.0, v.target), size, size)
                got = decode_png(png)
                if got.shape != (size, size, 3) or not np.array_equal(
                        got, want):
                    fail(f"{tag} /render {output} at {size}: the PNG "
                         "differs from ViewerRenderer.get_outputs at the "
                         "same pose")
        v.moving_window_s = 0.0
        request_ms, direct_ms, encode_ms = [], [], []
        for i in range(RENDER_REPS):
            _, ms = host_ms(lambda i=i: http_get(
                base, f"/render?yaw={30 + i}&pitch=-10&dist=6&output=rgb"))
            request_ms.append(ms)
        v.renderer.output_type = "rgb"
        for i in range(RENDER_REPS):
            img, ms = host_ms(lambda i=i: v.renderer.get_outputs(
                orbit_c2w(30.0 + i, -10.0, 6.0, v.target), VIEWER_SIZE,
                VIEWER_SIZE))
            direct_ms.append(ms)
            encode_ms.append(host_ms(lambda: png_bytes(img))[1])

        # CONCURRENT poses' peaks one request at a time, then the same
        # requests at once: the viewer renders under one lock, so the
        # peak must be the largest single one (a pose's buffers follow
        # its slot count). A round at once first: each server thread
        # alive at once takes its own cuBLAS handle, whose 32 MiB
        # workspace is allocated once and kept
        def peak_of(yaws, workers):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                pngs = list(pool.map(lambda yaw: http_get(
                    base, f"/render?yaw={yaw}&pitch=-10&dist=6"), yaws))
            torch.cuda.synchronize()
            if not all(p[:8] == b"\x89PNG\r\n\x1a\n" for p in pngs):
                fail(f"{tag}: a concurrent /render gave no PNG")
            return torch.cuda.max_memory_allocated() / 2 ** 30

        yaws = [50.0 + i for i in range(CONCURRENT)]
        peak_of(yaws, CONCURRENT)
        single = max(peak_of([y], 1) for y in yaws)
        http_get(base, "/render?yaw=80&pitch=-10&dist=6")   # uncache
        peaks = [single, peak_of(yaws, CONCURRENT)]
        if peaks[1] > peaks[0] * 1.01:
            fail(f"{tag}: {CONCURRENT} concurrent /render requests peaked "
                 f"at {peaks[1]:.4f} GiB, the largest single one at "
                 f"{peaks[0]:.4f}")
        kw = dict(translate=(0.3, -0.2, 0.5), rotate_deg=(10.0, -25.0, 40.0),
                  scale=1.2)
        _, transform_ms = host_ms(lambda: http_get(
            base, "/transform?tx=0.3&ty=-0.2&tz=0.5&rx=10&ry=-25&rz=40"
            "&s=1.2"))
        direct = transform_state(v._base_state, **kw)
        for k in direct.params.fields():
            if not torch.equal(getattr(v.renderer.state.params, k),
                               getattr(direct.params, k)):
                fail(f"{tag} /transform: {k} differs from transform_state "
                     "applied directly")
        means = v.renderer.state.params.means.cpu().numpy()
        alive = v.renderer.state.alive.cpu().numpy()
        lo = [float(f"{x:.4f}") for x in np.percentile(means, 30, axis=0)]
        hi = [float(f"{x:.4f}") for x in np.percentile(means, 60, axis=0)]
        inside = int((((means >= lo) & (means <= hi)).all(1) & alive).sum())
        text, delete_ms = host_ms(lambda: http_get(
            base, f"/edit/delete_box?min={','.join(map(str, lo))}"
            f"&max={','.join(map(str, hi))}").decode())
        if text != f"deleted {inside}" or inside == 0 \
                or v.renderer.state.n_alive != n_rows - inside:
            fail(f"{tag} /edit/delete_box said {text!r}; the host counts "
                 f"{inside} alive means in the box")
        text, measure_ms = host_ms(lambda: http_get(
            base, "/measure?p1=0.4,0.5&p2=0.6,0.5&yaw=12&pitch=-10&dist=6"
        ).decode())
        if not (text.startswith("distance ")
                and math.isfinite(float(text.split()[1]))):
            fail(f"{tag} /measure said {text!r}")
        http_get(base, "/path/add?yaw=0&pitch=-10&dist=6")
        if http_get(base, "/path/add?yaw=40&pitch=-20&dist=7") \
                != b"2 keyframes":
            fail(f"{tag} /path/add kept no second keyframe")
        path_file = os.path.join(tmp, tag.replace(" ", "_") + ".json")
        http_get(base, f"/path/save?file={path_file}")
        with open(path_file) as f:
            if len(json.load(f)["keyframes"]) != 2:
                fail(f"{tag} /path/save wrote no two keyframes")
        torch.cuda.synchronize()
        reset_launches()
        gif, gif_ms = host_ms(lambda: http_get(base, "/path/render.gif"))
        gif_launches = {k: c for k, c in read_launches().items() if c}
        im = Image.open(io.BytesIO(gif))
        if im.n_frames != GIF_FRAMES or im.size != (VIEWER_SIZE,
                                                    VIEWER_SIZE):
            fail(f"{tag} /path/render.gif: {im.n_frames} frames of "
                 f"{im.size}")
        for i in range(GIF_FRAMES):
            im.seek(i)
            im.convert("RGB").load()
        if gif_launches != {k: GIF_FRAMES for k in kernels}:
            fail(f"{tag} /path/render.gif launched {gif_launches}")
        http_get(base, "/path/clear")
        if v.camera_path.keyframes:
            fail(f"{tag} /path/clear left keyframes")
    finally:
        v.stop()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag}: {n_rows} rows; /outputs {names}; every output's /render "
        f"PNG at {VIEWER_SIZE}^2 (resting) and {VIEWER_SIZE // 2}^2 "
        "(moving) equal to ViewerRenderer.get_outputs; launches per request "
        f"{json.dumps(per_request)}")
    log(f"{tag}: ms per rgb /render request at {VIEWER_SIZE}^2 (HTTP round "
        f"trip incl. PNG encode) median "
        f"{float(np.median(request_ms)):.2f} of "
        f"{[round(x, 2) for x in request_ms]}; get_outputs alone median "
        f"{float(np.median(direct_ms)):.2f} of "
        f"{[round(x, 2) for x in direct_ms]}; PNG encode alone median "
        f"{float(np.median(encode_ms)):.2f} ms; on {CARD}")
    log(f"{tag}: peak of {CONCURRENT} poses' /render requests one at a time "
        f"{peaks[0]:.4f} GiB (the largest), sent at once {peaks[1]:.4f} GiB "
        "(renders take one lock)")
    log(f"{tag}: /transform (rotation, scale, translation) {transform_ms:.2f}"
        f" ms, equal to transform_state; /edit/delete_box {delete_ms:.2f} ms, "
        f"deleted {inside} (the host's count); /measure {measure_ms:.2f} ms "
        f"({text}); /path/render.gif {GIF_FRAMES} frames in "
        f"{gif_ms / 1e3:.2f} s ({len(gif)} bytes, launches {gif_launches}); "
        f"peak memory {peak:.3f} GiB")
    return {"render_ms": float(np.median(request_ms)),
            "get_outputs_ms": float(np.median(direct_ms)),
            "transform_ms": transform_ms, "gif_s": gif_ms / 1e3,
            "peak_gib": peak}


class RecordedTrainingViewer(TrainingViewer):
    """The fit's training viewer, kept where this script can find its
    bound port."""
    started = []

    def start(self):
        RecordedTrainingViewer.started.append(super().start())
        return self


def phase_training_viewer(tmp):
    """Phase 15 (b): colmap.yaml on phase 8's scene with --viewer on port
    0 while a client polls it, against the same fit without the viewer."""
    log(f"== phase 15 (b): the in-training viewer, colmap.yaml for "
        f"{VIEWER_FIT_STEPS} steps on phase 8's scene")
    data, runs = os.path.join(tmp, "scene"), os.path.join(tmp, "runs")

    def argv(name, viewer):
        return ["fit", "--config", os.path.join(PRESETS, "colmap.yaml"),
                "--data.path", data, "--output", runs, "-n", name,
                "--max_steps", str(VIEWER_FIT_STEPS), *FIT_OVERRIDES,
                "fit.log_interval=1", "fit.save_ply=false"] + (
            ["--viewer", "--viewer_port", "0"] if viewer else [])

    polls, frames, stop = [0], [], threading.Event()

    def client():
        """The page's client: /status every PAGE_POLL_S, /frame when the
        frame id changes."""
        while not RecordedTrainingViewer.started and not stop.is_set():
            time.sleep(0.005)
        if stop.is_set():
            return
        base = f"http://127.0.0.1:{RecordedTrainingViewer.started[0].port}"
        shown = None
        while not stop.is_set():
            try:
                st = json.loads(http_get(
                    base, "/status?yaw=20&pitch=-10&dist=5", timeout=30))
                polls[0] += 1
                if st.get("frame") and st["frame"] != shown:
                    frames.append(http_get(base, "/frame", timeout=30))
                    shown = st["frame"]
            except OSError:
                return               # the fit ended and stopped its server
            stop.wait(PAGE_POLL_S)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # both fits alike
    saved = fit_module.TrainingViewer
    fit_module.TrainingViewer = RecordedTrainingViewer
    poller = threading.Thread(target=client, daemon=True)
    try:
        plain = run_cli(argv("no_viewer", False), GAUSSIAN_KERNELS)
        poller.start()
        viewed = run_cli(argv("viewer", True), GAUSSIAN_KERNELS)
    finally:
        stop.set()
        poller.join(timeout=60)
        fit_module.TrainingViewer = saved
        torch.backends.cudnn.deterministic = deterministic
    tv = RecordedTrainingViewer.started[0]
    if tv._server is not None:
        fail("the fit left its training viewer running")
    if not frames or not all(f[:2] == b"\xff\xd8" for f in frames):
        fail(f"the training viewer served {len(frames)} JPEG frames")
    losses = [[r[1] for r in f["rows"]] for f in (plain, viewed)]
    if losses[0] != losses[1] or len(losses[0]) != VIEWER_FIT_STEPS:
        fail("the losses with the viewer differ from those without: "
             f"{losses[1][:5]}... vs {losses[0][:5]}...")
    ms = [[1e3 / float(r[3]) for r in f["rows"][10:]] for f in
          (plain, viewed)]
    log(f"training viewer: {VIEWER_FIT_STEPS} losses equal with and "
        f"without the viewer; ms per step (steps 11-{VIEWER_FIT_STEPS}, "
        f"median) {float(np.median(ms[1])):.2f} with the viewer vs "
        f"{float(np.median(ms[0])):.2f} without; {tv.frames} frames "
        f"rendered at {tv.image_size}^2 every {tv.pump_interval} steps, "
        f"{len(frames)} fetched over {polls[0]} /status polls; launches "
        f"{viewed['launches']} vs {plain['launches']}; on {CARD}")
    return {"ms": float(np.median(ms[1])),
            "plain_ms": float(np.median(ms[0])), "frames": len(frames)}


def write_parser_captures(tmp, arrays):
    """Phase 8's views (the same PNGs, linked) as an NSVF, an instant-ngp,
    a MatrixCity (no depth files) and a SiLVR capture; every eighth view
    is val where the format has a split."""
    src = os.path.join(tmp, "scene", "images")
    names = [f"view_{i:03d}.png" for i in range(FIT_VIEWS)]
    gl = []
    for c2w in fit_poses():
        g = np.array(c2w, np.float64)
        g[:3, 1:3] *= -1            # OpenCV -> OpenGL; the parsers flip back
        gl.append(g)
    roots = {k: os.path.join(tmp, "captures", k) for k in PARSER_CAPTURES}

    def link(name, dst):
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.symlink(os.path.join(src, name), dst)

    def dump(obj, path):
        with open(path, "w") as f:
            json.dump(obj, f)

    intr = {"fl_x": FOCAL, "fl_y": FOCAL, "cx": W / 2, "cy": H / 2, "w": W,
            "h": H}
    r = roots["NSVF"]
    os.makedirs(os.path.join(r, "pose"))
    for i, name in enumerate(names):
        stem = f"{int(i % 8 == 0)}_{i:03d}"
        link(name, os.path.join(r, "rgb", stem + ".png"))
        np.savetxt(os.path.join(r, "pose", stem + ".txt"), gl[i])
    with open(os.path.join(r, "intrinsics.txt"), "w") as f:
        f.write(f"{FOCAL} {W / 2} {H / 2} 0.\n")
    np.savetxt(os.path.join(r, "bbox.txt"), [np.concatenate(
        [arrays["means"].min(0), arrays["means"].max(0), [0.05]])])
    frames = [{"file_path": f"images/{n}", "transform_matrix": gl[i].tolist()}
              for i, n in enumerate(names)]
    for key in ("NGP", "SILVR"):
        for n in names:
            link(n, os.path.join(roots[key], "images", n))
    dump(dict(intr, frames=frames),
         os.path.join(roots["NGP"], "transforms.json"))
    dump({"frames": [dict(f, **intr) for f in frames]},
         os.path.join(roots["SILVR"], "transforms.json"))
    r = roots["MatrixCity"]
    for n in names:
        link(n, os.path.join(r, "rgb", n))
    for split, keep in (("train", False), ("test", True)):
        dump(dict(intr, frames=[
            {"file_path": f"rgb/{n}", "transform_matrix": gl[i].tolist()}
            for i, n in enumerate(names) if (i % 8 == 0) == keep]),
            os.path.join(r, f"transforms_{split}.json"))
    return roots


def phase_parser_fits(tmp, arrays):
    """Phase 15 (c): the four parsers fitted through the CLI."""
    log(f"== phase 15 (c): NSVF, NGP, MatrixCity and SiLVR captures of "
        f"phase 8's views, blender.yaml with each parser, "
        f"{PARSER_FIT_STEPS} steps")
    roots = write_parser_captures(tmp, arrays)
    blender = os.path.join(PRESETS, "blender.yaml")
    out = {}
    for name in PARSER_CAPTURES:
        extra = ["trainer.background_color=[0.0, 0.0, 0.0]"]
        if name == "NGP":
            extra.append("data.parser.init_args.scene_box=8.0")
        overrides = [f"data.parser.class_path={name}",
                     f"data.path={roots[name]}", *extra]
        psnr0, _ = initial_psnr([blender], overrides, tmp, name)
        f = run_cli(["fit", "--config", blender, "--data.path", roots[name],
                     "--output", os.path.join(tmp, "runs"), "-n",
                     f"parser_{name}", "--max_steps", str(PARSER_FIT_STEPS),
                     f"data.parser.class_path={name}", "fit.log_interval=10",
                     "fit.save_ply=false", *extra], GAUSSIAN_KERNELS)
        psnr = f["results"]["psnr"]
        if not psnr > psnr0:
            fail(f"{name}: val PSNR {psnr:.3f} dB after {PARSER_FIT_STEPS} "
                 f"steps is not above the initial cloud's {psnr0:.3f}")
        rows = f["rows"]
        ms = [1e3 / float(r[3]) for r in rows[1:]]
        log(f"fit {name}: val PSNR {psnr0:.3f} -> {psnr:.3f} dB; ms per step "
            f"(windows after the first) median {float(np.median(ms)):.2f} of "
            f"{[round(x, 2) for x in ms]}; {int(rows[-1][2])} Gaussians; "
            f"peak {f['peak_gib']} GiB; on {CARD}")
        out[name] = {"psnr0": psnr0, "psnr": psnr,
                     "ms": float(np.median(ms))}
    return out


def lpips_random_weights(path):
    """A seeded AlexNet-LPIPS weight file of the exported layout."""
    rng = np.random.RandomState(0)
    convs = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3),
             (256, 256, 3)]
    z = {}
    for fid, (o, i, k) in zip((0, 3, 6, 8, 10), convs):
        z[f"features.{fid}.weight"] = (rng.randn(o, i, k, k)
                                       * 0.05).astype(np.float32)
        z[f"features.{fid}.bias"] = np.zeros(o, np.float32)
    for li, c in enumerate((64, 192, 384, 256, 256)):
        z[f"lin.{li}.weight"] = (np.abs(rng.randn(1, c, 1, 1))
                                 * 0.1).astype(np.float32)
    np.savez(path, **z)
    return path


def phase_lpips(tmp):
    """Phase 15 (d): LPIPS on the card against the CPU, and validate's
    column filled on phase 8's run."""
    log("== phase 15 (d): LPIPS (seeded random weights: the values show "
        "the path, not quality)")
    path = lpips_random_weights(os.path.join(tmp, "lpips_alex.npz"))
    gt = image_to_float(torch.from_numpy(np.array(Image.open(os.path.join(
        tmp, "scene", "images", "view_000.png")))))
    loaded, renderer, sh_degree = GaussianModelLoader.load(
        os.path.join(tmp, "runs", "colmap"))
    with torch.no_grad():
        render = renderer.forward(loaded, camera(np.eye(4)), H, W,
                                  torch.zeros(3, device="cuda"),
                                  sh_degree).render.clamp(0, 1)
    del loaded
    w_card, w_cpu = lpips_module.load_weights(path, "cuda"), \
        lpips_module.load_weights(path)
    card = float(lpips_module.lpips(render, gt.cuda(), w_card))
    cpu = float(lpips_module.lpips(render.cpu(), gt, w_cpu))
    if not abs(card - cpu) <= LPIPS_RTOL * abs(cpu):
        fail(f"LPIPS at {H}x{W}: card {card!r} vs CPU {cpu!r}")
    ms = cuda_ms(lambda: lpips_module.lpips(render, gt.cuda(), w_card), 10)
    os.environ["GSL_LPIPS_WEIGHTS"] = path
    lpips_module.get_lpips_fn.cache_clear()
    try:
        val = run_cli(["validate", "--output", os.path.join(tmp, "runs"),
                       "-n", "colmap"], SERVE_KERNELS)
    finally:
        del os.environ["GSL_LPIPS_WEIGHTS"]
        lpips_module.get_lpips_fn.cache_clear()
    with open(val["results"]["csv"]) as f:
        rows = list(csv.reader(f))
    if rows[0][3] != "lpips" or not all(
            math.isfinite(float(r[3])) for r in rows[1:]):
        fail(f"validate wrote no LPIPS column: {rows}")
    log(f"LPIPS at {H}x{W} (random weights): card {card:.6f}, CPU "
        f"{cpu:.6f} (rtol {LPIPS_RTOL}); {ms:.2f} ms on {CARD}; validate "
        f"on phase 8's run: column {rows[0][3]!r}, MEAN "
        f"{float(rows[-1][3]):.6f} over {len(rows) - 2} views")
    return {"ms": ms, "card": card, "cpu": cpu}


def phase_tools(tmp):
    """Phase 15 (e): the PLY and checkpoint tools on phase 8's run."""
    log("== phase 15 (e): ckpt2ply, gaussian_transform, fuse_mip_filter "
        "and convert2splat on phase 8's colmap.yaml run")
    run, data = os.path.join(tmp, "runs", "colmap"), os.path.join(tmp,
                                                                 "scene")
    loaded, _, _ = GaussianModelLoader.load(run)
    n = loaded.n_alive
    means = loaded.params.means.cpu().numpy()
    del loaded
    out = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name, fn in (
                ("ckpt2ply", lambda: ckpt2ply.main([run, "-o", os.path.join(
                    tmp, "exported.ply")])),
                ("gaussian_transform", lambda: gaussian_transform.main(
                    [run, os.path.join(tmp, "transformed.ply"),
                     "--rotate-euler", "10", "-20", "30", "--translate", "1",
                     "0", "0", "--scale", "1.5"])),
                ("fuse_mip_filter", lambda: fuse_mip_filter.main(
                    [run, "--dataset_path", data, "-o",
                     os.path.join(tmp, "fused.ply")])),
                ("convert2splat", lambda: convert2splat.main(
                    [run, os.path.join(tmp, "scene.splat")]))):
            out[name] = host_ms(fn)[1] / 1e3
    exported = load_gaussian_ply(os.path.join(tmp, "exported.ply"))
    if not np.array_equal(exported["means"], means):
        fail("ckpt2ply: the exported means differ from the loader's")
    for name in ("transformed.ply", "fused.ply"):
        got = load_gaussian_ply(os.path.join(tmp, name))
        if got["means"].shape[0] != n or not all(
                np.isfinite(v).all() for v in got.values()):
            fail(f"{name}: {got['means'].shape[0]} rows, or a non-finite "
                 "value")
    splat = np.fromfile(os.path.join(tmp, "scene.splat"), np.uint8)
    pos = splat.reshape(n, 32)[:, :12].copy().view(np.float32)
    if splat.size != 32 * n or not np.array_equal(
            np.sort(pos, axis=0), np.sort(means, axis=0)):
        fail("convert2splat: the .splat does not hold the run's means")
    log(f"tools on phase 8's run ({n} Gaussians): seconds "
        f"{ {k: round(v, 3) for k, v in out.items()} }; each file read "
        f"back by the port's readers; on {CARD}")
    return out


def phase_serve_and_edit(tmp, arrays):
    """Phase 15: (a) the web viewer on the bench scene's PLY and on phase
    8's gs2d.yaml run; (b) the in-training viewer; (c) the four parsers;
    (d) LPIPS; (e) the tools."""
    log("== phase 15 (a): the web viewer over HTTP at full width")
    ply = os.path.join(tmp, "bench.ply")
    save_gaussian_ply(ply, **arrays)
    t0 = time.perf_counter()
    rec = {"3dgs": serve_and_edit("viewer 3DGS", ply, SERVE_KERNELS, tmp)}
    torch.cuda.empty_cache()
    rec["2dgs"] = serve_and_edit("viewer 2DGS", os.path.join(
        tmp, "runs", "gs2d"), SURFEL_SERVE_KERNELS, tmp)
    torch.cuda.empty_cache()
    rec["training_viewer"] = phase_training_viewer(tmp)
    torch.cuda.empty_cache()
    rec["parsers"] = phase_parser_fits(tmp, arrays)
    torch.cuda.empty_cache()
    rec["lpips"] = phase_lpips(tmp)
    torch.cuda.empty_cache()
    rec["tools"] = phase_tools(tmp)
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return rec


CITY_SPACING = 8.0          # the copies' offsets in x and z: 2 x 2, apart
CITY_OFFSETS = [np.array([CITY_SPACING * i, 0.0, CITY_SPACING * j])
                for j in (0, 1) for i in (0, 1)]
CITY_FRAMES = 40            # the LoD fly-over at 1088x1920
CITY_VIEWS = 12             # COLMAP views per copy in (b)
CITY_STEPS, CITY_FINETUNE_STEPS = 100, 50
EVAL_PARTITIONS = 1            # the partitions eval_scenes re-validates
CITY_HOSTS = 4                 # train_partitions processes run at once


def city_arrays(arrays):
    """The bench scene's four copies, at CITY_OFFSETS."""
    return {k: np.concatenate([
        v + o.astype(np.float32) if k == "means" else v
        for o in CITY_OFFSETS]) for k, v in arrays.items()}


def fly_over():
    """CITY_FRAMES camera-to-world poses: 14 units behind and 7 above a
    target gliding along z over the grid at x = 3, looking down at it."""
    return [orbit_c2w(0.0, 30.0, 14.0, np.array([3.0, 2.0, z]))
            for z in np.linspace(-12.0, 22.0, CITY_FRAMES)]


def phase_lod_serving(arrays, tmp):
    """Phase 16 (a): the four 1M copies as the finest level, an opacity
    prune as the coarse one, a fly-over through PartitionLoDRenderer, and
    the merge of the 4M."""
    log("== phase 16 (a): a 4M-row city served through "
        "PartitionLoDRenderer at 1088x1920")
    parts = os.path.join(tmp, "city_lod")
    t0 = time.perf_counter()
    # each copy's footprint under a 3 x 3 grid of camera centres
    centres = np.stack([o + [u, 0.0, 5.0 + w] for o in CITY_OFFSETS
                        for u in (-3.0, 0.0, 3.0) for w in (-4.0, 0.0, 4.0)])
    scene = build_partitions(centres, n_partitions_hint=4)
    scene.save(os.path.join(parts, "partitions.npz"))
    for pi, part in enumerate(scene.partitions):
        copy = dict(arrays)
        owner = [i for i, o in enumerate(CITY_OFFSETS)
                 if np.all((o[[0, 2]] + [0.0, 5.0] >= part.xy_min)
                           & (o[[0, 2]] + [0.0, 5.0] < part.xy_max))]
        if len(owner) != 1:
            fail(f"partition {pi} ({part.xy_min}, {part.xy_max}) holds "
                 f"copies {owner}, not one")
        copy["means"] = arrays["means"] + CITY_OFFSETS[owner[0]].astype(
            np.float32)
        save_gaussian_ply(os.path.join(
            parts, f"partition_{pi:03d}", "point_cloud", "iteration_1",
            "point_cloud.ply"), **copy)
    written = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()):
        _, prune_s = timed(lambda: prune_partitions.main(
            [parts, "--dst", "lod1", "--mode", "opacity", "--percent",
             "0.6"]))
    prune_s /= 1e3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lod, setup_ms = timed(lambda: PartitionLoDConfig(
        data=parts, names=[".", "lod1"], lod_distances=[1.0],
        visibility_filter=True).instantiate().setup())
    assembly_ms = []
    assemble = lod._assemble

    def timed_assemble(lods, visible):
        out, ms = timed(lambda: assemble(lods, visible))
        assembly_ms.append(ms)
        return out
    lod._assemble = timed_assemble
    bg = torch.zeros(3, device="cuda")
    frame_ms, rows, keys, changed = [], {}, [], []
    reset_launches()
    for c2w in fly_over():
        cam = camera(c2w)
        n_before = len(assembly_ms)
        with torch.no_grad():
            (out, stats), ms = timed(lambda: lod.forward(
                cam, H, W, bg, render_types=frozenset({"rgb", "alpha"})))
        alpha = float(out.alpha.mean())
        if not (bool(torch.isfinite(out.render).all()) and alpha > 0.0):
            fail(f"LoD frame {len(frame_ms)} ({stats}): a non-finite value, "
                 f"or mean alpha {alpha}")
        # levels / visibility of the four partitions, e.g. "0011/1110"
        key = ("".join(str(int(x)) for x in stats["partition_lods"]) + "/"
               + "".join(str(int(x)) for x in stats["visible"]))
        rows[key] = stats["n_gaussians"]
        keys.append(key)
        changed.append(len(assembly_ms) > n_before)
        frame_ms.append(ms)
    expect_launches("the LoD fly-over", {"expand": CITY_FRAMES,
                                         "rasterize_fwd": CITY_FRAMES})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_changes = sum(a != b for a, b in zip(keys, keys[1:]))
    if n_changes < 3 or max(rows.values()) < 4 * N_GAUSSIANS:
        fail(f"the fly-over changed its selection {n_changes} times and "
             f"assembled at most {max(rows.values())} rows")
    steady = [ms for ms, c in zip(frame_ms[1:], changed[1:]) if not c]
    by_key = {k: round(float(np.median([ms for ms, c, kk in zip(
        frame_ms, changed, keys) if kk == k and not c])), 2)
        for k in rows if any(kk == k and not c
                             for c, kk in zip(changed, keys))}
    log(f"LoD: 4 partitions of {N_GAUSSIANS} (SH degree {SH_DEGREE}), lod1 "
        f"the opacity prune at 0.6; PLYs written in {written:.1f} s, "
        f"prune_partitions --mode opacity {prune_s:.2f} s, setup "
        f"{setup_ms / 1e3:.2f} s; on {CARD}")
    log(f"LoD fly-over of {CITY_FRAMES} frames: ms per frame with the "
        f"selection unchanged, median {float(np.median(steady)):.2f} "
        f"(min {min(steady):.2f}, max {max(steady):.2f}, {len(steady)} "
        f"frames); ms per re-assembly "
        f"{[round(x, 2) for x in assembly_ms]}; the selection changed "
        f"{n_changes} times; rows per selection (levels, visible) {rows}; "
        f"median ms per selection with it unchanged {by_key}; K1/K2 "
        f"launches per frame 1/1; peak {peak:.3f} GiB")
    del lod
    torch.cuda.empty_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        merged, merge_ms = timed(lambda: merge_partitions.main([parts]))
    n_merged = load_gaussian_ply(merged)["means"].shape[0]
    if n_merged != 4 * N_GAUSSIANS:
        fail(f"merge_partitions kept {n_merged} of {4 * N_GAUSSIANS} rows")
    log(f"merge_partitions of the 4M: {merge_ms / 1e3:.2f} s, {n_merged} "
        "rows (each copy inside its own cell)")
    shutil.rmtree(parts)
    return {"frame_ms": float(np.median(steady)), "by_selection": by_key,
            "assembly_ms": assembly_ms,
            "peak_gib": peak, "merge_s": merge_ms / 1e3}


STRAYS = {"stray_0.png": np.array([400.0, -300.0, -500.0]),
          "stray_1.png": np.array([-350.0, -250.0, 600.0])}


def city_poses():
    """{name: camera-to-world}: per copy CITY_VIEWS views on a ring around
    its TARGET, 30 degrees down from 8 away, so that the cameras' centres,
    which the partitions are cut from, surround every copy."""
    return {f"c{c}_view_{k:02d}.png": orbit_c2w(
        360.0 * k / CITY_VIEWS, 30.0, 8.0, TARGET + o)
        for c, o in enumerate(CITY_OFFSETS) for k in range(CITY_VIEWS)}


def write_city_scene(root, arrays):
    """The city as a COLMAP scene: CITY_VIEWS views of each copy rendered
    at HxW, and SFM_POINTS of each copy's means as the SfM cloud; and
    beside it `registered/`, the same model with the two STRAYS images
    registered far off the grid, as an SfM run could leave them."""
    city = city_arrays(arrays)
    state = state_from_raw_arrays(city, device="cuda")
    del city
    renderer = TileRendererConfig().instantiate()
    bg = torch.zeros(3, device="cuda")
    os.makedirs(os.path.join(root, "scene", "images"))
    images = {}
    # PNG encodes on 8 threads (zlib lets go of the GIL) while the card
    # renders the next view
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        saves = []
        for name, c2w in sorted(city_poses().items()):
            with torch.no_grad():
                out = renderer.forward(state, camera(c2w), H, W, bg,
                                       SH_DEGREE)
            img = (out.render.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
            saves.append(pool.submit(
                Image.fromarray(img).save, os.path.join(
                    root, "scene", "images", name),
                compress_level=PNG_LEVEL))
            w2c = np.linalg.inv(c2w)
            images[len(images) + 1] = ColmapImage(
                len(images) + 1, rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], 1,
                name)
        for f in saves:
            f.result()
    del state
    pick = np.random.RandomState(3).choice(N_GAUSSIANS, SFM_POINTS,
                                           replace=False)
    rgb = np.clip(0.5 + SH_C0 * arrays["shs_dc"][pick, 0], 0.0, 1.0)
    cam = {1: ColmapCamera(1, "PINHOLE", W, H,
                           np.array([FOCAL, FOCAL, W / 2, H / 2]))}
    write_model_bin(ColmapModel(
        cameras=cam, images=images, points_xyz=np.concatenate(
            [arrays["means"][pick] + o for o in CITY_OFFSETS]).astype(
                np.float64),
        points_rgb=np.tile((rgb * 255 + 0.5).astype(np.uint8), (4, 1)),
        points_err=np.zeros(4 * SFM_POINTS)),
        os.path.join(root, "scene", "sparse", "0"))
    registered = dict(images)
    for name, pos in STRAYS.items():
        i = len(registered) + 1
        registered[i] = ColmapImage(i, np.array([1.0, 0.0, 0.0, 0.0]), -pos,
                                    1, name)
    write_model_bin(ColmapModel(cameras=cam, images=registered,
                                points_xyz=np.zeros((0, 3)),
                                points_rgb=np.zeros((0, 3), np.uint8),
                                points_err=np.zeros(0)),
                    os.path.join(root, "registered", "sparse", "0"))
    shutil.copy(os.path.join(root, "scene", "sparse", "0", "points3D.bin"),
                os.path.join(root, "registered", "sparse", "0"))


def mega_capture(root, poses, image_dir, scale=2.0,
                 origin=np.array([1.0, -2.0, 3.0])):
    """The city's cameras as a Mega-NeRF capture: coordinates.pt, and
    train/metadata/<name>.pt with the c2w that meganerf2colmap turns back
    into each pose; the images linked under train/rgbs."""
    os.makedirs(os.path.join(root, "train", "rgbs"))
    torch.save({"pose_scale_factor": scale,
                "origin_drb": torch.tensor(origin, dtype=torch.float64)},
               os.path.join(root, "coordinates.pt"))
    os.makedirs(os.path.join(root, "train", "metadata"))
    M = meganerf2colmap.C2W_TRANSFORM @ meganerf2colmap.RDF_TO_DRB
    mega = {}
    for name, c2w in poses.items():
        c = meganerf2colmap.RDF_TO_DRB @ c2w @ np.linalg.inv(M)
        c[:3, 3] = (c[:3, 3] - origin) / scale
        stem = name[:-4]
        torch.save({"c2w": torch.tensor(c[:3], dtype=torch.float64),
                    "intrinsics": torch.tensor([FOCAL, FOCAL, W / 2, H / 2],
                                               dtype=torch.float64),
                    "W": W, "H": H},
                   os.path.join(root, "train", "metadata", stem + ".pt"))
        os.symlink(os.path.join(image_dir, name),
                   os.path.join(root, "train", "rgbs", name))
        mega[name] = c[:3]
    return mega


def run_tool(main, argv):
    """main(argv) with its standard output kept; -> (result, said, s)."""
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out, ms = timed(lambda: main(argv))
    return out, tee.kept.getvalue(), ms / 1e3


def train_partitions_as_hosts(argv):
    """train_partitions over CITY_HOSTS processes at once, each with its
    own --host-id (after a --dry-run writes the partitions both read);
    -> (their output in host order, seconds). Fails on a nonzero exit."""
    run_tool(train_partitions.main, argv + ["--dry-run"])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-m", "gsl_tpu_torch.tools.train_partitions",
         *argv, "--hosts", str(CITY_HOSTS), "--host-id", str(h)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=train_partitions.fit_env()) for h in range(CITY_HOSTS)]
    said = [p.communicate(timeout=900)[0] for p in procs]
    seconds = time.perf_counter() - t0
    for h, (p, text) in enumerate(zip(procs, said)):
        log(text.rstrip())
        if p.returncode != 0:
            fail(f"train_partitions --host-id {h} exited {p.returncode}")
    return "\n".join(said), seconds


def lod_val_psnr(parts, names, scene_cfg, out_csv):
    """val_partition_lod's MEAN PSNR over the val split, K1 and K2 launched
    once a frame and nothing else, every frame finite with alpha."""
    forward = PartitionLoDRenderer.forward

    def checked(self, cam, height, width, bg, render_types=frozenset({"rgb"})):
        out, stats = forward(self, cam, height, width, bg,
                             render_types=render_types | {"alpha"})
        alpha = float(out.alpha.mean())
        if not (bool(torch.isfinite(out.render).all()) and alpha > 0.0):
            fail(f"val_partition_lod {names}: a frame ({stats}) with a "
                 f"non-finite value, or mean alpha {alpha}")
        return out, stats
    reset_launches()
    PartitionLoDRenderer.forward = checked
    try:
        rows, _, s = run_tool(val_partition_lod.main, [
            parts, "--names", *names, "--lod-distances", "1",
            "--visibility-filter", "--config", scene_cfg, "--output",
            out_csv])
    finally:
        PartitionLoDRenderer.forward = forward
    expect_launches(f"val_partition_lod {names}",
                    {k: len(rows) for k in SERVE_KERNELS})
    if not all(math.isfinite(r[1]) for r in rows):
        fail(f"val_partition_lod {names}: a non-finite PSNR in {rows}")
    return float(np.mean([r[1] for r in rows])), rows, s


def phase_partition_pipeline(arrays, tmp):
    """Phase 16 (b): the partition pipeline through the tools."""
    log("== phase 16 (b): a COLMAP city through the partition tools at "
        "1088x1920")
    root = os.path.join(tmp, "city")
    t0 = time.perf_counter()
    write_city_scene(root, arrays)
    data = os.path.join(root, "scene")
    log(f"city: {len(CITY_OFFSETS) * CITY_VIEWS} views and "
        f"{len(CITY_OFFSETS) * SFM_POINTS} SfM points written in "
        f"{time.perf_counter() - t0:.1f} s")

    flagged, _, sfm_s = run_tool(sfm_outlier_detection.main,
                                 [os.path.join(root, "registered")])
    if flagged != sorted(STRAYS):
        fail(f"sfm_outlier_detection flagged {flagged}, not {sorted(STRAYS)}")

    points = os.path.join(data, "sparse", "0", "points3D.bin")
    native_got, native_ms = timed(lambda: read_points3d_bin(points))
    plain_got, plain_ms = timed(lambda: read_points3d_bin_plain(points))
    if not all(np.array_equal(a, b) for a, b in zip(native_got, plain_got)):
        fail("the native points3D.bin reader disagrees with the plain one")
    n_points = native_got[0].shape[0]
    log(f"sfm_outlier_detection flagged {flagged} ({sfm_s:.2f} s); "
        f"points3D.bin of {n_points} points: native reader "
        f"{native_ms / 1e3:.3f} s, plain {plain_ms / 1e3:.3f} s, arrays "
        "equal")

    # the SfM cloud's LoD, initialised as each partition's fit initialises
    # it, for the PSNR to beat
    scene_cfg = os.path.join(root, "scene.yaml")
    with open(scene_cfg, "w") as f:
        f.write(f"data:\n  path: {data}\n  parser:\n    class_path: "
                "Colmap\n")
    city_cfg = os.path.join(root, "city.yaml")
    with open(city_cfg, "w") as f:
        f.write("fit:\n  capacity_multiplier: 1.0\n")
    colmap = os.path.join(PRESETS, "colmap.yaml")
    trainer, dp_cfg, fit_cfg = cli.build_components(cli.load_config(
        [colmap, city_cfg], cli.parse_overrides((f"data.path={data}",))))
    outputs = dp_cfg.instantiate().get_outputs()
    init, init_ms = timed(lambda: _init_gaussians(trainer, outputs, fit_cfg,
                                                  "cuda"))
    log(f"the initial cloud of {outputs.point_cloud.xyz.shape[0]} points, "
        f"as each partition's fit builds it (the k-NN scales included), "
        f"in {init_ms / 1e3:.2f} s")
    parts = os.path.join(root, "parts")
    save_gaussian_ply(os.path.join(
        parts, "initial", "partition_000", "point_cloud", "iteration_1",
        "point_cloud.ply"), *(getattr(init.params, k)[init.alive].cpu()
                              .numpy() for k in PARAM_FIELDS))
    del trainer, init

    said, train_s = train_partitions_as_hosts(
        [data, "-o", parts, "--n-partitions", "4", "--max-steps",
         str(CITY_STEPS), "--config", colmap, "--config", city_cfg])
    log(f"train_partitions as {CITY_HOSTS} concurrent hosts on the card: "
        f"{train_s:.1f} s")
    scene = PartitionedScene.load(os.path.join(parts, "partitions.npz"))
    if len(scene.partitions) != 4:
        fail(f"{len(scene.partitions)} partitions, not 4")
    for pi in range(1, 4):          # the initial cloud at every partition
        shutil.copytree(os.path.join(parts, "initial", "partition_000"),
                        os.path.join(parts, "initial", f"partition_{pi:03d}"))
    per = {}
    for pi in range(4):
        run = os.path.join(parts, f"partition_{pi:03d}")
        if not os.path.isfile(os.path.join(run, "TRAINED")):
            fail(f"partition {pi} did not end TRAINED:\n{said}")
        with open(os.path.join(run, "fit_timing.json")) as f:
            t = json.load(f)
        if set(t["launches"]) != set(GAUSSIAN_KERNELS):
            fail(f"partition {pi}'s fit launched {t['launches']}")
        wall = re.search(rf"partition {pi}: TRAINED in ([0-9.]+) s, "
                         r"([0-9.]+) s of it before", said)
        with open(os.path.join(run, "image_list.txt")) as f:
            n_images = len(f.read().split())
        per[pi] = {"images": n_images, "wall_s": float(wall.group(1)),
                   "before_s": float(wall.group(2)),
                   "ms": 1e3 * t["wall_s"] / CITY_STEPS,
                   "psnr": eval_scenes.read_mean_row(os.path.join(
                       run, "metrics", "val.csv"))[0],
                   "launches": t["launches"]}
        log(f"partition {pi}: {n_images} images, {per[pi]['wall_s']:.1f} s "
            f"wall ({per[pi]['before_s']:.1f} s before the first step), "
            f"{per[pi]['ms']:.2f} ms per step over {CITY_STEPS} steps, val "
            f"PSNR {per[pi]['psnr']:.3f} dB, launches {t['launches']}")

    reset_launches()
    _, said, blend_s = run_tool(prune_partitions.main,
                                [parts, "--dst", "lod1"])
    launches = {k: v for k, v in read_launches().items() if v}
    if set(launches) != set(GAUSSIAN_KERNELS):
        fail(f"prune_partitions --mode blend launched {launches}")
    kept = [int(x) for x in re.findall(r"-> (\d+) kept", said)]
    log(f"prune_partitions --mode blend: {1e3 * blend_s:.1f} ms for the "
        f"four partitions, kept {kept}, launches {launches}")

    _, _, ft_s = run_tool(finetune_partition.main, [
        parts, "0", "--src", "lod1", "--steps", str(CITY_FINETUNE_STEPS)])
    with open(os.path.join(parts, "lod1_ft", "partition_000",
                           "fit_timing.json")) as f:
        t = json.load(f)
    if set(t["launches"]) != set(GAUSSIAN_KERNELS):
        fail(f"finetune_partition launched {t['launches']}")
    ft_psnr = eval_scenes.read_mean_row(os.path.join(
        parts, "lod1_ft", "partition_000", "metrics", "val.csv"))[0]
    log(f"finetune_partition 0 from lod1: {ft_s:.1f} s wall, "
        f"{1e3 * t['wall_s'] / CITY_FINETUNE_STEPS:.2f} ms per step over "
        f"{CITY_FINETUNE_STEPS} steps, val PSNR "
        f"{ft_psnr:.3f} dB")

    merged, _, merge_s = run_tool(merge_partitions.main, [parts])
    log(f"merge_partitions: {merge_s:.2f} s, "
        f"{load_gaussian_ply(merged)['means'].shape[0]} rows")

    reset_launches()
    scenes = [f"partition_{pi:03d}" for pi in range(EVAL_PARTITIONS)]
    results, _, eval_s = run_tool(eval_scenes.main,
                                  ["--output", parts, "--scenes", *scenes])
    launches = {k: v for k, v in read_launches().items() if v}
    if set(launches) != set(SERVE_KERNELS):
        fail(f"eval_scenes launched {launches}")
    log(f"eval_scenes over partitions {scenes}: {eval_s:.2f} s, PSNR "
        f"{[round(r[1], 3) for r in results]}")

    mega = os.path.join(root, "mega")
    poses = city_poses()
    want = mega_capture(mega, poses, os.path.join(data, "images"))
    sparse, _, mega_s = run_tool(meganerf2colmap.main, [mega])
    model = read_model(sparse)
    err = 0.0
    for im in model.images.values():
        w2c = np.eye(4)
        w2c[:3, :3] = qvec_to_rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        c = meganerf2colmap.RDF_TO_DRB @ np.linalg.inv(w2c) @ np.linalg.inv(
            meganerf2colmap.C2W_TRANSFORM @ meganerf2colmap.RDF_TO_DRB)
        c[:3, 3] = (c[:3, 3] - [1.0, -2.0, 3.0]) / 2.0
        err = max(err, float(np.abs(c[:3] - want[im.name]).max()),
                  float(np.abs(np.linalg.inv(w2c) - poses[im.name]).max()))
    if len(model.images) != len(poses) or err > 1e-9:
        fail(f"meganerf2colmap: {len(model.images)} images, poses off by "
             f"{err:.3e}")
    log(f"meganerf2colmap: {len(model.images)} images, poses round-trip "
        f"within {err:.3e}, {mega_s:.2f} s")
    psnr0, _, _ = lod_val_psnr(parts, ["initial"], scene_cfg,
                               os.path.join(root, "lod_initial.csv"))
    lod_psnr, rows, val_s = lod_val_psnr(parts, [".", "lod1"], scene_cfg,
                                         os.path.join(root, "lod_val.csv"))
    if not lod_psnr > psnr0:
        fail(f"the LoD's val PSNR {lod_psnr:.3f} dB is not above the "
             f"initial clouds' {psnr0:.3f}")
    log(f"val_partition_lod (levels . and lod1 at 1 x partition size, "
        f"visibility filter): mean PSNR {lod_psnr:.3f} dB over {len(rows)} "
        f"val views against {psnr0:.3f} for the initial clouds; rows "
        f"assembled {[r[3] for r in rows]}, levels {[r[4] for r in rows]}; "
        f"{val_s:.2f} s")
    return {"partitions": per, "blend_s": blend_s, "kept": kept,
            "lod_psnr": lod_psnr, "initial_psnr": psnr0,
            "native_s": native_ms / 1e3, "plain_s": plain_ms / 1e3,
            "points": n_points}


def phase_partitions(arrays, tmp):
    """Phase 16: (a) serving a 4M city by levels of detail; (b) the
    partition pipeline through the tools."""
    t0 = time.perf_counter()
    rec = {"serving": phase_lod_serving(arrays, tmp)}
    torch.cuda.empty_cache()
    rec["pipeline"] = phase_partition_pipeline(arrays, tmp)
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return rec


# ---- phase 17: distributed training ----------------------------------------

DIST_DP, DIST_MP = 2, 2
DIST_STEPS = 10                # timed steps after the first
DIST_FIT_STEPS, DIST_RESUME_STEPS = 50, 75
DIST_PRESET_STEPS = 10
DIST_LOG_INTERVAL = 25
DIST_OVERRIDES = ("model.density.init_args.densify_from_iter=25",
                  "model.density.init_args.densification_interval=25",
                  f"fit.log_interval={DIST_LOG_INTERVAL}")
DIST_LOSS_RTOL = 1e-5
# ROADMAP's gradient tolerance, rtol 5e-3 and atol 1e-4, with the atol
# taken of each field's own scale (max |ref|, where below 1): the fields
# but the means have gradients of ~1e-4 and less
DIST_GRAD_RTOL, DIST_GRAD_ATOL = 5e-3, 1e-4
DIST_RATIO_TOL = 1e-3          # |g| / |mean-loss g| within n_dev +- this


def dist_views():
    """The bench pose and three orbits: one view a rank."""
    return list(views().values()) + [orbit_c2w(35.0, -5.0, 5.0, TARGET)]


def compaction_views():
    """Views that each leave rows of every shard unseen, so that a top-K
    budget below a shard drops no visible splat: the bench pose and three
    orbits from inside the scene, 2.5 from its middle."""
    return [np.eye(4)] + [orbit_c2w(yaw, 0.0, 2.5, TARGET)
                          for yaw in (0.0, 120.0, 240.0)]


def grads_held(got, want):
    """(max |d|, max |want|, ok): `got` within DIST_GRAD_RTOL and
    DIST_GRAD_ATOL of `want`'s own scale; a `want` of zeros is not held."""
    scale = float(want.abs().max())
    atol = DIST_GRAD_ATOL * min(1.0, scale)
    return (float((got - want).abs().max()), scale,
            scale > 0 and bool(torch.allclose(got, want, rtol=DIST_GRAD_RTOL,
                                              atol=atol)))


def moments_against(opt, total):
    """Per field: the first step's moments against `total`, the gradient
    they must hold (mu = (1 - b1) g, nu = (1 - b2) g^2): (max |d| of g,
    max |g|, g held, sqrt(nu / (1 - b2)) held against |g|)."""
    out = {}
    for name in PARAM_FIELDS:
        want = getattr(total, name)
        g = grads_held(opt.exp_avg[name] / (1.0 - 0.9), want)
        a = grads_held(torch.sqrt(opt.exp_avg_sq[name] / (1.0 - 0.999)),
                       want.abs())
        out[name] = g + (a[2],)
    return out


def reference_gradients(trainer, state, cams, targets, bg):
    """The port's single-device Trainer over the cameras: the losses, and
    the parameters' and the tap's gradients summed over the cameras."""
    losses, total, tap = [], None, None
    for cam, target in zip(cams, targets):
        def loss_of(gstate, t, abstap, cam=cam, target=target):
            return trainer.render_losses(gstate, cam, H, W, bg, SH_DEGREE,
                                         target, None, t, abstap, 0)
        g, t, _, loss, _ = trainer.gradients(state, loss_of)
        losses.append(float(loss.detach()))
        total = g if total is None else total.map(
            lambda k, x: x + getattr(g, k))
        tap = t if tap is None else tap + t
    return losses, total, tap


def sharded_rank(dp, mp, n_steps):
    """One rank of phase 17 (a): the sharded step on its view. Returns its
    step times, launches per step, exchange cost and peak memory; then,
    in a world of more than one, a step from the same state at a top-K
    budget below the shard on `compaction_views`. Rank 0 also holds the
    first step and that step against the single-device Trainer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = GS.make_mesh(dp * mp, dp=dp, mp=mp, device="cuda")
    arrays = scene_arrays(N_GAUSSIANS)
    trainer = Trainer(model=VanillaGaussianConfig(sh_degree=SH_DEGREE))
    bg = torch.zeros(3, device="cuda")
    cams = [camera(c2w) for c2w in dist_views()][:dp * mp]
    truth = state_from_raw_arrays(arrays, device="cuda")
    with torch.no_grad():
        targets = [trainer.renderer.forward(truth, cam, H, W, bg,
                                            SH_DEGREE).render
                   for cam in cams]
    del truth
    state = trainer.setup(
        state_from_raw_arrays(perturbed(arrays), device="cuda"),
        cameras_extent=TRAIN_EXTENT)
    k = auto_compact_k(state.gaussians, cams, H, W, mp)
    step = GS.make_mp_train_step(
        mesh, trainer.tx, H, W, SH_DEGREE,
        compact_k=None if k >= state.params.capacity // mp else k)
    j = mesh.dp_index * mp + mesh.mp_index
    params, alive, opt = GS.shard_params(mesh, state.params, state.alive,
                                         state.opt_state)
    torch.cuda.synchronize()
    reset_launches()
    out = step(params, alive, opt, cams[j], targets[j], bg)
    first = {"loss": float(out[2]), "overflow": int(out[5]),
             "launches": read_launches()}
    # the first step's moments are its raw gradients: mu = (1 - b1) g
    _, _, opt1 = GS.gather_params(mesh, out[0], alive, out[1])
    tap1 = GS.gather_rows(mesh, out[3])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mesh.stats.reset()
    ms, overflow = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        out = step(out[0], alive, out[1], cams[j], targets[j], bg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        overflow.append(out[5])
    rec = {"rank": mesh.rank, "backend": mesh.backend, "ms": ms,
           "launches": read_launches(), "exchange": mesh.stats.snapshot(),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "overflow": [int(x) for x in overflow], "first": first,
           "compact_k": k, "cap_local": state.params.capacity // mp}
    if mesh.size == 1:
        return rec
    # a budget below the shard: one step from the same state on views that
    # leave rows of each shard unseen, at the least budget that drops none
    ccams = [camera(c2w) for c2w in compaction_views()][:dp * mp]
    ctargets = bench_targets(arrays, ccams, bg)
    k_tight = max_visible_per_shard(state.gaussians, ccams, H, W, mp)
    cout = GS.make_mp_train_step(mesh, trainer.tx, H, W, SH_DEGREE,
                                 compact_k=k_tight)(
        params, alive, opt, ccams[j], ctargets[j], bg)
    _, _, copt = GS.gather_params(mesh, cout[0], alive, cout[1])
    ctap = GS.gather_rows(mesh, cout[3])
    rec["compaction"] = {"k": k_tight, "loss": float(cout[2]),
                         "overflow": int(cout[5])}
    if mesh.rank != 0:
        return rec
    losses, total, tap = reference_gradients(trainer, state, cams, targets,
                                             bg)
    ratio = float(torch.linalg.norm(opt1.exp_avg["means"] / (1.0 - 0.9))
                  / torch.linalg.norm(total.means / len(cams)))
    rec["reference"] = {"losses": losses, "mean": float(np.mean(losses)),
                        "errs": moments_against(opt1, total), "ratio": ratio,
                        "tap": grads_held(tap1, tap)}
    losses, total, tap = reference_gradients(trainer, state, ccams,
                                             ctargets, bg)
    rec["compaction"].update(
        losses=losses, mean=float(np.mean(losses)),
        errs=moments_against(copt, total), tap=grads_held(ctap, tap))
    return rec


def hold_sharded(what, loss, ref, n_dev):
    """Fail unless the sharded step's `loss`, moments and tap sums hold
    the single-device reference `ref` (loss the mean, gradients the sums
    over the views, each field held to its own scale)."""
    if abs(loss - ref["mean"]) > DIST_LOSS_RTOL * abs(ref["mean"]):
        fail(f"{what}: sharded loss {loss} != the single-device mean "
             f"{ref['mean']} ({ref['losses']})")
    bad = [k for k, e in ref["errs"].items() if not (e[2] and e[3])]
    if bad or not ref["tap"][2]:
        fail(f"{what}: sharded gradients off the single-device sums: {bad},"
             f" tap {ref['tap']}; {ref['errs']}")
    log(f"{what}: loss {loss:.7f} vs the single-device mean "
        f"{ref['mean']:.7f} over {ref['losses']}; first moments / (1 - b1) "
        f"against the Trainer's gradients summed over the {n_dev} views, "
        f"max |d| (max |ref|): "
        + ", ".join(f"{k} {e[0]:.3e} ({e[1]:.3e})"
                    for k, e in ref["errs"].items())
        + f"; tap sums {ref['tap'][0]:.3e} ({ref['tap'][1]:.3e}); each "
        f"field within rtol {DIST_GRAD_RTOL} and {DIST_GRAD_ATOL} of its "
        "max |ref|, and sqrt(nu / (1 - b2)) so against |g|")


def phase_distributed_step():
    """Phase 17 (a)."""
    log(f"== phase 17 (a): the sharded step, {DIST_DP * DIST_MP} ranks "
        f"(dp {DIST_DP} x mp {DIST_MP}) on {torch.cuda.device_count()} "
        f"card(s), {N_GAUSSIANS} Gaussians, {H}x{W}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = spawn(sharded_rank, DIST_DP * DIST_MP, "cuda",
                 args=(DIST_DP, DIST_MP, DIST_STEPS))
    spawn_s = time.perf_counter() - t0
    ref = recs[0]["reference"]
    first = recs[0]["first"]
    n_dev = DIST_DP * DIST_MP
    hold_sharded("distributed gradients", first["loss"], ref, n_dev)
    if abs(ref["ratio"] - n_dev) > DIST_RATIO_TOL:
        fail(f"|g| / |mean-loss g| {ref['ratio']:.6f}, not {n_dev}")
    log(f"distributed gradients: |g| / |mean-loss g| {ref['ratio']:.6f} "
        f"(n_dev = {n_dev})")
    comp = recs[0]["compaction"]
    cap_local = recs[0]["cap_local"]
    if not comp["k"] < cap_local:
        fail(f"the compaction views see {comp['k']} rows of a shard of "
             f"{cap_local}: the top-K would drop nothing")
    if any(r["compaction"]["overflow"] for r in recs):
        fail(f"compaction at k {comp['k']} dropped splats: "
             f"{[r['compaction']['overflow'] for r in recs]}")
    hold_sharded(f"distributed compaction (compact_k {comp['k']} of "
                 f"{cap_local} rows a shard, overflow 0)", comp["loss"], comp,
                 n_dev)
    for r in recs:
        for name in GAUSSIAN_KERNELS:
            if r["launches"][name] != DIST_STEPS \
                    or r["first"]["launches"][name] != 1:
                fail(f"rank {r['rank']} launched {name} "
                     f"{r['launches'][name]} times in {DIST_STEPS} steps")
        others = {k: v for k, v in r["launches"].items()
                  if v and k not in GAUSSIAN_KERNELS}
        if others:
            fail(f"rank {r['rank']} launched {others}")
        if any(r["overflow"]) or r["first"]["overflow"]:
            fail(f"the exchange dropped splats: {r['overflow']}")
    k = recs[0]["compact_k"]
    k_eff = min(k, recs[0]["cap_local"])
    xbytes = GS.exchange_bytes_per_step(n_dev, DIST_MP, k_eff)
    ex = recs[0]["exchange"]
    log(f"distributed step: {n_dev} ranks on {torch.cuda.device_count()} x "
        f"{CARD}, backend "
        f"{recs[0]['backend']}, compact_k {k} of {recs[0]['cap_local']} "
        f"rows a shard, overflow 0; spawn to results {spawn_s:.1f} s")
    log(f"distributed step: ms per step (host clock, synchronised, steps "
        f"2-{DIST_STEPS + 1}), median per rank "
        f"{[round(float(np.median(r['ms'])), 2) for r in recs]}; rank 0 "
        f"{[round(x, 2) for x in recs[0]['ms']]}")
    log(f"distributed step: exchange per step on rank 0: forward "
        f"{1e3 * ex['fwd_s'] / DIST_STEPS:.2f} ms, backward "
        f"{1e3 * ex['bwd_s'] / DIST_STEPS:.2f} ms (staging included); "
        f"host staging of every collective {1e3 * ex['staging_s'] / DIST_STEPS:.2f}"
        f" ms and {ex['staged_bytes'] / DIST_STEPS / 1e6:.1f} MB a step in "
        f"{ex['staged_copies'] // DIST_STEPS} copies; "
        f"exchange_bytes_per_step {xbytes} ({xbytes / 1e6:.1f} MB)")
    log(f"distributed step: peak memory per rank "
        f"{[round(r['peak_gib'], 3) for r in recs]} GiB; launches per rank "
        f"in {DIST_STEPS} steps {[r['launches'] for r in recs][:1]} (each "
        f"rank the same)")
    torch.cuda.synchronize()
    one = sharded_rank(1, 1, DIST_STEPS)
    for name in GAUSSIAN_KERNELS:
        if one["launches"][name] != DIST_STEPS:
            fail(f"world 1 launched {name} {one['launches'][name]} times")
    log(f"distributed step at world 1 (dp 1 x mp 1, no process group, "
        f"bench pose): ms per step median "
        f"{float(np.median(one['ms'])):.2f} ({[round(x, 2) for x in one['ms']]})"
        f", peak {one['peak_gib']:.3f} GiB; beside {n_dev} ranks: "
        f"{float(np.median(recs[0]['ms'])):.2f}")
    return {"ranks": recs, "one": one, "exchange_bytes": xbytes,
            "launches": [r["launches"] for r in recs]}


def phase_distributed_fit(tmp, colmap_fit):
    """Phase 17 (b), on phase 8's scene in `tmp`."""
    log("== phase 17 (b): colmap.yaml + distributed.yaml through `cli fit`"
        f", dp {DIST_DP} x mp {DIST_MP} spawned by the CLI, at {H}x{W}")
    colmap = os.path.join(PRESETS, "colmap.yaml")
    dist_preset = os.path.join(PRESETS, "distributed.yaml")
    data, runs = os.path.join(tmp, "scene"), os.path.join(tmp, "runs")
    run = os.path.join(runs, "dist")

    def fit(steps, name="dist", extra=DIST_OVERRIDES + (
            f"distributed={{dp: {DIST_DP}, mp: {DIST_MP}}}",)):
        torch.cuda.empty_cache()
        t0 = time.time()
        _, results = cli.main(
            ["fit", "--config", colmap, "--config", dist_preset,
             "--data.path", data, "--output", runs, "-n", name,
             "--max_steps", str(steps), *extra])
        with open(os.path.join(runs, name, "fit_timing.json")) as f:
            timing = json.load(f)
        n = timing["end_step"] - timing["start_step"] + 1
        for r, rank in enumerate(timing["ranks"]):
            if {k: v for k, v in rank["launches"].items()} != {
                    k: n for k in GAUSSIAN_KERNELS}:
                fail(f"{name}: rank {r} launched {rank['launches']} in "
                     f"{n} steps")
        with open(os.path.join(runs, name, "mp_log.csv")) as f:
            rows = list(csv.reader(f))[1:]
        if not all(math.isfinite(float(r[1])) for r in rows):
            fail(f"{name}: a non-finite loss in {rows}")
        return results, timing, rows, timing["loop_start_time"] - t0

    res1, t1, rows1, before1 = fit(DIST_FIT_STEPS)
    res2, t2, rows2, before2 = fit(DIST_RESUME_STEPS)
    if t2["start_step"] != DIST_FIT_STEPS + 1:
        fail(f"the resumed fit started at {t2['start_step']}")
    if rows2[:len(rows1)] != rows1 or [int(r[0]) for r in rows2] != list(
            range(DIST_LOG_INTERVAL, DIST_RESUME_STEPS + 1,
                  DIST_LOG_INTERVAL)):
        fail(f"mp_log.csv holds {rows2}, not {rows1} and then the resumed "
             "run's rows")
    for rel in [f"checkpoints/step_{s}/{f}"
                for s in (DIST_FIT_STEPS, DIST_RESUME_STEPS)
                for f in ("state.pt", "fit_meta.json")] + [
            f"point_cloud/iteration_{DIST_RESUME_STEPS}/point_cloud.ply",
            "metrics/val.csv", "config.yaml"]:
        if not os.path.isfile(os.path.join(run, rel)):
            fail(f"the distributed fit wrote no {rel}")
    if not any(d["after"] != d["before"] for d in t1["densify"] +
               t2["densify"]):
        fail(f"no densify changed the count: {t1['densify']}")
    val = run_cli(["validate", "--output", runs, "-n", "dist"],
                  ("expand", "rasterize_fwd"))
    psnr0 = colmap_fit["psnr0"]
    if not val["results"]["psnr"] > psnr0:
        fail(f"val PSNR {val['results']['psnr']:.3f} of the distributed fit "
             f"is not above the initial cloud's {psnr0:.3f}")
    for tag, t, rows, before in (
            (f"steps 1-{DIST_FIT_STEPS}", t1, rows1, before1),
            (f"resumed to {DIST_RESUME_STEPS}", t2, rows2, before2)):
        ms = {int(r[0]): round(1e3 / float(r[8]), 2) for r in rows}
        log(f"fit distributed.yaml {tag}: {before:.1f} s before the first "
            f"step (4 rank start-ups, parse, init); loop "
            f"{t['wall_s']:.1f} s, {1e3 * t['wall_s'] / (t['end_step'] - t['start_step'] + 1):.1f}"
            f" ms per step; ms per step in each log window {ms}; backend "
            f"{t['backend']}; loader wait on rank 0 {t['loader_wait_s']:.2f} s;"
            f" peak per rank "
            f"{[round(r['peak_bytes'] / 2 ** 30, 3) for r in t['ranks']]} GiB"
            f"; exchange fwd/bwd s per rank "
            f"{[(round(r['exchange']['fwd_s'], 2), round(r['exchange']['bwd_s'], 2)) for r in t['ranks']]}")
        for d in t["densify"]:
            log(f"fit distributed.yaml: densify at step {d['step']}: "
                f"{d['before']} -> {d['after']} alive, capacity "
                f"{d['capacity']}, shards {d['shards']}, rebalanced to "
                f"{d['rebalanced']}, "
                f"{t['densify_ms'][t['densify'].index(d)]:.1f} ms")
    log(f"fit distributed.yaml mp_log.csv rows {rows2}")
    log(f"fit distributed.yaml: val PSNR at step {DIST_FIT_STEPS} "
        f"{res1['psnr']:.3f} dB, at {DIST_RESUME_STEPS} {res2['psnr']:.3f}, "
        f"`cli validate` of the run {val['results']['psnr']:.3f}, the "
        f"initial cloud's {psnr0:.3f}")

    res3, t3, rows3, before3 = fit(DIST_PRESET_STEPS, "dist_preset",
                                   ("fit.log_interval=5",))
    if t3["mesh"] != {"dp": 1, "mp": 1} or t3["backend"] is not None:
        fail(f"distributed.yaml as shipped ran on {t3['mesh']}, "
             f"{t3['backend']}")
    log(f"fit distributed.yaml as shipped (distributed: true, a world of 1"
        f" on this card): {DIST_PRESET_STEPS} steps, {before3:.1f} s before "
        f"the first, {1e3 * t3['wall_s'] / DIST_PRESET_STEPS:.1f} ms per "
        f"step ({t3['loader_wait_s']:.2f} s of {t3['wall_s']:.2f} waiting "
        f"on the loader), rows {rows3}, val PSNR "
        f"{res3['psnr']:.3f} dB")
    return {"fit": (t1, t2), "psnr": val["results"]["psnr"]}


def phase_distributed(tmp, colmap_fit):
    """Phase 17: (a) the sharded step; (b) the distributed fit through the
    CLI."""
    t0 = time.perf_counter()
    rec = {"step": phase_distributed_step()}
    torch.cuda.empty_cache()
    rec["fit"] = phase_distributed_fit(tmp, colmap_fit)
    log(f"phase 17 took {time.perf_counter() - t0:.1f} s")
    return rec


# phase 18 (b): the quality protocol, cut in views and steps only
# (1,202 steps: densify_until 601, so one densify, at 600; a densify runs
# at from < step < until)
QUALITY_ARGV = ["--views", "16", "--res", "512", "--steps", "1202",
                "--fast-steps", "50", "--variant-steps", "200",
                "--gs2d-steps", "100", "--gs2d-res", "256"]
# profile_stages' rows beside phase 4's stage_times and phase 3's kernels
PROFILE_BESIDE = {"project": ("stage", "project"),
                  "sh_colors": ("stage", "sh"),
                  "isect_encode": ("stage", "expand"),
                  "expand": ("kernel", "expand_ms"),
                  "sort": ("stage", "sort"),
                  "tile ranges": ("stage", "ranges"),
                  "raster_fwd": ("stage", "forward"),
                  "raster_bwd": ("kernel", "bwd_ms"),
                  "reduce": ("kernel", "reduce_ms")}


def phase_profile_stages(stage_ms, kernel_rec):
    """Phase 18 (a): profile_stages at the bench scene, each stage beside
    phase 4's stage_times (isect_encode beside its expand, which holds
    isect_encode and K1) or phase 3's kernel time (`kernel_rec`, None
    when phase 3 did not run)."""
    log("== phase 18 (a): gsl_tpu_torch.tools.profile_stages at the bench "
        f"scene ({N_GAUSSIANS}, {H}x{W})")
    t0 = time.perf_counter()
    reset_launches()
    prof = profile_stages.main([])
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    if set(launches) != set(GAUSSIAN_KERNELS):
        fail(f"profile_stages launched {launches}, not K1-K4 alone")
    for name, ms in prof["ms"].items():
        if not (math.isfinite(ms) and ms > 0):
            fail(f"profile_stages: stage {name} took {ms} ms")
    if not all(bool(torch.isfinite(g).all()) for g in prof["e2e_grads"]):
        fail("profile_stages: non-finite e2e gradients")
    for name, (where, key) in PROFILE_BESIDE.items():
        if where == "stage":
            other = f"phase 4 stage_times {key} {stage_ms[key]:.4f} ms"
        elif kernel_rec is None:
            other = "phase 3 not run"
        else:
            other = f"phase 3 {key[:-3]} (CUDA graph) {kernel_rec[key]:.4f} ms"
        log(f"profile {name:<14} {prof['ms'][name]:9.4f} ms; {other}")
    log(f"profile e2e raster fwd+bwd {prof['ms'][profile_stages.E2E]:.4f} "
        f"ms, {prof['pixels_per_s'] / 1e6:.2f}M pixels/s; n_isects "
        f"{prof['n_isects']}, slots {prof['slots']}; launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def quality_initial_psnr(trainer, outputs, out_dir):
    """Val PSNR of a run's initial cloud, built as its fit builds it."""
    cfg = quality_benchmark.protocol_fit_config(1, out_dir)
    with contextlib.redirect_stdout(io.StringIO()):
        gaussians = _init_gaussians(trainer, outputs, cfg, "cuda")
        return validate(trainer, trainer.setup(
            gaussians, outputs.camera_extent), outputs, cfg)["psnr"]


def phase_quality(tmp):
    """Phase 18 (b): the quality protocol in process, cut in views and
    steps: every run's PSNR must be above its initial cloud's, its count
    positive, and all nine kernels launched."""
    log("== phase 18 (b): gsl_tpu_torch.tools.quality_benchmark "
        + " ".join(QUALITY_ARGV))
    t0 = time.perf_counter()
    work = os.path.join(tmp, "quality")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = quality_benchmark.main(QUALITY_ARGV + ["--workdir", work])
    torch.cuda.synchronize()
    launches = read_launches()
    t_run = time.perf_counter() - t0
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        fail(f"quality protocol: kernels {missing} were never launched")
    args = quality_benchmark.parse_args(QUALITY_ARGV + ["--device", "cuda",
                                                        "--workdir", work])
    outputs = {r: quality_benchmark.build_outputs(args, r)
               for r in (args.res, args.gs2d_res)}
    presets = {tag: cli.build_components(cli.load_config(
        [os.path.join(PRESETS, f"{tag}.yaml")], {}))[0]
        for tag in ("stp", "gs2d")}
    runs = {"full": (result["full"], args.steps,
                     quality_benchmark.protocol_trainer(args.steps),
                     outputs[args.res]),
            "short": (result["exact_short"], args.fast_steps,
                      quality_benchmark.protocol_trainer(args.fast_steps),
                      outputs[args.res]),
            "stp": (result["variants"]["stp"], args.variant_steps,
                    presets["stp"], outputs[args.res]),
            "gs2d": (result["variants"]["gs2d"], args.gs2d_steps,
                     presets["gs2d"], outputs[args.gs2d_res])}
    for tag, (rec, steps, trainer, outs) in runs.items():
        psnr0 = quality_initial_psnr(trainer, outs,
                                     os.path.join(work, f"initial_{tag}"))
        log(f"quality {tag}: {steps} steps, val PSNR {rec['psnr']:.3f} dB "
            f"(initial cloud {psnr0:.3f}), SSIM {rec['ssim']:.4f}, "
            f"{rec['n_gaussians']} Gaussians, {60 * rec['minutes']:.1f} s")
        if not (math.isfinite(rec["psnr"]) and rec["psnr"] > psnr0):
            fail(f"quality {tag}: val PSNR {rec['psnr']} is not above the "
                 f"initial cloud's {psnr0}")
        if not rec["n_gaussians"] > 0:
            fail(f"quality {tag}: no Gaussian left")
    with open(os.path.join(work, "QUALITY.md")) as f:
        report = f.read()
    if (f"| full | {args.steps} |" not in report
            or "| 2DGS (gs2d.yaml" not in report):
        fail(f"quality protocol: the report lacks a row:\n{report}")
    log(f"quality protocol: launches {launches}; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
        f"{t_run:.1f} s, {time.perf_counter() - t0:.1f} s with the initial "
        "clouds' PSNR")
    return launches


def phase_quality_tools(tmp, stage_ms, kernel_rec):
    """Phase 18: (a) the stage profile; (b) the quality protocol."""
    t0 = time.perf_counter()
    rec = {"profile": phase_profile_stages(stage_ms, kernel_rec)}
    torch.cuda.empty_cache()
    rec["quality"] = phase_quality(tmp)
    log(f"phase 18 took {time.perf_counter() - t0:.1f} s")
    return rec


def tensors_of(x):
    """The tensors and numbers of nested dicts, in key order."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in tensors_of(x[k])]
    return [x] if isinstance(x, torch.Tensor) else [torch.tensor(x)]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    # float32 everywhere: no TF32 in matmuls (projection's p_cam) or
    # convolutions, so the card computes what the CPU tests check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    log("== phase 1: device and build")
    global CARD
    CARD = quality_benchmark.card_name("cuda")
    log(CARD)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {kind} "
        f"x{count}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        usual = pool.submit(cuda_build.build)
        loose = pool.submit(cuda_build.build, UNCONTRACTED,
                            cuda_build.NO_CONTRACTION)
        logs = usual.result()
        loose.result()
    log(f"built {sorted(logs)}, and {sorted(UNCONTRACTED)} a second time "
        f"without contraction, in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or ("spill" in line
                                  and "0 bytes spill stores" not in line):
                log(f"  {name}: {line.strip()}")

    log("== phase 2: scene")
    t0 = time.perf_counter()
    arrays = scene_arrays(N_GAUSSIANS)
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "point_cloud.ply")
        save_gaussian_ply(ply, **arrays)
        log(f"{N_GAUSSIANS} Gaussians, SH degree {SH_DEGREE}, PLY "
            f"{os.path.getsize(ply) / 2 ** 20:.1f} MiB in "
            f"{time.perf_counter() - t0:.1f} s")
        state = state_from_raw_arrays(arrays, device="cuda")
        renderer = TileRendererConfig().instantiate()
        with torch.no_grad():
            rec = phase_kernels(state, renderer)
            phase_small_reference()
            trec = phase_stp_kernels(state, renderer)
            phase_small_reference(stp=True)
            del state
            torch.cuda.empty_cache()
            srec = phase_surfel_kernels(state_from_raw_arrays(
                surfel_arrays(arrays), device="cuda"))
            phase_small_surfel_reference()
            torch.cuda.empty_cache()
            launches, serving = phase_main_path(ply)
        phase_stp_saturated()
        torch.cuda.empty_cache()
        train_launches, training = phase_training(
            arrays, {"rasterize_bwd": rec["bwd_ms"],
                     "invert_order": rec["invert_ms"],
                     "reduce_grads": rec["reduce_ms"]})
        torch.cuda.empty_cache()
        surfel_serving, surfel_launches = phase_surfel_main_path(arrays)
        torch.cuda.empty_cache()
        with torch.no_grad():
            stp_serving_launches, stp_serving = phase_main_path(ply,
                                                                stp=True)
        torch.cuda.empty_cache()
        stp_launches, stp_training = phase_training(
            arrays, {"rasterize_bwd_stp": trec["bwd_ms"],
                     "invert_order": rec["invert_ms"],
                     "reduce_grads": trec["reduce_ms"]}, stp=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        colmap_fit = phase_fit(arrays, tmp)
        torch.cuda.empty_cache()
        phase_mip(arrays)
        torch.cuda.empty_cache()
        phase_mcmc(arrays)
        torch.cuda.empty_cache()
        phase_variant_fits(tmp)
        torch.cuda.empty_cache()
        with torch.no_grad():
            phase_geometry_kernels(
                state_from_raw_arrays(arrays, device="cuda"),
                TileRendererConfig().instantiate())
        torch.cuda.empty_cache()
        phase_geometry_training(
            arrays, float(np.median(training["step_ms"][5:TRAIN_STEPS])))
        torch.cuda.empty_cache()
        phase_depth_fits(arrays, tmp)
        torch.cuda.empty_cache()
        phase_mesh(tmp)
        torch.cuda.empty_cache()
        phase_appearance_training(
            arrays, float(np.median(training["step_ms"][5:TRAIN_STEPS])))
        torch.cuda.empty_cache()
        phase_appearance_fits(tmp, colmap_fit)
        torch.cuda.empty_cache()
        phase_density_variants(
            arrays, float(np.median(training["step_ms"][5:TRAIN_STEPS])))
        torch.cuda.empty_cache()
        phase_density_fits(tmp, colmap_fit)
        torch.cuda.empty_cache()
        phase_dynamic_training(
            arrays, float(np.median(training["step_ms"][5:TRAIN_STEPS])))
        torch.cuda.empty_cache()
        phase_dynamic_fits(tmp)
        torch.cuda.empty_cache()
        plain_step_ms = float(np.median(training["step_ms"][5:TRAIN_STEPS]))
        with torch.no_grad():
            wide = phase_wide_kernels(arrays, trec, srec)
        torch.cuda.empty_cache()
        phase_spotless_training(arrays, plain_step_ms)
        torch.cuda.empty_cache()
        phase_spotless_fit(tmp)
        torch.cuda.empty_cache()
        phase_distill(arrays)
        torch.cuda.empty_cache()
        phase_distill_entry_points(tmp)
        torch.cuda.empty_cache()
        phase_serve_and_edit(tmp, arrays)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as city_tmp:
            phase_partitions(arrays, city_tmp)
        torch.cuda.empty_cache()
        dist = phase_distributed(tmp, colmap_fit)
        torch.cuda.empty_cache()
        quality = phase_quality_tools(tmp, serving["stage_ms"], rec)
    # StopThePop beside plain 3DGS, phases 7 and 4/5 of this run
    log("StopThePop over plain 3DGS, this run: bench-pose rgb frame ms "
        f"{[round(x, 2) for x in stp_serving['rgb_frame_ms']]} vs "
        f"{[round(x, 2) for x in serving['rgb_frame_ms']]}; stage ms "
        f"{json.dumps(stp_serving['stage_ms'])} vs "
        f"{json.dumps(serving['stage_ms'])}; viewer frames "
        f"{stp_serving['viewer_ms']} vs {serving['viewer_ms']}; serving peak "
        f"{stp_serving['peak_gib']:.3f} vs {serving['peak_gib']:.3f} GiB")
    log("StopThePop over plain 3DGS, this run: ms per step at capacity 1M, "
        f"steps 6-{STP_TRAIN_STEPS}, median "
        f"{float(np.median(stp_training['step_ms'][5:STP_TRAIN_STEPS])):.2f}"
        f" vs {float(np.median(training['step_ms'][5:TRAIN_STEPS])):.2f} "
        f"(steps 6-{TRAIN_STEPS}); stage ms "
        f"{json.dumps(stp_training['stage_ms'])} vs "
        f"{json.dumps(training['stage_ms'])}; densify ms "
        f"{stp_training['density_ms']} vs {training['density_ms']}; "
        f"training peak {stp_training['peak_gib']:.3f} vs "
        f"{training['peak_gib']:.3f} GiB")

    def entry(name, line, err, key, library_ms=None):
        # launches: on the training main path, which runs all four;
        # serving_launches: on the serving main path, where it runs
        bound_ms, bound_by = rec[f"{key}_bound"]
        return {"name": name, "route": "cuda",
                "source": f"gsl_tpu_torch/csrc/{name}.cu",
                "replaces": f"gsl_tpu/ops/rasterize_pallas.py:{line}",
                "launches": train_launches[name],
                "serving_launches": launches.get(name, 0),
                "max_abs_err": err, "ms": rec[f"{key}_ms"],
                "plain_ms": rec[f"{key}_plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    def surfel_entry(name, line, err, key):
        bound_ms, bound_by = srec[f"{key}_bound"]
        return {"name": name, "route": "cuda",
                "source": f"gsl_tpu_torch/csrc/{name}.cu",
                "replaces": f"gsl_tpu/ops/surfel_pallas.py:{line}",
                "launches": surfel_launches[name],
                "serving_launches": surfel_serving.get(name, 0),
                "max_abs_err": err, "ms": srec[f"{key}_ms"],
                "plain_ms": srec[f"{key}_plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    reduce_entry = entry("reduce_grads", 1379, rec["reduce_err"], "reduce",
                         rec["reduce_library_ms"])
    reduce_entry.update(
        surfel_launches=surfel_launches["reduce_grads"],
        surfel_max_abs_err=srec["reduce_err"], surfel_ms=srec["reduce_ms"],
        surfel_plain_ms=srec["reduce_plain_ms"],
        surfel_bound_ms=srec["reduce_bound"][0],
        surfel_bound_by=srec["reduce_bound"][1],
        surfel_library_ms=srec["reduce_library_ms"])
    def stp_entry(name, line, err, key):
        bound_ms, bound_by = trec[f"{key}_bound"]
        return {"name": name, "route": "cuda",
                "source": f"gsl_tpu_torch/csrc/{name}.cu",
                "replaces": f"gsl_tpu/ops/rasterize_pallas.py:{line}",
                "branch": "stp_resort",
                "launches": stp_launches[name],
                "serving_launches": stp_serving_launches.get(name, 0),
                "max_abs_err": err, "ms": trec[f"{key}_ms"],
                "plain_ms": trec[f"{key}_plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    expand_entry = entry("expand", 227, 0.0, "expand")
    expand_entry.update(
        stp_launches=stp_launches["expand"],
        stp_serving_launches=stp_serving_launches["expand"],
        stp_max_abs_err=0.0, stp_ms=trec["expand_ms"],
        stp_plain_ms=trec["expand_plain_ms"],
        stp_bound_ms=trec["expand_bound"][0],
        stp_bound_by=trec["expand_bound"][1], stp_library_ms=None)
    reduce_entry.update(stp_launches=stp_launches["reduce_grads"],
                        stp_ms=trec["reduce_ms"],
                        attributes=rec["reduce_attributes"],
                        surfel_attributes=srec["reduce_attributes"])
    expand_entry.update(attributes=rec["expand_attributes"])
    surfel_expand_entry = surfel_entry("surfel_expand", 61, 0.0, "expand")
    surfel_expand_entry.update(attributes=srec["expand_attributes"])
    kernels = [
        expand_entry,
        entry("rasterize_fwd", 869, rec["fwd_err"], "fwd"),
        entry("rasterize_bwd", 1069, rec["bwd_err"], "bwd"),
        reduce_entry,
        surfel_expand_entry,
        surfel_entry("surfel_fwd", 253, srec["fwd_err"], "fwd"),
        surfel_entry("surfel_bwd", 428, srec["bwd_err"], "bwd"),
        stp_entry("rasterize_fwd_stp", 869, trec["fwd_err"], "fwd"),
        stp_entry("rasterize_bwd_stp", 1069, trec["bwd_err"], "bwd"),
    ]
    for e, r in ((kernels[2], rec), (kernels[6], srec), (kernels[8], trec)):
        e.update(composited_slot_warps=r["composited_slot_warps"],
                 attributes=r["bwd_attributes"])
    for e, r in ((kernels[1], rec), (kernels[5], srec), (kernels[7], trec)):
        e.update(attributes=r["fwd_attributes"])
    # phase 17 (a): each rank's launches in its timed sharded steps
    for e in kernels[:4]:
        e["distributed_launches"] = [r[e["name"]]
                                     for r in dist["step"]["launches"]]
    # phase 18: launches in the stage profile and the quality protocol
    for e in kernels:
        e["quality_launches"] = quality["quality"][e["name"]]
        e["profile_launches"] = quality["profile"].get(e["name"], 0)
    for e, r in ((kernels[1], rec), (kernels[7], trec)):
        e.update(near_pairs=r["near_pairs"])
    # phase 14 (a): K2, K3 and K4 at the distillation widths
    for e, key in ((kernels[1], "K2"), (kernels[2], "K3"),
                   (kernels[3], "K4")):
        e["wide"] = {C: {"ms": wide[C][f"{key}_ms"],
                         "bound_ms": wide[C][f"{key}_bound"][0],
                         "bound_by": wide[C][f"{key}_bound"][1]}
                     for C in WIDE_WIDTHS}
    for C in WIDE_WIDTHS:
        kernels[2]["wide"][C]["ms_by_group"] = wide[C]["K3_ms_by_group"]
    kernels[8]["wide"] = {STP_WIDE: wide["stp"]}
    kernels[6]["wide"] = {SURFEL_WIDE: wide["surfel"]}
    log(f"surfel backward at the bench pose: K6's median depth differs by "
        f"up to {srec['median_err']:.3e} (a flipped crossing); K7 errors "
        f"are of rows up to {srec['bwd_scale']:.3e}, K4's of sums up to "
        f"{srec['reduce_scale']:.3e}; torch.sort of {srec['slots']} int64 "
        f"keys: {srec['sort_ms']:.4f} ms")
    log(f"backward at the bench pose: invert_order {rec['invert_ms']:.4f} "
        f"ms; K3 errors are of rows up to {rec['bwd_scale']:.3e}, K4's of "
        f"sums up to {rec['reduce_scale']:.3e}")
    log(f"torch.sort of {rec['slots']} int64 keys: {rec['sort_ms']:.4f} ms;"
        f" tile ranges (searchsorted): {rec['ranges_ms']:.4f} ms")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (raytracing_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no exception is caught):
  1. the card: torch's device name and nvidia-smi's name and power limit;
  2. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the time
     (every library's nvcc at once, before any timed phase);
  3. kernel vs its plain PyTorch version, cornell b5 at 256x192 and at the
     main path's 1024x1024, same u-planes: at most 1% of rays beyond
     rtol/atol 2e-4 (contracted FMAs move rays at silhouettes and grazing
     hits) and the mean accumulator within 1e-5 relative;
  4. the kernel's in-kernel threefry vs its own u-planes route for the same
     passes: bit-equal accumulators (1 pass, and 3 passes in one launch);
  5. the main path: render_passes(cornell 1024^2, b5, 16 passes per call),
     1 warm-up + 5 timed calls. The launch counter must grow by one per
     call, acc must be finite and the mean radiance per pass within 2% of
     the plain version's first pass (same draws). Prints ray segments/s
     and the times per pass, writes build/chip_smoke_cornell_1024.png,
     and kernel 1's share of its bound (bound ms / kernel ms; the bound
     from the OPS_* counts on kernel 1's record of a pass, see below);
  6. kernel 2 (the adjoint) vs its plain version (autograd through the
     plain forward), same tables, draws and seeded random cotangent: at
     256x192 cornell b5 and sphere_field(64) (the most spheres "auto" sends
     to kernel 2) with all five groups, at 1024x1024 cornell with ("sph",
     "mat") (timed) and with all five groups. Per group: cosine >= 0.999,
     norm ratio within 1%, and at 256x192 max |kernel - plain| <= 5e-3 x
     the group's largest entry; the PRNG route and the u-planes route agree
     to the same gates;
  7. the training main path: cornell 1024^2 b5, mega_grad_wrt ("sph",
     "mat"), sphere centers, radii and materials requiring grad; per step
     render_pass -> image -> mean square -> backward -> SGD, the
     progressive state threaded from step to step; 1 warm-up and 10 timed
     steps. Exactly one kernel-1 and one kernel-2 launch per step, a finite
     loss, finite nonzero gradients. Prints forward + backward segments/s
     and kernel 2 alone in ms on the step's own cotangent, with its
     share of its bound;
  8. kernels 4 and 5 (the stage pipeline's hit searches) vs their plain
     versions on 2^20 seeded rays with dead rays and short windows: kernel
     4 over sphere_field(1024)'s spheres, over the tie and masked table
     (sphere_field(1024) with 64 spheres copied to the last 64 rows, exact
     ties the lower index must win, and every 9th sphere masked off), over
     sphere_field(4096) on 2^18 rays (all three the tree instance) and
     over cornell's 2 spheres (the brute loop), kernel 5 over a seeded
     soup of 4096 triangles (single- and two-sided; the tree instance, its
     tree built on the card by one launch and equal to HK.triangle_tree
     element for element, the build's device time printed apart) and over
     cornell's 10 (the brute loop).
     The kernels are written to equal their plain versions bit for bit, so
     idx and t must be equal on every ray (gates first set at idx on
     99.99% and t within rtol 1e-5, tightened once the card showed 100%).
     Kernel and plain ms and the share of each kernel's bound (the tree
     instance's: the smaller of the brute count and the walk's, counted by
     its plain emulation on every SAMPLE_STRIDE-th ray); the tree instance
     searches with its tree built beforehand, as a stage pass does, and
     the build's ms (host clock) is printed apart;
  9. the stage pipeline's main path: render_passes(sphere_field(1024),
     1024^2, b5, use_megakernel=False, use_pallas=True), 1 warm-up + 4
     timed one-pass calls: exactly 12 kernel-4 launches per pass, all of
     the tree instance, and 0 of kernel 5, one one-launch build of the
     sphere tree per pass (MK.tree_build_launches) and no torch build,
     finite acc, and the first
     pass's mean radiance within 2% of the same pass through
     use_pallas=False (same draws). Two of the first pass's searches, the
     first bounce's closest hit and its shadow search, are held to the
     plain version under phase 8's exact gates. Prints segments/s, ms per
     pass and torch.profiler's split of one pass (the share in kernels 4
     and 5). Then one render_direct call on the same scene (2 kernel-4
     launches), both PNGs under build/;
 10. the stage route against kernel 1: cornell 1024^2 b5, one pass with
     the same pass key through use_megakernel=False, use_pallas=True (12
     launches each of kernels 4 and 5; both run their brute loops on
     cornell's 2 spheres and 10 triangles) and through use_megakernel=True (1
     launch of kernel 1): at most 1% of rays beyond rtol/atol 2e-4 and the
     mean accumulator within 1e-5 relative (phase 3's gates; kernel 1
     contracts FMAs, the stage route does not);
 11. the champion (cell) route's kernels: kernel 1 recording vs not
     recording on sphere_field(1024) at 1024^2 b5 (bit-equal
     accumulators); kernel 1's path mode over the sphere tree (row 1s:
     past MK.SPH_BRUTE_MAX["path"] resident spheres, its instances walk a
     box tree built by its call) equal to its brute instances (forced) on
     sphere_field(1024) at 1024^2 b5, path and the roulette, recording
     and not, in both builds (acc, ids and occs, fatal), the recording
     pass's ms through the tree and through the brute instance and the
     tree build's device time (torch.profiler), beside the card's name
     and power limit; row 1s's bound, the smaller of the brute count and
     the walk's (the plain walk's count on the same pass);
     kernel 1 recording vs its plain version on the same u-planes, on
     sphere_field(1024) at 1024^2 and on sphere_field(256) and cornell at
     256x192, the share of differing champion ids and occlusion bits
     printed (on the sphere fields, which the route walks as a tree, the
     plain version is the plain walk, MK.pathtrace_walk_reference, equal
     to the brute plain version on every value): the same source built
     with --fmad=false must equal the plain version on every ray, id and
     bit; the build that runs, on cornell,
     phase 3's gates; on sphere fields, where contracted multiply-adds move
     grazing hits, SPHERE_GATES (at most 0.02% of first-segment ids, 5e-3
     of the mean, 5% of rays beyond 2e-4, 1% of id slots; the comment above
     it gives the readings they sit between); kernel 3 vs its plain version
     on kernel 1's own records (so both differentiate the same champions)
     through the PRNG and the u-planes route: sphere_field(1024) at 1024^2
     with ("sph", "mat") (cosine >= 0.999, norm ratio within 1%),
     sphere_field(1024) and cornell at 256x192 with all five groups (also
     max |d| <= 5e-3 x the group's largest entry); kernel 3 vs kernel 2 on
     cornell b5 with the same cotangent, all five groups, with phase 6's
     gates at 256x192 and at 1024^2;
 12. the cell route's training main path: sphere_field(1024) 1024^2 b5,
     mega_grad_wrt ("sph", "mat"), mega_bwd_impl "auto"; per step
     render_pass -> image -> mean square -> backward -> SGD on sphere
     centers, radii and materials; 1 warm-up and 10 timed steps. Exactly
     one kernel-1 and one kernel-3 launch per step and no kernel-2 launch,
     one build of kernel 3's ray order per step (MKG.order_launches), one
     sphere tree build per step, which kernel 1 walks
     (MK.tree_build_launches, MK.path_walk_launches),
     a finite loss, finite gradients. Prints ms/step, forward + backward
     segments/s, kernel 1 recording and kernel 3 alone (CUDA events around
     the wrappers, on the last step's pass and cotangent) with their shares
     of their bounds, and the plain champion backward's ms on the same
     record; then kernel 3's ray order on that record (MKG.champ_order,
     built on the card) held equal to its plain version
     (MKG.champ_order_reference) element for element, its device time,
     and the plain counts of the segments its warps walk
     (MKG.champ_warp_work) and of the row groups they add
     (MKG.champ_add_count) in ray order and in the order;
 13. Russian roulette (from depth RR_START, as bench.py runs config 5):
     kernel 1 vs its plain version on the same u-planes, cornell at 256x192
     and 1024^2 b5 (phase 3's gates) and sphere_field(256) at 256x192
     (SPHERE_GATES), its --fmad=false build equal to the plain version on
     every ray, id and bit on cornell and sphere_field(256) at 256x192, the
     PRNG route bit-equal to the u-planes route (1 pass, and 3 passes in
     one launch); kernel 2 vs its plain version (phase 6's gates) on cornell
     at 256x192 with all five groups and at 1024^2 with ("sph", "mat");
     kernel 3 vs its plain version on kernel 1's own record of
     sphere_field(256) at 256x192 (all groups), and vs kernel 2 on cornell
     at 256x192 (all groups);
 14. config 5 as BASELINE.json specifies it (bench.py BENCH_FULL=1): render
     cornell 1024^2 spp 1 b5 with Russian roulette for 1024 passes, 64 per
     call: exactly 16 kernel-1 launches, a finite image whose mean is within
     1% of the same 1024 passes without the roulette (unbiasedness); train
     1024 steps with the roulette and ("sph", "mat") as bench.py's
     _full_train_bench does (forward + backward every pass, parameters
     fixed, state threaded): one kernel-1 and one kernel-2 launch per step,
     a finite loss, finite nonzero last gradients; nominal segments/s of
     both, counted as bench.py:271 and :320 count them; then 10 steps of
     sphere_field(1024)'s cell route with the roulette: one kernel-1 and one
     kernel-3 launch per step, one sphere tree build per step;
 15. direct mode and fake shade: kernel 1's direct mode vs its plain
     version on u_planes_for_direct (phase 3's gates) on cornell 1024^2 spp
     1 (assign08's shape) and spp 4 with focal length 2.8 and lens diameter
     0.25 (assign09's, 4,194,304 rays), its PRNG route bit-equal to its
     u-planes route; render_direct through kernel 1 against the stage
     route's (use_megakernel=False, use_pallas=True) with the same key for
     1 and 3 passes (phase 10's gates, on the image); timed, one kernel-1
     launch per call, configs 2 and 4 at 1024^2 with 16 passes per call
     (rays as bench.py:225-228 count them), the kernel alone (CUDA events
     around the wrapper) beside the call; config 1 (16 orbit frames of
     render_fake_shade_orbit at 1024^2; no hand-written kernel, as in JAX)
     timed.
 16. grid build: prepare_grids of shapes 1 and 3 at 1024^2 -- cornell plus
     a procedural 992-triangle torus mesh (the teapot's size; its kernel
     grid 3^3 by auto_slabs, the walls the brute prefix; the scene of
     tests/torch_grid_scenes.py) and sphere_field(8192) (its sphere grid
     6^3, past the resident 4608) -- with the build ms; phases 17-19 reuse
     these scenes (built once per shape and size);
 17. kernel 1's grid mode vs its plain version (accel/traverse's march with
     the brute loops' arithmetic) at 256x192 on both scenes in direct,
     path and roulette modes, the path modes recording (the record and the
     accumulator of the recording launch against the plain record; the
     path launch's accumulator equal to the recording launch's), same
     draws: phase 3's gates on the torus, SPHERE_GATES on the sphere grid;
     its --fmad=false build equal on every ray, id and bit; the plain grid
     version equal to the brute plain version (ids and bits, acc within
     1e-6) in direct mode and, on the torus, in path mode at depth 1. The
     plain march's walk steps and distinct (ray, item) tests give the grid
     bounds (OPS_WALK, OPS_CELL), scaled to 1024^2;
 18. timings at 1024^2: config 3's shape through render_direct (16 passes
     per call, one launch per call) at block 64 and block 0 in turns, rays
     as bench.py:225-228 count them, the kernel alone and its share of the
     bound, the two blocks' images bit-equal, the first pass vs plain
     (phase 3's gates); shapes 2 (the torus scene in path mode b5, block
     64, BENCH_GRID=1) and 3 (sphere_field(8192), block 0): forward
     segments/s, kernel alone, first pass vs plain, then 5 cell-route train
     steps (("sph", "mat", "tri") on the torus, ("sph", "mat") on the
     spheres): one kernel-1 and one kernel-3 launch per step, no kernel 2,
     ms/step, kernel 1 recording and kernel 3 alone with their bounds, and
     kernel 3 vs its plain version on the last step's record and cotangent
     (phase 6's gates at 1024^2), its hot rows built on the card equal to
     their plain version (MKG.hot_rows_reference) on that record, and the
     plain count of kernel 3's row adds there (MKG.champ_add_count: the
     scalar atomics of the design before the hot rows against this one's
     slab adds, vector reductions and flushes);
 19. kernel 3 on kernel 1's grid record (original rows) vs its plain
     version (PRNG and u-planes routes, phase 6's gates) on both scenes at
     256x192 with all five groups, its hot rows equal to their plain
     version, and the count of its row adds;
 20. edge-aware gradients (bench.py BENCH_EDGE=1, mega_edge_bandwidth and
     tau EDGE_BW): (a) kernel 2s (csrc/megakernel_soft.cu, the adjoint of
     the soft program) vs its plain version
     (ops/megakernel_soft.pathtrace_pass_bwd_soft_reference, run over the
     rays in chunks) on cornell 256x192 b5 with and without the roulette,
     all five groups and ("sph", "mat"), the same u-planes and seeded
     random cotangent, its PRNG route too, with phase 6's gates (max |d|
     included); (b) edge mode over prepare_grids(cornell, 2) (kernel 1's
     grid mode forward) against the brute edge route through
     render_pass_mega, all five groups, the same cotangent of acc: cosine
     >= 0.999999 and max |d| <= 1e-4 of each group's scale (only kernel
     2s's float atomics differ), one kernel-1 and one kernel-2s launch per
     pass; (c) the BENCH_EDGE step at 1024^2 b5 with ("sph", "mat") as
     bench.py::_train_bench runs it (parameters fixed, state threaded) and
     the hard step in the same run: median ms of 10 synchronised steps
     after a warm-up, fwd+bwd segments/s (bench.py:393-395), launches
     (edge: kernel 1 and kernel 2s once per step, kernel 2 never), the
     ratio of the two steps (bench.py's budget is 3x; not gated), kernel 2s
     alone on the last step's cotangent (CUDA events) against its plain
     version (phase 6's gates, max |d| included) and its share of its
     bound (OPS_SOFT_*) and of its second bound (SFU_SOFT_*: MUFU
     operations at 16 per SM per clock), with what its launch took (lanes
     per ray, shared memory per block, registers; stack frame and spill
     bytes from the build's ptxas report);
 21. streamed tables (render/mega.chunk_tables: Morton chunks and the
     tree over them, no grid): (1)
     kernel 1 over cornell plus the 992-triangle torus (1,002 triangles in
     8 chunks) in path, roulette (from RR_START) and direct modes, the
     path modes recording, and over sphere_field(STREAM_SPHERES) (64
     sphere chunks) in path mode, vs the plain streamed version on the
     same draws at 256x192: phase 3's gates and at most 1% of id slots and
     occlusion bits differing on the torus, SPHERE_GATES on the spheres;
     the --fmad=false build equal on every ray, id and bit; records
     naming original rows; the kernel's tree walk counted on the plain
     version's rays (MK.tree_walk_work: node and row tests, leaves, a
     warp's union) beside the Morton chunks' slab and row tests, none of
     its champions or occlusion bits missing; (2) the plain streamed
     version equal to the plain brute version (ids, bits, acc) on the
     torus scene at
     STREAM_BRUTE_W x STREAM_BRUTE_H, path b1 and direct; (3) kernel 3 on
     kernel 1's streamed record vs its plain version with ("sph", "mat",
     "tri") (phase 19's gates, its hot rows and its count); (4) at 1024^2
     b5: the torus scene's forward (16 passes per call) at block 64 with the cell route's train
     step (one streamed kernel-1 recording and one kernel-3 launch per
     step, no kernel 2), at block 0, with the roulette, and direct through
     render_direct (16 passes per call, block 64), and sphere_field(8192)
     streamed beside phase 18's sphere-grid time: segments/s or rays/s, ms
     per pass, the kernel alone, the device's idle share, the first pass
     vs plain, the share of the bound (OPS_CHUNK per slab test of a
     chunk or a node, OPS_STREAM per streamed trace or shadow ray, and the
     row tests at 256x192, a shadow ray's up to its first occluder,
     scaled, priced by the smaller of the two counts, both printed); every
     launch of the phase's main-path runs must stream
     (MK.stream_launches); timing only, the torus of HOUSE_SEGMENTS (5,322
     triangles, BENCH_SCENE=house's count).
 22. kernels 2 and 2s past 64 objects per type (ROADMAP item 16): (a) at
     LARGE_W x LARGE_H b5 (the main path's depth), the same u-planes and
     seeded random cotangent, the u-planes and PRNG routes, one count of
     the large-table route each (none of the 64-object one): kernel 2
     (kernel 1's --fmad=false record of the pass, then kernel 3's sweep
     of it: MKG.pathtrace_pass_bwd_split) vs its plain version (the
     long tables' rows tested a chunk at a time over the program's
     Morton build, its ``chunks`` argument) on
     sphere_field(256) and sphere_field(1024) (resident spheres, the 2-
     and 8-row loops) with ("sph", "mat"), on the torus scene streamed and
     over its grids with ("sph", "mat", "tri"), and on the streamed torus
     at BRUTE_W x BRUTE_H b BRUTE_BOUNCES vs the brute plain version (one
     row at a time, no Morton build); kernel 2s (the two-level composite,
     sparse over each warp's live rows; the triangles Morton-sorted) vs
     its plain version in path mode, with the roulette and in direct mode
     (SOFT_MODES) on the torus scene (("sph", "mat", "tri")),
     sphere_field(1024), sphere_field(256) (path mode and the roulette),
     a film whose rays all miss (every span mask
     empty: every plain and kernel word exactly 0) and a packed
     sphere_field(128) whose warps' live rows fill every span; all under
     phase 6's gates. Where kernel 2s misses them, the rays whose cotangent
     float32 does not pin down (_ray_moves: the ray's share of the plain
     cotangent moves between its draws moved by +2^-22 and -2^-22) are
     excused one at a time, the least stable first, until every other ray
     is within the gates; each must move the cotangent the gates then
     read by more than UNSTABLE_MOVE of its norm, and at most 2% of the
     rays go; the excused rays are listed, and the phase prints how many
     it excused in all; edge x grid
     on the torus scene vs the streamed brute edge route (one kernel-1
     and one large kernel-2s launch each; cosine >= 0.99999, max |d| <=
     1e-3 of scale); (c) one launch of each route at DIFF_TABLE_MAX
     (sphere_field(4096), a seeded soup of 4096 triangles) at CAP_W x
     CAP_H b1, all five groups, the same gates, kernel 2s also with the
     roulette (from depth 0) and in direct mode; (b) at 1024^2 b5: the
     "pallas" train step (one kernel-1 launch and one large kernel-2
     count per step: the record and the sweep count no kernel-1 or
     kernel-3 launch; on sphere_field(1024) one sphere tree build per
     step on either route, the "pallas" record walking the forward's)
     beside the cell route's (kernel 1 recording and
     kernel 3) on sphere_field(1024) with ("sph", "mat") and on the torus scene
     streamed with ("sph", "mat", "tri"), LARGE_STEPS steps each, median
     ms and fwd+bwd segments/s, kernel 2 alone on the last step's
     cotangent (both launches, then the record and the sweep each alone,
     with the sweep's hot rows and the count of its row adds) with its
     bound (the record's count, on sphere_field(1024) the smaller of the
     brute count and the sphere tree walk's over the live rays, plus the
     sweep's operations;
     bytes: 12 per ray, the tables twice, the record, 4 + L per segment,
     written and read); BENCH_EDGE on the torus scene (one step;
     one kernel-1 and one large kernel-2s launch), kernel 2s alone (CUDA
     events around its launch in that step) with its bounds, FP32 and
     MUFU: dense (every factor of every row, every pair of every span and
     the spans' level; the kernels line's dense_bound_ms) and live work
     (what this run's data needs: each ray's rows up to the first factor
     of alpha exactly 0, then only its own live rows, pairs and spans,
     counted by the plain version, MKS.live_stats, on LIVE_BLOCKS blocks
     of the step's rays; the kernels line's bound), the warps' union of
     live rows that the kernel runs beside them, and its launch.
     Prints the
     phase's seconds. The kernels
     line's entries of this phase name the size of their ``ms``
     (``shape``) and of their ``plain_ms`` (``plain_shape``).
 23. the differentiable direct pass (pathtrace_pass_diff(mode="direct"),
     ops/megakernel_grad.py): (iv) at DIRECT_W x DIRECT_H, the same
     u_planes_for_direct draws and seeded random cotangent, on cornell
     spp 1 and spp 4 through a lens of diameter 0.25 (all five groups),
     sphere_field(SMALL_SPHERES) (kernel 2's large-table route and kernel
     2s's large-table instance, ("sph", "mat")) and the torus scene
     streamed (("sph", "mat", "tri")): piece a, kernel 1's direct-mode
     recording, bit-equal
     to the launch that does not record, its --fmad=false build equal to
     the plain record on every ray, id and bit, the build that runs within
     phase 3's gates (SPHERE_GATES on the sphere field); piece b, kernel 2
     (over the forward's streamed chunks), piece c, kernel 3 on kernel 1's
     own record, and piece d, kernel 2s (EDGE_BW; on the large scenes at
     DIRECT_SOFT_W x DIRECT_SOFT_H, the triangles Morton-sorted), each
     against its plain version under phase 6's gates, with phase 22's
     excusal of unstable rays for kernel 2s; the PRNG route bit-equal to
     the u-planes route forward and within phase 6's gates backward;
     (i)-(iii) at 1024^2 spp 1 with ("sph", "mat"), 1 warm-up and
     DIRECT_STEPS timed SGD steps on mean(image^2) (the image the
     per-pixel mean over spp over the lights, as render_direct_mega
     forms it): cornell through kernels 1 and 2, through kernel 1
     recording and kernel 3, and through kernels 1 and 2s
     (mega_edge_bandwidth EDGE_BW), sphere_field(N_SPHERES) through kernel
     2's large-table route and through the cell route: exactly one
     direct launch and one launch of the route's backward per step, a
     finite loss, finite nonzero gradients; ms per step, fwd+bwd rays/s,
     each kernel alone (CUDA events) on the last step with its share of
     its bound (_direct_bounds, _soft_ops with ``direct``). Prints the
     phase's seconds.
 24. the stage pipeline's main path on the torus scene (cornell plus the
     992-face torus, 1,002 triangles, no grids: BENCH_MEGA=0 on the
     teapot's stand-in): render_passes at 1024^2 b5, use_pallas=True, 1
     warm-up and 4 timed one-pass calls: exactly 12 kernel-5 launches per
     pass, all of the tree instance, one one-launch triangle-tree build
     per pass and no torch build, finite acc; the first pass against
     kernel 1's streamed route (row 1', one launch, the same pass key)
     under phase 10's gates; the card's build of the pass's tree equal to
     HK.triangle_tree; two of the first pass's searches, the first
     bounce's closest hit and its shadow search, held to the plain version
     under phase 8's exact gates; segments/s, ms per pass, the 12
     searches' ms on their own inputs, the build's device time and
     torch.profiler's split of one pass.
 25. sharding (``raytracing_tpu_torch/parallel/``): two ranks on one card
     (gloo, collectives staged through the host) or one NCCL rank per
     card where there are two or more, spawned after phase 2 built the
     kernels. Each rank, with the launch counts set to 0 just before each
     path and read just after: the sharded forward through kernel 1 on
     cornell 1024^2 b5 and the uneven 1001x999 film (16 passes per call,
     one launch per call), the "pallas" train step (cornell, ("sph",
     "mat"): one kernel-1 and one kernel-2 launch) and the cell step
     (sphere_field(1024): kernel 1 recording over one tree build, kernel
     3 in one order), and kernel 4 over sphere_field(1024)'s spheres split
     over the mesh's 'obj' axis (one launch of the tree instance per
     rank). Held against this process: the gathered accumulators equal
     the single-process launch (block 0) bit for bit, the steps' losses to
     1e-5 and cotangents under phase 6's gates, the object-sharded search
     (t, idx, valid) bit for bit. Prints per-rank ms per call and rays/s
     beside the card's name and power limit; ranks that share a card
     measure no scaling.
 26. the surface (XML scenes, mesh JSON, the CLI, the viewer, mesh
     scenes), on stand-ins written to a temporary directory by
     tests/torch_xml_scenes.py (the reference's scene files are not in
     the repository): (1) the torus scene written as XML and mesh JSON
     (io/scene_xml.load_scene) is phase 18's config-3 scene element for
     element after prepare_grids("auto", mesh_slabs="auto"), scene and
     kernel tables, and kernel 1's films of both are bit-equal, direct
     and path b5, GRID_PASSES passes at 1024^2, block GRID_BLOCK; (2)
     config 3 through assign07(scene_xml=<the cornell_teapot stand-in>,
     n_slabs=3, mesh_slabs="auto"): kernel 1's grid-mode direct pass
     against its plain version at 256x192, the --fmad=false build equal to
     it on every ray, the build that runs within phase 3's 1% of rays
     beyond 2e-4 and within TEAPOT_REL of the mean (shadow rays that graze
     the normalised torus near its terminator take the other side when
     contracted multiply-adds move the hit point; the comment above
     TEAPOT_REL gives the readings), and at
     1024^2 exactly one direct launch per GRID_PASSES-pass call, made with
     the grids, a finite film, 1 warm-up and GRID_REPS timed calls (ms per
     pass, rays/s); (3) the CLI on that XML at 1024^2 b5 (--grid 3
     --block 64, GRID_PASSES passes): exit 0, a PNG that io/png.read_png
     reads back as (1024, 1024, 3), and --orbit 2 at 256x192: two frames
     that differ; (4) the viewer: RenderSession at 1024^2 b5, 4 passes per
     step: two steps on cornell, one kernel-1 launch and 4 passes each,
     engine "megakernel" and device "cuda:0"; make_server on port 0
     serves /, /scenes, /devices (naming the card), /status and
     /frame.png (1024x1024); start on the XML scene advances the passes
     within VIEWER_DEADLINE seconds, then stop; (5) big_mesh_scene with
     RT_REFERENCE_DIR on a house_of_parliament.json stand-in (the
     HOUSE_SEGMENTS torus, 5,312 faces) through render_passes at 1024^2
     b5, GRID_PASSES passes per call, block GRID_BLOCK: one streamed
     launch per call, a finite film, ms per pass. Prints the phase's
     seconds.
Each phase prints the seconds elapsed since the start before it runs.
Ends with a kernels JSON line and, last, the device JSON line. Exits non-zero
without a result where CUDA is missing or the package is not beside it.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
START = time.perf_counter()
TOL = 2e-4
BOUNCES = 5
MAIN_W = MAIN_H = 1024
PASSES_PER_CALL = 16
TIMED_CALLS = 5
# phases 6-7
GRAD_SEED = 2
TRAIN_WRT = ("sph", "mat")
TRAIN_STEPS = 10
TRAIN_LR = 1e-3
# phases 8-10
HIT_RAYS = 1 << 20
HIT_SEED = 8
N_SPHERES = 1024
BIG_SPHERES, BIG_RAYS = 4096, 1 << 18   # phase 8's largest sphere table
TIE_COPIES = 64          # the tie table's copied spheres
SAMPLE_STRIDE = 61       # the walk's count runs on every 61st ray
SOUP_TRIANGLES = 4096
STAGE_TIMED_CALLS = 4
# phases 11-12
SMALL_W, SMALL_H = 256, 192
SMALL_SPHERES = 256
UNROLL_SPHERES = 64        # the most spheres "auto" sends to kernel 2
# kernel 1 built without contracted multiply-adds computes its plain
# version's float32 arithmetic, so it must equal it exactly
EXACT_FLAGS = ("--fmad=false",)
# phases 13-15
RR_START = 2               # bench.py's rr_start_depth
FULL_PASSES = 1024         # BASELINE.json config 5: 1024 spp with RR
FULL_CHUNK = 64            # passes per call (bench.py BENCH_PASSES)
CELL_RR_STEPS = 10
DIRECT_PASSES = 16         # bench.py's BENCH_PASSES for configs 2 and 4
DIRECT_REPS = 10
ORBIT_FRAMES = 16
# phases 16-19: kernel 1's grid mode on config 3's shape (cornell plus a
# procedural 992-triangle torus mesh, the teapot's size), its path mode
# (BENCH_GRID=1) and a molecule-scale sphere grid
TORUS_SEGMENTS = (31, 16)   # tests/torch_grid_scenes.py's torus, 992 faces
GRID_SPHERES = 8192        # past SPH_RESIDENT_MAX: the sphere grid
GRID_PASSES = 16           # passes per call (bench.py BENCH_PASSES)
GRID_BLOCK = 64            # assign07's (and bench.py's mesh scenes') block
GRID_REPS = 5
GRID_TRAIN_STEPS = 5
# the stage route's pass before kernel 5's tree and the one-launch sphere
# tree build (kernel 4's tree built by torch every pass, kernel 5's brute
# loop), as raytracing_tpu_torch/profile_kernels.py --only hit measured it
# on one H100 80GB HBM3 at 700.00 W: ms per one-pass call (host clock,
# the median of 5) of phases 9 and 24's scenes, in two processes. Printed
# beside this run's times; no gate reads them
BEFORE_STAGE_MS = {"spheres": (73.8226, 69.3757), "torus": (106.023, 104.494)}
# kernel 1's grid mode before the cell-major copies (the walk that tested
# every item of each cell through the CSR, one dependent load at a time),
# as this script measured it on one H100 80GB HBM3 at 700.00 W: ms per
# pass (kernel alone) and of the recording launch. Printed beside this
# run's times (phase 18); no gate reads them
BEFORE_GRID_MS = {"shape 1": 0.314348, "shape 2": 6.99592,
                  "shape 2 recording": 7.41169, "shape 3": 1.42714,
                  "shape 3 recording": 1.60053}
MESH_WRT = ("sph", "mat", "tri")
STREAM_SPHERES = GRID_SPHERES   # streamed: no sphere grid (phase 21)
HOUSE_SEGMENTS = (83, 32)  # 5,312 faces + 10 walls: BENCH_SCENE=house's 5,322
STREAM_BRUTE_W, STREAM_BRUTE_H = 64, 48  # plain streamed vs plain brute
# phase 20: edge-aware gradients (kernel 2s), bench.py BENCH_EDGE=1
EDGE_BW = 2e-2             # mega_edge_bandwidth (and tau)
EDGE_W, EDGE_H = 256, 192  # kernel 2s vs its plain version, edge x grid
EDGE_STEPS = 10
# phase 22: kernels 2 and 2s past 64 objects per type (ROADMAP item 16)
LARGE_W, LARGE_H = 24, 16  # kernel vs plain: 384 rays
# kernel 2s's rays that float32 does not pin down (_ray_moves)
UNSTABLE_MOVE = 1e-3
BRUTE_W, BRUTE_H, BRUTE_BOUNCES = 8, 6, 1  # the streamed torus vs brute
LARGE_STEPS = 5            # timed hard steps per route at 1024^2
CAP_W, CAP_H = 16, 8       # one launch of each route at DIFF_TABLE_MAX
LIVE_BLOCKS, LIVE_BLOCK = 8, 1024  # kernel 2s's live rows, counted on rays
SOFT_MODES = ("path", "rr", "direct")  # kernel 2s's builds (RT_SOFT_MODE)
SOFT_CHUNK = 64            # JAX's SOFT_CHUNK: rows per span past 64
DIRECT_W, DIRECT_H = 256, 192   # phase 23's kernel vs plain
DIRECT_SOFT_W, DIRECT_SOFT_H = 64, 48   # kernel 2s vs plain past 64 objects
VIEWER_DEADLINE = 120      # seconds for phase 26's viewer loop to advance
# phase 26 (2): kernel 1 (contracted) vs plain, direct, on the cornell_teapot
# stand-in (a torus normalised and scaled by 0.7), one pass. Readings on one
# H100 80GB HBM3 (PERF.md): at 256x192 41 of 49,152 rays beyond 2e-4
# (25 brighter, 16 darker: shadow rays near the torus' terminator), mean
# 1.44e-4 apart; 21 rays and 4.1e-5 through a pinhole; at 1024^2 954 rays
# (496 / 458) and 3.26e-5; the --fmad=false build equal to the plain
# version on every ray in all three. So the mean only bounds that noise;
# the --fmad=false build's equality is what would show a fault.
TEAPOT_REL = 5e-4
DIRECT_STEPS = 10          # phase 23's timed train steps per route
WALK_SPHERES = 4608        # phase 23's largest resident table (the walk)

# Bounds: the least time the card could take for a kernel's work, the
# larger of its FP32 operations over the H100's 67 TFLOP/s and its bytes
# over 3.35 TB/s (NVIDIA's data sheet, H100 SXM; the card's power limit
# is printed beside). FP32 operations per unit of work, counted in
# csrc/pathtrace.cuh and csrc/pathtrace_adj.cuh: each add, sub, mul, div,
# sqrt, rsqrt, min, max, compare and select is one, a multiply-add two;
# integer work (threefry draws, indexing) and warp shuffles are not
# counted. The counts of work come from this run's record of the pass (the
# champion ids and occlusion bits), so each bound is a lower bound: an
# object test counts what every test computes -- a sphere's discriminant
# (m = o - c 3, b 6, m.m - r^2 7, b^2 - 4ac 3, its test 1) or a
# triangle's facing test (n.d 5, its test 1) -- plus the rest of the test
# for each champion, and an occluded shadow ray one test.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
OPS_SPHERE_TEST = 20
OPS_TRIANGLE_TEST = 6
OPS_SPHERE_HIT = 33      # sqrt, two roots, window, select 15; normal 18
OPS_TRIANGLE_HIT = 66    # 1/div, beta 12, gamma 12, t 7, window 8; normal 26
                         # (kernels 4 and 5 compute no normal)
OPS_CAMERA = 129         # film and focal point 50, lens 29, d 12, AABB 38
OPS_TRACE = 24           # d.d, 0.5/a, 4a, o x d, hit point, found
OPS_EMITTER = 36         # per light on the primary segment
OPS_NEE = 112            # per shadow ray: disk point 28, ray 25, anyhit
                         # set-up 16, geometric term 28, shading 15
OPS_BOUNCE = 103         # tangent frame 53, disk lift 20, d 24, o 6
OPS_CHAMP = 60           # kernel 3: a recorded champion's t, beta, gamma,
                         # normal, material
OPS_RR = 9               # Russian roulette (rr_survive): max, max, clip 2,
                         # compare, 1 / p, three products
OPS_WALK = 86            # grid mode, per grid walked by a traced segment or
                         # shadow ray: slab test and cell crossings 39,
                         # margin and window 8, entry point and cell 21,
                         # first faces 18 (csrc/pathtrace.cuh grid_walk)
OPS_CHUNK = 31           # a streamed chunk's slab test: box - o 6, times
                         # 1 / d 6, min 3 and max 3 per axis, near 2, far 2,
                         # window max, min and compare 3 (JAX's ~30)
OPS_STREAM = 6           # per traced segment or shadow ray that streams:
                         # safe_inv's 3 divisions and 3 selects
OPS_CELL = 10            # per walk step: nearest face 2, bound, margin
                         # and test 3, tie tests 4, one face advanced 1
OPS_DIRECT_SHADE = 86    # per direct-mode shadow ray: disk point 28, ray
                         # 25, any-hit set-up 16, cosine and clip 7,
                         # ambient and clip 4, albedo x shade into acc 6
# The reverse sweep (csrc/pathtrace_adj.cuh reverse_sweep), per taped
# segment, shadow ray or path, each term under the diff_wrt groups that run
# it (_adj_ops), counted as kernel 2s's are: each forward piece once (kernel
# 2: kernel 1's pass, _k1_ops; kernel 3: _k3_fwd_ops), the *_ADJ constants
# the adjoint's own operations, not the pieces the sweep recomputes (the
# champion's surface, the discriminant or the Moller-Trumbore terms, the
# shadow ray and light geometry, the tangent frame and bounce direction,
# the camera chain, the survival probability). With dot 5, cross 9,
# normalize 11 and normalize_adj 24:
OPS_SHADOW = 77          # kernel 3's forward piece per shadow ray: the
                         # shadow ray 53 (disk point 28, ray 25) and the
                         # light geometry 24 (kernel 1's in OPS_NEE)
OPS_ADJ_NEE = 30         # per shadow ray: the shading's adjoint 3, albedo
                         # and throughput cotangents 27
OPS_ADJ_NEE_FREE = 4     # per free shadow ray: the geometric term
OPS_ADJ_NEE_GEOM = 92    # per free shadow ray, with par/sph/tri/lig: gsh 6,
                         # ggeom 5, area and cosine cotangents 9, r2 5, clips
                         # 6, gq 4, direction 9 + 24, hit point and normal
                         # 18, eps 6
OPS_ADJ_NEE_LIG = 32     # per free shadow ray, with lig: the light row's
                         # position, normal, irradiance, tangent, bitangent
                         # 18, radius 14
OPS_ADJ_BOUNCE = 225     # per segment followed by a taped one, with
                         # par/sph/tri: direction 24, cosine lift 9,
                         # tangent_frame_adj 171 (2 normalize 22, 6 cross 54,
                         # 3 normalize_adj 72, min-component 11, adds 9,
                         # selects 3), origin, normal and eps 21
OPS_ADJ_SPHERE = 106     # per sphere champion, with par/sph/tri: hit point
                         # and normal 32 + 18, the root's and discriminant's
                         # cotangents 56
OPS_ADJ_SPHERE_ROW = 2   # with sph: the radius cotangent
OPS_ADJ_TRIANGLE = 119   # per triangle champion, with par/sph/tri: hit
                         # point and normal 32, barycentrics 19, the
                         # numerators' and divisor's cotangents 20, origin
                         # and direction 48
OPS_ADJ_TRIANGLE_ROW = 32  # with tri: the row's 25 cotangents
OPS_ADJ_CAMERA = 186     # per path, with par: the camera chain's adjoint
                         # 155, the par cotangents 31
OPS_ADJ_RR = 41          # per segment that followed a roulette: the tie and
                         # bound weights 20, g.tp 5, the chain 5, the three
                         # cotangents 11
# Direct mode's adjoint (csrc/pathtrace_adj.cuh direct_sweep), counted the
# same way; its champion's and camera's adjoints are OPS_ADJ_SPHERE,
# OPS_ADJ_TRIANGLE (and their rows) and OPS_ADJ_CAMERA:
OPS_ADJ_DIRECT = 17      # per shadow ray of a valid hit: the albedo's
                         # cotangent 6, the outer clip's 10, ambient 1
OPS_ADJ_DIRECT_GEOM = 53   # per free shadow ray, with par/sph/tri/lig: the
                           # cosine's clip 5, direction 3 + 24, hit point
                           # 3, normal 12, eps 6
OPS_ADJ_DIRECT_LIG = 22  # per free shadow ray, with lig: radius 14,
                         # tangent and bitangent 8
OPS_DIRECT_SHADOW = 64   # kernel 3's forward piece per direct shadow ray:
                         # the shadow ray 53, cosine and its clip 7, ambient
                         # and its clip 4
OPS_SOFT_DIRECT_NEE = 73     # kernel 2s, per direct shadow ray past its
                             # transmittance: the shadow ray and its length
                             # 53, the shade 20 (cosine, clips, vis, albedo)
OPS_SOFT_DIRECT_NEE_ADJ = 115  # its adjoint: coverage and albedo 14, the
                               # clips 15, direction 3 + 24, length 12,
                               # origin and hit point 12, light row 22, eps
                               # 6, normal 7
# Kernel 2s (csrc/pathtrace_soft_adj.cuh, csrc/megakernel_soft.cu), counted
# the same way with each expf as one operation (a sigmoid: negate, expf,
# add, divide: 4); _soft_ops puts them together per segment and light. What
# the function needs is counted once: the kernel's replays (its tape pass
# and its sweep each run the soft forward, comp_adj recomputes the fields
# and the pair sigmoids, hyp_adj its hypothesis, the sweep the bounce) are
# not, and the *_ADJ constants are the adjoint's own operations.
# A hypothesis (hyp_fwd) per factor of its alpha, in the order the kernel
# evaluates and votes them: where a factor is exactly 0 for a ray, the
# function needs none of the later ones (MKS.live_stats' reach_s and
# reach_t count the rows that evaluate each; on dense tables every row
# evaluates all). A sphere's 37: mask 2; m 3, b 5, c 7, discriminant 2 and
# its sigmoid with scaling and product 6; guarded root 3, t 2, its sigmoid
# past mint with scaling and product 7. A triangle's 63: mask 1; n.d 5,
# side 2; 1 / div 3, beta 12, gamma 12, margin 4, its sigmoid with scaling
# and products 8; t 8, its sigmoid past mint with scaling and product 8.
OPS_SOFT_SPHERE_FACTORS = (2, 23, 12)
OPS_SOFT_TRIANGLE_FACTORS = (1, 7, 39, 16)
OPS_SOFT_FIELDS_SPHERE = 30    # its fields: hit point 6 + 3, normal 11,
                               # material 4, point 6
OPS_SOFT_FIELDS_TRIANGLE = 42  # clips 6, vertex normals 15, normalize 11,
                               # material 4, point 6
OPS_SOFT_PAIR = 9        # per ordered pair of the composite (comp_fwd):
                         # sigmoid of the depth order 6, 1 - alpha s 2, product
OPS_SOFT_BLEND = 24      # per hypothesis: coverage sum 2, weight 2, blend 20
OPS_SOFT_SPAN = 7        # per span of the two-level composite (past 64
                         # objects): its coverage's clip 2, 1 / cov 5 (it
                         # is then a hypothesis of the spans' composite)
OPS_SOFT_SPAN_ADJ = 10   # its adjoint: the clip and 1 / cov
OPS_SOFT_SEGMENT = 30    # per segment: o x d 9, 1 / cov 5, the finished
                         # surface (clip, normal and its fallback) 16
OPS_SOFT_PAIR_ADJ = 14   # per ordered pair in comp_adj, past the pair's
                         # sigmoid and factor 1 - alpha s (the forward's):
                         # the suffix product 1, the prefix pass 13
OPS_SOFT_BLEND_ADJ = 40  # per hypothesis in comp_adj: gb . f 20, 1 / cov 3,
                         # alpha and trans 7, the fields' cotangents 10
OPS_SOFT_SEGMENT_ADJ = 27  # per segment: the normal's adjoint 17, the
                           # coverage's clip and 1 / cov 10
OPS_SOFT_HYP_ADJ_SPHERE = 58     # hyp_adj past its hypothesis: sigmoids
                                 # 15, root and discriminant 14, m, o, d,
                                 # centre 24, radius 5
OPS_SOFT_HYP_ADJ_TRIANGLE = 152  # sigmoids 15, margin's min ties 20,
                                 # 1 / div and numerators 16, o x d and the
                                 # origin and direction 63, the row 38
OPS_SOFT_FIELDS_ADJ_SPHERE = 49    # past the fields: normalize_adj 24,
                                   # point, centre, origin, direction and t
                                   # 22, mat 3
OPS_SOFT_FIELDS_ADJ_TRIANGLE = 94  # past the fields' clips and vertex
                                   # normals: 9 + normalize_adj 24,
                                   # barycentric cotangents 33, point 16,
                                   # rows 12
OPS_SOFT_OCCLUDER = 9    # per occluder of soft_vis past its hypothesis:
                         # sigmoid 6, coverage 1, transmittance 2
OPS_SOFT_OCCLUDER_ADJ = 13   # its adjoint past its factor 1 - alpha s:
                             # suffix 1, prefix 4, sigmoid 7, t 1
OPS_SOFT_NEE_ADJ = 298   # per shadow ray (the forward's NEE runs only in the
                         # sweep): the shadow ray 53 (OPS_NEE's disk point
                         # and ray), the light geometry 31, its adjoint 125,
                         # the direction and disk point's adjoint 89
OPS_SOFT_EMIT = 62       # per light on the primary segment (emit_fwd): plane
                         # 26, disk and front sigmoids 18, race 9, weight 9
OPS_SOFT_EMIT_ADJ = 106  # its adjoint and the emitter term's (emit_adj and
                         # the sweep's acc and path-weight cotangents)
OPS_SOFT_BOUNCE_ADJ = 225  # per bounce: OPS_ADJ_BOUNCE past the tangent
                           # frame 53 and the direction 15 it recomputes
# Kernel 2s's second bound: its special-function (MUFU) operations at the
# H100's 16 per SM per clock (132 SMs, the SM clock nvidia-smi reports as
# clocks.max.sm), counted like OPS_SOFT_* (what the function needs once).
# A sigmoid is 2: EX2 inside expf and RCP inside the IEEE division
# (profile_kernels --sass of kernel 2s: one MUFU.EX2 per expf site and one
# MUFU.RCP per division site); sqrtf, rsqrtf and each other division 1;
# sinf and cosf are FP32 polynomials, no MUFU.
PEAK_SFU_PER_SM_CLOCK = 16
N_SMS = 132
SFU_SOFT_SIGMOID = 2
SFU_SOFT_SPHERE_FACTORS = (0, 2, 3)      # per factor as OPS_SOFT_*_FACTORS:
SFU_SOFT_TRIANGLE_FACTORS = (0, 0, 3, 2)  # sigmoids, the guarded root,
                                          # 1 / (n . d)
SFU_SOFT_FIELDS = 1      # the normal's normalize
SFU_SOFT_COMPOSITE = 1   # 1 / cov, per composite (a segment's, a span's)
SFU_SOFT_SEGMENT = 1     # the finished normal's rsqrt
SFU_SOFT_HYP_ADJ_SPHERE = 2    # 0.5 / sq; with fields normalize_adj
SFU_SOFT_HYP_ADJ_TRIANGLE = 1  # with fields: normalize_adj
SFU_SOFT_NEE = 10        # per shadow ray: disk point, length, direction,
                         # geometry; its adjoint's normalize_adj and
                         # divisions
SFU_SOFT_EMIT = 7        # per light on the primary segment: 1 / den, three
                         # sigmoids
SFU_SOFT_BOUNCE = 11     # per bounce: disk point, lift, direction, tangent
                         # frame; the adjoint's normalize_adjs
SFU_SOFT_CAMERA = 20     # per ray: the camera chain, the box clip and their
                         # adjoints' divisions and normalizes


def _elapsed(phase: int) -> None:
    print(f"[{time.perf_counter() - START:.1f} s elapsed before phase "
          f"{phase}]")


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        _fail(msg)


def _print_builds(_build, libs) -> None:
    """Each library's build time and its ptxas report."""
    for name, _, flags in libs:
        info = _build.build_log.get((name, flags))
        print(f"  {' '.join((name,) + flags)}: "
              + (f"built in {info['seconds']:.2f} s" if info else "cached"))
        for line in (info["ptxas"] if info else "").splitlines():
            if any(k in line for k in ("registers", "spill", "stack",
                                       "Compiling entry")):
                print("    ptxas:", line.strip())


def _smi(query: str) -> str:
    """First card's line of ``nvidia-smi --query-gpu=<query>``."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _bound(ops: float, nbytes: float) -> dict:
    """bound_ms and what sets it."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _pass_work(ids, occs, n_lig: int, n_sph: int, live=None,
               rr_start=None) -> dict:
    """The work of one pass from kernel 1's record (ids (1 + b, R), occs
    (L (1 + b), R)), over the rays in ``live`` (all by default): rays,
    traced segments (segment 0 counted only where it found a champion),
    champions by kind, shadow rays free and occluded, bounces. With the
    roulette from depth ``rr_start``: its tests (every hit segment from
    that depth but the last), the segments that followed one, and as
    bounces only those that found a champion (the record does not tell a
    path the roulette ended from a bounce that missed: a lower bound)."""
    if live is not None:
        ids, occs = ids[:, live], occs[:, live]
    hit = ids >= 0
    per_seg = hit.sum(-1).double()
    shadow = per_seg.sum().item() * n_lig
    occluded = occs.double().sum().item()
    bounces = (per_seg[:-1] if rr_start is None else per_seg[1:]).sum().item()
    rr = 0 if rr_start is None else rr_start
    return {"rays": ids.shape[1], "traced": per_seg[0].item() + bounces,
            "primary": per_seg[0].item(),
            "sph_hits": (hit & (ids < n_sph)).double().sum().item(),
            "tri_hits": (ids >= n_sph).double().sum().item(),
            "shadow": shadow, "occluded": occluded,
            "free": shadow - occluded, "bounces": bounces,
            "continued": per_seg[1:].sum().item(),
            "taped": per_seg.sum().item(),
            "rr": 0.0 if rr_start is None else per_seg[rr:-1].sum().item(),
            "after_rr": (0.0 if rr_start is None
                         else per_seg[rr + 1:].sum().item())}


def _k1_ops(w: dict, n_sph: int, n_tri: int, n_lig: int) -> float:
    """FP32 operations of kernel 1's pass (and of kernel 2's replay)."""
    tests = n_sph * OPS_SPHERE_TEST + n_tri * OPS_TRIANGLE_TEST
    one = min(x for n, x in ((n_sph, OPS_SPHERE_TEST),
                             (n_tri, OPS_TRIANGLE_TEST)) if n)
    return (w["rays"] * OPS_CAMERA + w["traced"] * (OPS_TRACE + tests)
            + w["sph_hits"] * OPS_SPHERE_HIT
            + w["tri_hits"] * OPS_TRIANGLE_HIT
            + w["primary"] * n_lig * OPS_EMITTER + w["shadow"] * OPS_NEE
            + w["free"] * tests + w["occluded"] * one
            + w["bounces"] * OPS_BOUNCE + w["rr"] * OPS_RR)


def _direct_ops(w: dict, n_sph: int, n_tri: int) -> float:
    """FP32 operations of a direct-mode pass, from the record of the
    primary segment and its shadow rays (w of a pass without bounces)."""
    tests = n_sph * OPS_SPHERE_TEST + n_tri * OPS_TRIANGLE_TEST
    one = min(x for n, x in ((n_sph, OPS_SPHERE_TEST),
                             (n_tri, OPS_TRIANGLE_TEST)) if n)
    return (w["rays"] * OPS_CAMERA + w["primary"] * (OPS_TRACE + tests)
            + w["sph_hits"] * OPS_SPHERE_HIT
            + w["tri_hits"] * OPS_TRIANGLE_HIT
            + w["shadow"] * OPS_DIRECT_SHADE + w["free"] * tests
            + w["occluded"] * one)


def _adj_ops(w: dict, wrt) -> float:
    """FP32 operations of the reverse sweep's own work (its recomputed
    forward pieces are counted once with the forward: _k1_ops, _k3_fwd_ops)
    over the taped segments of w for the diff_wrt groups ``wrt``; the warp
    sums of the row adds and the atomics are not counted."""
    geo = bool({"par", "sph", "tri"} & set(wrt))
    ops = w["shadow"] * OPS_ADJ_NEE + w["free"] * OPS_ADJ_NEE_FREE
    if geo or "lig" in wrt:
        ops += w["free"] * OPS_ADJ_NEE_GEOM
    if "lig" in wrt:
        ops += w["free"] * OPS_ADJ_NEE_LIG
    if geo:
        ops += (w["sph_hits"] * OPS_ADJ_SPHERE
                + w["tri_hits"] * OPS_ADJ_TRIANGLE
                + w["continued"] * OPS_ADJ_BOUNCE)
    if "sph" in wrt:
        ops += w["sph_hits"] * OPS_ADJ_SPHERE_ROW
    if "tri" in wrt:
        ops += w["tri_hits"] * OPS_ADJ_TRIANGLE_ROW
    if "par" in wrt:
        ops += w["primary"] * OPS_ADJ_CAMERA
    return ops + w["after_rr"] * OPS_ADJ_RR


def _k3_ops(w: dict, n_lig: int, wrt) -> float:
    """FP32 operations of kernel 3 on a record: its forward pieces once
    (camera and emitter per ray, each recorded champion's surface, each
    shadow ray and light geometry, each bounce, each roulette) and the
    sweep's own (_adj_ops)."""
    return (w["rays"] * (OPS_CAMERA + n_lig * OPS_EMITTER)
            + (w["sph_hits"] + w["tri_hits"]) * OPS_CHAMP
            + w["shadow"] * OPS_SHADOW + w["bounces"] * OPS_BOUNCE
            + w["rr"] * OPS_RR + _adj_ops(w, wrt))


def _table_bytes(tables) -> int:
    return sum(4 * t.numel() for t in tables)


def _pass_kw(cfg, **extra) -> dict:
    """The kernels' keyword arguments for a RenderConfig."""
    return dict(spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
                two_sided=cfg.two_sided_triangles,
                normalize_emitter=cfg.normalize_emitter, seed=cfg.seed,
                russian_roulette=cfg.russian_roulette,
                rr_start_depth=cfg.rr_start_depth, **extra)


def _plain(MK, mega, scene, cfg, u, acc):
    """The kernel's plain PyTorch version on the same tables and draws."""
    import torch
    tables = mega.scene_tables(scene, cfg)
    return MK.pathtrace_pass_reference(
        tables[0], torch.tensor([0, 0], dtype=torch.int32), *tables[1:],
        acc, u, **_pass_kw(cfg))


def compare_with_plain(dev, w: int, h: int) -> float:
    """Phase 3 at one size; returns max |kernel - plain|."""
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                       use_megakernel=True)
    scene = cornell_box(cols=w, rows=h, device=dev)
    st = pt.init_state(cfg, dev)
    u = mega.u_planes_for_pass(st["key"], 0, cfg, scene.lights.count, dev)
    got = mega.render_pass_mega(scene, st, cfg, u_planes=u)["acc"]
    want = _plain(MK, mega, scene, cfg, u, torch.zeros_like(got))
    torch.cuda.synchronize()
    err = (got - want).abs()
    beyond = (err > TOL + TOL * want.abs()).any(-1).double().mean().item()
    gm, wm = got.double().mean().item(), want.double().mean().item()
    rel_mean = abs(gm - wm) / abs(wm)
    max_err = err.max().item()
    print(f"phase 3 {w}x{h} b{BOUNCES}: max|d acc| {max_err:.6g}, rays "
          f"beyond {TOL:g}: {beyond:.6%}, mean acc kernel {gm:.9g} plain "
          f"{wm:.9g} (rel {rel_mean:.3g})")
    _check(bool(torch.isfinite(got).all()), "kernel acc not finite")
    _check(beyond <= 0.01, f"{beyond:.4%} of rays beyond {TOL:g} (> 1%)")
    _check(rel_mean <= 1e-5, f"mean acc differs by {rel_mean:.3g} relative")
    return max_err


def prng_equals_u_planes(dev, w: int, h: int) -> None:
    """Phase 4: in-kernel threefry vs u-planes, same passes."""
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                       use_megakernel=True)
    scene = cornell_box(cols=w, rows=h, device=dev)
    start = 5
    st_u = dict(pt.init_state(cfg, dev), passes=start)
    for p in range(3):
        u = mega.u_planes_for_pass(st_u["key"], start + p, cfg,
                                   scene.lights.count, dev)
        st_u = mega.render_pass_mega(scene, st_u, cfg, u_planes=u)
        if p == 0:
            one_u = st_u["acc"].clone()
    one = pt.render_pass(scene, dict(pt.init_state(cfg, dev), passes=start),
                         cfg)["acc"]
    three = pt.render_passes(scene, dict(pt.init_state(cfg, dev),
                                         passes=start), cfg, 3)["acc"]
    torch.cuda.synchronize()
    d1 = (one - one_u).abs().max().item()
    d3 = (three - st_u["acc"]).abs().max().item()
    print(f"phase 4 {w}x{h} b{BOUNCES}: PRNG vs u-planes max|d| 1 pass "
          f"{d1:g}, 3 passes in one launch {d3:g}")
    _check(torch.equal(one, one_u), "PRNG route != u-planes route (1 pass)")
    _check(torch.equal(three, st_u["acc"]),
           "PRNG route != u-planes route (3 passes in one launch)")


def main_path(dev, smi: str) -> dict:
    """Phase 5: the main path through render_passes; returns the kernel
    entry of the kernels line."""
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.io.png import write_png
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                       use_megakernel=True)
    scene = cornell_box(cols=MAIN_W, rows=MAIN_H, device=dev)
    n_l = scene.lights.count
    segs_per_pass = cfg.total_rays * (1 + n_l + cfg.bounces * (1 + n_l))

    MK.launches = 0
    state = pt.init_state(cfg, dev)
    state = pt.render_passes(scene, state, cfg, PASSES_PER_CALL)  # warm-up
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_CALLS):
        state = pt.render_passes(scene, state, cfg, PASSES_PER_CALL)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = MK.launches
    # clocks and power under load: sample while ~0.5 s of passes is queued
    busy = pt.init_state(cfg, dev)
    for _ in range(20):
        busy = pt.render_passes(scene, busy, cfg, PASSES_PER_CALL)
    clocks = _smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    torch.cuda.synchronize()
    del busy
    n_calls = 1 + TIMED_CALLS
    _check(launches == n_calls,
           f"{launches} kernel launches for {n_calls} render_passes calls")
    acc = state["acc"]
    _check(tuple(acc.shape) == (cfg.total_rays, 3), "acc shape")
    _check(bool(torch.isfinite(acc).all()), "main-path acc not finite")
    passes = state["passes"]
    _check(passes == n_calls * PASSES_PER_CALL, f"passes = {passes}")

    timed_passes = TIMED_CALLS * PASSES_PER_CALL
    kernel_ms = start.elapsed_time(end) / timed_passes
    rate = segs_per_pass * timed_passes / wall

    # the plain version's first pass on the same draws: time and mean
    u = mega.u_planes_for_pass(state["key"], 0, cfg, n_l, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    plain = _plain(MK, mega, scene, cfg, u, torch.zeros_like(acc))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    mean_kernel = acc.double().mean().item() / passes
    mean_plain = plain.double().mean().item()
    rel = abs(mean_kernel - mean_plain) / abs(mean_plain)
    img = pt.image(state, cfg)
    out = HERE / "build" / "chip_smoke_cornell_1024.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    write_png(str(out), img)
    print(f"phase 5 cornell {MAIN_W}x{MAIN_H} b{BOUNCES}, "
          f"{PASSES_PER_CALL} passes/call x {TIMED_CALLS} timed calls on "
          f"[{smi}]: {rate:.6g} ray segments/s ({segs_per_pass} per pass), "
          f"kernel {kernel_ms:.6g} ms/pass (CUDA events), wall "
          f"{wall * 1e3 / timed_passes:.6g} ms/pass; plain version "
          f"{plain_ms:.6g} ms/pass; launches {launches}; mean radiance/pass "
          f"kernel {mean_kernel:.7g} vs plain pass 0 {mean_plain:.7g} "
          f"(rel {rel:.3g}); image mean {img.mean().item():.6g} -> {out}; "
          f"under load after the timed calls: SM clock, max SM clock, "
          f"power, temperature = {clocks}")
    _check(rel <= 0.02, f"mean radiance differs by {rel:.3g} (> 2%)")

    # kernel-only times: tables packed once, CUDA events around the wrapper
    # alone (render_pass_mega repacks the tables on the host every call)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)

    def kernel_only_ms(u_planes, n_passes, reps):
        acc_k = torch.zeros_like(acc)
        kw = dict(spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
                  two_sided=cfg.two_sided_triangles,
                  normalize_emitter=cfg.normalize_emitter, seed=cfg.seed,
                  n_passes=n_passes)
        MK.pathtrace_pass(tables[0], ipar, *tables[1:], acc_k, u_planes, **kw)
        start.record()
        for _ in range(reps):
            MK.pathtrace_pass(tables[0], ipar, *tables[1:], acc_k, u_planes,
                              **kw)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * n_passes)

    k16 = kernel_only_ms(None, PASSES_PER_CALL, TIMED_CALLS)
    # the bound of a pass, from kernel 1's record of pass 0 (a launch
    # outside the main path's count)
    _, ids, occs = _record(MK, tables, ipar, torch.zeros_like(acc), None, cfg)
    n_s, n_t = tables[1].shape[0], tables[2].shape[0]
    work = _pass_work(ids, occs, n_l, n_s)
    ops = _k1_ops(work, n_s, n_t, n_l)
    bound = _bound(ops, 24 * cfg.total_rays + _table_bytes(tables))
    # the cost of making the draws in-kernel: PRNG route vs reading the same
    # pass's u-planes (96 B/ray), one pass per launch, in turns
    one = [kernel_only_ms(x, 1, 20) for x in (None, u, u, None)]
    print(f"phase 5 kernel only: {k16:.6g} ms/pass in {PASSES_PER_CALL}-pass "
          f"launches (main path {kernel_ms:.6g}: device idle share "
          f"{max(0.0, 1 - k16 / kernel_ms):.3%}); one pass per launch "
          f"(order PRNG, u, u, PRNG): PRNG route {one[0]:.6g} / "
          f"{one[3]:.6g} ms, u-planes route {one[1]:.6g} / {one[2]:.6g} ms")
    print(f"phase 5 bound: {ops / cfg.total_rays:.6g} FP32 operations per "
          f"ray and pass (OPS_* constants; {work['traced']:.0f} traced "
          f"segments, {work['shadow']:.0f} shadow rays per pass) -> "
          f"{bound['bound_ms']:.6g} ms per pass ({bound['bound_by']}); share "
          f"of the bound {bound['bound_ms'] / k16:.3%} (kernel only), "
          f"{bound['bound_ms'] / kernel_ms:.3%} (main path)")
    return {"launches": launches, "ms": kernel_ms, "plain_ms": plain_ms,
            **bound}


def _gate_stats(want, got) -> tuple:
    """One group's (finite, max |got - want|, plain norm, kernel norm,
    cosine, the plain's largest |entry|)."""
    import torch
    a, b = want.double().ravel(), got.double().ravel()
    err = (a - b).abs().max().item() if a.numel() else 0.0
    na, nb = a.norm().item(), b.norm().item()
    cos = (a @ b).item() / max(na * nb, 1e-300)
    scale = a.abs().max().item() if a.numel() else 0.0
    return bool(torch.isfinite(b).all()), err, na, nb, cos, scale


def _grad_gates(name: str, want, got, max_gate: bool) -> float:
    """Phase 6 gates of one group; returns max |got - want|."""
    finite, err, na, nb, cos, scale = _gate_stats(want, got)
    _check(finite, f"{name}: kernel 2 not finite")
    if na == 0.0:
        _check(nb == 0.0, f"{name}: plain gradient is 0, kernel's {nb:g}")
        return err
    print(f"    {name}: cosine {cos:.9f}, norm ratio {nb / na:.7f}, "
          f"max|d| {err:.6g} = {err / scale:.3g} x max|plain| {scale:.6g}")
    _check(cos >= 0.999, f"{name}: cosine {cos:.6f} < 0.999")
    _check(abs(nb / na - 1.0) <= 0.01, f"{name}: norm ratio {nb / na:.5f}")
    if max_gate:
        _check(err <= 5e-3 * scale, f"{name}: max|d| {err:g} > 5e-3 x "
               f"{scale:g}")
    return err


def kernel2_vs_plain(dev, name: str, w: int, h: int, wrt,
                     max_gate: bool, rr: bool = False) -> dict:
    """Phase 6 on one scene and size (phase 13 with ``rr``: the roulette
    from RR_START): kernel 2 (u-planes and PRNG routes) vs its plain
    version on the same tables, draws and random cotangent."""
    import numpy as np
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                       russian_roulette=rr, rr_start_depth=RR_START,
                       use_megakernel=True)
    scene = _cell_scene(name, w, h, dev)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], 0, cfg,
                               scene.lights.count, dev)
    g = torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=dev)
    kw = _pass_kw(cfg, diff_wrt=wrt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = MKG.pathtrace_pass_bwd_reference(tables[0], ipar, *tables[1:], g,
                                            u, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    got_u = MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], g, u, **kw)
    got_p = MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], g, None,
                                   **kw)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 5
    start.record()
    for _ in range(reps):
        MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], g, None, **kw)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    print(f"phase {13 if rr else 6} {name} {w}x{h} b{BOUNCES} wrt "
          f"{list(wrt)}{' with the roulette' if rr else ''}: plain "
          f"backward {plain_ms:.6g} ms, peak memory {peak / 2**30:.3f} GiB; kernel 2 "
          f"(PRNG route, random g) {ms:.6g} ms")
    err = 0.0
    names = MKG.DIFF_ALL
    for route, got in (("u-planes", got_u), ("PRNG", got_p)):
        print(f"  kernel 2 {route} route vs plain version:")
        for name, a, b in zip(names, want, got):
            if name in wrt:
                err = max(err, _grad_gates(name, a, b, max_gate))
            else:
                _check(not b.any().item(), f"{name} outside diff_wrt "
                       "is not zero")
    print("  PRNG route vs u-planes route:")
    for name, a, b in zip(names, got_u, got_p):
        if name in wrt:
            _grad_gates(name, a, b, max_gate)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def train_path(dev, smi: str) -> dict:
    """Phase 7: the training main path; returns the kernel-2 entry's
    launches and time."""
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                       mega_grad_wrt=TRAIN_WRT, use_megakernel=True)
    scene = cornell_box(cols=MAIN_W, rows=MAIN_H, device=dev)
    n_l = scene.lights.count
    segs = cfg.total_rays * (1 + n_l + cfg.bounces * (1 + n_l))
    params = {"center": scene.spheres.center.clone().requires_grad_(True),
              "radius": scene.spheres.radius.clone().requires_grad_(True),
              "materials": scene.materials.clone().requires_grad_(True)}
    seen = {}

    def step(state):
        sc = replace(scene, spheres=replace(scene.spheres,
                                            center=params["center"],
                                            radius=params["radius"]),
                     materials=params["materials"])
        st = pt.render_pass(sc, state, cfg)
        st["acc"].register_hook(lambda g: seen.__setitem__("g", g))
        loss = torch.mean(pt.image(st, cfg) ** 2)
        loss.backward()
        grads = {}
        with torch.no_grad():
            for name, p in params.items():
                grads[name] = p.grad
                p -= TRAIN_LR * p.grad
                p.grad = None
        return dict(st, acc=st["acc"].detach()), loss.detach(), grads

    state = pt.init_state(cfg, dev)
    state, loss0, _ = step(state)                       # warm-up
    torch.cuda.synchronize()
    MK.launches = MKG.launches = 0
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, loss, grads = step(state)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = MK.launches, MKG.launches
    _check(k1 == TRAIN_STEPS and k2 == TRAIN_STEPS,
           f"{k1} kernel-1 and {k2} kernel-2 launches for {TRAIN_STEPS} "
           "steps (want one each per step)")
    losses = torch.stack([loss0] + losses)
    _check(bool(torch.isfinite(losses).all()), "training loss not finite")
    for name in ("center", "materials", "radius"):
        gr = grads[name]
        _check(gr is not None and bool(torch.isfinite(gr).all()),
               f"{name} gradient missing or not finite")
    for name in ("center", "materials"):
        _check(bool(grads[name].any()), f"{name} gradient is zero")
    _check(state["passes"] == 1 + TRAIN_STEPS, f"passes {state['passes']}")

    # kernel 2 alone on the last step's own cotangent of acc
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([state["passes"] - 1, 0], dtype=torch.int32)
    kw = dict(spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
              two_sided=cfg.two_sided_triangles,
              normalize_emitter=cfg.normalize_emitter, seed=cfg.seed,
              diff_wrt=TRAIN_WRT)
    g = seen["g"].contiguous()
    MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], g, None, **kw)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 10
    start.record()
    for _ in range(reps):
        MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], g, None, **kw)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    live = (g != 0).any(-1)
    # the bound: kernel 2 replays the pass of each ray with g != 0 and
    # sweeps its taped segments back; the work from kernel 1's record of
    # the same pass (a launch outside the step's count)
    _, ids, occs = _record(MK, tables, ipar, torch.zeros_like(g), None, cfg)
    n_s, n_t = tables[1].shape[0], tables[2].shape[0]
    work = _pass_work(ids, occs, n_l, n_s, live)
    ops = _k1_ops(work, n_s, n_t, n_l) + _adj_ops(work, TRAIN_WRT)
    bound = _bound(ops, 12 * cfg.total_rays + 2 * _table_bytes(tables))
    live = live.double().mean().item()
    print(f"phase 7 train cornell {MAIN_W}x{MAIN_H} b{BOUNCES} wrt "
          f"{list(TRAIN_WRT)}, {TRAIN_STEPS} timed steps on [{smi}]: "
          f"{segs * TRAIN_STEPS / wall:.6g} fwd+bwd ray segments/s "
          f"({segs} per step), {wall * 1e3 / TRAIN_STEPS:.6g} ms/step; "
          f"launches kernel 1 {k1}, kernel 2 {k2}; kernel 2 alone on the "
          f"step's cotangent {ms:.6g} ms ({live:.3%} of rays with g != 0); "
          f"loss first {losses[0].item():.7g} last {losses[-1].item():.7g}; "
          f"|grad| center {grads['center'].norm().item():.6g} radius "
          f"{grads['radius'].norm().item():.6g} materials "
          f"{grads['materials'].norm().item():.6g}")
    print(f"phase 7 kernel 2 bound: {ops / work['rays']:.6g} FP32 operations "
          f"per ray with g != 0 (the pass's, plus the reverse sweep's "
          f"OPS_ADJ_* over {work['taped']:.0f} taped segments) -> "
          f"{bound['bound_ms']:.6g}"
          f" ms ({bound['bound_by']}); share of the bound "
          f"{bound['bound_ms'] / ms:.3%}")
    return {"launches": k2, "ms": ms, **bound}


def _seeded_rays(dev, n: int, seed: int, lo: float, hi: float):
    """n rays from uniform origins in [lo, hi]^3 in uniform directions,
    made with numpy from ``seed``: every 16th ray dead at INF, every 16th
    (offset 5) dead at t = 1, every 7th with the window [0.5, 4]."""
    import numpy as np
    import torch
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mint = np.zeros((n,), np.float32)
    maxt = np.full((n,), np.inf, np.float32)
    mint[::7], maxt[::7] = 0.5, 4.0
    mint[::16] = maxt[::16] = np.inf
    mint[5::16] = maxt[5::16] = 1.0
    return [torch.as_tensor(x, device=dev) for x in (o, d, mint, maxt)]


def _soup(n: int, seed: int):
    """A seeded triangle soup: centres in [-4, 4]^3, corners within 0.6."""
    import numpy as np
    from raytracing_tpu_torch.core.types import make_triangles
    g = np.random.default_rng(seed)
    v = (g.uniform(-4.0, 4.0, (n, 1, 3))
         + g.uniform(-0.6, 0.6, (n, 3, 3))).astype(np.float32)
    return make_triangles(v)


def hit_kernel_vs_plain(dev, name: str, search, plain, rays, rows,
                        *extra, test_ops: int, hit_ops: int,
                        walk_ops=None) -> dict:
    """Phase 8, one table: the kernel against its plain version on the
    same rays and packed rows; returns errors, times and the bound (every
    live ray tests every row at ``test_ops``, each hit adds ``hit_ops``;
    ``walk_ops``, where given, the tree walk's operations, and the bound
    takes the smaller count)."""
    import torch
    got_t, got_i = search(*rays, rows, *extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_t, want_i = plain(*rays, rows, *extra)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = _hold_search(name, (got_t, got_i), (want_t, want_i))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 10
    start.record()
    for _ in range(reps):
        search(*rays, rows, *extra)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    hits = (want_i >= 0).double().mean().item()
    n = rays[0].shape[0]
    live = (rays[2] != rays[3]).double().sum().item()
    brute = live * rows.shape[0] * test_ops
    ops = brute if walk_ops is None else min(brute, walk_ops)
    bound = _bound(ops + hits * n * hit_ops, 40 * n + 4 * rows.numel())
    walk = ("" if walk_ops is None else
            f" (the walk's count {walk_ops:.6g} operations against the "
            f"brute {brute:.6g})")
    print(f"phase 8 {name}: {rays[0].shape[0]} rays x {rows.shape[0]} "
          f"objects, {hits:.3%} hit; {errs['text']}; kernel "
          f"{ms:.6g} ms (CUDA events), plain {plain_ms:.6g} ms; bound "
          f"{bound['bound_ms']:.6g} ms ({bound['bound_by']}){walk}, share "
          f"{bound['bound_ms'] / ms:.3%}")
    _check(hits > 0.01, f"{name}: only {hits:.3%} of rays hit")
    return {"max_abs_err": errs["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, **bound}


def _hold_search(name: str, got, want) -> dict:
    """A search's (t, idx) against its plain version's: idx equal and t
    bit-equal on every ray. The kernels are written to equal their plain
    versions bit for bit (no FMA contraction; IEEE sqrt and division on
    both sides; the tree walk's champion the least (t, index) pair), and
    the card shows it, so the gates are exact."""
    import torch
    (got_t, got_i), (want_t, want_i) = got, want
    same_i = got_i == want_i
    idx_eq = same_i.double().mean().item()
    fin = same_i & torch.isfinite(want_t)
    dt = (got_t - want_t).abs()[fin]
    max_err = dt.max().item() if dt.numel() else 0.0
    rel = (dt / want_t.abs()[fin]).max().item() if dt.numel() else 0.0
    bit_eq = (same_i & ((got_t == want_t) | (torch.isinf(got_t)
                                             & torch.isinf(want_t)))
              ).double().mean().item()
    _check(idx_eq == 1.0, f"{name}: idx equal on {idx_eq:.6%} (< 100%)")
    _check(bit_eq == 1.0, f"{name}: t bit-equal on {bit_eq:.6%} (< 100%)")
    return {"max_abs_err": max_err,
            "text": f"idx equal {idx_eq:.6%}, t bit-equal {bit_eq:.6%}, "
                    f"max|d t| {max_err:.6g} (rel {rel:.3g})"}


def _walk_ops(HK, rays, rows) -> float:
    """Kernel 4's tree walk on ``rays``, counted by its plain emulation
    (``HK.sphere_walk_reference``) on every SAMPLE_STRIDE-th ray and
    scaled: node tests at OPS_CHUNK (a slab test, as ``MK.tree_walk_work``
    prices it) and row tests at OPS_SPHERE_TEST."""
    work: dict = {}
    HK.sphere_walk_reference(*(x[::SAMPLE_STRIDE].contiguous()
                               for x in rays), HK.sphere_tree(rows), work)
    n = rays[0].shape[0]
    scale = n / -(-n // SAMPLE_STRIDE)
    return scale * (work.get("node_tests", 0) * OPS_CHUNK
                    + work.get("sph_tests", 0) * OPS_SPHERE_TEST)


def _tie_table(dev):
    """Phase 8's tie and masked table: sphere_field(N_SPHERES)'s rows with
    spheres 0, 15, 30, ... copied to the last TIE_COPIES rows (exact ties:
    a ray that hits one hits the other at the same t, and the lower index
    must win) and every 9th sphere masked off."""
    import torch
    from raytracing_tpu_torch.models.scenes import sphere_field
    from raytracing_tpu_torch.ops import hit_kernels as HK
    sp = sphere_field(N_SPHERES, device=dev).spheres
    c, r, m = sp.center.clone(), sp.radius.clone(), sp.mask.clone()
    m[::9] = False
    src = torch.arange(TIE_COPIES, device=dev) * 15
    dst = torch.arange(N_SPHERES - TIE_COPIES, N_SPHERES, device=dev)
    c[dst], r[dst], m[dst] = c[src], r[src], True
    return HK.sphere_rows(c, r, m)


def _tri_walk_ops(HK, rays, tree, two_sided: bool) -> float:
    """Kernel 5's tree walk on ``rays``, counted by its plain version
    (``HK.triangle_walk_reference``) on every SAMPLE_STRIDE-th ray and
    scaled: node tests at OPS_CHUNK and row tests (loose rows included)
    at OPS_TRIANGLE_TEST."""
    work: dict = {}
    HK.triangle_walk_reference(*(x[::SAMPLE_STRIDE].contiguous()
                                 for x in rays), tree, two_sided, work)
    n = rays[0].shape[0]
    scale = n / -(-n // SAMPLE_STRIDE)
    return scale * (work.get("node_tests", 0) * OPS_CHUNK
                    + work.get("tri_tests", 0) * OPS_TRIANGLE_TEST)


def _same_tree(got, want) -> bool:
    """Two trees (a build on the card and the torch build) element for
    element."""
    import torch
    return got.tree.leaf == want.tree.leaf and all(
        torch.equal(a, b) for a, b in zip((*got[:2], *got.tree[:3]),
                                          (*want[:2], *want.tree[:3])))


def _profiled_ms(run, key: str, reps: int = 10, events=None) -> tuple:
    """The device time per call of ``run`` in kernels named ``key``: their
    durations in torch.profiler's trace over ``reps`` calls
    ("profiler"), or where the trace holds no device time ``events()``
    or, without it, ``reps`` calls back to back between CUDA events
    ("events", the calls' host work included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if key in e.key)
    if us > 0:
        return us / reps / 1e3, "profiler"
    if events is not None:
        return events(), "events"
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, "events"


def hit_kernels_vs_plain(dev) -> tuple[dict, dict, dict, dict]:
    """Phase 8: kernels 4 and 5 against their plain versions; returns the
    kernel-4 tree entry (sphere_field(1024); the worst error of its three
    tables), its brute entry (cornell's 2 spheres, the shape of its main
    path), the kernel-5 tree entry (the soup, single-sided; the worst
    error of both sides) and its brute entry (cornell's 10 triangles)."""
    import torch
    from raytracing_tpu_torch.models.scenes import cornell_box, sphere_field
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.ops import megakernel as MK

    def k4(name, rays, rows, tree: bool):
        """The tree instance searches with the tree built once beforehand,
        as a stage pass does (its build timed apart)."""
        before = HK.sphere_tree_launches
        built = ()
        if tree:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            built = (HK.sphere_tree(rows),)
            torch.cuda.synchronize()
            print(f"phase 8 {name}: the tree's build "
                  f"{(time.perf_counter() - t0) * 1e3:.6g} ms (host clock, "
                  "synchronised)")
        out = hit_kernel_vs_plain(
            dev, name, lambda *a: HK.sphere_search_rows(*a, *built),
            HK.sphere_search_reference, rays, rows,
            test_ops=OPS_SPHERE_TEST, hit_ops=OPS_SPHERE_HIT - 18,
            walk_ops=_walk_ops(HK, rays, rows) if tree else None)
        _check((HK.sphere_tree_launches > before) == tree,
               f"{name}: the {'tree' if tree else 'brute'} instance did "
               "not run")
        return out

    rays = _seeded_rays(dev, HIT_RAYS, HIT_SEED, -6.0, 6.0)
    sp = sphere_field(N_SPHERES, device=dev).spheres
    k4t = k4(f"kernel 4 sphere_field({N_SPHERES}) (tree)", rays,
             HK.sphere_rows(sp.center, sp.radius, sp.mask), True)
    errs = [k4(f"kernel 4 sphere_field({N_SPHERES}), {TIE_COPIES} copies, "
               "every 9th masked (tree)", rays, _tie_table(dev),
               True)["max_abs_err"]]
    big = sphere_field(BIG_SPHERES, device=dev).spheres
    errs.append(k4(f"kernel 4 sphere_field({BIG_SPHERES}) (tree)",
                   _seeded_rays(dev, BIG_RAYS, HIT_SEED + 3, -6.0, 6.0),
                   HK.sphere_rows(big.center, big.radius, big.mask),
                   True)["max_abs_err"])
    k4t["max_abs_err"] = max([k4t["max_abs_err"], *errs])
    cornell = cornell_box(device=dev)
    room = _seeded_rays(dev, HIT_RAYS, HIT_SEED + 2, -0.95, 0.95)
    cs = cornell.spheres
    k4b = k4(f"kernel 4 cornell({cs.count}) (brute)", room,
             HK.sphere_rows(cs.center, cs.radius, cs.mask), False)

    # kernel 5 over the soup: the tree instance, its tree built on the card
    # once beforehand as a stage pass builds it, equal to the torch build
    soup = _soup(SOUP_TRIANGLES, HIT_SEED + 1).to(dev)
    rows = HK.triangle_rows(soup.v, soup.mask)
    _check(HK.TRIANGLE_BRUTE_MAX < rows.shape[0] <= MK.TREE_BUILD_MAX,
           "the soup must take kernel 5's tree instance and its one-launch "
           "build")
    builds = HK.triangle_build_launches
    tree = HK.pass_triangle_tree(soup.v, rows)
    torch.cuda.synchronize()
    _check(HK.triangle_build_launches == builds + 1,
           "the soup's tree was not built by one launch")
    _check(_same_tree(tree, HK.triangle_tree(soup.v, rows)),
           "the card's triangle tree differs from HK.triangle_tree")
    build_ms, clock = _profiled_ms(
        lambda: HK.triangle_tree_build(soup.v, rows), "triangle_tree_build")
    print(f"phase 8 kernel 5 soup({SOUP_TRIANGLES}): the tree's build on the "
          f"card equals HK.triangle_tree element for element; {build_ms:.6g} "
          f"ms per build ({clock}), leaves of {tree.tree.leaf} rows, "
          f"{int((tree.tree.loose >= 0).sum())} loose")
    k5t, errs = None, []
    for two_sided in (False, True):
        before = HK.triangle_tree_launches
        e = hit_kernel_vs_plain(
            dev, f"kernel 5 soup({SOUP_TRIANGLES}) two_sided={two_sided} "
            "(tree)",
            lambda o, d, lo, hi, r, ts: HK.triangle_search_rows(
                o, d, lo, hi, r, ts, tree),
            HK.triangle_search_reference, rays, rows, two_sided,
            test_ops=OPS_TRIANGLE_TEST, hit_ops=OPS_TRIANGLE_HIT - 26,
            walk_ops=_tri_walk_ops(HK, rays, tree, two_sided))
        _check(HK.triangle_tree_launches > before,
               "the soup's search did not run kernel 5's tree instance")
        errs.append(e["max_abs_err"])
        k5t = k5t or {**e, "build_ms": build_ms}
    k5t["max_abs_err"] = max(errs)
    tris = cornell.triangles
    before = HK.triangle_tree_launches
    k5b = hit_kernel_vs_plain(
        dev, f"kernel 5 cornell({tris.count}) (brute)",
        HK.triangle_search_rows, HK.triangle_search_reference, room,
        HK.triangle_rows(tris.v, tris.mask), False,
        test_ops=OPS_TRIANGLE_TEST, hit_ops=OPS_TRIANGLE_HIT - 26)
    _check(HK.triangle_tree_launches == before,
           "cornell's 10 triangles must take kernel 5's brute loop")
    return k4t, k4b, k5t, k5b


def _profile_split(run) -> str:
    """torch.profiler over ``run()``: device time in the hit kernels
    against all device time and the wall time, and the largest ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side entries (kernels, copies, fills), not the host ops that
    # launched them
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    rows.sort(key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in rows) / 1e3
    hit = sum(dev_us(e) for e in rows if "search_kernel" in e.key
              or "_tree_kernel" in e.key) / 1e3
    built = sum(dev_us(e) for e in rows if "tree_build_kernel" in e.key) / 1e3
    top = "; ".join(f"{e.key[:60]} x{e.count} {dev_us(e) / 1e3:.4g} ms"
                    for e in rows[:8])
    return (f"profiled pass {wall:.6g} ms wall: device busy {total:.6g} ms "
            f"({total / wall:.3%}), kernels 4+5 {hit:.6g} ms ({hit / wall:.3%}"
            f" of the pass), the trees' builds {built:.6g} ms; largest: "
            f"{top}")


def stage_main_path(dev, smi: str) -> dict:
    """Phase 9: the stage pipeline's main path on sphere_field(1024);
    returns the kernel-4 launches."""
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.io.png import write_png
    from raytracing_tpu_torch.models.scenes import sphere_field
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import pathtracer as pt
    from raytracing_tpu_torch.render.direct import render_direct

    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                       use_pallas=True)
    _check(not cfg.use_megakernel, "RenderConfig() must take the stage route")
    scene = sphere_field(N_SPHERES, cols=MAIN_W, rows=MAIN_H, device=dev)
    n_l = scene.lights.count
    segs_per_pass = cfg.total_rays * (1 + n_l + cfg.bounces * (1 + n_l))

    HK.sphere_launches = HK.sphere_tree_launches = HK.triangle_launches = 0
    MK.tree_build_launches = HK.torch_tree_builds = 0
    state = pt.render_passes(scene, pt.init_state(cfg, dev), cfg, 1)
    torch.cuda.synchronize()
    first = state["acc"].clone()
    t0 = time.perf_counter()
    for _ in range(STAGE_TIMED_CALLS):
        state = pt.render_passes(scene, state, cfg, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4, k4t = HK.sphere_launches, HK.sphere_tree_launches
    k5 = HK.triangle_launches
    builds, torch_builds = MK.tree_build_launches, HK.torch_tree_builds
    n_passes = 1 + STAGE_TIMED_CALLS
    _check(k4 == 12 * n_passes and k4t == k4 and k5 == 0,
           f"{k4} kernel-4 launches ({k4t} of the tree instance) and {k5} "
           f"kernel-5 launches for {n_passes} passes (want 12, all of the "
           "tree instance, and 0 per pass)")
    _check(builds == n_passes and torch_builds == 0,
           f"{builds} one-launch sphere-tree builds and {torch_builds} torch "
           f"builds for {n_passes} passes (want 1 and 0 per pass)")
    acc = state["acc"]
    _check(tuple(acc.shape) == (cfg.total_rays, 3), "acc shape")
    _check(bool(torch.isfinite(acc).all()), "stage acc not finite")
    _check(state["passes"] == n_passes, f"passes = {state['passes']}")
    ms = wall * 1e3 / STAGE_TIMED_CALLS
    rate = segs_per_pass * STAGE_TIMED_CALLS / wall

    # the same first pass through the all-pairs search (same draws)
    xcfg = replace(cfg, use_pallas=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    xla = pt.render_pass(scene, pt.init_state(xcfg, dev), xcfg)["acc"]
    torch.cuda.synchronize()
    xla_ms = (time.perf_counter() - t1) * 1e3
    mk, mx = first.double().mean().item(), xla.double().mean().item()
    rel = abs(mk - mx) / abs(mx)
    beyond = ((first - xla).abs() > TOL + TOL * xla.abs()).any(-1) \
        .double().mean().item()
    split = _profile_split(lambda: pt.render_passes(scene, state, cfg, 1))
    img = pt.image(state, cfg)
    out = HERE / "build" / "chip_smoke_spheres_1024.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    write_png(str(out), img)
    print(f"phase 9 stage route sphere_field({N_SPHERES}) {MAIN_W}x{MAIN_H} "
          f"b{BOUNCES} use_pallas on [{smi}]: {rate:.6g} ray segments/s "
          f"({segs_per_pass} per pass), {ms:.6g} ms/pass over "
          f"{STAGE_TIMED_CALLS} timed one-pass calls (host clock; with the "
          f"torch build of kernel 4's tree "
          f"{' / '.join(map(str, BEFORE_STAGE_MS['spheres']))} ms/pass); "
          f"launches kernel 4 {k4}, kernel 5 {k5}, the tree's build "
          f"{builds} for {n_passes} passes; first pass mean "
          f"radiance {mk:.9g} vs use_pallas=False {mx:.9g} (rel {rel:.3g}, "
          f"{beyond:.6%} of rays beyond {TOL:g}; that pass {xla_ms:.6g} "
          f"ms); image mean {img.mean().item():.6g} -> {out}")
    print(f"phase 9 {split}")
    _check(rel <= 0.02, f"mean radiance differs by {rel:.3g} (> 2%)")
    stage_searches_vs_plain(scene, cfg, dev)

    HK.sphere_launches = HK.triangle_launches = 0
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dimg = render_direct(scene, cfg)
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t2) * 1e3
    d4, d5 = HK.sphere_launches, HK.triangle_launches
    _check(d4 == 2 * n_l and d5 == 0,
           f"render_direct: {d4} kernel-4, {d5} kernel-5 launches")
    _check(bool(torch.isfinite(dimg).all()) and dimg.max().item() > 0,
           "direct image not finite or black")
    dout = HERE / "build" / "chip_smoke_spheres_direct_1024.png"
    write_png(str(dout), dimg)
    print(f"phase 9 render_direct {MAIN_W}x{MAIN_H}: {direct_ms:.6g} ms, "
          f"launches kernel 4 {d4}, kernel 5 {d5}; image mean "
          f"{dimg.mean().item():.6g} -> {dout}")
    return {"launches": k4t}


def _stage_searches(scene, cfg, dev,
                    fn: str = "sphere_search_rows") -> list:
    """The searches of one stage pass (pass 0) through the wrapper ``fn``
    of ``HK`` (kernel 4's, or kernel 5's ``triangle_search_rows``), in
    their order (a closest hit, then its shadow search, per segment):
    each search's arguments (o, d, mint, maxt, rows, [two_sided,] tree)
    and the kernel's (t, idx)."""
    import torch
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.render import pathtracer as pt
    search, seen = getattr(HK, fn), []

    def spy(*args):
        out = search(*args)
        seen.append((args, out))
        return out

    setattr(HK, fn, spy)
    try:
        pt.render_pass(scene, pt.init_state(cfg, dev), cfg)
    finally:
        setattr(HK, fn, search)
    torch.cuda.synchronize()
    return seen


def stage_searches_vs_plain(scene, cfg, dev) -> None:
    """Phase 9: two of a pass's real kernel-4 searches, the first
    bounce's closest hit (search 2) and its shadow search (search 3),
    against the plain version under phase 8's exact gates."""
    import torch
    from raytracing_tpu_torch.ops import hit_kernels as HK
    seen = _stage_searches(scene, cfg, dev)
    _check(len(seen) == 12, f"{len(seen)} kernel-4 searches in one pass")
    for k, what in ((2, "first bounce's closest hit"),
                    (3, "its shadow search")):
        (o, d, mint, maxt, rows, tree), got = seen[k]
        _check(tree is not None, f"search {k} walked no tree")
        t0 = time.perf_counter()
        want = HK.sphere_search_reference(o, d, mint, maxt, rows)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = _hold_search(f"phase 9 search {k}", got, want)
        live = (mint != maxt).double().mean().item()
        hits = (want[1] >= 0).double().mean().item()
        print(f"phase 9 search {k} ({what}): {o.shape[0]} rays, {live:.3%} "
              f"live, {hits:.3%} hit; {errs['text']}; plain {plain_ms:.6g} "
              "ms")


def stage_vs_megakernel(dev) -> dict:
    """Phase 10: the stage route against kernel 1 on cornell; returns the
    kernel-5 and kernel-4 launches."""
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                       use_pallas=True)
    scene = cornell_box(cols=MAIN_W, rows=MAIN_H, device=dev)
    HK.sphere_launches = HK.sphere_tree_launches = HK.triangle_launches = 0
    HK.triangle_tree_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pt.render_pass(scene, pt.init_state(cfg, dev), cfg)["acc"]
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    k4, k5 = HK.sphere_launches, HK.triangle_launches
    _check(HK.sphere_tree_launches == 0 and HK.triangle_tree_launches == 0,
           "cornell's 2 spheres and 10 triangles must take kernels 4 and "
           "5's brute loops")
    mcfg = replace(cfg, use_megakernel=True)
    k1 = MK.launches
    want = pt.render_pass(scene, pt.init_state(mcfg, dev), mcfg)["acc"]
    torch.cuda.synchronize()
    k1 = MK.launches - k1
    err = (got - want).abs()
    beyond = (err > TOL + TOL * want.abs()).any(-1).double().mean().item()
    gm, wm = got.double().mean().item(), want.double().mean().item()
    rel = abs(gm - wm) / abs(wm)
    print(f"phase 10 cornell {MAIN_W}x{MAIN_H} b{BOUNCES}, pass 0: stage "
          f"route (kernels 4 + 5, {stage_ms:.6g} ms) vs kernel 1: max|d acc| "
          f"{err.max().item():.6g}, rays beyond {TOL:g}: {beyond:.6%}, mean "
          f"acc stage {gm:.9g} kernel 1 {wm:.9g} (rel {rel:.3g}); launches "
          f"kernel 4 {k4}, kernel 5 {k5}, kernel 1 {k1}")
    _check(k4 == 12 and k5 == 12 and k1 == 1,
           f"launches: kernel 4 {k4}, kernel 5 {k5} (want 12 each), kernel "
           f"1 {k1} (want 1)")
    _check(bool(torch.isfinite(got).all()), "stage acc not finite")
    _check(beyond <= 0.01, f"{beyond:.4%} of rays beyond {TOL:g} (> 1%)")
    _check(rel <= 1e-5, f"mean acc differs by {rel:.3g} relative (> 1e-5)")
    return {"launches": k5, "k4_launches": k4}


def stage_torus(dev, smi: str) -> dict:
    """Phase 24: the stage pipeline's main path on the torus scene
    (cornell plus the torus of TORUS_SEGMENTS, 1,002 triangles, no grids:
    BENCH_MEGA=0 on the teapot's stand-in), MAIN_W x MAIN_H b5,
    use_pallas=True; returns kernel 5's tree launches, its tree builds, the
    torch build's host ms and the 12 searches' ms."""
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import pathtracer as pt
    from raytracing_tpu_torch.render import stages

    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                       use_pallas=True)
    scene = _stream_scene("torus", MAIN_W, MAIN_H, dev)
    n_l = scene.lights.count
    segs_per_pass = cfg.total_rays * (1 + n_l + cfg.bounces * (1 + n_l))
    HK.triangle_launches = HK.triangle_tree_launches = 0
    HK.triangle_build_launches = HK.torch_tree_builds = 0
    state = pt.render_passes(scene, pt.init_state(cfg, dev), cfg, 1)
    torch.cuda.synchronize()
    first = state["acc"].clone()
    t0 = time.perf_counter()
    for _ in range(STAGE_TIMED_CALLS):
        state = pt.render_passes(scene, state, cfg, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5, k5t = HK.triangle_launches, HK.triangle_tree_launches
    builds, torch_builds = HK.triangle_build_launches, HK.torch_tree_builds
    n_passes = 1 + STAGE_TIMED_CALLS
    _check(k5 == 12 * n_passes and k5t == k5,
           f"{k5} kernel-5 launches ({k5t} of the tree instance) for "
           f"{n_passes} passes (want 12 per pass, all of the tree instance)")
    _check(builds == n_passes and torch_builds == 0,
           f"{builds} one-launch triangle-tree builds and {torch_builds} "
           f"torch builds for {n_passes} passes (want 1 and 0 per pass)")
    acc = state["acc"]
    _check(tuple(acc.shape) == (cfg.total_rays, 3), "acc shape")
    _check(bool(torch.isfinite(acc).all()), "stage acc not finite")
    ms = wall * 1e3 / STAGE_TIMED_CALLS
    rate = segs_per_pass * STAGE_TIMED_CALLS / wall

    # the first pass against kernel 1's streamed route (row 1'), the same
    # pass key, phase 10's gates
    mcfg = replace(cfg, use_megakernel=True)
    k1 = MK.stream_launches
    want = pt.render_pass(scene, pt.init_state(mcfg, dev), mcfg)["acc"]
    torch.cuda.synchronize()
    k1 = MK.stream_launches - k1
    err = (first - want).abs()
    beyond = (err > TOL + TOL * want.abs()).any(-1).double().mean().item()
    gm, wm = first.double().mean().item(), want.double().mean().item()
    rel = abs(gm - wm) / abs(wm)

    # the torch build of the pass's tree (past MK.TREE_BUILD_MAX rows it is
    # the pass's own), host clock, synchronised
    tris = stages._all_triangles(scene)
    rows = HK.triangle_rows(tris.v, tris.mask)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want_tree = HK.triangle_tree(tris.v, rows)
    torch.cuda.synchronize()
    torch_ms = (time.perf_counter() - t1) * 1e3
    tree = HK.triangle_tree_build(tris.v, rows)
    _check(_same_tree(tree, want_tree), "the card's triangle tree of the "
           "torus scene differs from HK.triangle_tree")
    build_ms, clock = _profiled_ms(
        lambda: HK.triangle_tree_build(tris.v, rows), "triangle_tree_build")
    # bytes: the rows and vertices read once, the tree written once;
    # operations: per row its box (6) and code (15), per node its box (6)
    build_bound = _bound(
        21 * rows.shape[0] + 6 * tree.tree.nodes.shape[0],
        4 * (rows.numel() + tris.v.numel() + sum(x.numel() for x in (
            tree.rows, tree.perm, tree.tree.nodes, tree.tree.masks,
            tree.tree.loose))))
    split = _profile_split(lambda: pt.render_passes(scene, state, cfg, 1))
    print(f"phase 24 stage route cornell + torus ({tris.count} triangles) "
          f"{MAIN_W}x{MAIN_H} b{BOUNCES} use_pallas on [{smi}]: {rate:.6g} "
          f"ray segments/s ({segs_per_pass} per pass), {ms:.6g} ms/pass over "
          f"{STAGE_TIMED_CALLS} timed one-pass calls (host clock; before "
          f"kernel 5's tree {' / '.join(map(str, BEFORE_STAGE_MS['torus']))}"
          f" ms/pass); launches kernel 5 {k5} ({k5t} of the tree instance), "
          f"its tree's build "
          f"{builds} for {n_passes} passes ({build_ms:.6g} ms, {clock}; "
          f"bound {build_bound['bound_ms']:.6g} ms, {build_bound['bound_by']};"
          f" the torch build {torch_ms:.6g} ms, host clock); first pass vs "
          f"kernel 1's streamed "
          f"route ({k1} launch): max|d acc| {err.max().item():.6g}, rays "
          f"beyond {TOL:g}: {beyond:.6%}, mean acc stage {gm:.9g} kernel 1 "
          f"{wm:.9g} (rel {rel:.3g})")
    print(f"phase 24 {split}")
    _check(k1 == 1, f"kernel 1's streamed route: {k1} launches (want 1)")
    _check(beyond <= 0.01, f"{beyond:.4%} of rays beyond {TOL:g} (> 1%)")
    _check(rel <= 1e-5, f"mean acc differs by {rel:.3g} relative (> 1e-5)")

    # two of the first pass's searches held to the plain version, the 12
    # timed on their own inputs
    seen = _stage_searches(scene, cfg, dev, "triangle_search_rows")
    _check(len(seen) == 12, f"{len(seen)} kernel-5 searches in one pass")
    _check(all(a[6] is seen[0][0][6] and a[6] is not None for a, _ in seen),
           "the pass's searches did not share one tree")
    for k, what in ((2, "first bounce's closest hit"),
                    (3, "its shadow search")):
        (o, d, mint, maxt, rows, ts, tree), got = seen[k]
        t0 = time.perf_counter()
        want = HK.triangle_search_reference(o, d, mint, maxt, rows, ts)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = _hold_search(f"phase 24 search {k}", got, want)
        live = (mint != maxt).double().mean().item()
        hits = (want[1] >= 0).double().mean().item()
        print(f"phase 24 search {k} ({what}): {o.shape[0]} rays, "
              f"{live:.3%} live, {hits:.3%} hit; {errs['text']}; plain "
              f"{plain_ms:.6g} ms")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 5
    search_ms = []
    for args, _ in seen:
        HK.triangle_search_rows(*args)
        start.record()
        for _ in range(reps):
            HK.triangle_search_rows(*args)
        end.record()
        torch.cuda.synchronize()
        search_ms.append(start.elapsed_time(end) / reps)
    print(f"phase 24 kernel 5's 12 searches of the pass on their own inputs: "
          f"{sum(search_ms):.6g} ms ("
          + ", ".join(f"{x:.4g}" for x in search_ms) + ")")
    return {"launches": k5t, "search_ms": sum(search_ms), "ms": ms,
            "build": {"launches": builds, "max_abs_err": 0.0, "ms": build_ms,
                      "clock": clock, "plain_ms": torch_ms, **build_bound}}


def _record(MK, tables, ipar, acc, u, cfg, build_flags=()):
    """Kernel 1 recording one pass: (acc, ids, occs)."""
    return MK.pathtrace_pass(tables[0], ipar, *tables[1:], acc, u,
                             record=True, build_flags=build_flags,
                             **_pass_kw(cfg))


def _cell_scene(name: str, w: int, h: int, dev):
    from raytracing_tpu_torch.models.scenes import cornell_box, sphere_field
    if name == "cornell":
        return cornell_box(cols=w, rows=h, device=dev)
    n = int(name.split("(")[1].rstrip(")"))
    return sphere_field(n, cols=w, rows=h, device=dev)


# kernel 1 (contracted) recording vs plain on sphere fields. Sound readings
# and those of kernel 1 skipping one visible sphere (a faulty loop bound),
# on one H100 80GB HBM3 (PERF.md): first-segment ids 0.0020-0.0049% of
# rays sound, 0.11-0.37% faulty; mean 4.2e-4..2.36e-3 sound, 0.025-0.11
# with sphere 0 skipped (about 1e-3 with a smaller one). Rays beyond 2e-4
# (1.35-2.32% sound, 1.52-2.49% faulty) and all id slots (0.07-0.35%
# sound, 0.12-0.64% faulty) do not tell the two apart, so they only bound
# the noise.
SPHERE_GATES = {"ids0": 2e-4, "rel": 5e-3, "beyond": 0.05, "ids": 0.01}


def _plain_record(MK, tables, ipar, zeros, u, cfg, work=None):
    """Kernel 1's plain version of a recording pass on the route the kernel
    takes: past MK.SPH_BRUTE_MAX["path"] resident spheres the plain walk of
    the sphere tree (MK.pathtrace_walk_reference, which equals the brute
    plain version on every value: tests/test_torch_path_walk.py, and
    counts the walk into ``work``), else the brute plain version."""
    kw = dict(record=True, **_pass_kw(cfg))
    if MK.sphere_walks(tables[1]):
        return MK.pathtrace_walk_reference(tables[0], ipar, *tables[1:],
                                           zeros, u, work=work, **kw)
    return MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:], zeros,
                                       u, **kw)


def _path_walk_ops(w: dict, work: dict, n_tri: int, n_lig: int) -> float:
    """FP32 operations of a path pass whose sphere loops are the tree's
    walk (``work``: node tests at OPS_CHUNK, a slab test, and row tests at
    OPS_SPHERE_TEST, as kernel 4's and direct mode's walks are priced)
    over the record's work w; the rest as _k1_ops counts it."""
    tri = n_tri * OPS_TRIANGLE_TEST
    return (w["rays"] * OPS_CAMERA + w["traced"] * (OPS_TRACE + tri)
            + work.get("node_tests", 0) * OPS_CHUNK
            + work.get("sph_tests", 0) * OPS_SPHERE_TEST
            + w["sph_hits"] * OPS_SPHERE_HIT
            + w["tri_hits"] * OPS_TRIANGLE_HIT
            + w["primary"] * n_lig * OPS_EMITTER + w["shadow"] * OPS_NEE
            + w["free"] * tri + w["bounces"] * OPS_BOUNCE
            + w["rr"] * OPS_RR)


def _walk_bound(tables, ids, occs, cfg, work: dict) -> dict:
    """The bound of a recording pass whose record is (ids, occs): the
    smaller of the brute count's (_k1_ops) and the walk's (_path_walk_ops
    over ``work``), bytes as _record_bound's. Both bounds are kept beside
    it."""
    n_s, n_t, n_l = (t.shape[0] for t in tables[1:3] + tables[4:5])
    w = _pass_work(ids, occs, n_l, n_s)
    nbytes = ((24 + (1 + cfg.bounces) * (4 + n_l)) * cfg.total_rays
              + _table_bytes(tables))
    brute = _bound(_k1_ops(w, n_s, n_t, n_l), nbytes)
    walk = _bound(_path_walk_ops(w, work, n_t, n_l), nbytes)
    best = walk if walk["bound_ms"] < brute["bound_ms"] else brute
    rays = max(w["rays"], 1)
    return dict(best, walk_bound_ms=walk["bound_ms"],
                brute_bound_ms=brute["bound_ms"],
                node_tests_per_ray=work.get("node_tests", 0) / rays,
                sph_tests_per_ray=work.get("sph_tests", 0) / rays)


def _tree_build_device_ms(MK, rows, reps: int = 10) -> tuple:
    """The sphere tree's build kernel alone, ms of device time per build:
    its durations in torch.profiler's trace over ``reps`` wrapper calls
    ("profiler"), or where the trace holds no device time its C entry
    back to back between CUDA events ("events", _build_device_ms)."""
    return _profiled_ms(lambda: MK.sphere_tree_build(rows, MK.SPH_TREE_LEAF),
                        "sphere_tree", reps,
                        lambda: _build_device_ms(None, MK, rows, reps))


def path_walk_vs_brute(dev, smi: str) -> dict:
    """Phase 11, kernel 1's path mode over the sphere tree (row 1s) on
    sphere_field(N_SPHERES) at MAIN_W x MAIN_H b5: the tree instances (the
    route past MK.SPH_BRUTE_MAX["path"]) equal to the brute instances
    (forced through sphere_walk=False), path and the roulette (from
    RR_START), recording and not, in the default and the --fmad=false
    builds: acc, ids and occs with torch.equal, fatal; then the recording
    pass through the tree (its build included) and through the brute
    instance in turns (CUDA events) and the build's device time."""
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega

    base = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                        use_megakernel=True)
    scene = _cell_scene(f"sphere_field({N_SPHERES})", MAIN_W, MAIN_H, dev)
    t = mega.scene_tables(scene, base)
    _check(MK.sphere_walks(t[1]), f"{N_SPHERES} spheres do not take the "
           f"walk (SPH_BRUTE_MAX {MK.SPH_BRUTE_MAX})")
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    zeros = torch.zeros((base.total_rays, 3), device=dev)
    same = {}
    for flags in ((), EXACT_FLAGS):
        for rr in (False, True):
            cfg = replace(base, russian_roulette=rr,
                          rr_start_depth=RR_START if rr else 0)
            kw = _pass_kw(cfg, build_flags=flags)
            rec = {walk: MK.pathtrace_pass(t[0], ipar, *t[1:], zeros.clone(),
                                           None, record=True,
                                           sphere_walk=walk, **kw)
                   for walk in (None, False)}
            acc = {walk: MK.pathtrace_pass(t[0], ipar, *t[1:], zeros.clone(),
                                           None, sphere_walk=walk, **kw)
                   for walk in (None, False)}
            ok = (all(torch.equal(a, b) for a, b in zip(rec[None],
                                                        rec[False]))
                  and torch.equal(acc[None], acc[False])
                  and torch.equal(acc[None], rec[None][0]))
            same[f"{'rr' if rr else 'path'} {flags or 'default'}"] = ok
            _check(ok, f"the tree instance differs from the brute instance "
                   f"(roulette {rr}, build flags {flags})")
    kw = _pass_kw(base)
    ms = {None: [], False: []}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for walk in (None, False, False, None):
        MK.pathtrace_pass(t[0], ipar, *t[1:], zeros.clone(), None,
                          record=True, sphere_walk=walk, **kw)
        start.record()
        for _ in range(5):
            MK.pathtrace_pass(t[0], ipar, *t[1:], zeros.clone(), None,
                              record=True, sphere_walk=walk, **kw)
        end.record()
        torch.cuda.synchronize()
        ms[walk].append(start.elapsed_time(end) / 5)
    build_ms, clock = _tree_build_device_ms(MK, t[1])
    print(f"phase 11 kernel 1 path mode over the sphere tree, "
          f"sphere_field({N_SPHERES}) {MAIN_W}x{MAIN_H} b{BOUNCES}: tree == "
          f"brute instance (acc, ids, occs; recording and not) {same}; "
          f"recording through the tree (its build included) "
          f"{[round(x, 6) for x in ms[None]]} ms, through the brute "
          f"instance {[round(x, 6) for x in ms[False]]} ms; the build alone "
          f"{build_ms:.6g} ms of device time ({clock}); on [{smi}]")
    return {"ms": min(ms[None]), "brute_ms": min(ms[False]),
            "build_ms": build_ms, "build_clock": clock}


def record_vs_plain(dev, smi: str) -> dict:
    """Phase 11, kernel 1's recording mode: bit-equal to the plain launch
    at the main path's size; against its plain version on the same
    u-planes, as built and as built with --fmad=false (which must equal it
    on every ray, champion and bit), at the main path's size and at
    256x192; on the sphere fields past MK.SPH_BRUTE_MAX["path"] the route
    walks the sphere tree and its plain version is the plain walk
    (_plain_record), whose count gives row 1s's bound. Returns row 1s's
    entry (path_walk_vs_brute's timings, the bound, the plain walk's ms
    and the largest |d acc| of the default build on the sphere fields)."""
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                       use_megakernel=True)
    scene = _cell_scene(f"sphere_field({N_SPHERES})", MAIN_W, MAIN_H, dev)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    acc = torch.zeros((cfg.total_rays, 3), device=dev)
    norec = MK.pathtrace_pass(tables[0], ipar, *tables[1:], acc.clone(),
                              None, spp=cfg.spp, width=cfg.width,
                              bounces=cfg.bounces, two_sided=False,
                              normalize_emitter=True, seed=cfg.seed)
    rec, ids, occs = _record(MK, tables, ipar, acc.clone(), None, cfg)
    torch.cuda.synchronize()
    hit = (ids >= 0).double().mean(-1).tolist()
    print(f"phase 11 kernel 1 sphere_field({N_SPHERES}) {MAIN_W}x{MAIN_H} "
          f"b{BOUNCES}: recording vs not, max|d acc| "
          f"{(rec - norec).abs().max().item():g}; share of rays with a "
          f"champion per segment {[round(x, 6) for x in hit]}; occluded "
          f"share {occs.double().mean().item():.6g}")
    _check(torch.equal(rec, norec), "recording changes kernel 1's acc")
    _check(bool((ids >= -1).all()) and bool((ids < N_SPHERES).all()),
           "recorded ids outside [-1, n_sph)")
    row = path_walk_vs_brute(dev, smi)

    errs = []
    for name, w, h in ((f"sphere_field({N_SPHERES})", MAIN_W, MAIN_H),
                       (f"sphere_field({SMALL_SPHERES})", SMALL_W, SMALL_H),
                       ("cornell", SMALL_W, SMALL_H)):
        cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                           use_megakernel=True)
        scene = _cell_scene(name, w, h, dev)
        tables = mega.scene_tables(scene, cfg)
        u = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], 0, cfg,
                                   scene.lights.count, dev)
        zeros = torch.zeros((cfg.total_rays, 3), device=dev)
        work: dict = {}
        t0 = time.perf_counter()
        want = _plain_record(MK, tables, ipar, zeros, u, cfg, work)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        how = "plain walk" if work else "plain"
        got = _record(MK, tables, ipar, zeros.clone(), u, cfg)
        exact = _record(MK, tables, ipar, zeros.clone(), u, cfg, EXACT_FLAGS)
        torch.cuda.synchronize()
        for build, r in (("kernel 1", got), ("--fmad=false build", exact)):
            d = _record_diff(r, want)
            print(f"phase 11 {build} recording vs {how} ({plain_ms:.6g} "
                  f"ms), {name} {w}x{h} b{BOUNCES}: max|d acc| "
                  f"{d['max']:.6g}, rays beyond {TOL:g}: {d['beyond']:.6%}, "
                  f"mean acc rel {d['rel']:.3g}; ids differ on "
                  f"{d['ids']:.6%} of slots ({d['ids0']:.6%} of first "
                  f"segments), occlusion bits on {d['occs']:.6%}")
            _check(bool(torch.isfinite(r[0]).all()), f"{name}: acc")
        d, dx = _record_diff(got, want), _record_diff(exact, want)
        _check(dx["beyond"] == 0.0 and dx["ids"] == 0.0 and dx["occs"] == 0.0,
               f"{name}: the --fmad=false build differs from the plain "
               "version")
        if name == "cornell":
            _check(d["beyond"] <= 0.01, f"{name}: {d['beyond']:.4%} of rays "
                   f"beyond {TOL:g}")
            _check(d["rel"] <= 1e-5, f"{name}: mean acc differs by "
                   f"{d['rel']:.3g}")
        else:
            errs.append(d["max"])
            _check(all(d[k] <= lim for k, lim in SPHERE_GATES.items()),
                   f"{name}: kernel 1 vs plain {d}, limits {SPHERE_GATES}")
        if w == MAIN_W:
            # row 1s's bound on this pass (the u-planes are the draws of
            # the timed PRNG pass 0): the smaller of the brute count's and
            # the walk's
            _check(bool(work), f"{name}: the route does not walk the tree")
            bound = _walk_bound(tables, want[1], want[2], cfg, work)
            row.update(bound, plain_ms=plain_ms)
            print(f"phase 11 row 1s bound, {name} {w}x{h} b{BOUNCES}: the "
                  f"walk's count {bound['node_tests_per_ray']:.6g} node "
                  f"tests and {bound['sph_tests_per_ray']:.6g} row tests "
                  f"per ray, {work.get('union_leaves', 0)} leaves of the "
                  f"warps' unions -> {bound['walk_bound_ms']:.6g} ms; the "
                  f"brute count's {bound['brute_bound_ms']:.6g} ms; bound "
                  f"{bound['bound_ms']:.6g} ms ({bound['bound_by']}), share "
                  f"{bound['bound_ms'] / row['ms']:.3%} of the tree's "
                  f"{row['ms']:.6g} ms, of the brute instance's "
                  f"{bound['bound_ms'] / row['brute_ms']:.3%}")
    row["max_abs_err"] = max(errs)
    return row


def _record_diff(got, want) -> dict:
    """Kernel 1's record (acc, ids, occs) against the plain version's."""
    err = (got[0] - want[0]).abs()
    gm, wm = got[0].double().mean().item(), want[0].double().mean().item()
    return {"max": err.max().item(),
            "beyond": (err > TOL + TOL * want[0].abs()).any(-1).double()
            .mean().item(),
            "rel": abs(gm - wm) / abs(wm),
            "ids": (got[1] != want[1]).double().mean().item(),
            "ids0": (got[1][0] != want[1][0]).double().mean().item(),
            "occs": (got[2] != want[2]).double().mean().item()}


def kernel3_vs_plain(dev, name: str, w: int, h: int, wrt,
                     max_gate: bool, rr: bool = False) -> dict:
    """Phase 11 (phase 13 with ``rr``: the roulette from RR_START): kernel
    3 (PRNG and u-planes routes) vs its plain version on kernel 1's own
    record and a seeded random cotangent."""
    import numpy as np
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                       russian_roulette=rr, rr_start_depth=RR_START,
                       use_megakernel=True)
    scene = _cell_scene(name, w, h, dev)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], 0, cfg,
                               scene.lights.count, dev)
    _, ids, occs = _record(MK, tables, ipar,
                           torch.zeros((cfg.total_rays, 3), device=dev),
                           None, cfg)
    g = torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=dev)
    kw = _pass_kw(cfg, diff_wrt=wrt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = MKG.pathtrace_pass_bwd_champ_reference(
        tables[0], ipar, *tables[1:], g, u, ids, occs, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_u = MKG.pathtrace_pass_bwd_champ(tables[0], ipar, *tables[1:], g, u,
                                         ids, occs, **kw)
    got_p = MKG.pathtrace_pass_bwd_champ(tables[0], ipar, *tables[1:], g,
                                         None, ids, occs, **kw)
    torch.cuda.synchronize()
    print(f"phase {13 if rr else 11} kernel 3 vs plain, {name} {w}x{h} "
          f"b{BOUNCES} wrt {list(wrt)}{' with the roulette' if rr else ''}: "
          f"plain champion backward {plain_ms:.6g} ms")
    err = 0.0
    for route, got in (("u-planes", got_u), ("PRNG", got_p)):
        print(f"  kernel 3 {route} route vs plain version:")
        for gname, a, b in zip(MKG.DIFF_ALL, want, got):
            if gname in wrt:
                err = max(err, _grad_gates(gname, a, b, max_gate))
            else:
                _check(not b.any().item(), f"{gname} outside diff_wrt "
                       "is not zero")
    return {"max_abs_err": err, "plain_ms": plain_ms}


def kernel3_vs_kernel2(dev, w: int, h: int, wrt, max_gate: bool,
                       rr: bool = False) -> None:
    """Phase 11 (phase 13 with ``rr``): kernel 3 on kernel 1's record vs
    kernel 2 on cornell, the same cotangent (phase 6's gates for kernel 2
    vs plain)."""
    import numpy as np
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.render import mega

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                       russian_roulette=rr, rr_start_depth=RR_START,
                       use_megakernel=True)
    scene = _cell_scene("cornell", w, h, dev)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    _, ids, occs = _record(MK, tables, ipar,
                           torch.zeros((cfg.total_rays, 3), device=dev),
                           None, cfg)
    g = torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=dev)
    kw = _pass_kw(cfg, diff_wrt=wrt)
    k2 = MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], g, None, **kw)
    k3 = MKG.pathtrace_pass_bwd_champ(tables[0], ipar, *tables[1:], g, None,
                                      ids, occs, **kw)
    torch.cuda.synchronize()
    print(f"phase {13 if rr else 11} kernel 3 vs kernel 2, cornell {w}x{h} "
          f"b{BOUNCES}, wrt {list(wrt)}{' with the roulette' if rr else ''}"
          f", random g:")
    for gname, a, b in zip(MKG.DIFF_ALL, k2, k3):
        if gname in wrt:
            _grad_gates(gname, a, b, max_gate)


def train_cell_path(dev, smi: str) -> dict:
    """Phase 12: the cell route's training main path; returns the kernel-3
    entry's launches and times."""
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                       mega_grad_wrt=TRAIN_WRT, mega_bwd_impl="auto",
                       use_megakernel=True)
    scene = _cell_scene(f"sphere_field({N_SPHERES})", MAIN_W, MAIN_H, dev)
    _check(mega.bwd_impl_for(scene, cfg) == "cell",
           "sphere_field(1024) does not take the cell route")
    n_l = scene.lights.count
    segs = cfg.total_rays * (1 + n_l + cfg.bounces * (1 + n_l))
    params = {"center": scene.spheres.center.clone().requires_grad_(True),
              "radius": scene.spheres.radius.clone().requires_grad_(True),
              "materials": scene.materials.clone().requires_grad_(True)}
    seen = {}

    def step(state):
        sc = replace(scene, spheres=replace(scene.spheres,
                                            center=params["center"],
                                            radius=params["radius"]),
                     materials=params["materials"])
        st = pt.render_pass(sc, state, cfg)
        st["acc"].register_hook(lambda g: seen.__setitem__("g", g))
        loss = torch.mean(pt.image(st, cfg) ** 2)
        loss.backward()
        grads = {}
        with torch.no_grad():
            for name, p in params.items():
                grads[name] = p.grad
                p -= TRAIN_LR * p.grad
                p.grad = None
        return dict(st, acc=st["acc"].detach()), loss.detach(), grads

    state = pt.init_state(cfg, dev)
    state, loss0, _ = step(state)                       # warm-up
    torch.cuda.synchronize()
    MK.launches = MKG.launches = MKG.champ_launches = 0
    MKG.order_launches = MK.path_walk_launches = MK.tree_build_launches = 0
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, loss, grads = step(state)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2, k3 = MK.launches, MKG.launches, MKG.champ_launches
    n_order = MKG.order_launches
    walks, builds = MK.path_walk_launches, MK.tree_build_launches
    _check(k1 == TRAIN_STEPS and k3 == TRAIN_STEPS and k2 == 0,
           f"{k1} kernel-1, {k3} kernel-3 and {k2} kernel-2 launches for "
           f"{TRAIN_STEPS} steps (want one, one and none per step)")
    _check(n_order == TRAIN_STEPS, f"{n_order} builds of kernel 3's ray "
           f"order for {TRAIN_STEPS} steps (want one per step)")
    # past SPH_BRUTE_MAX["path"] kernel 1 walks a sphere tree, built once
    # per step by its recording forward
    _check(walks == TRAIN_STEPS and builds == TRAIN_STEPS,
           f"{walks} kernel-1 launches walking a sphere tree and {builds} "
           f"tree builds for {TRAIN_STEPS} steps (want one each per step)")
    losses = torch.stack([loss0] + losses)
    _check(bool(torch.isfinite(losses).all()), "training loss not finite")
    for name in ("center", "materials", "radius"):
        gr = grads[name]
        _check(gr is not None and bool(torch.isfinite(gr).all()),
               f"{name} gradient missing or not finite")
    for name in ("center", "materials"):
        _check(bool(grads[name].any()), f"{name} gradient is zero")
    _check(state["passes"] == 1 + TRAIN_STEPS, f"passes {state['passes']}")

    # kernels 1 (recording) and 3 alone on the last step's pass and
    # cotangent, with the parameters that step used
    sc = replace(scene, spheres=replace(
        scene.spheres, center=params["center"].detach(),
        radius=params["radius"].detach()),
        materials=params["materials"].detach())
    tables = mega.scene_tables(sc, cfg)
    ipar = torch.tensor([state["passes"] - 1, 0], dtype=torch.int32)
    kw = dict(spp=cfg.spp, width=cfg.width, bounces=cfg.bounces,
              two_sided=cfg.two_sided_triangles,
              normalize_emitter=cfg.normalize_emitter, seed=cfg.seed)
    g = seen["g"].contiguous()
    acc = torch.zeros_like(g)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 10
    _, ids, occs = _record(MK, tables, ipar, acc, None, cfg)
    start.record()
    for _ in range(reps):
        _record(MK, tables, ipar, acc, None, cfg)
    end.record()
    torch.cuda.synchronize()
    k1_ms = start.elapsed_time(end) / reps
    MKG.pathtrace_pass_bwd_champ(tables[0], ipar, *tables[1:], g, None, ids,
                                 occs, diff_wrt=TRAIN_WRT, **kw)
    start.record()
    for _ in range(reps):
        got = MKG.pathtrace_pass_bwd_champ(tables[0], ipar, *tables[1:], g,
                                           None, ids, occs,
                                           diff_wrt=TRAIN_WRT, **kw)
    end.record()
    torch.cuda.synchronize()
    k3_ms = start.elapsed_time(end) / reps
    order = _order_phase(MKG, tables, ids, g)
    t1 = time.perf_counter()
    want = MKG.pathtrace_pass_bwd_champ_reference(
        tables[0], ipar, *tables[1:], g, None, ids, occs, diff_wrt=TRAIN_WRT,
        **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    _, k3_bound, ops = _cell_bounds(tables, ids, occs, g, cfg)
    live = (g != 0).any(-1).double().mean().item()
    print(f"phase 12 train sphere_field({N_SPHERES}) {MAIN_W}x{MAIN_H} "
          f"b{BOUNCES} wrt {list(TRAIN_WRT)}, cell route, {TRAIN_STEPS} timed "
          f"steps on [{smi}]: {segs * TRAIN_STEPS / wall:.6g} fwd+bwd ray "
          f"segments/s ({segs} per step), {wall * 1e3 / TRAIN_STEPS:.6g} "
          f"ms/step; launches kernel 1 {k1} (walking the sphere tree "
          f"{walks}, tree builds {builds}), kernel 3 {k3}, kernel 2 {k2}; "
          f"alone on the last step's pass: kernel 1 recording {k1_ms:.6g} ms, "
          f"kernel 3 {k3_ms:.6g} ms ({live:.3%} of rays with g != 0), plain "
          f"champion backward {plain_ms:.6g} ms; loss first "
          f"{losses[0].item():.7g} last {losses[-1].item():.7g}; |grad| "
          f"center {grads['center'].norm().item():.6g} radius "
          f"{grads['radius'].norm().item():.6g} materials "
          f"{grads['materials'].norm().item():.6g}")
    print(f"phase 12 bound on that pass (kernel 1 recording's: phase 11's "
          f"row 1s): kernel 3 {ops[1]:.6g} FP32 operations per ray with g "
          f"!= 0 -> {k3_bound['bound_ms']:.6g} ms ({k3_bound['bound_by']}), "
          f"share {k3_bound['bound_ms'] / k3_ms:.3%}")
    ray, ordered = order["warp_work_ray"], order["warp_work_order"]
    print(f"phase 12 kernel 3's ray order on that pass ({n_order} builds "
          f"in {TRAIN_STEPS} steps): {order['n_live']} rays with g != 0 of "
          f"{g.shape[0]}, equal to the plain version's element for element;"
          f" {order['order_ms']:.6g} ms of device time per build "
          f"({order['order_clock']}); kernel 3 "
          f"{k3_ms:.6g} ms in the order (the build included); "
          f"lane-segments walked / needed (plain count) in ray order "
          f"{ray['walked']} / {ray['needed']} = {ray['ratio']:.4g}, in the "
          f"order {ordered['walked']} / {ordered['needed']} = "
          f"{ordered['ratio']:.4g}; sphere row groups in ray order "
          f"{order['adds_ray']['sph_groups']}, in the order "
          f"{order['adds_order']['sph_groups']}")
    print("  kernel 3 on the step's cotangent vs plain version:")
    err = 0.0
    for gname, a, b in zip(MKG.DIFF_ALL, want, got):
        if gname in TRAIN_WRT:
            err = max(err, _grad_gates(gname, a, b, False))
    return {"launches": k3, "ms": k3_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "k1_record_ms": k1_ms, **k3_bound,
            "order_launches": n_order, "walk_launches": walks,
            "tree_builds": builds, **order}


def _order_device_ms(MKG, ids, g, n_obj: int, reps: int = 10) -> tuple:
    """Kernel 3's ray order alone, ms of device time per build and the
    clock that gave it: the sum of its three kernels' durations over
    ``reps`` builds in torch.profiler's trace ("profiler"), or where the
    trace holds no device time, ``reps`` builds between CUDA events
    queued behind a spin of the stream, so that they run back to back
    and the host's pace between them does not count ("events")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    lib = MKG._build.load("megakernel_champ", MKG._CHAMP_SIGNATURES,
                          MKG.ADJ_FLAGS)
    MKG._order_map(lib, ids, g, n_obj)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            MKG._order_map(lib, ids, g, n_obj)
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if "order_" in e.key)
    if us > 0:
        return us / reps / 1e3, "profiler"
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(50_000_000)   # ~25 ms: the host queues the builds
    start.record()
    for _ in range(reps):
        MKG._order_map(lib, ids, g, n_obj)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, "events"


def _order_phase(MKG, tables, ids, g) -> dict:
    """Phase 12, kernel 3's ray order on the last step's record and g: the
    order built on the card held equal to its plain version element for
    element (fatal), its device time, and the plain count of the segments
    the warps walk and of the row groups they add in ray order and in the
    order."""
    import torch
    n_s, n_t = tables[1].shape[0], tables[2].shape[0]
    order, n_live = MKG.champ_order(ids, g, n_s + n_t)
    n_live = int(n_live)
    want, n_want = MKG.champ_order_reference(ids, g, "path", n_s + n_t)
    _check(n_live == n_want and torch.equal(order[:n_live], want),
           f"kernel 3's ray order on the card ({n_live} rays) differs from "
           f"its plain version ({n_want} rays)")
    order_ms, clock = _order_device_ms(MKG, ids, g, n_s + n_t)
    ray = MKG.champ_warp_work(ids, g, None, "path", n_s + n_t)
    ordered = MKG.champ_warp_work(ids, g, want, "path", n_s + n_t)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slot, _ = MKG.hot_rows(ids, n_s, n_t)
    adds = [MKG.champ_add_count(ids, n_s, n_t, slot, TRAIN_WRT, live=live,
                                blocks=4 * sms, order=o)
            for live, o in (((g != 0).any(-1), None), (None, want))]
    return {"order_ms": order_ms, "order_clock": clock, "n_live": n_live,
            "warp_work_ray": ray, "warp_work_order": ordered,
            "adds_ray": adds[0], "adds_order": adds[1]}


def rr_vs_plain(dev, name: str, w: int, h: int) -> dict:
    """Phase 13, kernel 1 with the roulette: against its plain version on
    the same u-planes (records compared), its --fmad=false build exactly
    (at 256x192 and on sphere fields, as phase 11 checks it), and its PRNG
    route against its u-planes route."""
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                       russian_roulette=True, rr_start_depth=RR_START,
                       use_megakernel=True)
    scene = _cell_scene(name, w, h, dev)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], 0, cfg,
                               scene.lights.count, dev)
    zeros = torch.zeros((cfg.total_rays, 3), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _plain_record(MK, tables, ipar, zeros, u, cfg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    how = "plain walk" if MK.sphere_walks(tables[1]) else "plain"
    got = _record(MK, tables, ipar, zeros.clone(), u, cfg)
    d = _record_diff(got, want)
    ended = ((want[1][:-1] >= 0) & (want[1][1:] < 0)).double().sum().item()
    print(f"phase 13 kernel 1 with the roulette vs {how} ({plain_ms:.6g} ms)"
          f", {name} {w}x{h} b{BOUNCES}: max|d acc| {d['max']:.6g}, rays "
          f"beyond {TOL:g}: {d['beyond']:.6%}, mean acc rel {d['rel']:.3g}; "
          f"ids differ on {d['ids']:.6%} of slots ({d['ids0']:.6%} of first "
          f"segments), occlusion bits on {d['occs']:.6%}; paths ended after "
          f"a hit (roulette or miss) {ended:.0f}")
    _check(bool(torch.isfinite(got[0]).all()), f"{name}: acc not finite")
    if name == "cornell":
        _check(d["beyond"] <= 0.01, f"{name}: {d['beyond']:.4%} of rays "
               f"beyond {TOL:g}")
        _check(d["rel"] <= 1e-5, f"{name}: mean acc differs by "
               f"{d['rel']:.3g}")
    else:
        _check(all(d[k] <= lim for k, lim in SPHERE_GATES.items()),
               f"{name}: kernel 1 vs plain {d}, limits {SPHERE_GATES}")
    if w == SMALL_W or name != "cornell":
        exact = _record(MK, tables, ipar, zeros.clone(), u, cfg, EXACT_FLAGS)
        dx = _record_diff(exact, want)
        print(f"phase 13 --fmad=false build with the roulette, {name} "
              f"{w}x{h}: rays "
              f"beyond {TOL:g} {dx['beyond']:.6%}, ids {dx['ids']:.6%}, "
              f"bits {dx['occs']:.6%}, max|d acc| {dx['max']:.6g}")
        _check(all(torch.equal(a, b) for a, b in zip(exact, want)),
               f"{name}: the --fmad=false build differs from the plain "
               "version with the roulette")
    if name == "cornell" and w == SMALL_W:
        kw = _pass_kw(cfg)
        one = MK.pathtrace_pass(tables[0], ipar, *tables[1:], zeros.clone(),
                                None, **kw)
        three = MK.pathtrace_pass(tables[0], ipar, *tables[1:],
                                  zeros.clone(), None, n_passes=3, **kw)
        acc = zeros.clone()
        for p in range(3):
            up = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], p,
                                        cfg, scene.lights.count, dev)
            MK.pathtrace_pass(tables[0], torch.tensor([p, 0],
                                                      dtype=torch.int32),
                              *tables[1:], acc, up, **kw)
        torch.cuda.synchronize()
        print(f"phase 13 PRNG vs u-planes with the roulette: max|d| 1 pass "
              f"{(one - got[0]).abs().max().item():g}, 3 passes in one launch"
              f" {(three - acc).abs().max().item():g}")
        _check(torch.equal(one, got[0]),
               "roulette PRNG route != u-planes route (1 pass)")
        _check(torch.equal(three, acc),
               "roulette PRNG route != u-planes route (3 passes)")
    return {"max_abs_err": d["max"], "plain_ms": plain_ms}


def full_render(dev, smi: str) -> dict:
    """Phase 14, render: config 5 as specified, 1024 passes with the
    roulette in calls of 64; returns kernel 1's roulette entry."""
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                       russian_roulette=True, rr_start_depth=RR_START,
                       use_megakernel=True)
    scene = cornell_box(cols=MAIN_W, rows=MAIN_H, device=dev)
    n_l = scene.lights.count
    segs = cfg.total_rays * (1 + n_l + cfg.bounces * (1 + n_l))
    calls = FULL_PASSES // FULL_CHUNK

    def run(c):
        state = pt.init_state(c, dev)
        for _ in range(calls):
            state = pt.render_passes(scene, state, c, FULL_CHUNK)
        return state

    pt.render_passes(scene, pt.init_state(cfg, dev), cfg, FULL_CHUNK)
    torch.cuda.synchronize()
    MK.launches = 0
    t0 = time.perf_counter()
    state = run(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = MK.launches
    _check(launches == calls, f"{launches} kernel-1 launches for {calls} "
           f"calls of {FULL_CHUNK} passes (want one per call)")
    _check(state["passes"] == FULL_PASSES, f"passes {state['passes']}")
    img = pt.image(state, cfg)
    _check(bool(torch.isfinite(state["acc"]).all())
           and bool(torch.isfinite(img).all()), "full render not finite")
    fixed_cfg = replace(cfg, russian_roulette=False)
    t1 = time.perf_counter()
    fixed = run(fixed_cfg)
    torch.cuda.synchronize()
    fixed_wall = time.perf_counter() - t1
    m_rr = state["acc"].double().mean().item()
    m_fixed = fixed["acc"].double().mean().item()
    rel = abs(m_rr - m_fixed) / abs(m_fixed)
    # the kernel alone (launches outside the count above): the same calls
    # of FULL_CHUNK passes, tables packed once, events around the wrapper
    tables = mega.scene_tables(scene, cfg)
    acc = torch.zeros_like(state["acc"])
    ipars = [torch.tensor([c * FULL_CHUNK, 0], dtype=torch.int32)
             for c in range(calls)]
    kw = _pass_kw(cfg, n_passes=FULL_CHUNK)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for ipar in ipars:
        MK.pathtrace_pass(tables[0], ipar, *tables[1:], acc, None, **kw)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / FULL_PASSES
    _check(torch.equal(acc, state["acc"]), "the kernel alone does not "
           "repeat render_passes' accumulator")
    # the bound of a pass, from kernel 1's record of pass 0 (a launch
    # outside the count above)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    _, ids, occs = _record(MK, tables, ipar,
                           torch.zeros_like(state["acc"]), None, cfg)
    n_s, n_t = tables[1].shape[0], tables[2].shape[0]
    work = _pass_work(ids, occs, n_l, n_s, rr_start=RR_START)
    ops = _k1_ops(work, n_s, n_t, n_l)
    bound = _bound(ops, 24 * cfg.total_rays + _table_bytes(tables))
    out = HERE / "build" / "chip_smoke_cornell_1024spp_rr.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    from raytracing_tpu_torch.io.png import write_png
    write_png(str(out), img)
    print(f"phase 14 config 5 render, cornell {MAIN_W}x{MAIN_H} spp 1 "
          f"b{BOUNCES}, roulette from depth {RR_START}, {FULL_PASSES} passes "
          f"in {calls} calls on [{smi}]: {wall:.6g} s, nominal "
          f"{segs * FULL_PASSES / wall:.6g} ray segments/s ({segs} per "
          f"pass), {wall * 1e3 / FULL_PASSES:.6g} ms/pass; kernel alone "
          f"{ms:.6g} ms/pass (CUDA events around the wrapper); "
          f"launches {launches}; without the roulette {fixed_wall:.6g} s "
          f"({segs * FULL_PASSES / fixed_wall:.6g} segments/s); mean acc "
          f"{m_rr:.9g} vs {m_fixed:.9g} without (rel {rel:.3g}); image mean "
          f"{img.mean().item():.6g} -> {out}")
    print(f"phase 14 kernel 1 roulette bound: {ops / cfg.total_rays:.6g} "
          f"FP32 operations per ray and pass ({work['rr']:.0f} roulette "
          f"tests, {work['traced']:.0f} traced segments) -> "
          f"{bound['bound_ms']:.6g} ms ({bound['bound_by']}), share "
          f"{bound['bound_ms'] / ms:.3%}")
    _check(rel <= 0.01, f"the roulette's mean differs by {rel:.3g} (> 1%)")
    return {"launches": launches, "ms": ms, **bound}


def _train_step(params, scene, cfg, seen, state):
    """One step as bench.py's _full_train_bench takes it: render_pass ->
    image -> mean square -> backward, parameters fixed."""
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.render import pathtracer as pt
    sc = replace(scene, spheres=replace(scene.spheres,
                                        center=params["center"],
                                        radius=params["radius"]),
                 materials=params["materials"])
    st = pt.render_pass(sc, state, cfg)
    st["acc"].register_hook(lambda g: seen.__setitem__("g", g))
    loss = torch.mean(pt.image(st, cfg) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()))
    return (dict(st, acc=st["acc"].detach()), loss.detach(),
            dict(zip(params, grads)))


def full_train(dev, smi: str) -> tuple[dict, dict]:
    """Phase 14, train: config 5 as specified (1024 steps with the
    roulette), then the cell route with the roulette; returns kernel 2's
    and kernel 3's roulette entries."""
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    entries = []
    for name, steps in (("cornell", FULL_PASSES),
                        (f"sphere_field({N_SPHERES})", CELL_RR_STEPS)):
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                           russian_roulette=True, rr_start_depth=RR_START,
                           mega_grad_wrt=TRAIN_WRT, use_megakernel=True)
        scene = (cornell_box(cols=MAIN_W, rows=MAIN_H, device=dev)
                 if name == "cornell" else
                 _cell_scene(name, MAIN_W, MAIN_H, dev))
        cell = mega.bwd_impl_for(scene, cfg) == "cell"
        _check(cell == (name != "cornell"), f"{name}: backward route")
        n_l = scene.lights.count
        segs = cfg.total_rays * (1 + n_l + cfg.bounces * (1 + n_l))
        params = {"center": scene.spheres.center.clone().requires_grad_(True),
                  "radius": scene.spheres.radius.clone().requires_grad_(True),
                  "materials": scene.materials.clone().requires_grad_(True)}
        seen = {}
        state, _, _ = _train_step(params, scene, cfg, seen,
                                  pt.init_state(cfg, dev))   # warm-up
        state = pt.init_state(cfg, dev)
        torch.cuda.synchronize()
        MK.launches = MKG.launches = MKG.champ_launches = 0
        MK.path_walk_launches = MK.tree_build_launches = 0
        t0 = time.perf_counter()
        losses = []
        for _ in range(steps):
            state, loss, grads = _train_step(params, scene, cfg, seen, state)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2, k3 = MK.launches, MKG.launches, MKG.champ_launches
        want = (steps, 0, steps) if cell else (steps, steps, 0)
        _check((k1, k2, k3) == want, f"{name}: launches kernel 1 {k1}, "
               f"kernel 2 {k2}, kernel 3 {k3} for {steps} steps (want "
               f"{want})")
        # one sphere tree per step where kernel 1 walks one
        trees = steps if MK.sphere_walks(
            mega.scene_tables(scene, cfg)[1]) else 0
        _check((MK.path_walk_launches, MK.tree_build_launches)
               == (trees, trees), f"{name}: kernel 1 walked "
               f"{MK.path_walk_launches} times and built "
               f"{MK.tree_build_launches} trees for {steps} steps (want "
               f"{trees} each)")
        losses = torch.stack(losses)
        _check(bool(torch.isfinite(losses).all()), f"{name}: loss")
        for gname, gr in grads.items():
            _check(bool(torch.isfinite(gr).all()), f"{name}: {gname} grad")
        for gname in ("center", "materials"):
            _check(bool(grads[gname].any()), f"{name}: {gname} grad is zero")
        # the backward alone on the last step's pass and cotangent
        tables = mega.scene_tables(scene, cfg)
        ipar = torch.tensor([state["passes"] - 1, 0], dtype=torch.int32)
        kw = _pass_kw(cfg, diff_wrt=TRAIN_WRT)
        g = seen["g"].contiguous()
        _, ids, occs = _record(MK, tables, ipar, torch.zeros_like(g), None,
                               cfg)
        if cell:
            def bwd():
                return MKG.pathtrace_pass_bwd_champ(
                    tables[0], ipar, *tables[1:], g, None, ids, occs, **kw)
        else:
            def bwd():
                return MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:],
                                              g, None, **kw)
        bwd()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            bwd()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 10
        live = (g != 0).any(-1)
        n_s, n_t = tables[1].shape[0], tables[2].shape[0]
        work = _pass_work(ids, occs, n_l, n_s, live, rr_start=RR_START)
        if cell:
            ops = _k3_ops(work, n_l, TRAIN_WRT)
            nbytes = (12 * cfg.total_rays + (1 + cfg.bounces) * (4 + n_l)
                      * work["rays"] + 2 * _table_bytes(tables))
        else:
            ops = _k1_ops(work, n_s, n_t, n_l) + _adj_ops(work, TRAIN_WRT)
            nbytes = 12 * cfg.total_rays + 2 * _table_bytes(tables)
        bound = _bound(ops, nbytes)
        label = "kernel 3 (cell route)" if cell else "kernel 2"
        print(f"phase 14 train {name} {MAIN_W}x{MAIN_H} b{BOUNCES} with the "
              f"roulette, wrt {list(TRAIN_WRT)}, {steps} steps on [{smi}]: "
              f"{wall:.6g} s, {wall * 1e3 / steps:.6g} ms/step, nominal "
              f"{segs * steps / wall:.6g} fwd+bwd ray segments/s ({segs} per "
              f"step); launches kernel 1 {k1}, kernel 2 {k2}, kernel 3 {k3}; "
              f"loss first {losses[0].item():.7g} last "
              f"{losses[-1].item():.7g}; last |grad| center "
              f"{grads['center'].norm().item():.6g} materials "
              f"{grads['materials'].norm().item():.6g}; {label} alone on the "
              f"last step's cotangent {ms:.6g} ms, bound "
              f"{bound['bound_ms']:.6g} ms ({bound['bound_by']}, "
              f"{ops / max(work['rays'], 1):.6g} FP32 operations per ray with "
              f"g != 0), share {bound['bound_ms'] / ms:.3%}")
        entries.append({"launches": k3 if cell else k2, "ms": ms, **bound})
    return entries[0], entries[1]


def _image_gates(name: str, got, want) -> float:
    """Phase 10's gates on two images: at most 1% of pixels beyond 2e-4,
    the mean within 1e-5 relative; returns max |got - want|."""
    import torch
    err = (got - want).abs()
    beyond = (err > TOL + TOL * want.abs()).any(-1).double().mean().item()
    gm, wm = got.double().mean().item(), want.double().mean().item()
    rel = abs(gm - wm) / abs(wm)
    print(f"phase 15 {name}: max|d| {err.max().item():.6g}, pixels beyond "
          f"{TOL:g}: {beyond:.6%}, mean {gm:.9g} vs {wm:.9g} (rel {rel:.3g})")
    _check(bool(torch.isfinite(got).all()), f"{name}: not finite")
    _check(beyond <= 0.01, f"{name}: {beyond:.4%} beyond {TOL:g} (> 1%)")
    _check(rel <= 1e-5, f"{name}: mean differs by {rel:.3g} (> 1e-5)")
    return err.max().item()


def direct_vs_plain(dev) -> dict:
    """Phase 15, correctness: kernel 1's direct mode against its plain
    version, its PRNG route against its u-planes route, render_direct
    through it against the stage route's."""
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.core import rng
    from raytracing_tpu_torch.models import assignments as A
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render.direct import render_direct

    err, plain_ms = 0.0, {}
    for name, make in (("assign08", lambda: A.assign08(MAIN_W, MAIN_H,
                                                       device=dev)),
                       ("assign09", lambda: A.assign09(MAIN_W, MAIN_H, spp=4,
                                                       device=dev))):
        _, (scene, cfg), _ = make()
        tables = mega.scene_tables(scene, cfg)
        key = rng.base_key(cfg.seed)
        u = mega.u_planes_for_direct(key, cfg, scene.lights.count, dev)
        zeros = torch.zeros((cfg.total_rays, 3), device=dev)
        kw = dict(key=key, spp=cfg.spp, width=cfg.width,
                  two_sided=cfg.two_sided_triangles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = MK.direct_pass_reference(tables[0], *tables[1:], zeros, u,
                                        **kw)
        torch.cuda.synchronize()
        plain_ms[name] = (time.perf_counter() - t0) * 1e3
        got = MK.direct_pass(tables[0], *tables[1:], zeros.clone(), u, **kw)
        prng = MK.direct_pass(tables[0], *tables[1:], zeros.clone(), None,
                              **kw)
        torch.cuda.synchronize()
        d = (got - want).abs()
        beyond = (d > TOL + TOL * want.abs()).any(-1).double().mean().item()
        gm, wm = got.double().mean().item(), want.double().mean().item()
        rel = abs(gm - wm) / abs(wm)
        err = max(err, d.max().item())
        print(f"phase 15 direct mode vs plain ({plain_ms[name]:.6g} ms), "
              f"{name} shape {MAIN_W}x{MAIN_H} spp {cfg.spp} lens "
              f"{2 * scene.lens_radius.item():g} ({cfg.total_rays} rays): "
              f"max|d acc| {d.max().item():.6g}, rays beyond {TOL:g}: "
              f"{beyond:.6%}, mean rel {rel:.3g}; PRNG vs u-planes max|d| "
              f"{(prng - got).abs().max().item():g}")
        _check(bool(torch.isfinite(got).all()) and got.max().item() > 0,
               f"{name}: direct acc not finite or black")
        _check(beyond <= 0.01, f"{name}: {beyond:.4%} of rays beyond {TOL:g}")
        _check(rel <= 1e-5, f"{name}: mean acc differs by {rel:.3g}")
        _check(torch.equal(prng, got),
               f"{name}: direct PRNG route != u-planes route")
        scfg = replace(cfg, use_megakernel=False, use_pallas=True)
        for n_passes in (1, 3):
            k = MK.direct_launches
            HK.sphere_launches = HK.triangle_launches = 0
            img = render_direct(scene, cfg, key=key, n_passes=n_passes)
            stage = render_direct(scene, scfg, key=key, n_passes=n_passes)
            torch.cuda.synchronize()
            _check(MK.direct_launches == k + 1 and HK.triangle_launches > 0,
                   f"{name}: launches direct {MK.direct_launches - k}, "
                   f"kernel 5 {HK.triangle_launches}")
            err = max(err, _image_gates(
                f"{name} render_direct, {n_passes} pass(es): kernel 1 vs "
                "stage route", img, stage))
    return {"max_abs_err": err, "plain_ms": plain_ms["assign08"]}


def direct_main_path(dev, smi: str) -> dict:
    """Phase 15, timed: configs 2 and 4 through render_direct (one kernel-1
    launch per call), config 1 through render_fake_shade_orbit; returns
    the direct-mode entry (config 2)."""
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.core import rng
    from raytracing_tpu_torch.models import assignments as A
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render.simple import render_fake_shade_orbit

    entry = None
    for config, make in ((2, lambda: A.assign08(MAIN_W, MAIN_H, device=dev)),
                         (4, lambda: A.assign09(MAIN_W, MAIN_H, spp=4,
                                                device=dev))):
        render, (scene, cfg), _ = make()
        work = cfg.total_rays * (1 + scene.lights.count) * DIRECT_PASSES
        img = render(scene, cfg, n_passes=DIRECT_PASSES)     # warm-up
        torch.cuda.synchronize()
        MK.direct_launches = MK.launches = 0
        t0 = time.perf_counter()
        for _ in range(DIRECT_REPS):
            img = render(scene, cfg, n_passes=DIRECT_PASSES)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3 / DIRECT_REPS
        launches = MK.direct_launches
        _check(launches == DIRECT_REPS and MK.launches == 0,
               f"config {config}: {launches} direct launches for "
               f"{DIRECT_REPS} calls")
        _check(bool(torch.isfinite(img).all()) and img.max().item() > 0,
               f"config {config}: image not finite or black")
        # the kernel alone: tables packed once, events around the wrapper
        tables = mega.scene_tables(scene, cfg)
        acc = torch.zeros((cfg.total_rays, 3), device=dev)
        kw = dict(key=rng.base_key(cfg.seed), spp=cfg.spp, width=cfg.width,
                  two_sided=cfg.two_sided_triangles, n_passes=DIRECT_PASSES)
        MK.direct_pass(tables[0], *tables[1:], acc, None, **kw)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(DIRECT_REPS):
            MK.direct_pass(tables[0], *tables[1:], acc, None, **kw)
        end.record()
        torch.cuda.synchronize()
        k_ms = start.elapsed_time(end) / DIRECT_REPS
        # the bound of a pass, from kernel 1's path-mode record of a pass
        # without bounces on the direct draws (the same primary rays and
        # shadow rays; a launch outside the count above)
        u = mega.u_planes_for_direct(kw["key"], cfg, scene.lights.count, dev)
        _, ids, occs = _record(MK, tables, torch.tensor([0, 0],
                                                        dtype=torch.int32),
                               torch.zeros_like(acc), u,
                               replace(cfg, bounces=0))
        n_s, n_t = tables[1].shape[0], tables[2].shape[0]
        w = _pass_work(ids, occs, scene.lights.count, n_s)
        ops = _direct_ops(w, n_s, n_t)
        bound = _bound(ops * DIRECT_PASSES,
                       24 * cfg.total_rays + _table_bytes(tables))
        shape = "assign08" if config == 2 else "assign09"
        print(f"phase 15 config {config} ({shape}) {MAIN_W}x{MAIN_H} spp "
              f"{cfg.spp}, "
              f"{DIRECT_PASSES} passes per call on [{smi}]: "
              f"{work / (call_ms / 1e3):.6g} rays/s ({work} per call), call "
              f"{call_ms:.6g} ms, kernel alone {k_ms:.6g} ms (CUDA events; "
              f"host share {max(0.0, 1 - k_ms / call_ms):.3%}); launches "
              f"{launches}; bound {ops / cfg.total_rays:.6g} FP32 "
              f"operations per ray and pass -> {bound['bound_ms']:.6g} ms "
              f"per call ({bound['bound_by']}), share "
              f"{bound['bound_ms'] / k_ms:.3%}")
        if config == 2:
            entry = {"launches": launches, "ms": k_ms / DIRECT_PASSES,
                     "bound_ms": bound["bound_ms"] / DIRECT_PASSES,
                     "bound_by": bound["bound_by"]}

    render, (cam, spheres, colors), _ = A.assign01(MAIN_W, MAIN_H,
                                                   device=dev)
    bounds = spheres.bounds()
    render_fake_shade_orbit(cam, spheres, colors, bounds, ORBIT_FRAMES)
    torch.cuda.synchronize()
    counts = (MK.launches, MK.direct_launches, HK.sphere_launches,
              HK.triangle_launches)
    t0 = time.perf_counter()
    frames = render_fake_shade_orbit(cam, spheres, colors, bounds,
                                     ORBIT_FRAMES)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _check((MK.launches, MK.direct_launches, HK.sphere_launches,
            HK.triangle_launches) == counts,
           "fake shade launched a hand-written kernel")
    _check(tuple(frames.shape) == (ORBIT_FRAMES, MAIN_H, MAIN_W, 3)
           and bool(torch.isfinite(frames).all())
           and frames.max().item() > 0, "fake-shade frames")
    print(f"phase 15 config 1 (render_fake_shade_orbit) {MAIN_W}x{MAIN_H}, "
          f"{ORBIT_FRAMES} frames on [{smi}]: {ms:.6g} ms, "
          f"{MAIN_W * MAIN_H * ORBIT_FRAMES / (ms / 1e3):.6g} rays/s; no "
          f"hand-written kernel (eager PyTorch, as JAX runs XLA)")
    return entry


# ---------------------------------------------------------------------------
# phases 16-19: kernel 1's grid mode
# ---------------------------------------------------------------------------

@functools.cache
def _grid_scene(shape: str, w: int, h: int, dev):
    """Config 3's scene (cornell plus the torus mesh of
    tests/torch_grid_scenes.py, its grid at auto_slabs(992) = 3 over the
    mesh, the walls brute force) or sphere_field(GRID_SPHERES) with its
    sphere grid, prepared as bench.py's BENCH_GRID=1 prepares them
    ("auto"); built once per shape and size (nothing mutates a scene)."""
    from raytracing_tpu_torch.accel import prepare_grids
    from raytracing_tpu_torch.models.scenes import sphere_field
    if shape == "spheres":
        return prepare_grids(sphere_field(GRID_SPHERES, cols=w, rows=h,
                                          device=dev), "auto")
    sys.path.insert(0, str(HERE / "tests"))
    from torch_grid_scenes import cornell_torus
    return prepare_grids(cornell_torus(w, h, *TORUS_SEGMENTS, device=dev),
                         "auto", mesh_slabs="auto")


def _grid_cfg(shape: str, w: int, h: int, mode: str, **kw):
    from raytracing_tpu_torch import RenderConfig
    return RenderConfig(width=w, height=h,
                        bounces=0 if mode == "direct" else BOUNCES,
                        use_grid=True, use_megakernel=True,
                        russian_roulette=mode == "rr",
                        rr_start_depth=RR_START, **kw)


def _grid_bytes(tables, grid) -> int:
    """The tables, each triangle grid's cell-major copy as the kernel reads
    it (the copied rows' original ids, the cell table and the node boxes;
    the copied rows are the tables' rows, counted once) and the sphere
    grid's CSR."""
    csr = ([grid.sph.cell_offsets, grid.sph.item_indices]
           if grid.sph is not None else [])
    return _table_bytes(tables) + 4 * sum(
        t.numel() for t in [t for cp in grid.copies
                            for t in (cp.perm, cp.cell, cp.nodes)] + csr)


def _grid_counts(work: dict, walk: dict) -> dict:
    """The two counts of a grid-mode pass's tests that a bound may price:
    the march's (the plain version's ``work``: the cell steps and the
    distinct (ray, item) tests of each cell's every item) and the cell
    walk's (``MK.grid_walk_work``: the same steps, the node slab tests of
    the cells' trees and the row tests of the leaves they visit), a shadow
    ray's up to its first occluder in the walk's."""
    rows = ("sph_tests", "tri_tests")
    return {"march": {"cells": work["cells"], "node_tests": 0,
                      **{k: work.get(k, 0) for k in rows}},
            "walk": {"cells": walk["cells"],
                     "node_tests": walk.get("node_tests", 0),
                     **{k: walk.get(k, 0) for k in rows}}}


def _grid_bound(ops_of, nbytes: float) -> dict:
    """The bound of a grid-mode pass priced by each count of
    ``_grid_counts`` (``ops_of(count)``): ``bound_ms`` the smaller,
    ``bound_by`` its limit, ``bound_from`` its count, and each count's
    bound beside it."""
    b = {o: _bound(ops_of(o), nbytes) for o in ("march", "walk")}
    best = min(b, key=lambda o: b[o]["bound_ms"])
    return {**b[best], "bound_from": best,
            "march_bound_ms": b["march"]["bound_ms"],
            "walk_bound_ms": b["walk"]["bound_ms"]}


def _grid_ops(w: dict, work: dict, grid, n_sph: int, n_lig: int,
              direct: bool) -> float:
    """FP32 operations of a grid-mode pass: the brute prefix as _k1_ops and
    _direct_ops count it (the spheres unless gridded, the triangles below
    ``start``), one walk set-up per grid for each traced segment and shadow
    ray, and the walks' cell steps, node slab tests (OPS_CHUNK each, the
    streamed trees' test) and row tests of one count of ``_grid_counts``
    (``work``, scaled to this pass's rays; the march's each item once per
    ray and walk however many of the walk's cells hold it, no side cell:
    their visits and the raw tests are printed beside)."""
    n_s = 0 if grid.sph is not None else n_sph
    n_t = grid.start
    tests = n_s * OPS_SPHERE_TEST + n_t * OPS_TRIANGLE_TEST
    one = OPS_TRIANGLE_TEST if n_t else (OPS_SPHERE_TEST if n_s else 0)
    seg = w["primary"] if direct else w["traced"]
    n_grids = len(grid.tri) + (grid.sph is not None)
    ops = (w["rays"] * OPS_CAMERA + seg * (OPS_TRACE + tests)
           + w["sph_hits"] * OPS_SPHERE_HIT + w["tri_hits"] * OPS_TRIANGLE_HIT
           + w["free"] * tests + w["occluded"] * one
           + (seg + w["shadow"]) * n_grids * OPS_WALK
           + work["cells"] * OPS_CELL
           + work.get("node_tests", 0) * OPS_CHUNK
           + work.get("sph_tests", 0) * OPS_SPHERE_TEST
           + work.get("tri_tests", 0) * OPS_TRIANGLE_TEST)
    if direct:
        return ops + w["shadow"] * OPS_DIRECT_SHADE
    return ops + (w["primary"] * n_lig * OPS_EMITTER + w["shadow"] * OPS_NEE
                  + w["bounces"] * OPS_BOUNCE + w["rr"] * OPS_RR)


def grid_build(dev) -> None:
    """Phase 16: build the grids of shapes 1 and 3 (host binning, then the
    CSR arrays to the card) and print the build ms."""
    import torch
    for shape in ("torus", "spheres"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene = _grid_scene(shape, MAIN_W, MAIN_H, dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        g = scene.mega_sph_grid if shape == "spheres" else \
            scene.folded_tri_grid[0]
        want = (6, 6, 6) if shape == "spheres" else (3, 3, 3)
        print(f"phase 16 grid build {shape}: {ms:.6g} ms (prepare_grids, "
              f"all of the scene's grids); kernel grid {g.n}, "
              f"{g.item_indices.numel()} payload rows, at most "
              f"{g.max_per_cell} per cell, start {g.start}")
        _check(g.n == want, f"{shape}: grid {g.n}, want {want}")
        if shape == "torus":
            _check(g.start == 10 and scene.mega_sph_grid is None,
                   "torus: the walls are not the brute prefix")


def grid_vs_plain(dev, shape: str, mode: str) -> dict:
    """Phase 17 at 256x192, one shape and mode ("direct", "path", "rr"):
    kernel 1's grid mode against its plain grid version on the same draws
    (phase 3's gates; SPHERE_GATES on the sphere grid), the path modes
    recording (in "path" the launch without the record must give the
    recording launch's accumulator bit for bit), its --fmad=false build
    equal on every ray, id and bit, and the plain grid version against the
    brute plain version over the whole tables (ids and bits equal, acc
    within 1e-6) in direct mode and, on the torus, in path mode at depth 1
    (the brute loops launch per object: ~20 s for a b5 pass over the torus
    whatever the film; the CPU tests hold the roulette's grid to brute
    force); in "direct" and "path" the kernel's cell walk counted on the
    plain version's rays (``MK.grid_walk_work``), which must keep every
    champion and occlusion bit of the plain version. Returns max |d|, the
    plain ms and the two counts (``_grid_counts``; none in "rr")."""
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.core import rng
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    w, h = SMALL_W, SMALL_H
    scene = _grid_scene(shape, w, h, dev)
    cfg = _grid_cfg(shape, w, h, mode)
    tables = mega.scene_tables(scene, cfg)
    grid = mega.grid_tables(scene, tables[1], tables[2])
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    zeros = torch.zeros((cfg.total_rays, 3), device=dev)
    work = {}
    if mode == "direct":
        key = rng.base_key(cfg.seed)
        u = mega.u_planes_for_direct(key, cfg, scene.lights.count, dev)
        kw = dict(key=key, spp=1, width=w, two_sided=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = (MK.direct_pass_reference(*tables, zeros, u, grid=grid,
                                         work=work, **kw),)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = (MK.direct_pass(*tables, zeros.clone(), u, grid=grid, **kw),)
        exact = (MK.direct_pass(*tables, zeros.clone(), u, grid=grid,
                                build_flags=EXACT_FLAGS, **kw),)
        brute = (want, (MK.direct_pass_reference(*tables, zeros, u, **kw),))
        walk_kw = dict(kw, bounces=0, normalize_emitter=False,
                       seed=cfg.seed, mode="direct")
    else:
        u = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], 0, cfg,
                                   scene.lights.count, dev)
        kw = _pass_kw(cfg)

        def run(**extra):
            return MK.pathtrace_pass(tables[0], ipar, *tables[1:],
                                     zeros.clone(), u, grid=grid, **kw,
                                     **extra)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:],
                                           zeros, u, grid=grid, work=work,
                                           record=True, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = run(record=True)
        exact = run(record=True, build_flags=EXACT_FLAGS)
        if mode == "path":
            _check(torch.equal(run(), got[0]), f"{shape}: the recording "
                   "launch's acc differs from the path launch's")
        walk_kw = {k: v for k, v in kw.items() if k != "record"}
        brute = None
        if shape == "torus" and mode == "path":
            c1 = replace(cfg, bounces=1)
            u1 = mega.u_planes_for_pass(pt.init_state(c1, dev)["key"], 0, c1,
                                        scene.lights.count, dev)
            brute = tuple(MK.pathtrace_pass_reference(
                tables[0], ipar, *tables[1:], zeros, u1, record=True,
                grid=g, **_pass_kw(c1)) for g in (grid, None))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the roulette's walk is held on the CPU (tests/test_torch_grid_tree.py)
    walk = (MK.grid_walk_work(tables[0], ipar, *tables[1:], zeros, u,
                              grid=grid, **walk_kw) if mode != "rr" else None)
    walk_s = time.perf_counter() - t0
    err = (got[0] - want[0]).abs()
    beyond = (err > TOL + TOL * want[0].abs()).any(-1).double().mean().item()
    gm, wm = got[0].double().mean().item(), want[0].double().mean().item()
    rel = abs(gm - wm) / abs(wm)
    ids = ((got[1] != want[1]).double().mean().item() if len(got) > 1
           else 0.0)
    ids0 = ((got[1][0] != want[1][0]).double().mean().item()
            if len(got) > 1 else 0.0)
    same = all(torch.equal(a, b) for a, b in zip(exact, want))
    line = (f"phase 17 grid mode {shape} {mode} {w}x{h}: kernel vs plain "
            f"({plain_ms:.6g} ms) max|d acc| {err.max().item():.6g}, rays "
            f"beyond {TOL:g} {beyond:.6%}, mean rel {rel:.3g}, ids differ "
            f"{ids:.6%} (first segments {ids0:.6%}); --fmad=false build "
            f"equal {same}; plain march: "
            f"{ {k: int(v) for k, v in work.items()} }")
    if brute is not None:
        gv, bv = brute
        bsame = all(torch.equal(a, b) for a, b in zip(gv[1:], bv[1:]))
        bmax = (gv[0] - bv[0]).abs().max().item()
        line += (f"; brute plain{' (b1)' if mode == 'path' else ''}: ids "
                 f"and bits equal {bsame}, max|d| {bmax:g}")
        _check(bsame and bmax <= 1e-6,
               f"{shape} {mode}: grid plain version != brute plain version")
    print(line)
    if walk is None:
        _check(bool(torch.isfinite(got[0]).all()) and got[0].max().item() > 0,
               f"{shape} {mode}: grid acc not finite or black")
        _check(same, f"{shape} {mode}: the --fmad=false build differs from "
               "the plain version")
        return {"max_abs_err": err.max().item(), "plain_ms": plain_ms}
    walks = walk["traces"] + walk["shadows"]
    kind = "sph_tests" if shape == "spheres" else "tri_tests"
    print(f"phase 17 grid mode {shape} {mode} {w}x{h}: per live trace or "
          f"shadow ray ({walks}), {walk['cells'] / walks:.4g} cells; the "
          f"march {work[kind] / walks:.4g} distinct row tests "
          f"({work[kind + '_raw'] / walks:.4g} in all), the cell walk "
          f"{walk.get('node_tests', 0) / walks:.4g} node and "
          f"{walk[kind] / walks:.4g} row tests, "
          f"{walk.get('leaf_visits', 0) / walks:.4g} leaves; champions "
          f"missed {walk['misses']}, occlusion bits missed "
          f"{walk['occ_misses']} ({walk_s:.3g} s): "
          f"{ {k: int(v) for k, v in walk.items()} }")
    _check(walk["misses"] == 0 and walk["occ_misses"] == 0,
           f"{shape} {mode}: the cell walk culled a champion or occluder")
    _check(bool(torch.isfinite(got[0]).all()) and got[0].max().item() > 0,
           f"{shape} {mode}: grid acc not finite or black")
    _check(same, f"{shape} {mode}: the --fmad=false build differs from the "
           "plain version")
    if shape == "torus":
        _check(beyond <= 0.01 and rel <= 1e-5,
               f"{shape} {mode}: beyond {beyond:.4%}, mean rel {rel:.3g}")
    else:
        d = {"beyond": beyond, "rel": rel, "ids": ids, "ids0": ids0}
        _check(all(d[k] <= SPHERE_GATES[k] for k in d),
               f"{shape} {mode}: {d}, limits {SPHERE_GATES}")
    if len(got) > 1:
        _check(bool((got[1] >= -1).all()) and bool(
            (got[1] < tables[1].shape[0] + tables[2].shape[0]).all()),
            f"{shape} {mode}: recorded ids outside the original rows")
    return {"max_abs_err": err.max().item(), "plain_ms": plain_ms,
            "work": _grid_counts(work, walk)}


def _scaled(work: dict, factor: float) -> dict:
    return {k: float(v) * factor for k, v in work.items()}


def grid_direct_main(dev, smi: str, work: dict) -> dict:
    """Phase 18, shape 1 (config 3's shape): render_direct in grid mode,
    16 passes per call, at B = GRID_BLOCK and B = 0 in turns (B, 0, 0, B);
    one direct-mode launch per call; rays as bench.py:225-228 count them;
    the kernel alone (CUDA events around the wrapper) and its share of the
    bound (the 256x192 march's work scaled); the kernel's first pass vs
    the plain version at 1024^2 (phase 3's gates). Returns the entry."""
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.core import rng
    from raytracing_tpu_torch.io.png import write_png
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render.direct import render_direct

    scene = _grid_scene("torus", MAIN_W, MAIN_H, dev)
    base = _grid_cfg("torus", MAIN_W, MAIN_H, "direct", n_slabs=3)
    n_rays = base.total_rays * (1 + scene.lights.count) * GRID_PASSES
    tables = mega.scene_tables(scene, base)
    grid = mega.grid_tables(scene, tables[1], tables[2])
    key = rng.base_key(base.seed)
    res = {}
    for block in (GRID_BLOCK, 0, 0, GRID_BLOCK):
        cfg = replace(base, mega_block=block)
        img = render_direct(scene, cfg, n_passes=GRID_PASSES)   # warm-up
        torch.cuda.synchronize()
        MK.direct_launches = MK.launches = 0
        t0 = time.perf_counter()
        for _ in range(GRID_REPS):
            img = render_direct(scene, cfg, n_passes=GRID_PASSES)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3 / GRID_REPS
        launches = MK.direct_launches
        _check(launches == GRID_REPS and MK.launches == 0,
               f"B={block}: {launches} direct launches for {GRID_REPS} calls")
        _check(bool(torch.isfinite(img).all()) and img.max().item() > 0,
               f"B={block}: image not finite or black")
        acc = torch.zeros((base.total_rays, 3), device=dev)
        kw = dict(key=key, spp=1, width=MAIN_W, two_sided=False,
                  n_passes=GRID_PASSES, grid=grid, block=block)
        MK.direct_pass(*tables, acc, None, **kw)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(GRID_REPS):
            MK.direct_pass(*tables, acc, None, **kw)
        end.record()
        torch.cuda.synchronize()
        k_ms = start.elapsed_time(end) / GRID_REPS
        res.setdefault(block, []).append((call_ms, k_ms, img, launches))
        n_tri = 2 * TORUS_SEGMENTS[0] * TORUS_SEGMENTS[1]
        print(f"phase 18 config 3's shape (cornell + torus({n_tri}), "
              f"grid {grid.tri[0].n}) {MAIN_W}x{MAIN_H} direct, "
              f"{GRID_PASSES} passes per call, B = {block} on [{smi}]: "
              f"{n_rays / (call_ms / 1e3):.6g} rays/s ({n_rays} per call), "
              f"call {call_ms:.6g} ms, kernel alone {k_ms:.6g} ms (host "
              f"share {max(0.0, 1 - k_ms / call_ms):.3%}); launches "
              f"{launches}")
    _check(torch.equal(res[GRID_BLOCK][0][2], res[0][0][2]),
           f"B = {GRID_BLOCK} image != B = 0 image")
    out = HERE / "build" / "chip_smoke_cornell_torus_direct_1024.png"
    write_png(str(out), res[GRID_BLOCK][0][2])
    # one pass against the plain version on the same draws
    u = mega.u_planes_for_direct(key, base, scene.lights.count, dev)
    zeros = torch.zeros((base.total_rays, 3), device=dev)
    one = dict(key=key, spp=1, width=MAIN_W, two_sided=False, grid=grid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = MK.direct_pass_reference(*tables, zeros, u, **one)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = MK.direct_pass(*tables, zeros.clone(), u, block=GRID_BLOCK, **one)
    torch.cuda.synchronize()
    err = (got - want).abs()
    beyond = (err > TOL + TOL * want.abs()).any(-1).double().mean().item()
    rel = abs(got.double().mean().item() / want.double().mean().item() - 1)
    _check(beyond <= 0.01 and rel <= 1e-5,
           f"config 3 shape 1024^2: beyond {beyond:.4%}, rel {rel:.3g}")
    # the bound of a pass: the record of a pass without bounces on the
    # direct draws (primary and shadow rays; a launch outside the count)
    _, ids, occs = MK.pathtrace_pass(
        tables[0], torch.tensor([0, 0], dtype=torch.int32), *tables[1:],
        torch.zeros_like(zeros), u, grid=grid, record=True,
        **_pass_kw(replace(base, bounces=0)))
    w = _pass_work(ids, occs, scene.lights.count, tables[1].shape[0])
    scale = base.total_rays / (SMALL_W * SMALL_H)
    priced = {o: _grid_ops(w, _scaled(work[o], scale), grid,
                           tables[1].shape[0], scene.lights.count, True)
              for o in work}
    bound = _grid_bound(priced.__getitem__, 24 * base.total_rays
                        + _grid_bytes(tables, grid))
    ops = priced[bound["bound_from"]]
    k_b = min(x[1] for x in res[GRID_BLOCK]) / GRID_PASSES
    k_0 = min(x[1] for x in res[0]) / GRID_PASSES
    print(f"phase 18 config 3's shape per pass: kernel B = {GRID_BLOCK} "
          f"{k_b:.6g} ms, B = 0 {k_0:.6g} ms (best of two turns; before the "
          f"cell-major copies {BEFORE_GRID_MS['shape 1']:.6g} ms at B = "
          f"{GRID_BLOCK}); plain version {plain_ms:.6g} ms, max|d acc| "
          f"{err.max().item():.6g}, rays beyond {TOL:g} {beyond:.6%}, mean "
          f"rel {rel:.3g}; bound {ops / base.total_rays:.6g} FP32 operations "
          f"per ray -> {bound['bound_ms']:.6g} ms ({bound['bound_by']}, from "
          f"the {bound['bound_from']} count: the march's "
          f"{bound['march_bound_ms']:.6g} ms, the cell walk's "
          f"{bound['walk_bound_ms']:.6g} ms), share "
          f"{bound['bound_ms'] / k_b:.3%}; image -> {out}")
    return {"launches": res[GRID_BLOCK][1][3], "ms": k_b,
            "plain_ms": plain_ms, "max_abs_err": err.max().item(), **bound}


def grid_path_main(dev, smi: str, shape: str, work: dict) -> tuple:
    """Phase 18, shapes 2 (the torus scene, B = GRID_BLOCK) and 3
    (sphere_field(GRID_SPHERES), B = 0), path mode b5 as bench.py's
    BENCH_GRID=1 runs them (``_path_main``). Returns the forward entry and
    the kernel-3 entry."""
    from raytracing_tpu_torch.render import mega

    block = GRID_BLOCK if shape == "torus" else 0
    scene = _grid_scene(shape, MAIN_W, MAIN_H, dev)
    cfg = _grid_cfg(shape, MAIN_W, MAIN_H, "path", mega_block=block,
                    mega_grad_wrt=MESH_WRT if shape == "torus" else TRAIN_WRT)
    tables = mega.scene_tables(scene, cfg)
    grid = mega.grid_tables(scene, tables[1], tables[2])
    scale = cfg.total_rays / (SMALL_W * SMALL_H)
    n_sph = scene.spheres.count
    name = ("cornell + torus" if shape == "torus"
            else f"sphere_field({GRID_SPHERES})")
    sph_grid = (f" + sphere grid {grid.sph.n}" if grid.sph is not None
                else "")
    priced = {}

    def ops_of(w):
        priced.update({o: _grid_ops(w, _scaled(work[o], scale), grid, n_sph,
                                    scene.lights.count, False)
                       for o in work})
        return min(priced.values())

    fwd, k3 = _path_main(
        dev, smi, 18, name, scene, cfg,
        f"grid mode (kernel grids {[g.n for g in grid.tri]}{sph_grid})",
        accel=lambda sc, tabs: {"grid": mega.grid_tables(sc, tabs[1],
                                                         tabs[2])},
        ops_of=ops_of, bytes_of=lambda tabs: _grid_bytes(tabs, grid),
        gates=((0.01, 1e-5) if shape == "torus"
               else (SPHERE_GATES["beyond"], SPHERE_GATES["rel"])))
    fwd.update(_grid_bound(priced.__getitem__, 24 * cfg.total_rays
                           + _grid_bytes(tables, grid)))
    label = "shape 2" if shape == "torus" else "shape 3"
    before, before_rec = (BEFORE_GRID_MS[label],
                          BEFORE_GRID_MS[label + " recording"])
    print(f"phase 18 {name} ({label}): kernel {fwd['ms']:.6g} ms/pass, "
          f"recording {k3['rec_ms']:.6g} ms; before the cell-major copies "
          f"{before:.6g} / {before_rec:.6g} ms (x{before / fwd['ms']:.3g} / "
          f"x{before_rec / k3['rec_ms']:.3g}); bound {fwd['bound_ms']:.6g} ms"
          f" from the {fwd['bound_from']} count (the march's "
          f"{fwd['march_bound_ms']:.6g} ms, the cell walk's "
          f"{fwd['walk_bound_ms']:.6g} ms), share "
          f"{fwd['bound_ms'] / fwd['ms']:.3%}")
    return fwd, k3


def _path_main(dev, smi: str, phase: int, name: str, scene, cfg, how: str,
               accel, ops_of, bytes_of, gates, train: bool = True) -> tuple:
    """Path mode b5 at 1024^2 in a mode of kernel 1 that ``accel(scene,
    tables)`` gives (its keyword arguments: ``grid`` or ``chunks``): the
    forward (render_passes, 16 passes per call, one launch per call) in
    segments/s and ms per pass, the kernel alone and the device's idle
    share, its first pass vs the plain version at 1024^2 (``gates``: rays
    beyond 2e-4, mean rel), its bound (``ops_of(pass work)`` operations,
    24 B per ray and ``bytes_of(tables)``); then, with ``train``, the cell
    route's train step (render_pass -> image -> mean square -> backward ->
    SGD on cfg.mega_grad_wrt's groups; one kernel-1 recording and one
    kernel-3 launch per step, no kernel 2), kernel 1 recording and kernel 3
    alone on the last step. Returns the forward entry and the kernel-3
    entry (None without ``train``)."""
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    block, wrt = cfg.mega_block, cfg.mega_grad_wrt
    tables = mega.scene_tables(scene, cfg)
    n_l = scene.lights.count
    segs = cfg.total_rays * (1 + n_l + cfg.bounces * (1 + n_l))
    state = pt.render_passes(scene, pt.init_state(cfg, dev), cfg,
                             GRID_PASSES)                        # warm-up
    torch.cuda.synchronize()
    MK.launches = MK.stream_launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(GRID_REPS):
        state = pt.render_passes(scene, state, cfg, GRID_PASSES)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, streamed = MK.launches, MK.stream_launches
    _check(launches == GRID_REPS, f"{name}: {launches} kernel-1 launches "
           f"for {GRID_REPS} render_passes calls")
    _check(bool(torch.isfinite(state["acc"]).all()), f"{name}: acc")
    ms_pass = start.elapsed_time(end) / (GRID_REPS * GRID_PASSES)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    acc = torch.zeros((cfg.total_rays, 3), device=dev)
    kw = _pass_kw(cfg)
    ak = accel(scene, tables)
    MK.pathtrace_pass(tables[0], ipar, *tables[1:], acc, None, block=block,
                      n_passes=GRID_PASSES, **ak, **kw)
    start.record()
    MK.pathtrace_pass(tables[0], ipar, *tables[1:], acc, None, block=block,
                      n_passes=GRID_PASSES, **ak, **kw)
    end.record()
    torch.cuda.synchronize()
    k_ms = start.elapsed_time(end) / GRID_PASSES
    # the first pass against the plain version on the same draws
    u = mega.u_planes_for_pass(state["key"], 0, cfg, n_l, dev)
    zeros = torch.zeros_like(acc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:], zeros,
                                       u, **ak, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got, ids, occs = MK.pathtrace_pass(tables[0], ipar, *tables[1:],
                                       zeros.clone(), u, block=block,
                                       record=True, **ak, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs()
    beyond = (err > TOL + TOL * want.abs()).any(-1).double().mean().item()
    rel = abs(got.double().mean().item() / want.double().mean().item() - 1)
    _check(beyond <= gates[0] and rel <= gates[1],
           f"{name} 1024^2 pass: beyond {beyond:.4%}, rel {rel:.3g}")
    w = _pass_work(ids, occs, n_l, tables[1].shape[0])
    ops = ops_of(w)
    bound = _bound(ops, 24 * cfg.total_rays + bytes_of(tables))
    print(f"phase {phase} {name} {MAIN_W}x{MAIN_H} b{BOUNCES} {how}, "
          f"B = {block}, {GRID_PASSES} passes/call x {GRID_REPS} on "
          f"[{smi}]: {segs * GRID_PASSES * GRID_REPS / wall:.6g} forward ray "
          f"segments/s ({segs} per pass), {ms_pass:.6g} ms/pass (CUDA "
          f"events), kernel alone {k_ms:.6g} ms/pass (device idle share "
          f"{max(0.0, 1 - k_ms / ms_pass):.3%}); launches {launches} "
          f"(streamed {streamed}); plain version {plain_ms:.6g} ms/pass, "
          f"max|d acc| {err.max().item():.6g}, rays beyond {TOL:g} "
          f"{beyond:.6%}, mean rel {rel:.3g}; bound "
          f"{ops / cfg.total_rays:.6g} FP32 operations per ray -> "
          f"{bound['bound_ms']:.6g} ms ({bound['bound_by']}), share "
          f"{bound['bound_ms'] / k_ms:.3%}")
    fwd = {"launches": launches, "streamed": streamed, "ms": k_ms,
           "call_ms": ms_pass, "plain_ms": plain_ms,
           "max_abs_err": err.max().item(), **bound}
    if not train:
        return fwd, None

    # the cell route's train step
    _check(mega.bwd_impl_for(scene, cfg) == "cell", f"{name}: not cell")
    params = {"center": scene.spheres.center.clone().requires_grad_(True),
              "radius": scene.spheres.radius.clone().requires_grad_(True),
              "materials": scene.materials.clone().requires_grad_(True)}
    if "tri" in wrt:
        params["tv"] = scene.meshes[0].tris.v.clone().requires_grad_(True)
    seen = {}

    def sc_of(p):
        sc = replace(scene, spheres=replace(scene.spheres, center=p["center"],
                                            radius=p["radius"]),
                     materials=p["materials"])
        if "tv" in p:
            m = scene.meshes[0]
            sc = replace(sc, meshes=(replace(m, tris=replace(m.tris,
                                                             v=p["tv"])),))
        return sc

    def step(st):
        st = pt.render_pass(sc_of(params), st, cfg)
        st["acc"].register_hook(lambda g: seen.__setitem__("g", g))
        loss = torch.mean(pt.image(st, cfg) ** 2)
        loss.backward()
        grads = {}
        with torch.no_grad():
            for k, p in params.items():
                grads[k] = p.grad
                p -= TRAIN_LR * p.grad
                p.grad = None
        return dict(st, acc=st["acc"].detach()), loss.detach(), grads

    st = pt.init_state(cfg, dev)
    st, loss0, _ = step(st)                                  # warm-up
    torch.cuda.synchronize()
    MK.launches = MK.stream_launches = 0
    MKG.launches = MKG.champ_launches = 0
    t0 = time.perf_counter()
    for _ in range(GRID_TRAIN_STEPS):
        st, loss, grads = step(st)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / GRID_TRAIN_STEPS
    k1, k2, k3 = MK.launches, MKG.launches, MKG.champ_launches
    _check(k1 == GRID_TRAIN_STEPS and k3 == GRID_TRAIN_STEPS and k2 == 0,
           f"{name} train: {k1} kernel-1, {k3} kernel-3, {k2} kernel-2 "
           f"launches for {GRID_TRAIN_STEPS} steps")
    _check(MK.stream_launches == (GRID_TRAIN_STEPS if streamed else 0),
           f"{name} train: {MK.stream_launches} streamed kernel-1 launches")
    _check(bool(torch.isfinite(loss)), f"{name} train: loss")
    for k, gr in grads.items():
        _check(gr is not None and bool(torch.isfinite(gr).all()),
               f"{name} train: {k} gradient missing or not finite")
    _check(bool(grads["materials"].any()), f"{name}: materials grad zero")
    if "tv" in grads:
        _check(bool(grads["tv"].any()), f"{name}: mesh vertex grad zero")
    # kernels 1 (recording) and 3 alone on the last step's pass
    with torch.no_grad():
        sc_last = sc_of({k: p.detach() for k, p in params.items()})
        tabs = mega.scene_tables(sc_last, cfg)
    ipar = torch.tensor([st["passes"] - 1, 0], dtype=torch.int32)
    g = seen["g"].contiguous()
    rec_kw = dict(kw, block=block, record=True, **accel(sc_last, tabs))
    _, ids, occs = MK.pathtrace_pass(tabs[0], ipar, *tabs[1:],
                                     torch.zeros_like(g), None, **rec_kw)
    start.record()
    for _ in range(GRID_REPS):
        MK.pathtrace_pass(tabs[0], ipar, *tabs[1:], torch.zeros_like(g),
                          None, **rec_kw)
    end.record()
    torch.cuda.synchronize()
    rec_ms = start.elapsed_time(end) / GRID_REPS
    k3kw = dict(kw, diff_wrt=wrt)
    MKG.pathtrace_pass_bwd_champ(tabs[0], ipar, *tabs[1:], g, None, ids,
                                 occs, **k3kw)
    start.record()
    for _ in range(GRID_REPS):
        got3 = MKG.pathtrace_pass_bwd_champ(tabs[0], ipar, *tabs[1:], g,
                                            None, ids, occs, **k3kw)
    end.record()
    torch.cuda.synchronize()
    k3_ms = start.elapsed_time(end) / GRID_REPS
    t1 = time.perf_counter()
    want3 = MKG.pathtrace_pass_bwd_champ_reference(
        tabs[0], ipar, *tabs[1:], g, None, ids, occs, **k3kw)
    torch.cuda.synchronize()
    plain3_ms = (time.perf_counter() - t1) * 1e3
    print(f"  {name}: kernel 3 on the last step's record and cotangent vs "
          "plain version:")
    err3 = max(_grad_gates(n, a, b, False)
               for n, a, b in zip(MKG.DIFF_ALL, want3, got3) if n in wrt)
    live = (g != 0).any(-1)
    print(f"  {name}: kernel 3 {k3_ms:.6g} ms; "
          + _add_counts(MKG, ids, tabs[1].shape[0], tabs[2].shape[0], wrt,
                        live))
    w3 = _pass_work(ids, occs, n_l, tabs[1].shape[0], live)
    k3_ops = _k3_ops(w3, n_l, wrt)
    k3_bound = _bound(k3_ops, 12 * cfg.total_rays
                      + (1 + cfg.bounces) * (4 + n_l) * w3["rays"]
                      + 2 * _table_bytes(tabs))
    rec_bound = _bound(ops, (24 + (1 + cfg.bounces) * (4 + n_l))
                       * cfg.total_rays + bytes_of(tabs))
    print(f"phase {phase} train {name} {MAIN_W}x{MAIN_H} b{BOUNCES} wrt "
          f"{list(wrt)}, cell route, {GRID_TRAIN_STEPS} timed steps on "
          f"[{smi}]: {step_ms:.6g} ms/step, {segs / (step_ms / 1e3):.6g} "
          f"fwd+bwd ray segments/s; launches kernel 1 {k1}, kernel 3 {k3}, "
          f"kernel 2 {k2}; alone on the last step: kernel 1 recording "
          f"{rec_ms:.6g} ms (bound {rec_bound['bound_ms']:.6g} ms, share "
          f"{rec_bound['bound_ms'] / rec_ms:.3%}), kernel 3 {k3_ms:.6g} ms "
          f"(bound {k3_bound['bound_ms']:.6g} ms, {k3_bound['bound_by']}, "
          f"share {k3_bound['bound_ms'] / k3_ms:.3%}), plain champion "
          f"backward {plain3_ms:.6g} ms; loss first {loss0.item():.7g} last "
          f"{loss.item():.7g}")
    return fwd, {"launches": k3, "ms": k3_ms, "plain_ms": plain3_ms,
                 "max_abs_err": err3, "step_ms": step_ms, "rec_ms": rec_ms,
                 **k3_bound}


def kernel3_on_record(dev, shape: str, w: int, h: int, wrt,
                           max_gate: bool, stream: bool = False) -> dict:
    """Phase 19: kernel 3 (PRNG and u-planes routes) vs its plain version
    on kernel 1's grid-mode record (original rows) and a seeded random
    cotangent, under phase 6's gates; with ``stream`` (phase 21) on kernel
    1's record over the streamed tables of ``_stream_scene(shape)``."""
    import numpy as np
    import torch
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    scene = (_stream_scene if stream else _grid_scene)(shape, w, h, dev)
    cfg = (_stream_cfg if stream else _grid_cfg)(shape, w, h, "path")
    tables = mega.scene_tables(scene, cfg)
    accel = ({"chunks": mega.chunk_tables(scene, cfg, tables[1], tables[2])}
             if stream else {"grid": mega.grid_tables(scene, tables[1],
                                                      tables[2])})
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], 0, cfg,
                               scene.lights.count, dev)
    _, ids, occs = MK.pathtrace_pass(
        tables[0], ipar, *tables[1:],
        torch.zeros((cfg.total_rays, 3), device=dev), None, record=True,
        **accel, **_pass_kw(cfg))
    g = torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=dev)
    kw = _pass_kw(cfg, diff_wrt=wrt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = MKG.pathtrace_pass_bwd_champ_reference(
        tables[0], ipar, *tables[1:], g, u, ids, occs, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_sph = tables[1].shape[0]
    tri_ids = ids[ids >= n_sph]
    print(f"phase {21 if stream else 19} kernel 3 on the "
          f"{'streamed' if stream else 'grid'} record, {shape} {w}x{h} "
          f"b{BOUNCES} wrt {list(wrt)}: plain {plain_ms:.6g} ms; recorded "
          f"rows: spheres {int(((ids >= 0) & (ids < n_sph)).sum())}, "
          f"triangles {tri_ids.numel()} (largest row "
          f"{int(ids.max())} of {n_sph + tables[2].shape[0]}); "
          + _add_counts(MKG, ids, n_sph, tables[2].shape[0], wrt))
    err = 0.0
    for route, uu in (("u-planes", u), ("PRNG", None)):
        got = MKG.pathtrace_pass_bwd_champ(tables[0], ipar, *tables[1:], g,
                                           uu, ids, occs, **kw)
        torch.cuda.synchronize()
        print(f"  kernel 3 {route} route vs plain version:")
        for gname, a, b in zip(MKG.DIFF_ALL, want, got):
            if gname in wrt:
                err = max(err, _grad_gates(gname, a, b, max_gate))
    return {"max_abs_err": err, "plain_ms": plain_ms}


def _record_bound(tables, ids, occs, cfg):
    """Kernel 1 recording the pass (ids, occs): its bound and operations
    per ray."""
    n_s, n_t, n_l = (t.shape[0] for t in tables[1:3] + tables[4:5])
    work = _pass_work(ids, occs, n_l, n_s)
    ops = _k1_ops(work, n_s, n_t, n_l)
    nbytes = ((24 + (1 + cfg.bounces) * (4 + n_l)) * cfg.total_rays
              + _table_bytes(tables))
    return _bound(ops, nbytes), ops / work["rays"]


def _cell_bounds(tables, ids, occs, g, cfg):
    """Bounds of kernel 1 recording a pass (ids, occs) and of kernel 3 on
    that record and cotangent g; also the operations per ray of each."""
    n_s, n_l = tables[1].shape[0], tables[4].shape[0]
    k1, k1_ops = _record_bound(tables, ids, occs, cfg)
    live = (g != 0).any(-1)
    w3 = _pass_work(ids, occs, n_l, n_s, live)
    k3_ops = _k3_ops(w3, n_l, TRAIN_WRT)
    k3 = _bound(k3_ops, 12 * cfg.total_rays
                + (1 + cfg.bounces) * (4 + n_l) * w3["rays"]
                + 2 * _table_bytes(tables))
    return k1, k3, (k1_ops, k3_ops / max(w3["rays"], 1))


def _add_counts(MKG, ids, n_s: int, n_t: int, wrt, live=None) -> str:
    """Phases 18, 19, 21 and 22: kernel 3's hot rows of the record ``ids``
    built on the card (``MKG.hot_rows``: the count and select kernels)
    held equal to their plain version (fatal), then the plain count of
    kernel 3's sphere and triangle row adds over the rays ``live``
    (``MKG.champ_add_count`` at those hot rows, a grid of 4 blocks per
    SM): the scalar atomics of the design before the hot rows (one per
    warp, row and word) against this one's slab adds, vector reductions
    and flushes."""
    import torch
    slot, hot = MKG.hot_rows(ids, n_s, n_t)
    want = MKG.hot_rows_reference(ids.cpu(), n_s, n_t, MKG.HOT_TRI)
    _check(torch.equal(slot.cpu(), want[0])
           and torch.equal(hot.cpu(), want[1]),
           f"kernel 3's hot rows on the card differ from their plain "
           f"version on a record of {ids.numel()} ids, {n_t} triangle "
           f"rows: hot {hot.tolist()} against {want[1].tolist()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    c = MKG.champ_add_count(ids, n_s, n_t, slot, wrt, live=live,
                            blocks=4 * sms)
    return (f"hot rows {hot.tolist()} (equal to the plain version's); "
            f"row adds (plain count): {c['atomics_parent']} scalar atomics "
            f"before the hot rows, {c['adds_new']} now (slab "
            f"{c['slab_adds']}, vector reductions {c['vector_reds']}, "
            f"flushes {c['flush_reds']}); triangle champions per live ray "
            f"{c['tri_champions_per_ray']:.4g}, hot share of the warps' "
            f"triangle row groups "
            f"{c['tri_hot_groups'] / max(c['tri_groups'], 1):.4g}")


def _soft_dense(n_sph: int, n_tri: int) -> dict:
    """Kernel 2s's work per segment ("surface") and per shadow ray
    ("shadow") on dense tables, in MKS.live_stats' terms: every row
    evaluates every factor of alpha and is live, every pair of every span
    (past 64 objects in two levels: within each SOFT_CHUNK span of one
    type, then between the spans' blends; a zero padding row is no work)."""
    n = n_sph + n_tri
    if n <= UNROLL_SPHERES:
        pairs, spans = n * (n - 1), 0
    else:
        widths = _soft_spans(n_sph) + _soft_spans(n_tri)
        spans = len(widths)
        pairs = sum(x * (x - 1) for x in widths) + spans * (spans - 1)
    rows = dict(reach_s=[n_sph] * len(OPS_SOFT_SPHERE_FACTORS),
                reach_t=[n_tri] * len(OPS_SOFT_TRIANGLE_FACTORS),
                rows_s=n_sph, rows_t=n_tri)
    return {"surface": dict(rows, pairs=pairs, spans=spans),
            "shadow": rows}


def _reach(w: dict, sphere, triangle) -> float:
    """The cost of the factors the rows of w evaluate (w's reach_s and
    reach_t against per-factor costs)."""
    return (sum(n * c for n, c in zip(w["reach_s"], sphere))
            + sum(n * c for n, c in zip(w["reach_t"], triangle)))


def _soft_ops(rays: float, segs: float, n_lig: int, work: dict,
              direct: bool = False) -> float:
    """FP32 operations of kernel 2s without the roulette and without par
    (the main path's step) over ``rays`` live rays (g != 0, inside the
    scene box) with ``segs`` segments between them, where each segment
    and each shadow ray does ``work`` (_soft_dense: the tables' own; or
    MKS.live_stats' per-ray means: what this run's data needs). Each
    segment's soft surface, each shadow ray's transmittance, the emitter
    and the bounce count once, then their adjoints. ``direct``: direct
    mode's (one segment per ray, the shade per light, no emitter term)."""
    sur, sh = work["surface"], work["shadow"]
    blends = sur["rows_s"] + sur["rows_t"] + sur["spans"]
    # the surface, the throughput (3 per light), and their adjoints
    surface = (_reach(sur, OPS_SOFT_SPHERE_FACTORS, OPS_SOFT_TRIANGLE_FACTORS)
               + sur["rows_s"] * (OPS_SOFT_FIELDS_SPHERE
                                  + OPS_SOFT_HYP_ADJ_SPHERE
                                  + OPS_SOFT_FIELDS_ADJ_SPHERE)
               + sur["rows_t"] * (OPS_SOFT_FIELDS_TRIANGLE
                                  + OPS_SOFT_HYP_ADJ_TRIANGLE
                                  + OPS_SOFT_FIELDS_ADJ_TRIANGLE)
               + sur["pairs"] * (OPS_SOFT_PAIR + OPS_SOFT_PAIR_ADJ)
               + blends * (OPS_SOFT_BLEND + OPS_SOFT_BLEND_ADJ)
               + sur["spans"] * (OPS_SOFT_SPAN + OPS_SOFT_SPAN_ADJ)
               + OPS_SOFT_SEGMENT + OPS_SOFT_SEGMENT_ADJ + 3 * n_lig)
    nee = (_reach(sh, OPS_SOFT_SPHERE_FACTORS, OPS_SOFT_TRIANGLE_FACTORS)
           + (sh["rows_s"] + sh["rows_t"]) * (OPS_SOFT_OCCLUDER
                                              + OPS_SOFT_OCCLUDER_ADJ)
           + sh["rows_s"] * OPS_SOFT_HYP_ADJ_SPHERE
           + sh["rows_t"] * OPS_SOFT_HYP_ADJ_TRIANGLE + OPS_SOFT_NEE_ADJ)
    if direct:
        # one segment, no emitter term: the shade per light
        nee += OPS_SOFT_DIRECT_NEE + OPS_SOFT_DIRECT_NEE_ADJ - OPS_SOFT_NEE_ADJ
        return rays * OPS_CAMERA + segs * (surface + n_lig * nee)
    return (rays * (OPS_CAMERA + n_lig * (OPS_SOFT_EMIT + OPS_SOFT_EMIT_ADJ))
            + segs * (surface + n_lig * nee)
            + (segs - rays) * (OPS_BOUNCE + OPS_SOFT_BOUNCE_ADJ + 1))


def _soft_sfu(rays: float, segs: float, n_lig: int, work: dict,
              direct: bool = False) -> float:
    """Special-function (MUFU) operations of kernel 2s on the work of
    _soft_ops (same arguments): each factor, field, ordered pair,
    composite, occluder and scalar piece once, with SFU_SOFT_*."""
    sur, sh = work["surface"], work["shadow"]
    surface = (_reach(sur, SFU_SOFT_SPHERE_FACTORS, SFU_SOFT_TRIANGLE_FACTORS)
               + (sur["rows_s"] + sur["rows_t"]) * SFU_SOFT_FIELDS
               + sur["pairs"] * SFU_SOFT_SIGMOID
               + (sur["spans"] + 1) * SFU_SOFT_COMPOSITE + SFU_SOFT_SEGMENT
               + sur["rows_s"] * SFU_SOFT_HYP_ADJ_SPHERE
               + sur["rows_t"] * SFU_SOFT_HYP_ADJ_TRIANGLE)
    nee = (_reach(sh, SFU_SOFT_SPHERE_FACTORS, SFU_SOFT_TRIANGLE_FACTORS)
           + (sh["rows_s"] + sh["rows_t"]) * SFU_SOFT_SIGMOID
           + sh["rows_s"] * (SFU_SOFT_HYP_ADJ_SPHERE - 1) + SFU_SOFT_NEE)
    if direct:
        return rays * SFU_SOFT_CAMERA + segs * (surface + n_lig * nee)
    return (rays * (SFU_SOFT_CAMERA + n_lig * SFU_SOFT_EMIT)
            + segs * (surface + n_lig * nee)
            + (segs - rays) * SFU_SOFT_BOUNCE)


def _soft_live(MKS, args: tuple, kw: dict, n_rays: int) -> dict:
    """MKS.live_stats of one kernel 2s call (its wrapper's positional
    arguments and keywords) on LIVE_BLOCKS blocks of LIVE_BLOCK rays spread
    evenly over its n_rays."""
    par, ipar, sph, tri, mat, lig, _, u = args
    step = n_rays // LIVE_BLOCKS // 32 * 32
    return MKS.live_stats(
        par, ipar, sph, tri, mat, lig, u,
        blocks=[(b * step, min(LIVE_BLOCK, n_rays - b * step))
                for b in range(LIVE_BLOCKS)],
        **{k: v for k, v in kw.items() if k != "diff_wrt"})


@functools.lru_cache(maxsize=None)
def _sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    return float(_smi("clocks.max.sm").split()[0]) * 1e6


def _sfu_bound(sfu: float) -> dict:
    """Kernel 2s's second bound: its MUFU operations over 16 per SM per
    clock on every SM at the maximum SM clock."""
    rate = PEAK_SFU_PER_SM_CLOCK * N_SMS * _sm_clock_hz()
    return {"bound_sfu_ms": 1e3 * sfu / rate}


def _soft_stats(MKS, rr: bool, direct: bool) -> dict:
    """Kernel 2s's last launch (MKS.last_launch: lanes per ray, 1 for the
    large-table kernel's thread per ray; shared memory per block;
    registers) and its instance's ptxas report (stack frame and spill
    bytes) from the build's log."""
    import re
    from raytracing_tpu_torch.ops import _build
    last = MKS.last_launch()
    flags = _build.NVCC_FLAGS + MKS.soft_flags(rr, direct)
    src = _build.CSRC / "megakernel_soft.cu"
    log = _build.BUILD_DIR / (f"libmegakernel_soft-"
                              f"{_build._source_hash(src, flags)}.log")
    text = log.read_text() if log.exists() else ""
    # the instance that ran, by its template arguments: the group layout's
    # <G, kRR, kDirect>, or the large-table kernel's <kRR, kDirect>
    inst = (f"soft_large_kernelILb{int(rr)}ELb{int(direct)}E"
            if last["group"] == 1 else
            f"soft_kernelILi{last['group']}ELb{int(rr)}ELb{int(direct)}E")
    stack = spill = None
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and inst in line:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", lines[i + 1])
            if m:
                stack, spill = int(m.group(1)), int(m.group(2))
            break
    return {"group": last["group"], "registers": last["registers"],
            "stack_bytes": stack, "spill_bytes": spill,
            "smem_bytes": last["smem_bytes"],
            "warps_per_sm": last["warps_per_sm"]}


def _soft_work(MK, tables, g, cfg) -> tuple:
    """(live rays, their segments) of kernel 2s without the roulette: the
    rays with g != 0 whose primary ray meets the scene box."""
    import torch
    lens = torch.full((cfg.total_rays, 2), 0.5, device=g.device)
    _, _, mint, _ = MK._camera_rays(tables[0], lens, cfg.total_rays, 0,
                                    cfg.spp, cfg.width)
    live = ((g != 0).any(-1) & (mint < float("inf"))).double().sum().item()
    return live, live * (1 + cfg.bounces)


def _soft_plain(MKS, tables, ipar, g, u, kw, chunk: int = 1 << 18):
    """Kernel 2s's plain version over the rays in chunks of ``chunk`` (its
    autograd graph at 1024^2 would not fit at once): the cotangents add
    over rays, each chunk at its own ray offset."""
    import torch
    out = None
    for lo in range(0, g.shape[0], chunk):
        part = MKS.pathtrace_pass_bwd_soft_reference(
            tables[0], torch.tensor([int(ipar[0]), lo], dtype=torch.int32),
            *tables[1:], g[lo:lo + chunk],
            None if u is None else u[:, lo:lo + chunk].contiguous(), **kw)
        out = part if out is None else tuple(a + b for a, b in zip(out, part))
    return out


def kernel2s_vs_plain(dev, w: int, h: int, wrt, rr: bool) -> dict:
    """Phase 20 (a): kernel 2s (u-planes and PRNG routes) vs its plain
    version on cornell at w x h b5 with the same tables, draws and seeded
    random cotangent, under phase 6's gates."""
    import numpy as np
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.ops import megakernel_soft as MKS
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                       russian_roulette=rr, rr_start_depth=RR_START,
                       use_megakernel=True)
    scene = cornell_box(cols=w, rows=h, device=dev)
    tables = mega.scene_tables(scene, cfg)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    u = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], 0, cfg,
                               scene.lights.count, dev)
    g = torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=dev)
    kw = _pass_kw(cfg, diff_wrt=wrt, soft_bandwidth=EDGE_BW,
                  soft_tau=EDGE_BW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _soft_plain(MKS, tables, ipar, g, u, kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_u = MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:], g, u,
                                        **kw)
    got_p = MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:], g,
                                        None, **kw)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 3
    start.record()
    for _ in range(reps):
        MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:], g, None,
                                    **kw)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    print(f"phase 20 kernel 2s cornell {w}x{h} b{BOUNCES} wrt {list(wrt)}"
          f"{' with the roulette' if rr else ''}: plain {plain_ms:.6g} ms; "
          f"kernel 2s (PRNG route, random g) {ms:.6g} ms")
    err = 0.0
    for route, got in (("u-planes", got_u), ("PRNG", got_p)):
        print(f"  kernel 2s {route} route vs plain version:")
        for name, a, b in zip(MKG.DIFF_ALL, want, got):
            if name in wrt:
                err = max(err, _grad_gates(name, a, b, True))
            else:
                _check(not b.any().item(), f"{name} outside diff_wrt "
                       "is not zero")
    print("  PRNG route vs u-planes route:")
    for name, a, b in zip(MKG.DIFF_ALL, got_u, got_p):
        if name in wrt:
            _grad_gates(name, a, b, True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _edge_params(scene):
    """Every table group's source in the scene, requiring grad."""
    return {"center": scene.spheres.center, "tv": scene.triangles.v,
            "materials": scene.materials, "irr": scene.lights.irradiance,
            "eye": scene.camera.eye}


def _with_params(scene, p):
    from raytracing_tpu_torch import replace
    return replace(
        scene, spheres=replace(scene.spheres, center=p["center"]),
        triangles=replace(scene.triangles, v=p["tv"]),
        lights=replace(scene.lights, irradiance=p["irr"]),
        materials=p["materials"], camera=replace(scene.camera, eye=p["eye"]))


def edge_grid_vs_brute(dev, w: int, h: int) -> float:
    """Phase 20 (b): edge mode over prepare_grids(cornell, 2) (kernel 1's
    grid mode forward, kernel 2s over the scene's own rows) against the
    brute edge route, all five groups, the same seeded cotangent of acc:
    equal up to the order of kernel 2s's float atomics. Returns the
    largest |d| over the groups' scales."""
    import numpy as np
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.accel import prepare_grids
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.ops import megakernel_soft as MKS
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                       use_megakernel=True, mega_edge_bandwidth=EDGE_BW)
    scene = cornell_box(cols=w, rows=h, device=dev)
    gs, gcfg = prepare_grids(scene, 2), replace(cfg, use_grid=True)
    _check(mega.bwd_impl_for(gs, gcfg) == "pallas",
           "edge mode over grids does not take kernel 2s")
    gacc = torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=dev)
    grads = []
    for sc, c in ((scene, cfg), (gs, gcfg)):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in _edge_params(sc).items()}
        MK.launches = MKS.soft_launches = MKG.launches = 0
        acc = mega.render_pass_mega(_with_params(sc, p),
                                    pt.init_state(c, dev), c)["acc"]
        grads.append(torch.autograd.grad((acc * gacc).sum(),
                                          list(p.values())))
        torch.cuda.synchronize()
        _check(MK.launches == 1 and MKS.soft_launches == 1
               and MKG.launches == 0,
               f"edge {'grid' if c.use_grid else 'brute'} pass: "
               f"{MK.launches} kernel-1, {MKS.soft_launches} kernel-2s and "
               f"{MKG.launches} kernel-2 launches (want 1, 1, 0)")
    worst = 0.0
    print(f"phase 20 edge x grid, cornell {w}x{h} b{BOUNCES} in "
          "prepare_grids(., 2) vs brute, all groups:")
    for name, a, b in zip(_edge_params(scene), *grads):
        a, b = a.double().ravel(), b.double().ravel()
        _check(bool(torch.isfinite(b).all()), f"{name}: not finite")
        scale = a.abs().max().item()
        rel = (a - b).abs().max().item() / max(scale, 1e-30)
        cos = (a @ b).item() / max(a.norm().item() * b.norm().item(), 1e-300)
        print(f"    {name}: cosine {cos:.9f}, max|d| {rel:.3g} x "
              f"max|brute| {scale:.6g}")
        _check(scale > 0 and cos >= 0.999999 and rel <= 1e-4,
               f"edge x grid {name}: cosine {cos:.9f}, max|d| {rel:.3g}")
        worst = max(worst, rel)
    return worst


def _bench_step(scene, cfg, dev, seen: dict):
    """bench.py::_train_bench's step (one pass, mean(image^2), grads wrt
    sphere centres, radii and materials; parameters fixed, the state
    threaded): (the state after a warm-up step, the step)."""
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.render import pathtracer as pt

    params = {"center": scene.spheres.center.clone().requires_grad_(True),
              "radius": scene.spheres.radius.clone().requires_grad_(True),
              "materials": scene.materials.clone().requires_grad_(True)}
    sc = replace(scene, spheres=replace(scene.spheres,
                                        center=params["center"],
                                        radius=params["radius"]),
                 materials=params["materials"])

    def step(state):
        st = pt.render_pass(sc, state, cfg)
        st["acc"].register_hook(lambda g: seen.__setitem__("g", g))
        loss = torch.mean(pt.image(st, cfg) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()))
        return dict(st, acc=st["acc"].detach()), loss.detach(), grads

    state, _, _ = step(pt.init_state(cfg, dev))
    torch.cuda.synchronize()
    return state, step


def edge_train(dev, smi: str) -> dict:
    """Phase 20 (c): the BENCH_EDGE step at 1024^2 b5 with ("sph", "mat")
    beside the hard step, in the same run; returns kernel 2s's entry."""
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.models.scenes import cornell_box
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.ops import megakernel_soft as MKS
    from raytracing_tpu_torch.render import mega

    scene = cornell_box(cols=MAIN_W, rows=MAIN_H, device=dev)
    hard = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                        mega_grad_wrt=TRAIN_WRT, use_megakernel=True)
    edge = replace(hard, mega_edge_bandwidth=EDGE_BW)
    n_l = scene.lights.count
    segs = hard.total_rays * (1 + n_l + hard.bounces * (1 + n_l))
    res = {}
    for label, cfg in (("hard", hard), ("edge", edge)):
        seen, times = {}, []
        state, step = _bench_step(scene, cfg, dev, seen)
        MK.launches = MKG.launches = MKS.soft_launches = 0
        for _ in range(EDGE_STEPS):
            t0 = time.perf_counter()
            state, loss, grads = step(state)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        k1, k2, k2s = MK.launches, MKG.launches, MKS.soft_launches
        want = (EDGE_STEPS, 0, EDGE_STEPS) if label == "edge" else (
            EDGE_STEPS, EDGE_STEPS, 0)
        _check((k1, k2, k2s) == want,
               f"{label} step: {k1} kernel-1, {k2} kernel-2 and {k2s} "
               f"kernel-2s launches for {EDGE_STEPS} steps (want {want})")
        _check(bool(torch.isfinite(loss)), f"{label} loss not finite")
        for name, gr in zip(("center", "radius", "materials"), grads):
            _check(bool(torch.isfinite(gr).all()),
                   f"{label} {name} gradient not finite")
        _check(bool(grads[0].any()) and bool(grads[2].any()),
               f"{label} center or materials gradient is zero")
        ms = float(sorted(times)[len(times) // 2])
        res[label] = {"ms": ms, "g": seen["g"].contiguous(),
                      "passes": state["passes"], "launches": k2s}
        print(f"phase 20 {label} train step cornell {MAIN_W}x{MAIN_H} "
              f"b{BOUNCES} wrt {list(TRAIN_WRT)}"
              f"{f' mega_edge_bandwidth {EDGE_BW:g}' if cfg is edge else ''}"
              f" on [{smi}]: median {ms:.6g} ms/step of {EDGE_STEPS} (min "
              f"{min(times):.6g}, max {max(times):.6g}), "
              f"{segs / ms * 1e3:.6g} fwd+bwd ray segments/s ({segs} per "
              f"step); launches kernel 1 {k1}, kernel 2 {k2}, kernel 2s {k2s};"
              f" loss {loss.item():.7g}; |grad| center "
              f"{grads[0].norm().item():.6g} materials "
              f"{grads[2].norm().item():.6g}")
    ratio = res["edge"]["ms"] / res["hard"]["ms"]
    print(f"phase 20 edge step / hard step: {ratio:.4g}x (bench.py:66-68's "
          "budget is 3x; recorded, not gated)")

    # kernel 2s alone on the last edge step's own cotangent, against its
    # plain version on the same inputs
    tables = mega.scene_tables(scene, edge)
    ipar = torch.tensor([res["edge"]["passes"] - 1, 0], dtype=torch.int32)
    kw = _pass_kw(edge, diff_wrt=TRAIN_WRT, soft_bandwidth=EDGE_BW,
                  soft_tau=EDGE_BW)
    g = res["edge"]["g"]
    got = MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:], g, None,
                                      **kw)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 5
    start.record()
    for _ in range(reps):
        MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:], g, None,
                                    **kw)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _soft_plain(MKS, tables, ipar, g, None, kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    print("  kernel 2s on the step's cotangent vs plain version:")
    err = 0.0
    for name, a, b in zip(MKG.DIFF_ALL, want, got):
        if name in TRAIN_WRT:
            err = max(err, _grad_gates(name, a, b, True))
    stats = _soft_stats(MKS, False, False)
    rays, nsegs = _soft_work(MK, tables, g, edge)
    dense = _soft_dense(tables[1].shape[0], tables[2].shape[0])
    ops = _soft_ops(rays, nsegs, n_l, dense)
    sfu = _soft_sfu(rays, nsegs, n_l, dense)
    bound = {**_bound(ops, 12 * edge.total_rays + 2 * _table_bytes(tables)),
             **_sfu_bound(sfu)}
    print(f"phase 20 kernel 2s alone on the step's cotangent {ms:.6g} ms "
          f"({ms / res['edge']['ms']:.3%} of the edge step), plain version "
          f"{plain_ms:.6g} ms; bound: {ops / max(rays, 1):.6g} FP32 "
          f"operations per live ray (OPS_SOFT_* constants, expf counted as "
          f"one; {rays:.0f} live rays, {nsegs:.0f} segments) -> "
          f"{bound['bound_ms']:.6g} ms ({bound['bound_by']}); share of the "
          f"bound {bound['bound_ms'] / ms:.3%}; second bound "
          f"{sfu / max(rays, 1):.6g} MUFU operations per live ray "
          f"(SFU_SOFT_*) -> {bound['bound_sfu_ms']:.6g} ms, share "
          f"{bound['bound_sfu_ms'] / ms:.3%}; launch {stats}")
    return {"launches": res["edge"]["launches"], "ms": ms,
            "plain_ms": plain_ms, "max_abs_err": err,
            "step_ms": res["edge"]["ms"], "hard_step_ms": res["hard"]["ms"],
            "stats": stats, **bound}


def _stream_scene(shape: str, w: int, h: int, dev):
    """Phase 21's scenes, no grid prepared: cornell plus the torus of
    TORUS_SEGMENTS (1,002 triangles: 8 streamed chunks; "house": of
    HOUSE_SEGMENTS, 5,322 triangles in 42 chunks) or
    sphere_field(STREAM_SPHERES) (64 streamed sphere chunks)."""
    from raytracing_tpu_torch.models.scenes import sphere_field
    if shape == "spheres":
        return sphere_field(STREAM_SPHERES, cols=w, rows=h, device=dev)
    sys.path.insert(0, str(HERE / "tests"))
    from torch_grid_scenes import cornell_torus
    segs = HOUSE_SEGMENTS if shape == "house" else TORUS_SEGMENTS
    return cornell_torus(w, h, *segs, device=dev)


def _stream_cfg(shape: str, w: int, h: int, mode: str, **kw):
    from raytracing_tpu_torch import RenderConfig
    return RenderConfig(width=w, height=h,
                        bounces=0 if mode == "direct" else BOUNCES,
                        use_megakernel=True, russian_roulette=mode == "rr",
                        rr_start_depth=RR_START, **kw)


def _stream_bytes(tables, chunks) -> int:
    """The tables (a streamed one read through its order) and each
    stream's order (perm) and walk layout (node boxes, leaf masks, loose
    positions)."""
    return _table_bytes(tables) + sum(
        4 * (st.perm.numel() + st.tree.nodes.numel() + st.tree.masks.numel()
             + st.tree.loose.numel())
        for st in (chunks.tri, chunks.sph) if st is not None)


def _stream_counts(work: dict, walk: dict) -> dict:
    """The two counts of a streamed pass's slab and row tests that a bound
    may price: the Morton order's (the plain version's ``work``: every
    chunk's slab test, the rows of the chunks a ray overlaps) and the
    tree walk's (``MK.tree_walk_work``: node slab tests, loose and leaf
    rows), a shadow ray's rows up to its first occluder in both."""
    rows = ("sph_tests", "tri_tests")
    return {"morton": {"slab_tests": work["chunk_tests"],
                       **{k: work.get(k, 0) for k in rows}},
            "tree": {"slab_tests": walk["node_tests"],
                     **{k: walk.get(k, 0) for k in rows}}}


def _stream_ops(w: dict, work: dict, chunks, n_sph: int, n_tri: int,
                n_lig: int, direct: bool) -> float:
    """FP32 operations of a streamed pass: the resident tables as _k1_ops
    and _direct_ops count them, the streamed set-up (OPS_STREAM) per
    traced segment and shadow ray, and the slab tests (OPS_CHUNK each, a
    chunk's or a node's) and the (ray, row) tests of one count of
    ``_stream_counts`` (``work``, scaled to this pass's rays; a shadow
    ray's rows up to its first occluder)."""
    n_s = 0 if chunks.sph is not None else n_sph
    n_t = 0 if chunks.tri is not None else n_tri
    tests = n_s * OPS_SPHERE_TEST + n_t * OPS_TRIANGLE_TEST
    one = OPS_TRIANGLE_TEST if n_t else (OPS_SPHERE_TEST if n_s else 0)
    seg = w["primary"] if direct else w["traced"]
    ops = (w["rays"] * OPS_CAMERA + seg * (OPS_TRACE + tests)
           + w["sph_hits"] * OPS_SPHERE_HIT + w["tri_hits"] * OPS_TRIANGLE_HIT
           + w["free"] * tests + w["occluded"] * one
           + (seg + w["shadow"]) * OPS_STREAM
           + work["slab_tests"] * OPS_CHUNK
           + work.get("sph_tests", 0) * OPS_SPHERE_TEST
           + work.get("tri_tests", 0) * OPS_TRIANGLE_TEST)
    if direct:
        return ops + w["shadow"] * OPS_DIRECT_SHADE
    return ops + (w["primary"] * n_lig * OPS_EMITTER + w["shadow"] * OPS_NEE
                  + w["bounces"] * OPS_BOUNCE + w["rr"] * OPS_RR)


def stream_vs_plain(dev, shape: str, mode: str) -> dict:
    """Phase 21 (1) at 256x192, one shape and mode ("direct", "path",
    "rr"): kernel 1 over the streamed tables against its plain streamed
    version on the same draws, the path modes recording (in "path" the
    launch without the record gives the recording launch's accumulator
    bit for bit): phase 3's gates and at most 1% of id slots and of
    occlusion bits differing (the grazing share) on the torus,
    SPHERE_GATES on the spheres; its --fmad=false build equal on every
    ray, id and bit; the tree walk's counts on the plain version's rays
    (``MK.tree_walk_work``), which must keep every champion and occlusion
    bit of the plain version. Returns max |d|, the plain ms and the two
    counts (``_stream_counts``)."""
    import torch
    from raytracing_tpu_torch.core import rng
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    w, h = SMALL_W, SMALL_H
    scene = _stream_scene(shape, w, h, dev)
    cfg = _stream_cfg(shape, w, h, mode)
    tables = mega.scene_tables(scene, cfg)
    chunks = mega.chunk_tables(scene, cfg, tables[1], tables[2])
    if shape == "spheres":
        _check(chunks.tri is None and chunks.sph.n_chunks
               == STREAM_SPHERES // MK.STREAM_CHUNK, "spheres: chunks")
    else:
        _check(chunks.sph is None and chunks.tri.n_chunks == -(
            -tables[2].shape[0] // MK.STREAM_CHUNK), f"{shape}: chunks")
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    zeros = torch.zeros((cfg.total_rays, 3), device=dev)
    work = {}
    if mode == "direct":
        key = rng.base_key(cfg.seed)
        u = mega.u_planes_for_direct(key, cfg, scene.lights.count, dev)
        kw = dict(key=key, spp=1, width=w, two_sided=False, chunks=chunks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = (MK.direct_pass_reference(*tables, zeros, u, work=work,
                                         **kw),)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = (MK.direct_pass(*tables, zeros.clone(), u, **kw),)
        exact = (MK.direct_pass(*tables, zeros.clone(), u,
                                build_flags=EXACT_FLAGS, **kw),)
        walk_kw = dict(kw, bounces=0, normalize_emitter=False,
                       seed=cfg.seed, mode="direct")
    else:
        u = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], 0, cfg,
                                   scene.lights.count, dev)
        kw = _pass_kw(cfg, chunks=chunks)

        def run(**extra):
            return MK.pathtrace_pass(tables[0], ipar, *tables[1:],
                                     zeros.clone(), u, **kw, **extra)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = MK.pathtrace_pass_reference(tables[0], ipar, *tables[1:],
                                           zeros, u, work=work, record=True,
                                           **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = run(record=True)
        exact = run(record=True, build_flags=EXACT_FLAGS)
        if mode == "path":
            _check(torch.equal(run(), got[0]), f"{shape}: the recording "
                   "launch's acc differs from the path launch's")
        walk_kw = kw
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    walk = MK.tree_walk_work(tables[0], ipar, *tables[1:], zeros, u,
                             **walk_kw)
    walk_s = time.perf_counter() - t0
    err = (got[0] - want[0]).abs()
    beyond = (err > TOL + TOL * want[0].abs()).any(-1).double().mean().item()
    gm, wm = got[0].double().mean().item(), want[0].double().mean().item()
    rel = abs(gm - wm) / abs(wm)
    rec = len(got) > 1
    ids = (got[1] != want[1]).double().mean().item() if rec else 0.0
    ids0 = (got[1][0] != want[1][0]).double().mean().item() if rec else 0.0
    occs = (got[2] != want[2]).double().mean().item() if rec else 0.0
    same = all(torch.equal(a, b) for a, b in zip(exact, want))
    print(f"phase 21 streamed {shape} {mode} {w}x{h}: kernel vs plain "
          f"({plain_ms:.6g} ms) max|d acc| {err.max().item():.6g}, rays "
          f"beyond {TOL:g} {beyond:.6%}, mean rel {rel:.3g}, ids differ "
          f"{ids:.6%} (first segments {ids0:.6%}), occlusion bits {occs:.6%};"
          f" --fmad=false build equal {same}; plain chunk work: "
          f"{ {k: int(v) for k, v in work.items()} }")
    walks = walk["traces"] + walk["shadows"]
    kind = "sph_tests" if shape == "spheres" else "tri_tests"
    print(f"phase 21 streamed {shape} {mode} {w}x{h}: per live trace or "
          f"shadow ray ({walks}), the Morton chunks "
          f"{work['chunk_tests'] / walks:.4g} slab and "
          f"{work[kind] / walks:.4g} row tests, the tree walk "
          f"{walk['node_tests'] / walks:.4g} slab (node) and "
          f"{walk[kind] / walks:.4g} row tests "
          f"({walk.get('loose_tests', 0) / walks:.4g} loose), "
          f"{walk['leaf_visits'] / walks:.4g} leaves; a warp's union "
          f"{walk['union_leaves'] / walks * 32:.4g} leaves and "
          f"{walk['union_' + kind] / walks * 32:.4g} row tests per warp "
          f"of 32 such rays; champions missed {walk['misses']}, occlusion "
          f"bits missed {walk['occ_misses']} ({walk_s:.3g} s): "
          f"{ {k: int(v) for k, v in walk.items()} }")
    _check(walk["misses"] == 0 and walk["occ_misses"] == 0,
           f"{shape} {mode}: the tree walk culled a champion or occluder")
    _check(bool(torch.isfinite(got[0]).all()) and got[0].max().item() > 0,
           f"{shape} {mode}: streamed acc not finite or black")
    _check(same, f"{shape} {mode}: the --fmad=false build differs from the "
           "plain version")
    if rec:
        _check(bool((got[1] >= -1).all()) and bool(
            (got[1] < tables[1].shape[0] + tables[2].shape[0]).all()),
            f"{shape} {mode}: recorded ids outside the original rows")
    if shape == "spheres":
        d = {"beyond": beyond, "rel": rel, "ids": ids, "ids0": ids0}
        _check(all(d[k] <= SPHERE_GATES[k] for k in d),
               f"{shape} {mode}: {d}, limits {SPHERE_GATES}")
    else:
        _check(beyond <= 0.01 and rel <= 1e-5 and ids <= SPHERE_GATES["ids"]
               and occs <= SPHERE_GATES["ids"],
               f"{shape} {mode}: beyond {beyond:.4%}, mean rel {rel:.3g}, "
               f"ids {ids:.4%}, occlusion bits {occs:.4%}")
    return {"max_abs_err": err.max().item(), "plain_ms": plain_ms,
            "work": _stream_counts(work, walk)}


def _stream_bound(ops_of, nbytes: float) -> dict:
    """The bound of a streamed pass priced by each count of
    ``_stream_counts`` (``ops_of(order)``): ``bound_ms`` the smaller
    (what this run's data needs, by the cheaper order), ``bound_by`` its
    limit, ``bound_from`` its order, and each order's bound beside it."""
    b = {o: _bound(ops_of(o), nbytes) for o in ("morton", "tree")}
    best = min(b, key=lambda o: b[o]["bound_ms"])
    return {**b[best], "bound_from": best,
            "morton_bound_ms": b["morton"]["bound_ms"],
            "tree_bound_ms": b["tree"]["bound_ms"]}


def stream_plain_vs_brute(dev) -> None:
    """Phase 21 (2): the plain streamed version against the plain brute
    version over the same tables on the card, cornell plus the torus at
    STREAM_BRUTE_W x STREAM_BRUTE_H (the brute loops launch per object,
    ~1.3 ms per object and loop whatever the film), path b1 with its record
    and direct mode: equal accumulators, ids and bits."""
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.core import rng
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    w, h = STREAM_BRUTE_W, STREAM_BRUTE_H
    scene = _stream_scene("torus", w, h, dev)
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    for mode in ("path", "direct"):
        cfg = replace(_stream_cfg("torus", w, h, mode),
                      bounces=int(mode == "path"))
        tables = mega.scene_tables(scene, cfg)
        chunks = mega.chunk_tables(scene, cfg, tables[1], tables[2])
        zeros = torch.zeros((cfg.total_rays, 3), device=dev)
        t0 = time.perf_counter()
        if mode == "path":
            u = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], 0,
                                       cfg, scene.lights.count, dev)
            got, want = (MK.pathtrace_pass_reference(
                tables[0], ipar, *tables[1:], zeros, u, record=True,
                chunks=c, **_pass_kw(cfg)) for c in (chunks, None))
        else:
            key = rng.base_key(cfg.seed)
            u = mega.u_planes_for_direct(key, cfg, scene.lights.count, dev)
            got, want = ((MK.direct_pass_reference(
                *tables, zeros, u, key=key, spp=1, width=w, two_sided=False,
                chunks=c),) for c in (chunks, None))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"phase 21 plain streamed vs plain brute, cornell + torus "
              f"{w}x{h} {mode}{' b1' if mode == 'path' else ''} "
              f"({(time.perf_counter() - t0):.3g} s): equal {same}, max|d "
              f"acc| {(got[0] - want[0]).abs().max().item():g}")
        _check(same and got[0].max().item() > 0,
               f"{mode}: the plain streamed version != the brute one")


def stream_direct_main(dev, smi: str, work: dict) -> dict:
    """Phase 21 (4), the torus scene in direct mode at 1024^2 through
    render_direct, 16 passes per call (one launch per call, streamed), in
    rays/s as bench.py:225-228 counts them; the chunk build's ms (host
    clock, synchronised), the kernel alone, its first pass vs the plain
    version (phase 3's gates) and its bound (the 256x192 chunk work
    scaled). Returns the entry."""
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.core import rng
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render.direct import render_direct

    scene = _stream_scene("torus", MAIN_W, MAIN_H, dev)
    cfg = _stream_cfg("torus", MAIN_W, MAIN_H, "direct",
                      mega_block=GRID_BLOCK)
    n_rays = cfg.total_rays * (1 + scene.lights.count) * GRID_PASSES
    tables = mega.scene_tables(scene, cfg)
    chunks = mega.chunk_tables(scene, cfg, tables[1], tables[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRID_REPS):              # every call builds its chunks
        mega.chunk_tables(scene, cfg, tables[1], tables[2])
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3 / GRID_REPS
    key = rng.base_key(cfg.seed)
    img = render_direct(scene, cfg, n_passes=GRID_PASSES)        # warm-up
    torch.cuda.synchronize()
    MK.direct_launches = MK.launches = MK.stream_launches = 0
    t0 = time.perf_counter()
    for _ in range(GRID_REPS):
        img = render_direct(scene, cfg, n_passes=GRID_PASSES)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / GRID_REPS
    launches, streamed = MK.direct_launches, MK.stream_launches
    _check(launches == GRID_REPS and streamed == GRID_REPS
           and MK.launches == 0, f"direct: {launches} launches ({streamed} "
           f"streamed) for {GRID_REPS} calls")
    _check(bool(torch.isfinite(img).all()) and img.max().item() > 0,
           "direct: image not finite or black")
    acc = torch.zeros((cfg.total_rays, 3), device=dev)
    kw = dict(key=key, spp=1, width=MAIN_W, two_sided=False,
              n_passes=GRID_PASSES, chunks=chunks, block=GRID_BLOCK)
    MK.direct_pass(*tables, acc, None, **kw)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(GRID_REPS):
        MK.direct_pass(*tables, acc, None, **kw)
    end.record()
    torch.cuda.synchronize()
    k_ms = start.elapsed_time(end) / (GRID_REPS * GRID_PASSES)
    u = mega.u_planes_for_direct(key, cfg, scene.lights.count, dev)
    zeros = torch.zeros((cfg.total_rays, 3), device=dev)
    one = dict(key=key, spp=1, width=MAIN_W, two_sided=False, chunks=chunks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = MK.direct_pass_reference(*tables, zeros, u, **one)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = MK.direct_pass(*tables, zeros.clone(), u, block=GRID_BLOCK, **one)
    torch.cuda.synchronize()
    err = (got - want).abs()
    beyond = (err > TOL + TOL * want.abs()).any(-1).double().mean().item()
    rel = abs(got.double().mean().item() / want.double().mean().item() - 1)
    _check(beyond <= 0.01 and rel <= 1e-5,
           f"streamed direct 1024^2: beyond {beyond:.4%}, rel {rel:.3g}")
    _, ids, occs = MK.pathtrace_pass(
        tables[0], torch.tensor([0, 0], dtype=torch.int32), *tables[1:],
        torch.zeros_like(zeros), u, chunks=chunks, record=True,
        **_pass_kw(replace(cfg, bounces=0)))
    w = _pass_work(ids, occs, scene.lights.count, tables[1].shape[0])
    scale = cfg.total_rays / (SMALL_W * SMALL_H)
    bound = _stream_bound(
        lambda o: _stream_ops(w, _scaled(work[o], scale), chunks,
                              tables[1].shape[0], tables[2].shape[0],
                              scene.lights.count, True),
        24 * cfg.total_rays + _stream_bytes(tables, chunks))
    ops = _stream_ops(w, _scaled(work[bound["bound_from"]], scale), chunks,
                      tables[1].shape[0], tables[2].shape[0],
                      scene.lights.count, True)
    print(f"phase 21 cornell + torus ({tables[2].shape[0]} triangles, "
          f"{chunks.tri.n_chunks} chunks) {MAIN_W}x{MAIN_H} direct, "
          f"streamed, {GRID_PASSES} passes per call, B = {GRID_BLOCK} on "
          f"[{smi}]: {n_rays / (call_ms / 1e3):.6g} rays/s ({n_rays} per "
          f"call), call {call_ms:.6g} ms (chunk build {build_ms:.6g} ms), "
          f"kernel alone {k_ms:.6g} ms/pass "
          f"(device idle share "
          f"{max(0.0, 1 - k_ms * GRID_PASSES / call_ms):.3%}); launches "
          f"{launches}; plain version {plain_ms:.6g} ms, max|d acc| "
          f"{err.max().item():.6g}, rays beyond {TOL:g} {beyond:.6%}, mean "
          f"rel {rel:.3g}; bound {ops / cfg.total_rays:.6g} FP32 operations "
          f"per ray -> {bound['bound_ms']:.6g} ms ({bound['bound_by']}, "
          f"the {bound['bound_from']} count; the Morton chunks' "
          f"{bound['morton_bound_ms']:.6g} ms, the tree walk's "
          f"{bound['tree_bound_ms']:.6g} ms), share "
          f"{bound['bound_ms'] / k_ms:.3%}")
    return {"launches": launches, "ms": k_ms, "plain_ms": plain_ms,
            "max_abs_err": err.max().item(), **bound}


def stream_house(dev, smi: str) -> None:
    """Phase 21 (4), timing only: cornell plus the HOUSE_SEGMENTS torus
    streamed (the triangle count of BENCH_SCENE=house, whose asset is
    absent), path b5 at 1024^2 through render_passes, 16 passes per call
    at block 64: one streamed launch per call, ms per pass (CUDA events)
    after a warm-up call."""
    import torch
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import pathtracer as pt

    scene = _stream_scene("house", MAIN_W, MAIN_H, dev)
    cfg = _stream_cfg("house", MAIN_W, MAIN_H, "path", mega_block=GRID_BLOCK)
    state = pt.render_passes(scene, pt.init_state(cfg, dev), cfg,
                             GRID_PASSES)                        # warm-up
    torch.cuda.synchronize()
    MK.launches = MK.stream_launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    state = pt.render_passes(scene, state, cfg, GRID_PASSES)
    end.record()
    torch.cuda.synchronize()
    _check(MK.launches == 1 == MK.stream_launches,
           f"house stand-in: {MK.launches} launches, {MK.stream_launches} "
           "streamed, for one call")
    _check(bool(torch.isfinite(state["acc"]).all()), "house stand-in: acc")
    n_t = 2 * HOUSE_SEGMENTS[0] * HOUSE_SEGMENTS[1] + 10
    print(f"phase 21 house stand-in (cornell + torus, {n_t} triangles, "
          f"{-(-n_t // MK.STREAM_CHUNK)} chunks) {MAIN_W}x{MAIN_H} "
          f"b{BOUNCES}, B = {GRID_BLOCK}, {GRID_PASSES} passes per call on "
          f"[{smi}]: {start.elapsed_time(end) / GRID_PASSES:.6g} ms/pass "
          "(timing only)")


def stream_main(dev, smi: str, work: dict, grid_ms: float) -> dict:
    """Phase 21 (4) in path mode b5 at 1024^2 (``_path_main``): the torus
    scene streamed at B = GRID_BLOCK with the cell route's train step
    (("sph", "mat", "tri")), at B = 0, with the roulette from RR_START;
    sphere_field(STREAM_SPHERES) streamed beside shape 3's sphere-grid
    time of phase 18 (``grid_ms``). ``work`` holds the 256x192 counts of
    phase 21 (1) per shape and mode (``_stream_counts``); each bound is
    priced by the smaller (``_stream_bound``). Returns the entries by
    name."""
    from raytracing_tpu_torch.render import mega

    scale = MAIN_W * MAIN_H / (SMALL_W * SMALL_H)
    out = {}

    def run(label, shape, mode, train, block, wk):
        scene = _stream_scene(shape, MAIN_W, MAIN_H, dev)
        cfg = _stream_cfg(shape, MAIN_W, MAIN_H, mode, mega_block=block,
                          mega_grad_wrt=MESH_WRT)
        tables = mega.scene_tables(scene, cfg)
        n_s, n_t = tables[1].shape[0], tables[2].shape[0]
        chunks = mega.chunk_tables(scene, cfg, tables[1], tables[2])
        n_c = sum(st.n_chunks for st in (chunks.tri, chunks.sph)
                  if st is not None)
        name = (f"sphere_field({n_s})" if shape == "spheres"
                else f"cornell + torus ({n_t} triangles)")
        priced = {}

        def ops_of(w):
            priced.update({o: _stream_ops(w, _scaled(wk[o], scale), chunks,
                                          n_s, n_t, scene.lights.count,
                                          False) for o in wk})
            return min(priced.values())

        fwd, k3 = _path_main(
            dev, smi, 21, name, scene, cfg,
            f"streamed ({n_c} chunks){', RR' if mode == 'rr' else ''}",
            accel=lambda sc, tabs: {"chunks": mega.chunk_tables(
                sc, cfg, tabs[1], tabs[2])},
            ops_of=ops_of,
            bytes_of=lambda tabs: _stream_bytes(tabs, chunks),
            gates=((SPHERE_GATES["beyond"], SPHERE_GATES["rel"])
                   if shape == "spheres" else (0.01, 1e-5)),
            train=train)
        _check(fwd["streamed"] == fwd["launches"],
               f"{label}: {fwd['streamed']} of {fwd['launches']} launches "
               "streamed")
        fwd.update(_stream_bound(priced.__getitem__, 24 * cfg.total_rays
                                 + _stream_bytes(tables, chunks)))
        print(f"phase 21 {label}: bound {fwd['bound_ms']:.6g} ms from the "
              f"{fwd['bound_from']} count (the Morton chunks' "
              f"{fwd['morton_bound_ms']:.6g} ms, the tree walk's "
              f"{fwd['tree_bound_ms']:.6g} ms), share "
              f"{fwd['bound_ms'] / fwd['ms']:.3%}")
        out[label] = fwd
        if k3 is not None:
            out["k3"] = k3
        return fwd

    run("torus", "torus", "path", True, GRID_BLOCK, work[("torus", "path")])
    run("torus B0", "torus", "path", False, 0, work[("torus", "path")])
    run("torus rr", "torus", "rr", False, GRID_BLOCK, work[("torus", "rr")])
    sp = run("spheres", "spheres", "path", False, 0,
             work[("spheres", "path")])
    print(f"phase 21 sphere_field({STREAM_SPHERES}) 1024^2 b{BOUNCES}: "
          f"streamed {sp['ms']:.6g} ms/pass vs phase 18's sphere grid "
          f"{grid_ms:.6g} ms/pass in this run (x{sp['ms'] / grid_ms:.3g}); "
          f"cornell + torus streamed {out['torus']['ms']:.6g} ms/pass")
    return out


# ---------------------------------------------------------------------------
# phase 22: kernels 2 and 2s past 64 objects per type (ROADMAP item 16)
# ---------------------------------------------------------------------------

def _large_scene(shape: str, w: int, h: int, dev):
    """Phase 22's scenes: sphere_field(SMALL_SPHERES) ("spheres"),
    sphere_field(N_SPHERES) ("spheres1024"), the torus scene of phase 21
    (cornell + 992 triangles, no grid: "torus"), the same over its grids
    (phase 16's, "torus-grid"), at DIFF_TABLE_MAX sphere_field(4096)
    ("cap-spheres") and a seeded soup of 4096 triangles in cornell's light
    and camera ("cap-triangles"), a film whose rays all miss
    (tests/torch_grid_scenes.py miss_field, "misses") and sphere_field(128)
    packed within 0.5, where every warp's live rows fill both 64-row spans
    ("cluster")."""
    from raytracing_tpu_torch.core.types import build_scene
    from raytracing_tpu_torch.models.scenes import cornell_box, sphere_field
    from raytracing_tpu_torch.render import mega
    if shape == "misses":
        sys.path.insert(0, str(HERE / "tests"))
        from torch_grid_scenes import miss_field
        return miss_field(N_SPHERES, w, h, dev)
    if shape == "spheres":
        return sphere_field(SMALL_SPHERES, cols=w, rows=h, device=dev)
    if shape == "cluster":
        return sphere_field(128, cols=w, rows=h, spread=0.5, device=dev)
    if shape == "spheres1024":
        return sphere_field(N_SPHERES, cols=w, rows=h, device=dev)
    if shape == "cap-spheres":
        return sphere_field(mega.DIFF_TABLE_MAX, cols=w, rows=h, device=dev)
    if shape == "cap-triangles":
        c = cornell_box(cols=w, rows=h, device=dev)
        return build_scene(camera=c.camera, lights=c.lights,
                           materials=c.materials, triangles=_soup(
                               mega.DIFF_TABLE_MAX, HIT_SEED).to(dev))
    if shape == "torus-grid":
        return _grid_scene("torus", w, h, dev)
    return _stream_scene("torus", w, h, dev)


def _plain_chunks(mega, MK, scene, tables):
    """Streams for the plain versions' forward: the triangles past 64 and
    the spheres past 64, in Morton chunks also where the kernel keeps them
    resident or walks a grid. The plain version tests a chunk of rows at
    a time and gives the brute version's champions, bits and values (phase
    21 (2)), where the brute version launches per object."""
    tri = (mega.tri_chunk_tables(scene, tables[2])
           if tables[2].shape[0] > MK.UNROLL_OBJECTS else None)
    sph = (mega.sph_chunk_tables(scene, tables[1])
           if tables[1].shape[0] > MK.UNROLL_OBJECTS else None)
    return (None if tri is None and sph is None
            else MK.KernelChunks(tri=tri, sph=sph))


def _gates_hold(want, got) -> bool:
    """Whether one group passes phase 6's gates (_grad_gates with max
    |d|), without failing the run."""
    finite, err, na, nb, cos, scale = _gate_stats(want, got)
    if not finite or na == 0.0:
        return finite and nb == 0.0
    return cos >= 0.999 and abs(nb / na - 1.0) <= 0.01 and err <= 5e-3 * scale


def _ray_moves(MKS, tables, g, u, kw, wrt) -> dict:
    """Per group in ``wrt``, how far each ray's share of the plain soft
    cotangent moves between its draws moved by +2^-22 and by -2^-22 (a
    roulette draw within rounding of its survival probability, a grazing
    hit near a square root's zero: rays whose cotangent float32 does not
    pin down). A ray's share is <g_r, d acc_r / d theta . v>, read by
    forward-mode AD through soft_pass_value for a seeded normal tangent v
    over the group's table; the larger move of two tangents. Only the
    plain version is read: the kernel cannot choose the rays it is
    excused on. Returns {group: (R,) moves}."""
    import numpy as np
    import torch
    import torch.autograd.forward_ad as fwAD
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    rng = np.random.default_rng(GRAD_SEED)
    vkw = {k: v for k, v in kw.items() if k not in ("seed", "diff_wrt")}
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    d = 2.0 ** -22
    up = torch.where(u + d < 1.0, u + d, u - d)
    down = torch.where(u - d >= 0.0, u - d, u + d)
    moves = {}
    for i, name in enumerate(MKG.DIFF_ALL):
        if name not in wrt or not tables[i].numel():
            continue
        move = torch.zeros(g.shape[0], device=g.device)
        for _ in range(2):
            v = torch.as_tensor(rng.normal(size=tuple(tables[i].shape))
                                .astype(np.float32), device=g.device)

            def share(planes):
                with fwAD.dual_level():
                    duals = list(tables)
                    duals[i] = fwAD.make_dual(tables[i], v)
                    acc = MKS.soft_pass_value(duals[0], ipar, *duals[1:],
                                              planes, **vkw)
                    return (fwAD.unpack_dual(acc).tangent * g).sum(-1)
            move = torch.maximum(move, (share(up) - share(down)).abs())
        moves[name] = move
    return moves


def _excuse_unstable(MKS, tables, g, u, kw, held, want, got, plain, kernel,
                     what: str):
    """Phase 22's rule for kernel 2s, where a group in ``held`` misses
    phase 6's gates: the least stable ray left by _ray_moves (the plain
    version alone) is excused, one at a time (its cotangent zeroed, the
    plain version ``plain(g)`` and the kernel's u-planes and PRNG routes
    ``kernel(g, planes)`` rerun), until every other ray is within the
    gates; each must move the cotangent the gates then read (its norm,
    group by group) by more than UNSTABLE_MOVE, and at most 2% of the rays
    go. Returns (want, got) on the rays kept and the excused rays, which
    are listed."""
    import torch
    from raytracing_tpu_torch.ops import megakernel_grad as MKG

    def hold(want, got):
        return all(_gates_hold(want[i], outs[i]) for outs in got.values()
                   for i, n in enumerate(MKG.DIFF_ALL) if n in held)

    if hold(want, got):
        return want, got, []
    moves = _ray_moves(MKS, tables, g, u, kw, held)
    idx = {n: i for i, n in enumerate(MKG.DIFF_ALL)}
    cap = max(1, g.shape[0] // 50)
    excused = []
    while not hold(want, got):
        rel = torch.stack([m / max(want[idx[n]].norm().item(), 1e-30)
                           for n, m in moves.items()]).amax(0)
        rel[excused] = -1.0
        r = int(rel.argmax())
        move = rel[r].item()
        print(f"  a group misses phase 6's gates; the least stable ray "
              f"left, {r}, moves the cotangent by {move:.3g} of its norm "
              "between draws moved by +-2^-22")
        _check(len(excused) < cap and move > UNSTABLE_MOVE,
               f"{what} misses phase 6's gates on rays that are stable "
               f"(ray {r}: {move:.3g} <= {UNSTABLE_MOVE:g}) or past {cap} "
               "excused rays")
        excused.append(r)
        gk = g.clone()
        gk[excused] = 0.0
        want = plain(gk)
        got = {"u-planes": kernel(gk, u), "PRNG": kernel(gk, None)}
    print(f"  rays {excused} excused ({len(excused)} of at most {cap}); "
          f"{what} on the other {g.shape[0] - len(excused)} rays:")
    return want, got, excused


def large_vs_plain(dev, shape: str, soft: bool, rr: bool, wrt,
                   w: int = LARGE_W, h: int = LARGE_H,
                   bounces: int = BOUNCES, brute: bool = False,
                   direct: bool = False, rr_start: int = RR_START) -> dict:
    """Phase 22 (a) and (c): kernel 2's large-table route (``soft``
    False; the record over the scene's resident spheres, its streamed
    chunks or its grids, as the forward, then kernel 3's sweep) or
    kernel 2s's large-table instance (the two-level composite; the
    triangles in Morton order) against its plain
    version on the same tables, u-planes and seeded random cotangent, the
    u-planes and PRNG routes, under phase 6's gates (max |d| included).
    The plain hard version tests the long tables a chunk of rows at a
    time over the program's own Morton build (_plain_chunks), or with
    ``brute`` one row at a time. Kernel 2s: where a group misses the gates,
    the least stable rays by _ray_moves are excused one at a time (their
    cotangent zeroed) until every other ray is within phase 6's gates;
    each must move the cotangent the gates then read by more than
    UNSTABLE_MOVE of its norm, and at most 2% of the rays go. ``direct``:
    direct mode (u_planes_for_direct, no bounce); the roulette from depth
    ``rr_start``. On the film whose rays all miss ("misses") every plain
    cotangent and every kernel word must be exactly 0. Returns max |d|,
    the plain version's ms and the kernel's (CUDA events, PRNG route), and
    the size they were taken at."""
    import numpy as np
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.ops import megakernel_soft as MKS
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    grid = shape == "torus-grid"
    empty = shape == "misses"
    scene = _large_scene(shape, w, h, dev)
    if direct:
        bounces = 0
    cfg = RenderConfig(width=w, height=h, bounces=bounces,
                       russian_roulette=rr, rr_start_depth=rr_start,
                       use_megakernel=True, use_grid=grid)
    tables = list(mega.scene_tables(scene, cfg))
    n_s, n_t = tables[1].shape[0], tables[2].shape[0]
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    if direct:
        u = mega.u_planes_for_direct(MK.pass_key_of(ipar, cfg.seed), cfg,
                                     scene.lights.count, dev)
    else:
        u = mega.u_planes_for_pass(pt.init_state(cfg, dev)["key"], 0, cfg,
                                   scene.lights.count, dev)
    g = torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=dev)
    chunks = mega.chunk_tables(scene, cfg, tables[1], tables[2])
    kw = _pass_kw(cfg, diff_wrt=wrt, **({"mode": "direct"} if direct
                                        else {}))
    if soft:
        st = mega.soft_tri_order(scene, tables[2], chunks)
        if st is not None:
            tables[2] = st.rows
        kw.update(soft_bandwidth=EDGE_BW, soft_tau=EDGE_BW)

        def plain(gg):
            return MKS.pathtrace_pass_bwd_soft_reference(
                tables[0], ipar, *tables[1:], gg, u, **kw)

        def kernel(gg, planes):
            return MKS.pathtrace_pass_bwd_soft(tables[0], ipar, *tables[1:],
                                               gg, planes, **kw)
        count = lambda: MKS.soft_large_launches  # noqa: E731
    else:
        replay = dict(grid=mega.grid_tables(scene, tables[1], tables[2])
                      if grid else None, chunks=chunks)
        pchunks = None if brute else _plain_chunks(mega, MK, scene, tables)

        def plain(gg):
            return MKG.pathtrace_pass_bwd_reference(
                tables[0], ipar, *tables[1:], gg, u, chunks=pchunks, **kw)

        def kernel(gg, planes):
            return MKG.pathtrace_pass_bwd(tables[0], ipar, *tables[1:], gg,
                                          planes, **kw, **replay)
        count = lambda: MKG.large_launches  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain(g)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    before, small = count(), (MKG.launches, MKS.soft_launches)
    got = {"u-planes": kernel(g, u), "PRNG": kernel(g, None)}
    torch.cuda.synchronize()
    _check(count() == before + 2 and (MKG.launches, MKS.soft_launches)
           == small, f"{shape}: {count() - before} launches of the large-"
           "table instance (want 2) or a launch of the 64-object one")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    kernel(g, None)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    what = "kernel 2s" if soft else "kernel 2"
    size = f"{w}x{h} " + ("direct" if direct else f"b{bounces}")
    order = ", Morton-sorted" if soft and n_t > 64 else ""
    print(f"phase 22 {what} past 64 objects, {shape} ({n_s} spheres, "
          f"{n_t} triangle rows{order}{', over its grids' if grid else ''})"
          f" {size}"
          f"{f' with the roulette from depth {rr_start}' if rr else ''} "
          f"wrt {list(wrt)} vs the "
          f"plain version{' (brute)' if brute else ''}: plain "
          f"{plain_ms:.6g} ms, kernel (PRNG route) {ms:.6g} ms")
    for route, outs in got.items():
        _check(all(bool(torch.isfinite(b).all()) for b in outs),
               f"{shape}: {what} {route} route not finite")
    if empty:
        # no live row anywhere: every word of both sides exactly 0
        _check(not any(a.any().item() for a in want),
               f"{shape}: a plain cotangent is not 0")
        for route, outs in got.items():
            _check(not any(b.any().item() for b in outs),
                   f"{shape}: {what} {route} route adds a nonzero word")
        print(f"  {what}: every plain and kernel cotangent exactly 0")
        return {"max_abs_err": 0.0, "plain_ms": plain_ms, "ms": ms,
                "shape": f"{shape} {size}", "excused": 0}
    _check(any(a.any().item() for n, a in zip(MKG.DIFF_ALL, want)
               if n in wrt), f"{shape}: every plain cotangent is 0")
    held = [n for n, a in zip(MKG.DIFF_ALL, want) if n in wrt and a.numel()]
    excused = []
    if soft:
        want, got, excused = _excuse_unstable(MKS, tables, g, u, kw, held,
                                              want, got, plain, kernel,
                                              f"{shape}: {what}")
    err = 0.0
    for route, outs in got.items():
        print(f"  {what} {route} route vs plain version:")
        for name, a, b in zip(MKG.DIFF_ALL, want, outs):
            if name in held:
                err = max(err, _grad_gates(name, a, b, True))
            else:
                _check(not b.any().item(), f"{name} outside diff_wrt "
                       "is not zero")
    return {"max_abs_err": err, "plain_ms": plain_ms, "ms": ms,
            "shape": f"{shape} {size}", "excused": len(excused)}


def edge_grid_large(dev, w: int, h: int) -> float:
    """Phase 22 (a): edge x grid on the torus scene (kernel 1's grid
    forward; kernel 2s's large-table instance over a Morton-sorted copy
    built for the backward alone) against the brute edge route over the
    streamed table, ("sph", "mat", "tri"), the same seeded cotangent of
    acc: equal
    up to the order of float atomics (cosine >= 0.99999, max |d| <= 1e-3
    of each group's scale). Returns the largest |d| over the scales."""
    import numpy as np
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.ops import megakernel_soft as MKS
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                       use_megakernel=True, mega_edge_bandwidth=EDGE_BW,
                       mega_grad_wrt=MESH_WRT)
    gacc = torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
        size=(cfg.total_rays, 3)).astype(np.float32), device=dev)
    grads = []
    for shape, c in (("torus", cfg), ("torus-grid",
                                      replace(cfg, use_grid=True))):
        sc = _large_scene(shape, w, h, dev)
        m = sc.meshes[0]
        p = {"center": sc.spheres.center, "materials": sc.materials,
             "tv": m.tris.v}
        p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        sc = replace(sc, spheres=replace(sc.spheres, center=p["center"]),
                     materials=p["materials"],
                     meshes=(replace(m, tris=replace(m.tris, v=p["tv"])),))
        MK.launches = MKS.soft_large_launches = MKG.launches = 0
        acc = mega.render_pass_mega(sc, pt.init_state(c, dev), c)["acc"]
        grads.append(torch.autograd.grad((acc * gacc).sum(),
                                          list(p.values())))
        torch.cuda.synchronize()
        _check(MK.launches == 1 and MKS.soft_large_launches == 1
               and MKG.launches == 0,
               f"edge {shape}: {MK.launches} kernel-1, "
               f"{MKS.soft_large_launches} kernel-2s (large) and "
               f"{MKG.launches} kernel-2 launches (want 1, 1, 0)")
    worst = 0.0
    print(f"phase 22 edge x grid, the torus scene {w}x{h} b{BOUNCES} "
          "over its grids vs streamed brute, ('sph', 'mat', 'tri'):")
    for name, a, b in zip(("center", "materials", "tv"), *grads):
        a, b = a.double().ravel(), b.double().ravel()
        _check(bool(torch.isfinite(b).all()), f"{name}: not finite")
        scale = a.abs().max().item()
        rel = (a - b).abs().max().item() / max(scale, 1e-30)
        cos = (a @ b).item() / max(a.norm().item() * b.norm().item(), 1e-300)
        print(f"    {name}: cosine {cos:.9f}, max|d| {rel:.3g} x "
              f"max|brute| {scale:.6g}")
        _check(scale > 0 and cos >= 0.99999 and rel <= 1e-3,
               f"edge x grid {name}: cosine {cos:.9f}, max|d| {rel:.3g}")
        worst = max(worst, rel)
    return worst


def _large_params(scene, mesh: bool) -> dict:
    """The trained parameters of phase 22's steps: sphere centres, radii
    and materials, and with ``mesh`` the torus's vertices."""
    p = {"center": scene.spheres.center, "radius": scene.spheres.radius,
         "materials": scene.materials}
    if mesh:
        p["tv"] = scene.meshes[0].tris.v
    return {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}


def _large_step(scene, cfg, dev, p: dict):
    """bench.py::_train_bench's step on ``p`` (one pass, mean(image^2),
    the gradients; parameters fixed, the state threaded); the cotangent of
    the pass's acc lands in ``p["g"]``."""
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.render import pathtracer as pt

    leaves = [v for k, v in p.items() if k != "g"]
    sc = replace(scene, spheres=replace(scene.spheres, center=p["center"],
                                        radius=p["radius"]),
                 materials=p["materials"])
    if "tv" in p:
        m = scene.meshes[0]
        sc = replace(sc, meshes=(replace(m, tris=replace(m.tris,
                                                         v=p["tv"])),))

    def step(state):
        st = pt.render_pass(sc, state, cfg)
        st["acc"].register_hook(lambda g: p.__setitem__("g", g))
        loss = torch.mean(pt.image(st, cfg) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        return dict(st, acc=st["acc"].detach()), loss.detach(), grads
    return step


def _soft_spans(n: int) -> list:
    """Rows per SOFT_CHUNK span of a table of n rows."""
    return [min(SOFT_CHUNK, n - lo) for lo in range(0, n, SOFT_CHUNK)]


def large_train(dev, smi: str, work: dict) -> dict:
    """Phase 22 (b) at 1024^2 b5: the hard "pallas" step (kernel 1 and
    kernel 2 past 64 objects: the record, then kernel 3's sweep) beside
    the cell route's step (kernel 1 recording and kernel 3) on
    sphere_field(N_SPHERES) with ("sph", "mat")
    and on the torus scene streamed with ("sph", "mat", "tri"), LARGE_STEPS
    timed steps each after a warm-up, median ms, fwd+bwd segments/s,
    launches; kernel 2 alone on the last step's cotangent (CUDA events;
    both launches, then each alone) with its bound; then BENCH_EDGE on
    the torus scene (tau = bandwidth = EDGE_BW, ("sph", "mat")): one
    step, kernel 2s's large-table instance alone
    timed by CUDA events around its launch inside that step, its bound.
    ``work`` is phase 21's 256x192 counts of the torus in path mode
    (``_stream_counts``). Returns the entries by name."""
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.ops import megakernel_soft as MKS
    from raytracing_tpu_torch.render import mega
    from raytracing_tpu_torch.render import pathtracer as pt

    out = {}
    for shape, wrt in (("spheres1024", TRAIN_WRT), ("torus", MESH_WRT)):
        scene = _large_scene(shape, MAIN_W, MAIN_H, dev)
        base = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                            use_megakernel=True, mega_grad_wrt=wrt)
        n_l = scene.lights.count
        segs = base.total_rays * (1 + n_l + base.bounces * (1 + n_l))
        ms = {}
        for route in ("pallas", "cell"):
            cfg = replace(base, mega_bwd_impl=route)
            _check(mega.bwd_impl_for(scene, cfg) == route,
                   f"{shape}: mega_bwd_impl={route} does not route there")
            p = _large_params(scene, shape == "torus")
            step = _large_step(scene, cfg, dev, p)
            state, _, _ = step(pt.init_state(cfg, dev))        # warm-up
            torch.cuda.synchronize()
            MK.launches = MK.stream_launches = MKG.launches = 0
            MKG.large_launches = MKG.champ_launches = 0
            MK.path_walk_launches = MK.tree_build_launches = 0
            times = []
            for _ in range(LARGE_STEPS):
                t0 = time.perf_counter()
                state, loss, grads = step(state)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            counts = (MK.launches, MK.stream_launches, MKG.launches,
                      MKG.large_launches, MKG.champ_launches,
                      MK.path_walk_launches, MK.tree_build_launches)
            streamed = LARGE_STEPS if shape == "torus" else 0
            # sphere_field(1024): one sphere tree per step, which kernel 1
            # walks and, on the "pallas" route, the record walks too
            trees = 0 if shape == "torus" else LARGE_STEPS
            want = ((LARGE_STEPS, streamed, 0, LARGE_STEPS, 0, trees, trees)
                    if route == "pallas"
                    else (LARGE_STEPS, streamed, 0, 0, LARGE_STEPS, trees,
                          trees))
            _check(counts == want, f"{shape} {route} step: launches (kernel "
                   "1, streamed, kernel 2, kernel 2 large, kernel 3, kernel "
                   f"1 walking a sphere tree, tree builds) {counts}, want "
                   f"{want}")
            _check(bool(torch.isfinite(loss)), f"{shape} {route}: loss")
            for name, gr in zip(p, grads):
                _check(bool(torch.isfinite(gr).all()) and bool(gr.any()),
                       f"{shape} {route}: {name} gradient not finite or 0")
            ms[route] = float(sorted(times)[len(times) // 2])
            print(f"phase 22 {route} train step {shape} {MAIN_W}x{MAIN_H} "
                  f"b{BOUNCES} wrt {list(wrt)} on [{smi}]: median "
                  f"{ms[route]:.6g} ms/step of {LARGE_STEPS} (min "
                  f"{min(times):.6g}, max {max(times):.6g}), "
                  f"{segs / ms[route] * 1e3:.6g} fwd+bwd ray segments/s; "
                  f"launches (kernel 1, streamed, kernel 2, kernel 2 large,"
                  f" kernel 3, kernel 1 walking a sphere tree, tree builds) "
                  f"{counts}")
            if route == "pallas":
                launches, g = counts[3], p["g"].contiguous()
                last = state["passes"] - 1
        print(f"phase 22 {shape}: pallas step / cell step "
              f"{ms['pallas'] / ms['cell']:.4g}x (\"auto\" keeps JAX's cell "
              "route past 64 objects)")
        # kernel 2 past 64 objects alone on the last pallas step's
        # cotangent: both launches (the uncontracted record, kernel 3's
        # sweep), then each alone
        cfg = replace(base, mega_bwd_impl="pallas")
        tables = mega.scene_tables(scene, cfg)
        n_s, n_t = tables[1].shape[0], tables[2].shape[0]
        chunks = mega.chunk_tables(scene, cfg, tables[1], tables[2])
        ipar = torch.tensor([last, 0], dtype=torch.int32)
        kw = _pass_kw(cfg, diff_wrt=wrt)
        rkw = {k: v for k, v in kw.items() if k != "diff_wrt"}
        # the record walks the forward's sphere tree, as in the step
        tree = MK.pass_tree(tables[1], None, chunks)
        pieces = {
            "both": lambda: MKG.pathtrace_pass_bwd(
                tables[0], ipar, *tables[1:], g, None, chunks=chunks,
                sph_tree=tree, **kw),
            "record": lambda: MKG._record(
                tables[0], ipar, *tables[1:], g, None, mode="path",
                chunks=chunks, grid=None, block=0, sph_tree=tree, **rkw)}
        rec = pieces["record"]()
        pieces["sweep"] = lambda: MKG._launch_champ(
            tables[0], ipar, *tables[1:], g, None, *rec, wrt, mode="path",
            **rkw)
        piece_ms = {}
        for k, fn in pieces.items():
            fn()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(3):
                fn()
            end.record()
            torch.cuda.synchronize()
            piece_ms[k] = start.elapsed_time(end) / 3
        k_ms = piece_ms["both"]
        # its bound: the record's forward (kernel 1's count of the pass,
        # the streamed chunks' slab and row tests as phase 21's plain
        # version counted them, scaled) and the sweep's own operations,
        # over the rays with g != 0, from kernel 1's record of the pass;
        # bytes: the tables twice, the cotangent and the record, (4 + L) B
        # a segment, written and read
        _, ids, occs = MK.pathtrace_pass(
            tables[0], ipar, *tables[1:], torch.zeros_like(g), None,
            record=True, chunks=chunks, **_pass_kw(cfg))
        live = (g != 0).any(-1)
        w = _pass_work(ids, occs, n_l, n_s, live)
        if tree is not None:
            # the smaller of the brute count's and the sphere tree walk's
            # over the live rays (the plain walk, the others dead)
            walked = _path_walk_work(MK, tables, ipar, cfg, live)
            ops = min(_k1_ops(w, n_s, n_t, n_l),
                      _path_walk_ops(w, walked, n_t, n_l))
            nbytes = _table_bytes(tables)
        elif chunks is None:
            ops = _k1_ops(w, n_s, n_t, n_l)
            nbytes = _table_bytes(tables)
        else:
            share = live.double().mean().item()
            # the smaller of the Morton chunks' and the tree walk's counts
            ops = min(_stream_ops(w, _scaled(work[o], share * MAIN_W * MAIN_H
                                             / (SMALL_W * SMALL_H)),
                                  chunks, n_s, n_t, n_l, False)
                      for o in ("morton", "tree"))
            nbytes = _stream_bytes(tables, chunks)
        ops += _adj_ops(w, wrt)
        bound = _bound(ops, 12 * cfg.total_rays + 2 * nbytes
                       + 2 * (4 + n_l) * ids.numel())
        print(f"phase 22 kernel 2 past 64 objects alone (record + sweep), "
              f"{shape} step cotangent wrt {list(wrt)}: {k_ms:.6g} ms "
              f"({k_ms / ms['pallas']:.3%} of the step; the record alone "
              f"{piece_ms['record']:.6g} ms, kernel 3's sweep alone "
              f"{piece_ms['sweep']:.6g} ms, its "
              + _add_counts(MKG, rec[0], n_s, n_t, wrt, live) + "); bound "
              f"{ops / max(w['rays'], 1):.6g} FP32 operations per live ray "
              f"-> {bound['bound_ms']:.6g} ms ({bound['bound_by']}); share "
              f"{bound['bound_ms'] / k_ms:.3%}")
        out[shape] = {"launches": launches, "ms": k_ms,
                      "record_ms": piece_ms["record"],
                      "sweep_ms": piece_ms["sweep"],
                      "shape": f"{shape} {MAIN_W}x{MAIN_H} b{BOUNCES}",
                      "step_ms": ms["pallas"], "cell_step_ms": ms["cell"],
                      **bound}

    # BENCH_EDGE on the torus scene: one step, kernel 2s timed inside it
    scene = _large_scene("torus", MAIN_W, MAIN_H, dev)
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                       use_megakernel=True, mega_grad_wrt=TRAIN_WRT,
                       mega_edge_bandwidth=EDGE_BW)
    n_l = scene.lights.count
    segs = cfg.total_rays * (1 + n_l + cfg.bounces * (1 + n_l))
    p = _large_params(scene, False)
    step = _large_step(scene, cfg, dev, p)
    events, wrapped, call = [], MKS.pathtrace_pass_bwd_soft, []

    def timed(*a, **k):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        r = wrapped(*a, **k)
        end.record()
        events.append((start, end))
        call.append((a, k))
        return r

    MKS.pathtrace_pass_bwd_soft = timed
    try:
        torch.cuda.synchronize()
        MK.launches = MK.stream_launches = MKG.launches = 0
        MKS.soft_launches = MKS.soft_large_launches = 0
        t0 = time.perf_counter()
        state, loss, grads = step(pt.init_state(cfg, dev))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        MKS.pathtrace_pass_bwd_soft = wrapped
    counts = (MK.launches, MK.stream_launches, MKG.launches,
              MKS.soft_launches, MKS.soft_large_launches)
    _check(len(events) == 1, f"edge step: {len(events)} kernel 2s calls")
    _check(counts == (1, 1, 0, 0, 1), "edge step on the torus scene: "
           "launches (kernel 1, streamed, kernel 2, kernel 2s, kernel 2s "
           f"large) {counts}, want (1, 1, 0, 0, 1)")
    _check(bool(torch.isfinite(loss)), "edge torus step: loss")
    for name, gr in zip(p, grads):
        _check(bool(torch.isfinite(gr).all()) and bool(gr.any()),
               f"edge torus step: {name} gradient not finite or 0")
    k_ms = events[0][0].elapsed_time(events[0][1])
    stats = _soft_stats(MKS, False, False)
    tables = mega.scene_tables(scene, cfg)
    rays, nsegs = _soft_work(MK, tables, p["g"], cfg)
    n_s, n_t = tables[1].shape[0], tables[2].shape[0]
    # the dense bound (every factor of every row, every pair of every
    # span), and the live-work bound: what this run's data needs, each
    # ray's own live rows, pairs and spans and each row's factors up to
    # the first exactly 0, counted by the plain version on LIVE_BLOCKS
    # blocks of whole warps spread over the step's own launch
    nbytes = 12 * cfg.total_rays + 2 * _table_bytes(tables)
    dense = _soft_dense(n_s, n_t)
    ops, sfu = (f(rays, nsegs, n_l, dense) for f in (_soft_ops, _soft_sfu))
    live = _soft_live(MKS, *call[0], cfg.total_rays)
    ops_live, sfu_live = (f(rays, nsegs, n_l, live)
                          for f in (_soft_ops, _soft_sfu))
    bound = {**_bound(ops_live, nbytes), **_sfu_bound(sfu_live),
             "dense_bound_ms": _bound(ops, nbytes)["bound_ms"]}
    dense_sfu_ms = _sfu_bound(sfu)["bound_sfu_ms"]
    sur = live["surface"]
    print(f"phase 22 BENCH_EDGE step, the torus scene: live work (the "
          f"plain version, {LIVE_BLOCKS} blocks of {LIVE_BLOCK} rays; per "
          f"ray what the function needs, per warp the union of its rays' "
          f"live rows, which the kernel runs): {json.dumps(live)}")
    print(f"phase 22 BENCH_EDGE step, the torus scene ({tables[2].shape[0]} "
          f"triangles, {len(_soft_spans(tables[2].shape[0]))} spans, "
          f"Morton-sorted) {MAIN_W}x{MAIN_H} b{BOUNCES} wrt "
          f"{list(TRAIN_WRT)} mega_edge_bandwidth {EDGE_BW:g} on [{smi}]: "
          f"{step_ms:.6g} ms/step (one step), {segs / step_ms * 1e3:.6g} "
          f"fwd+bwd ray segments/s; launches (kernel 1, streamed, kernel 2, "
          f"kernel 2s, kernel 2s large) {counts}; kernel 2s large-table "
          f"instance alone {k_ms:.6g} ms ({k_ms / step_ms:.3%} of the "
          f"step); dense bound "
          f"{ops / max(rays, 1):.6g} FP32 operations per live ray "
          f"(OPS_SOFT_*, pairs per span and the spans' level) -> "
          f"{bound['dense_bound_ms']:.6g} ms, MUFU "
          f"{sfu / max(rays, 1):.6g} -> {dense_sfu_ms:.6g} ms; "
          f"live-work bound (each ray's own live rows {sur['rows_s']:.4g} + "
          f"{sur['rows_t']:.4g}, pairs {sur['pairs']:.4g} and spans "
          f"{sur['spans']:.4g} per segment; the design runs its warp's "
          f"union: rows {sur['union_rows']:.4g}, pairs "
          f"{sur['union_pairs']:.4g}, spans {sur['union_spans']:.4g}) "
          f"{ops_live / max(rays, 1):.6g} FP32 operations per live ray -> "
          f"{bound['bound_ms']:.6g} ms ({bound['bound_by']}; share "
          f"{bound['bound_ms'] / k_ms:.3%}), MUFU "
          f"{sfu_live / max(rays, 1):.6g} -> {bound['bound_sfu_ms']:.6g} ms "
          f"(share {bound['bound_sfu_ms'] / k_ms:.3%}); launch {stats}")
    out["edge"] = {"launches": counts[4], "ms": k_ms, "step_ms": step_ms,
                   "shape": f"torus {MAIN_W}x{MAIN_H} b{BOUNCES}",
                   "stats": stats, **bound}
    return out


# ---------------------------------------------------------------------------
# phase 23: the differentiable direct pass (mode="direct")
# ---------------------------------------------------------------------------

def _direct_adj_ops(w: dict, wrt) -> float:
    """FP32 operations of direct_sweep's own work over the work w of the
    rays with g != 0 (a record of one segment) for the groups ``wrt``."""
    geo = bool({"par", "sph", "tri"} & set(wrt))
    ops = w["shadow"] * OPS_ADJ_DIRECT
    if geo or "lig" in wrt:
        ops += w["free"] * OPS_ADJ_DIRECT_GEOM
    if "lig" in wrt:
        ops += w["free"] * OPS_ADJ_DIRECT_LIG
    if geo:
        ops += (w["sph_hits"] * OPS_ADJ_SPHERE
                + w["tri_hits"] * OPS_ADJ_TRIANGLE)
    if "sph" in wrt:
        ops += w["sph_hits"] * OPS_ADJ_SPHERE_ROW
    if "tri" in wrt:
        ops += w["tri_hits"] * OPS_ADJ_TRIANGLE_ROW
    if "par" in wrt:
        ops += w["primary"] * OPS_ADJ_CAMERA
    return ops


def _direct_bounds(tables, ids, occs, g, wrt, split: bool = False) -> dict:
    """Bounds of pieces a (kernel 1 recording the direct pass: ids (1, R),
    occs (L, R)), b (kernel 2: kernel 1's pass over the rays with g != 0,
    then direct_sweep; with ``split``, past 64 objects, the record it
    writes and reads too) and c (kernel 3: the recorded champion's surface
    and each shadow ray once, then direct_sweep), and each one's
    operations per ray."""
    n = ids.shape[1]
    n_s, n_t, n_l = (t.shape[0] for t in tables[1:3] + tables[4:5])
    w = _pass_work(ids, occs, n_l, n_s)
    live = _pass_work(ids, occs, n_l, n_s, (g != 0).any(-1))
    ops = {"a": _direct_ops(w, n_s, n_t),
           "b": _direct_ops(live, n_s, n_t) + _direct_adj_ops(live, wrt),
           "c": (live["rays"] * OPS_CAMERA + live["primary"] * OPS_CHAMP
                 + live["shadow"] * OPS_DIRECT_SHADOW
                 + _direct_adj_ops(live, wrt))}
    nbytes = {"a": (24 + 4 + n_l) * n + _table_bytes(tables),
              "b": 12 * n + 2 * _table_bytes(tables)
              + (2 * (4 + n_l) * n if split else 0),
              "c": 12 * n + (4 + n_l) * live["rays"]
              + 2 * _table_bytes(tables)}
    return {k: dict(_bound(ops[k], nbytes[k]), bytes=nbytes[k],
                    per_ray=ops[k] / max(w["rays"] if k == "a"
                                         else live["rays"], 1))
            for k in ops}


def _direct_scene(name: str, w: int, h: int, dev, lens: float = 0.0):
    """Phase 23's scenes: cornell (with a lens of diameter ``lens``),
    sphere_field(SMALL_SPHERES) ("spheres", kernels 2 and 2s's large-table
    instances), sphere_field(N_SPHERES) ("spheres1024") and the torus
    scene without grids ("torus": 1,002 triangles streamed)."""
    from raytracing_tpu_torch.models.scenes import cornell_box, sphere_field
    if name == "cornell":
        return cornell_box(cols=w, rows=h, lens_diameter=lens, device=dev)
    if name == "spheres":
        return sphere_field(SMALL_SPHERES, cols=w, rows=h, device=dev)
    if name == "spheres1024":
        return sphere_field(N_SPHERES, cols=w, rows=h, device=dev)
    return _stream_scene("torus", w, h, dev)


def _direct_inputs(dev, name: str, w: int, h: int, spp: int, lens: float,
                   wrt) -> dict:
    """Tables, u_planes_for_direct of pass 0's key, a seeded cotangent and
    the kernels' arguments of one phase-23 case."""
    import numpy as np
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega
    scene = _direct_scene(name, w, h, dev, lens)
    cfg = RenderConfig(width=w, height=h, spp=spp, bounces=0,
                       use_megakernel=True)
    tables = list(mega.scene_tables(scene, cfg))
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    key = MK.pass_key_of(ipar, cfg.seed)
    return dict(scene=scene, cfg=cfg, tables=tables, ipar=ipar, key=key,
                u=mega.u_planes_for_direct(key, cfg, scene.lights.count, dev),
                g=torch.as_tensor(np.random.default_rng(GRAD_SEED).normal(
                    size=(cfg.total_rays, 3)).astype(np.float32), device=dev),
                chunks=mega.chunk_tables(scene, cfg, tables[1], tables[2]),
                kw=_pass_kw(cfg, diff_wrt=wrt, mode="direct"))


def _timed(fn):
    """(result, host ms) of fn, synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _hold_routes(what: str, want, got: dict, wrt) -> float:
    """Phase 6's gates (max |d| included) of each route in ``got`` against
    the plain cotangents, and of the PRNG route against the u-planes
    route; groups outside ``wrt`` zero. Returns max |d|."""
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    err = 0.0
    for route, outs in got.items():
        print(f"  {what} {route} route vs plain version:")
        for name, a, b in zip(MKG.DIFF_ALL, want, outs):
            if name in wrt and a.numel():
                err = max(err, _grad_gates(name, a, b, True))
            else:
                _check(not b.any().item(), f"{what}: {name} outside "
                       "diff_wrt is not zero")
    print(f"  {what} PRNG route vs u-planes route:")
    for name, a, b in zip(MKG.DIFF_ALL, got["u-planes"], got["PRNG"]):
        if name in wrt and a.numel():
            _grad_gates(name, a, b, True)
    return err


def direct_diff_vs_plain(dev, name: str, wrt, spp: int = 1,
                         lens: float = 0.0, soft: bool = True) -> dict:
    """Phase 23 (iv) on one scene at DIRECT_W x DIRECT_H: pieces a-d (a-c
    without ``soft``) against their plain versions on the same tables,
    u_planes_for_direct and seeded cotangent (kernel 2s on the large scenes
    at DIRECT_SOFT_W x DIRECT_SOFT_H); the PRNG route against the u-planes
    route (forward bit-equal, backward phase 6's gates). Returns each
    piece's max |d| and plain ms."""
    import torch
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.ops import megakernel_soft as MKS
    from raytracing_tpu_torch.render import mega

    w, h = DIRECT_W, DIRECT_H
    x = _direct_inputs(dev, name, w, h, spp, lens, wrt)
    t, ipar, u, g, kw, chunks = (x[k] for k in ("tables", "ipar", "u", "g",
                                                 "kw", "chunks"))
    size = f"{name} {w}x{h} spp {spp}" + (f" lens {lens:g}" if lens else "")
    n = g.shape[0]
    zeros = torch.zeros((n, 3), device=dev)
    fkw = dict(key=x["key"], spp=spp, width=w, two_sided=False,
               chunks=chunks)
    out = {"plain_ms": {}, "max_abs_err": {}}
    # a: recording, bit-equal to the launch that does not record; the
    # --fmad=false build's record equal to the plain one
    rec = MK.direct_pass(*t, zeros.clone(), u, record=True, **fkw)
    acc = MK.direct_pass(*t, zeros.clone(), u, **fkw)
    exact = MK.direct_pass(*t, zeros.clone(), u, record=True,
                           build_flags=EXACT_FLAGS, **fkw)
    prng = MK.direct_pass(*t, zeros.clone(), None, record=True, **fkw)
    want, out["plain_ms"]["a"] = _timed(lambda: MK.direct_pass_reference(
        *t, zeros, u, record=True, **fkw))
    ids_d = (rec[1] != want[1]).double().mean().item()
    occs_d = (rec[2] != want[2]).double().mean().item()
    err_a = (rec[0] - want[0]).abs().max().item()
    out["max_abs_err"]["a"] = err_a
    print(f"phase 23 (a) direct recording, {size}: plain {out['plain_ms']['a']:.6g}"
          f" ms; recording == not recording {torch.equal(rec[0], acc)}; "
          f"--fmad=false build == plain: acc {torch.equal(exact[0], want[0])}"
          f", ids {torch.equal(exact[1], want[1])}, bits "
          f"{torch.equal(exact[2], want[2])}; the build that runs vs plain: "
          f"ids {ids_d:.6%}, bits {occs_d:.6%} differ, max|d acc| "
          f"{err_a:.6g}; PRNG == u-planes: acc {torch.equal(prng[0], rec[0])}"
          f", record {torch.equal(prng[1], rec[1]) and torch.equal(prng[2], rec[2])}")
    _check(torch.equal(rec[0], acc), f"{size}: the recording launch's acc "
           "differs from the launch that does not record")
    _check(all(torch.equal(a, b) for a, b in zip(exact, want)),
           f"{size}: the --fmad=false recording build differs from the "
           "plain record")
    _check(torch.equal(prng[0], rec[0]) and torch.equal(prng[1], rec[1])
           and torch.equal(prng[2], rec[2]),
           f"{size}: the direct PRNG route differs from the u-planes route")
    # contracted multiply-adds move grazing hits (phase 11): sphere fields
    # under SPHERE_GATES, the rest under phase 3's
    beyond = ((rec[0] - want[0]).abs() > TOL + TOL * want[0].abs()).any(
        -1).double().mean().item()
    gate_b, gate_i = ((SPHERE_GATES["beyond"], SPHERE_GATES["ids0"])
                      if name.startswith("spheres") else (0.01, 0.01))
    _check(beyond <= gate_b and ids_d <= gate_i,
           f"{size}: {beyond:.4%} of rays beyond {TOL:g} (> {gate_b:.2%}) "
           f"or {ids_d:.4%} of ids differ (> {gate_i:.2%})")
    _, ids, occs = rec
    # b: kernel 2 (past 64 objects the record and the sweep, over the
    # forward's streamed chunks)
    large = MKG.large_route(t[1], t[2], None, chunks)
    count = lambda: MKG.large_launches if large else MKG.launches  # noqa: E731
    pchunks = _plain_chunks(mega, MK, x["scene"], t)
    want, out["plain_ms"]["b"] = _timed(
        lambda: MKG.pathtrace_pass_bwd_reference(t[0], ipar, *t[1:], g, u,
                                                 chunks=pchunks, **kw))
    before = count()
    got = {r: MKG.pathtrace_pass_bwd(t[0], ipar, *t[1:], g, p, chunks=chunks,
                                     **kw)
           for r, p in (("u-planes", u), ("PRNG", None))}
    torch.cuda.synchronize()
    _check(count() == before + 2, f"{size}: kernel 2 launches "
           f"{count() - before} (want 2{', large-table' if large else ''})")
    print(f"phase 23 (b) kernel 2 direct{' (record + sweep)' if large else ''}"
          f", {size} wrt {list(wrt)}: plain {out['plain_ms']['b']:.6g} ms")
    out["max_abs_err"]["b"] = _hold_routes("kernel 2", want, got, wrt)
    # c: kernel 3 on kernel 1's own record
    want, out["plain_ms"]["c"] = _timed(
        lambda: MKG.pathtrace_pass_bwd_champ_reference(
            t[0], ipar, *t[1:], g, u, ids, occs, **kw))
    before = MKG.champ_launches
    got = {r: MKG.pathtrace_pass_bwd_champ(t[0], ipar, *t[1:], g, p, ids,
                                           occs, **kw)
           for r, p in (("u-planes", u), ("PRNG", None))}
    torch.cuda.synchronize()
    _check(MKG.champ_launches == before + 2, f"{size}: kernel 3 launches")
    print(f"phase 23 (c) kernel 3 direct on kernel 1's record, {size}: plain "
          f"{out['plain_ms']['c']:.6g} ms")
    out["max_abs_err"]["c"] = _hold_routes("kernel 3", want, got, wrt)
    out["shape"] = {"abc": f"{DIRECT_W}x{DIRECT_H}"}
    if not soft:
        return out
    # d: kernel 2s (the large scenes at a smaller film: the plain soft
    # program's two-level composite holds every pair of a span per ray)
    if name != "cornell":
        w, h = DIRECT_SOFT_W, DIRECT_SOFT_H
        x = _direct_inputs(dev, name, w, h, spp, lens, wrt)
        t, u, g, kw = (x[k] for k in ("tables", "u", "g", "kw"))
        st = mega.soft_tri_order(x["scene"], t[2], x["chunks"])
        if st is not None:
            t[2] = st.rows
    kw = dict(kw, soft_bandwidth=EDGE_BW, soft_tau=EDGE_BW)
    soft_large = max(t[1].shape[0], t[2].shape[0]) > UNROLL_SPHERES
    scount = (lambda: MKS.soft_large_launches if soft_large  # noqa: E731
              else MKS.soft_launches)

    def plain(gg):
        return _soft_plain(MKS, t, ipar, gg, u, kw, chunk=1 << 14)

    def kernel(gg, planes):
        return MKS.pathtrace_pass_bwd_soft(t[0], ipar, *t[1:], gg, planes,
                                           **kw)
    want, out["plain_ms"]["d"] = _timed(lambda: plain(g))
    before = scount()
    got = {"u-planes": kernel(g, u), "PRNG": kernel(g, None)}
    torch.cuda.synchronize()
    _check(scount() == before + 2, f"{size}: kernel 2s launches")
    held = [nm for nm, a in zip(MKG.DIFF_ALL, want) if nm in wrt and a.numel()]
    print(f"phase 23 (d) kernel 2s direct{' (large-table instance)' if soft_large else ''}"
          f", {name} {w}x{h}: plain {out['plain_ms']['d']:.6g} ms")
    want, got, _ = _excuse_unstable(MKS, t, g, u, kw, held, want, got,
                                    plain, kernel,
                                    f"{name}: kernel 2s direct")
    out["max_abs_err"]["d"] = _hold_routes("kernel 2s", want, got, wrt)
    out["shape"]["d"] = f"{w}x{h}"
    return out


def _tree_equal(a, b) -> bool:
    """Two sphere trees (MK.SphereTree) element for element."""
    import torch
    return a.tree.leaf == b.tree.leaf and all(
        torch.equal(x, y) for x, y in (
            (a.rows, b.rows), (a.perm, b.perm), (a.tree.nodes, b.tree.nodes),
            (a.tree.masks, b.tree.masks), (a.tree.loose, b.tree.loose)))


def _walk_tables(name: str, dev) -> list:
    """Kernel 1's tables at MAIN_W x MAIN_H spp 1 past the direct walk's
    threshold: sphere_field(N_SPHERES) ("spheres1024"), its tie and masked
    copy (phase 8's: spheres 0, 15, 30, ... copied to the last TIE_COPIES
    rows, every 9th masked off) and sphere_field(WALK_SPHERES)."""
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.models.scenes import sphere_field
    from raytracing_tpu_torch.render import mega
    n = WALK_SPHERES if name == "spheres4608" else N_SPHERES
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=0,
                       use_megakernel=True)
    t = list(mega.scene_tables(sphere_field(n, cols=MAIN_W, rows=MAIN_H,
                                            device=dev), cfg))
    if name == "ties":
        sph = t[1].clone()
        sph[::9, 5] = 0.0
        src = torch.arange(TIE_COPIES, device=dev) * 15
        dst = torch.arange(N_SPHERES - TIE_COPIES, N_SPHERES, device=dev)
        sph[dst] = sph[src]
        sph[dst, 5] = 1.0
        t[1] = sph
    return t


def direct_walk_vs_brute(dev) -> None:
    """Phase 23 (a), the sphere tree: on each table of _walk_tables at
    MAIN_W x MAIN_H spp 1, the build kernel's tree equal to MK.sphere_tree
    (torch.equal), and kernel 1's walk instances (the route past
    MK.SPH_BRUTE_MAX["direct"]) equal to its brute ones (forced), recording
    and not, in the default and the --fmad=false builds: acc, ids and occs
    with torch.equal, each fatal. Card against card: no plain run."""
    import torch
    from raytracing_tpu_torch.core import rng
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.ops import megakernel as MK
    for name in ("spheres1024", "ties", "spheres4608"):
        t = _walk_tables(name, dev)
        _check(MK.sphere_walks(t[1], mode="direct"),
               f"{name}: {t[1].shape[0]} spheres do not take the walk "
               f"(SPH_BRUTE_MAX {MK.SPH_BRUTE_MAX})")
        built = MK.sphere_tree_build(t[1], MK.SPH_TREE_LEAF)
        _check(_tree_equal(built, MK.sphere_tree(t[1], MK.SPH_TREE_LEAF)),
               f"{name}: the build kernel's tree differs from MK.sphere_tree")
        n = MAIN_W * MAIN_H
        zeros = torch.zeros((n, 3), device=dev)
        kw = dict(key=rng.base_key(1), spp=1, width=MAIN_W, two_sided=False)
        same = {}
        for flags in ((), EXACT_FLAGS):
            got = {walk: MK.direct_pass(*t, zeros.clone(), None, record=True,
                                        build_flags=flags, sphere_walk=walk,
                                        **kw)
                   for walk in (None, False)}
            acc = MK.direct_pass(*t, zeros.clone(), None, build_flags=flags,
                                 **kw)
            same[flags] = (all(torch.equal(a, b)
                               for a, b in zip(got[None], got[False]))
                           and torch.equal(acc, got[None][0]))
            _check(same[flags], f"{name}: the walk instance differs from the "
                   f"brute instance (build flags {flags})")
        hits = (got[None][1] >= 0).double().mean().item()
        print(f"phase 23 (a) sphere tree, {name} ({t[1].shape[0]} spheres) "
              f"{MAIN_W}x{MAIN_H} spp 1: build == MK.sphere_tree True; walk "
              f"== brute (acc, ids, occs; recording and not): default build "
              f"{same[()]}, --fmad=false {same[EXACT_FLAGS]}; hits "
              f"{hits:.4%}")


def _build_device_ms(HK, MK, rows, reps: int = 20) -> float:
    """The tree's build kernel alone, ms per launch: ``reps`` launches of
    its C entry back to back into one tree allocated once, between CUDA
    events (through the wrapper, its allocations and checks pace the
    launches: ~0.06-0.1 ms of host work against ~0.04 ms of device time
    on sphere_field(1024))."""
    import torch
    tree = MK.sphere_tree_build(rows, MK.SPH_TREE_LEAF)
    st = tree.tree
    lib = MK._build.load("sphere_tree", MK._TREE_SIGNATURES)
    args = (rows.data_ptr(), rows.shape[0], st.leaf, st.n_slots,
            MK.CHUNK_PAD, MK.LOOSE_SHARE, st.loose.shape[0],
            tree.rows.data_ptr(), tree.perm.data_ptr(), st.nodes.data_ptr(),
            st.masks.data_ptr(), st.loose.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check(lib.rt_sphere_tree(*args) == 0, "rt_sphere_tree failed")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        lib.rt_sphere_tree(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _direct_walk_work(MK, tables, key, tree, live=None) -> dict:
    """The sphere tree's walk, counted by its plain emulation
    (``MK._walk_tree``, the kernel's lane order) over a direct pass's traces
    and shadow rays on ``tables`` at MAIN_W x MAIN_H spp 1 with the draws
    of ``key``, over the rays in ``live`` (all by default; the others dead,
    as the split's record skips them): node_tests, sph_tests, ..."""
    import torch
    work: dict = {}
    n = MAIN_W * MAIN_H
    sph, tri = tables[1], tables[2]

    def window(mint, maxt):
        if live is None:
            return mint, maxt
        inf = torch.full_like(mint, float("inf"))
        return torch.where(live, mint, inf), torch.where(live, maxt, inf)

    def trace(o, d, mint, maxt):
        return MK._trace(o, d, *window(mint, maxt), sph, tri, False,
                         work=work, sph_tree=tree)

    def anyhit(o, d, mint, maxt):
        return MK._anyhit(o, d, *window(mint, maxt), sph, tri, False,
                          work=work, sph_tree=tree)

    u = MK.direct_draw_planes(key, n, tables[4].shape[0], 1, sph.device)
    with torch.no_grad():
        MK._direct_reference(*tables, torch.zeros((n, 3), device=sph.device),
                             u, spp=1, width=MAIN_W, two_sided=False,
                             trace=trace, anyhit=anyhit)
    return work


def _path_walk_work(MK, tables, ipar, cfg, live) -> dict:
    """The sphere tree's walk, counted by its plain emulation (``MK._trace``
    / ``MK._anyhit`` with the tree, the kernel's lane order) over the path
    pass ``ipar`` of ``cfg`` (its PRNG draws) on ``tables``, the rays
    outside ``live`` dead in every segment, as the split's record skips
    them: node_tests, sph_tests, ..."""
    import torch
    work: dict = {}
    sph, tri = tables[1], tables[2]
    tree = MK.sphere_tree(sph, MK.SPH_TREE_LEAF)
    inf = torch.full_like(live, float("inf"), dtype=torch.float32)

    def window(mint, maxt):
        return torch.where(live, mint, inf), torch.where(live, maxt, inf)

    def trace(o, d, mint, maxt):
        return MK._trace(o, d, *window(mint, maxt), sph, tri, False,
                         work=work, sph_tree=tree)

    def anyhit(o, d, mint, maxt):
        return MK._anyhit(o, d, *window(mint, maxt), sph, tri, False,
                          work=work, sph_tree=tree)

    n = live.shape[0]
    kw = _pass_kw(cfg)
    u = MK.pass_draws(ipar, None, n, tables[4].shape[0], cfg.bounces,
                      cfg.seed, 0, sph.device, cfg.russian_roulette)
    with torch.no_grad():
        MK._pass_reference(*tables, torch.zeros((n, 3), device=sph.device),
                           u, int(ipar[1]), spp=cfg.spp, width=cfg.width,
                           bounces=cfg.bounces, two_sided=kw["two_sided"],
                           normalize_emitter=kw["normalize_emitter"],
                           russian_roulette=cfg.russian_roulette,
                           rr_start_depth=cfg.rr_start_depth, trace=trace,
                           anyhit=anyhit)
    return work


def _direct_walk_ops(w: dict, work: dict, n_tri: int) -> float:
    """FP32 operations of a direct pass whose sphere loops are the tree's
    walk (``work``: node tests at OPS_CHUNK, a slab test, and row tests at
    OPS_SPHERE_TEST, as kernel 4's walk is priced) over the record's work
    w; the triangles tested as _direct_ops tests them."""
    tri = n_tri * OPS_TRIANGLE_TEST
    return (w["rays"] * OPS_CAMERA + w["primary"] * (OPS_TRACE + tri)
            + work.get("node_tests", 0) * OPS_CHUNK
            + work.get("sph_tests", 0) * OPS_SPHERE_TEST
            + w["sph_hits"] * OPS_SPHERE_HIT
            + w["tri_hits"] * OPS_TRIANGLE_HIT
            + w["shadow"] * OPS_DIRECT_SHADE + w["free"] * tri)


def direct_train(dev, smi: str, name: str, route: str) -> dict:
    """Phase 23 (i)-(iii): one warm-up and DIRECT_STEPS timed SGD steps of
    direct mode at 1024^2 spp 1 through pathtrace_pass_diff(mode="direct")
    on ``route`` ("kernel2": kernels 1 and 2, past 64 objects kernel 2's
    record and sweep; "cell": kernel 1 recording and kernel 3; "soft":
    kernels 1 and 2s at EDGE_BW), ("sph", "mat"); the image is the
    per-pixel mean over spp over the lights, as render_direct_mega forms
    it. Gates one direct launch and one launch of the route's backward per
    step, a finite loss and finite nonzero gradients; times each kernel
    alone (CUDA events) on the last step's tables and cotangent, with its
    bound."""
    import torch
    from raytracing_tpu_torch import RenderConfig, replace
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.ops import megakernel_soft as MKS
    from raytracing_tpu_torch.render import mega

    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=0,
                       use_megakernel=True)
    scene = _direct_scene(name, MAIN_W, MAIN_H, dev)
    n_l = scene.lights.count
    soft = (dict(soft_bandwidth=EDGE_BW, soft_tau=EDGE_BW)
            if route == "soft" else {})
    kw = _pass_kw(cfg)
    params = {"center": scene.spheres.center.clone().requires_grad_(True),
              "radius": scene.spheres.radius.clone().requires_grad_(True),
              "materials": scene.materials.clone().requires_grad_(True)}
    seen = {}

    def tables_of():
        sc = replace(scene, spheres=replace(scene.spheres,
                                            center=params["center"],
                                            radius=params["radius"]),
                     materials=params["materials"])
        return mega.scene_tables(sc, cfg)

    def step(i):
        t = tables_of()
        acc = MKG.pathtrace_pass_diff(
            t[0], torch.tensor([i, 0], dtype=torch.int32), *t[1:],
            torch.zeros((cfg.total_rays, 3), device=dev), None,
            mode="direct", diff_wrt=TRAIN_WRT, bwd_cell=route == "cell",
            **soft, **kw)
        acc.register_hook(lambda g: seen.__setitem__("g", g))
        img = acc.reshape(MAIN_H, MAIN_W, cfg.spp, 3).mean(2) / n_l
        loss = torch.mean(img ** 2)
        loss.backward()
        grads = {}
        with torch.no_grad():
            for k, p in params.items():
                grads[k] = p.grad
                p -= TRAIN_LR * p.grad
                p.grad = None
        return loss.detach(), grads

    loss0, _ = step(0)                                   # warm-up
    torch.cuda.synchronize()
    counters = {"kernel 1 (direct)": "MK.direct_launches",
                "kernel 1 (direct, sphere tree)": "MK.direct_walk_launches",
                "sphere tree build": "MK.tree_build_launches",
                "kernel 2": "MKG.launches",
                "kernel 2 (large)": "MKG.large_launches",
                "kernel 3": "MKG.champ_launches",
                "kernel 2s": "MKS.soft_launches",
                "kernel 2s (large)": "MKS.soft_large_launches"}
    mods = {"MK": MK, "MKG": MKG, "MKS": MKS}
    for c in counters.values():
        m, attr = c.split(".")
        setattr(mods[m], attr, 0)
    t0 = time.perf_counter()
    losses = []
    for i in range(1, 1 + DIRECT_STEPS):
        loss, grads = step(i)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: getattr(mods[c.split(".")[0]], c.split(".")[1])
           for k, c in counters.items()}
    big = max(scene.spheres.count, 0) > UNROLL_SPHERES
    bwd = {"kernel2": "kernel 2 (large)" if big else "kernel 2",
           "cell": "kernel 3", "soft": "kernel 2s"}[route]
    want = {k: (DIRECT_STEPS if k in ("kernel 1 (direct)", bwd) else 0)
            for k in counters}
    # past the threshold every direct launch walks a tree, built once per
    # step by the forward (the split's record walks the forward's)
    walks = MK.sphere_walks(mega.scene_tables(scene, cfg)[1],
                            mode="direct")
    want["kernel 1 (direct, sphere tree)"] = DIRECT_STEPS * walks
    want["sphere tree build"] = DIRECT_STEPS * walks
    _check(got == want, f"direct {route} steps on {name}: launches {got} "
           f"(want {want})")
    losses = torch.stack([loss0] + losses)
    _check(bool(torch.isfinite(losses).all()), "direct training loss not "
           "finite")
    for k in ("center", "materials", "radius"):
        _check(grads[k] is not None and bool(torch.isfinite(grads[k]).all()),
               f"{k} gradient missing or not finite")
    for k in ("center", "materials"):
        _check(bool(grads[k].any()), f"{k} gradient is zero")

    # each kernel alone on the last step's tables and cotangent of acc
    with torch.no_grad():
        t = [x.detach() for x in tables_of()]
    ipar = torch.tensor([DIRECT_STEPS, 0], dtype=torch.int32)
    g = seen["g"].contiguous()
    zeros = torch.zeros_like(g)
    fkw = dict(key=MK.pass_key_of(ipar, cfg.seed), spp=1, width=MAIN_W,
               two_sided=False)
    bkw = dict(kw, diff_wrt=TRAIN_WRT, mode="direct")
    _, ids, occs = MK.direct_pass(*t, zeros.clone(), None, record=True,
                                  **fkw)
    bounds = _direct_bounds(t, ids, occs, g, TRAIN_WRT,
                            split=MKG.large_route(t[1], t[2]))
    if route == "kernel2":
        # the split's record walks the forward's tree, as in the step
        fwd_tree = MK.pass_tree(t[1], mode="direct")
        runs = {"b": lambda: MKG.pathtrace_pass_bwd(
            t[0], ipar, *t[1:], g, None, sph_tree=fwd_tree, **bkw)}
    elif route == "cell":
        runs = {"a": lambda: MK.direct_pass(*t, zeros.clone(), None,
                                            record=True, **fkw),
                "c": lambda: MKG.pathtrace_pass_bwd_champ(
                    t[0], ipar, *t[1:], g, None, ids, occs, **bkw)}
    else:
        tl = list(t)
        live, _ = _soft_work(MK, tl, g, cfg)
        dense = _soft_dense(tl[1].shape[0], tl[2].shape[0])
        bounds["d"] = _bound(_soft_ops(live, live, n_l, dense, direct=True),
                             12 * cfg.total_rays + 2 * _table_bytes(tl))
        bounds["d"]["per_ray"] = _soft_ops(1, 1, n_l, dense, direct=True)
        bounds["d"].update(_sfu_bound(_soft_sfu(live, live, n_l, dense,
                                                direct=True)))
        runs = {"d": lambda: MKS.pathtrace_pass_bwd_soft(
            t[0], ipar, *t[1:], g, None, **soft, **bkw)}
    build = {}
    if walks:
        # the walk's count (of the pieces this route times) against the
        # brute one: the bound takes the smaller; the build kernel alone
        # against its plain version
        tree = MK.sphere_tree(t[1], MK.SPH_TREE_LEAF)
        n_l = t[4].shape[0]
        live = (g != 0).any(-1)
        for k in ("a", "b"):
            if k not in runs:
                continue
            w = _pass_work(ids, occs, n_l, t[1].shape[0],
                           live if k == "b" else None)
            work = _direct_walk_work(MK, t, fkw["key"], tree,
                                     live if k == "b" else None)
            ops = _direct_walk_ops(w, work, t[2].shape[0])
            if k == "b":
                ops += _direct_adj_ops(w, TRAIN_WRT)
            walk_b = _bound(ops, bounds[k]["bytes"])
            brute_ms = bounds[k]["bound_ms"]
            rays = max(w["rays"], 1)
            print(f"  piece {k} walk count: "
                  f"{work.get('node_tests', 0) / rays:.6g} node tests and "
                  f"{work.get('sph_tests', 0) / rays:.6g} row tests per "
                  f"ray; bound {walk_b['bound_ms']:.6g} ms "
                  f"({walk_b['bound_by']}; the brute count's "
                  f"{brute_ms:.6g} ms)")
            if walk_b["bound_ms"] < brute_ms:
                bounds[k].update(walk_b, per_ray=ops / rays)
            bounds[k].update(walk_bound_ms=walk_b["bound_ms"],
                             brute_bound_ms=brute_ms)
        built = MK.sphere_tree_build(t[1], MK.SPH_TREE_LEAF)
        _check(_tree_equal(built, tree), f"{name}: the build kernel's tree "
               "differs from MK.sphere_tree")
        err = max(torch.where(a == b, 0.0, (a.double() - b.double()).abs())
                  .max().item() for a, b in (
                      (built.rows, tree.rows), (built.perm, tree.perm),
                      (built.tree.nodes, tree.tree.nodes)))
        plain_ms = _timed(lambda: MK.sphere_tree(t[1], MK.SPH_TREE_LEAF))[1]
        # bytes: the table read once, the tree written once; operations:
        # per row its box (6) and code (9), per node its box (6)
        tree_bytes = 4 * sum(x.numel() for x in (
            t[1], tree.rows, tree.perm, tree.tree.nodes, tree.tree.masks,
            tree.tree.loose))
        build = {"plain_ms": plain_ms, "max_abs_err": err,
                 **_bound(15 * t[1].shape[0] + 6 * tree.tree.nodes.shape[0],
                          tree_bytes)}
        runs["build"] = lambda: MK.sphere_tree_build(t[1],
                                                     MK.SPH_TREE_LEAF)
    ms = {}
    for k, fn in runs.items():
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        reps = 10
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms[k] = start.elapsed_time(end) / reps
    stats = _soft_stats(MKS, False, True) if route == "soft" else {}
    print(f"phase 23 direct train {name} {MAIN_W}x{MAIN_H} spp 1 route "
          f"{route} wrt {list(TRAIN_WRT)}, {DIRECT_STEPS} timed steps on "
          f"[{smi}]: {wall * 1e3 / DIRECT_STEPS:.6g} ms/step, "
          f"{cfg.total_rays * DIRECT_STEPS / wall:.6g} fwd+bwd rays/s; "
          f"launches {got}; loss first {losses[0].item():.7g} last "
          f"{losses[-1].item():.7g}; |grad| center "
          f"{grads['center'].norm().item():.6g} materials "
          f"{grads['materials'].norm().item():.6g}")
    piece = {"a": "kernel 1 recording", "b": "kernel 2", "c": "kernel 3",
             "d": "kernel 2s"}
    if "build" in ms:
        build["wrapper_ms"] = ms.pop("build")
        build["ms"] = _build_device_ms(HK, MK, t[1])
        print(f"  the sphere tree's build alone ({t[1].shape[0]} rows, one "
              f"launch): {build['ms']:.6g} ms (its C entry back to back); "
              f"{build['wrapper_ms']:.6g} ms per wrapper call back to back; "
              f"plain {build['plain_ms']:.6g} ms (host, synchronised); "
              f"bound {build['bound_ms']:.6g} ms ({build['bound_by']})")
    for k, t_ms in ms.items():
        b = bounds[k]
        print(f"  piece {k} ({piece[k]}) alone on the last step's "
              f"{'pass' if k == 'a' else 'cotangent'}: {t_ms:.6g} ms; bound "
              f"{b['bound_ms']:.6g} ms ({b['bound_by']}, {b['per_ray']:.6g} "
              f"FP32 operations per {'ray' if k == 'a' else 'ray with g != 0'}"
              f"); share of the bound {b['bound_ms'] / t_ms:.3%}"
              + (f"; second bound {b['bound_sfu_ms']:.6g} ms (MUFU), share "
                 f"{b['bound_sfu_ms'] / t_ms:.3%}; launch {stats}"
                 if k == "d" else ""))
    launches = {"a": got["kernel 1 (direct)"], "b": got[bwd],
                "c": got[bwd], "d": got[bwd]}
    out = {k: {"ms": v, "launches": launches[k],
               "bound_ms": bounds[k]["bound_ms"],
               "bound_by": bounds[k]["bound_by"],
               **{x: bounds[k][x] for x in ("walk_bound_ms", "brute_bound_ms")
                  if x in bounds[k]},
               **({"stats": stats,
                   "bound_sfu_ms": bounds[k]["bound_sfu_ms"]}
                  if k == "d" else {})} for k, v in ms.items()}
    if build:
        out["build"] = dict(build, launches=got["sphere tree build"],
                            walk_launches=got[
                                "kernel 1 (direct, sphere tree)"])
        for k in out:
            if k in ("a", "b"):
                out[k]["build_ms"] = build["ms"]
    return out


SHARD_PASSES = PASSES_PER_CALL   # phase 25: passes per sharded call
SHARD_CALLS = 5                  # timed sharded calls and steps per rank
SHARD_UNEVEN = (1001, 999)       # 999,999 rays: no rank holds whole rows,
                                 # and 2 ranks pad the last by one ray
SHARD_STEPS = (("pallas", "cornell", {"mega_bwd_impl": "pallas"}),
               ("cell", f"sphere_field({N_SPHERES})", {}))


def _shard_counts(MK, MKG, HK) -> dict:
    return {"k1": MK.launches, "k1_walk": MK.path_walk_launches,
            "builds": MK.tree_build_launches, "k2": MKG.launches,
            "k3": MKG.champ_launches, "order": MKG.order_launches,
            "k4": HK.sphere_launches, "k4_tree": HK.sphere_tree_launches}


def _zero_counts(MK, MKG, HK) -> None:
    MK.launches = MK.path_walk_launches = MK.tree_build_launches = 0
    MKG.launches = MKG.champ_launches = MKG.order_launches = 0
    HK.sphere_launches = HK.sphere_tree_launches = 0


def _shard_scene(name: str, w: int, h: int):
    """Phase 25's scenes, built on the CPU (a rank moves them to its card
    in ``replicate_scene``; the single-process runs with ``.to``), so both
    sides hold the same bits."""
    from raytracing_tpu_torch.models.scenes import cornell_box, sphere_field
    if name == "cornell":
        return cornell_box(cols=w, rows=h)
    return sphere_field(N_SPHERES, cols=w, rows=h)


def _shard_rank(n_obj: int) -> dict:
    """Phase 25, one rank: the sharded forward (cornell 1024^2 and the
    uneven film), the sharded "pallas" and cell train steps and the
    object-sharded kernel-4 search, each driven with the launch counts set
    to 0 just before and read just after; rank 0 hands back the gathered
    results, every rank its counts and times."""
    import torch
    import torch.distributed as dist
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.core.types import Rays
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.parallel import mesh as pm
    from raytracing_tpu_torch.parallel.obj_parallel import \
        closest_hit_spheres_objsharded
    from raytracing_tpu_torch.render import pathtracer as pt

    rank = dist.get_rank()
    m = pm.make_mesh()
    dev = pm.mesh_device(m)
    out = {"rank": rank, "card": torch.cuda.get_device_name(dev),
           "backend": dist.get_backend(), "cases": {}}

    def timed(fn):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0)

    for name, (w, h) in (("cornell", (MAIN_W, MAIN_H)),
                         ("uneven", SHARD_UNEVEN)):
        cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                           use_megakernel=True)
        scene = pm.replicate_scene(_shard_scene("cornell", w, h), m)
        render = pm.sharded_render_passes(m, cfg, SHARD_PASSES)
        state = pm.shard_state(pt.init_state(cfg, dev), m)
        off, local = pm.ray_slice(m, cfg.total_rays)
        _zero_counts(MK, MKG, HK)
        state, ms0 = timed(lambda: render(scene, state))
        counts = _shard_counts(MK, MKG, HK)
        full = pm.gather_state(state, m, cfg)["acc"]
        times, gathers = [], []
        for _ in range(SHARD_CALLS):
            state, ms = timed(lambda: render(scene, state))
            times.append(ms)
            gathers.append(timed(lambda: pm.gather_state(state, m, cfg))[1])
        out["cases"][name] = {
            "counts": counts, "first_ms": ms0, "ms": sorted(times),
            "gather_ms": sorted(gathers),
            "slice": (off, local), "acc": full.cpu().numpy()
            if rank == 0 else None}

    for name, scene_name, extra in SHARD_STEPS:
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                           mega_grad_wrt=TRAIN_WRT, use_megakernel=True,
                           **extra)
        scene = pm.replicate_scene(
            _shard_scene(scene_name, MAIN_W, MAIN_H), m)
        params = {"center": scene.spheres.center,
                  "radius": scene.spheres.radius,
                  "materials": scene.materials}
        target = torch.zeros((MAIN_H, MAIN_W, 3), device=dev)
        step = pm.make_train_step(m, cfg)
        state = pm.shard_state(pt.init_state(cfg, dev), m)
        _zero_counts(MK, MKG, HK)
        ((loss, _), grads), ms0 = timed(
            lambda: step(params, scene, state, target))
        counts = _shard_counts(MK, MKG, HK)
        times = []
        for _ in range(SHARD_CALLS):
            _, ms = timed(lambda: step(params, scene, state, target))
            times.append(ms)
        out["cases"][name] = {
            "counts": counts, "first_ms": ms0, "ms": sorted(times),
            "loss": float(loss),
            "grads": {k: g.cpu().numpy() for k, g in grads.items()}}

    m2 = pm.make_mesh(obj_parallel=n_obj)
    spheres = pm.replicate_scene(_shard_scene("spheres", 8, 8), m2).spheres
    rays = Rays(*_seeded_rays(dev, HIT_RAYS, HIT_SEED, -6.0, 6.0))
    _zero_counts(MK, MKG, HK)
    ch, ms0 = timed(lambda: closest_hit_spheres_objsharded(rays, spheres,
                                                           m2))
    counts = _shard_counts(MK, MKG, HK)
    times = []
    for _ in range(SHARD_CALLS):
        _, ms = timed(lambda: closest_hit_spheres_objsharded(rays, spheres,
                                                             m2))
        times.append(ms)
    out["cases"]["search"] = {
        "counts": counts, "first_ms": ms0, "ms": sorted(times),
        "mesh": tuple(m2.shape),
        "t": ch.t.cpu().numpy() if rank == 0 else None,
        "idx": ch.idx.cpu().numpy() if rank == 0 else None,
        "valid": ch.valid.cpu().numpy() if rank == 0 else None}
    return out


def sharding(dev, smi: str) -> dict:
    """Phase 25: the sharded paths on the card (``parallel/``): two gloo
    ranks on one card, or one NCCL rank per card where there are two or
    more. Every rank: the forward through kernel 1 (cornell 1024^2 b5 and
    the uneven 1001x999 film, 16 passes per call: one launch per call),
    the "pallas" train step (cornell, ("sph", "mat"): kernels 1 and 2) and
    the cell step (sphere_field(1024): kernel 1 recording over its tree,
    and kernel 3), and kernel 4 over sphere_field(1024)'s spheres split
    over 'obj'. Held here against this process's single-process runs: the
    gathered accumulators bit for bit (each ray is computed alone, keyed
    by its global id, block 0), the steps' losses to 1e-5 and cotangents
    under phase 6's gates, the search's (t, idx, valid) bit for bit.
    Prints per-rank times; ranks that share a card measure no scaling."""
    import numpy as np
    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.core.types import Rays
    from raytracing_tpu_torch.ops.closest_hit import closest_hit_spheres
    from raytracing_tpu_torch.parallel import mesh as pm
    from raytracing_tpu_torch.parallel.scaling import segments_per_pass
    from raytracing_tpu_torch.render import pathtracer as pt

    t25 = time.perf_counter()
    cards = torch.cuda.device_count()
    n = cards if cards >= 2 else 2
    n_obj = 2 if n % 2 == 0 else n
    backend, why = pm.pick_backend(n)
    print(f"phase 25: {n} ranks, {backend} ({why})")
    res = pm.spawn(_shard_rank, n, n_obj, store_dir=str(HERE / "build"),
                   timeout=600)
    print(f"phase 25: ranks done in {time.perf_counter() - t25:.1f} s")
    shared = n > cards
    note = (f"{n} ranks share one card: per-rank times, not a scaling "
            "measurement" if shared else f"one rank per card ({n} cards)")
    for r in res:
        cs = r["cases"]
        for name in ("cornell", "uneven"):
            c = cs[name]
            _check(c["counts"]["k1"] == 1 and c["counts"]["k2"] == 0,
                   f"phase 25 rank {r['rank']} {name}: kernel 1 launched "
                   f"{c['counts']['k1']} times in one sharded call")
        _check(cs["pallas"]["counts"]["k1"] == 1
               and cs["pallas"]["counts"]["k2"] == 1
               and cs["pallas"]["counts"]["k3"] == 0,
               f"phase 25 rank {r['rank']} pallas step: "
               f"{cs['pallas']['counts']}")
        c = cs["cell"]["counts"]
        _check(c["k1"] == 1 and c["k3"] == 1 and c["k2"] == 0
               and c["k1_walk"] == 1 and c["builds"] == 1
               and c["order"] == 1,
               f"phase 25 rank {r['rank']} cell step: {c}")
        c = cs["search"]["counts"]
        _check(c["k4"] == 1 and c["k4_tree"] == 1,
               f"phase 25 rank {r['rank']} object-sharded search: {c}")
    rank0 = res[0]["cases"]

    for name, (w, h) in (("cornell", (MAIN_W, MAIN_H)),
                         ("uneven", SHARD_UNEVEN)):
        cfg = RenderConfig(width=w, height=h, bounces=BOUNCES,
                           use_megakernel=True)
        scene = _shard_scene("cornell", w, h).to(dev)
        want = pt.render_passes(scene, pt.init_state(cfg, dev), cfg,
                                SHARD_PASSES)["acc"].cpu().numpy()
        got = rank0[name]["acc"]
        _check(got.shape == want.shape and np.isfinite(got).all(),
               f"phase 25 {name}: gathered acc {got.shape}")
        _check(np.array_equal(got, want),
               f"phase 25 {name}: the gathered accumulator differs from "
               f"the single-process launch on "
               f"{int((got != want).any(-1).sum())} rays")
        segs = segments_per_pass(cfg, scene.lights.count)
        for r in res:
            c = r["cases"][name]
            off, local = c["slice"]
            ms = c["ms"][len(c["ms"]) // 2]
            rays = min(local, cfg.total_rays - off)
            print(f"phase 25 rank {r['rank']} forward {name} {w}x{h} "
                  f"b{BOUNCES}, {SHARD_PASSES} passes per call, rays "
                  f"[{off}, {off + local}): {ms:.3f} ms per call (median "
                  f"of {SHARD_CALLS}; first {c['first_ms']:.3f}), "
                  f"{rays * SHARD_PASSES / ms * 1e3:.6e} rays/s, "
                  f"{segs * rays / cfg.total_rays * SHARD_PASSES / ms * 1e3:.6e}"
                  f" segments/s; gather_state of the film "
                  f"{c['gather_ms'][len(c['gather_ms']) // 2]:.3f} ms; "
                  f"{r['card']}, {r['backend']}; {smi}; {note}")
        print(f"phase 25 forward {name}: gathered == single-process launch, "
              "bit for bit")

    for name, scene_name, extra in SHARD_STEPS:
        cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                           mega_grad_wrt=TRAIN_WRT, use_megakernel=True,
                           **extra)
        scene = _shard_scene(scene_name, MAIN_W, MAIN_H).to(dev)
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in (
            ("center", scene.spheres.center),
            ("radius", scene.spheres.radius),
            ("materials", scene.materials))}
        st = pt.render_pass(pm.apply_default_params(scene, leaves),
                            pt.init_state(cfg, dev), cfg)
        loss = torch.mean((pt.image(st, cfg) - torch.zeros(
            (MAIN_H, MAIN_W, 3), device=dev)) ** 2)
        want = dict(zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))))
        got = rank0[name]
        _check(abs(got["loss"] - loss.item()) <= 1e-5 * abs(loss.item()),
               f"phase 25 {name} step: loss {got['loss']} vs single-process "
               f"{loss.item()}")
        print(f"phase 25 {name} step on {scene_name}: loss {got['loss']:.9g}"
              f" (single process {loss.item():.9g})")
        for k, w_ in want.items():
            if w_.abs().max() == 0:
                continue
            _grad_gates(f"phase 25 {name} {k}", w_,
                        torch.as_tensor(got["grads"][k], device=dev),
                        max_gate=False)
        for r in res:
            c = r["cases"][name]
            print(f"phase 25 rank {r['rank']} {name} step {scene_name} "
                  f"{MAIN_W}x{MAIN_H} b{BOUNCES} {TRAIN_WRT}: "
                  f"{c['ms'][len(c['ms']) // 2]:.3f} ms per step (median of "
                  f"{SHARD_CALLS}; first {c['first_ms']:.3f}; the gather "
                  f"and all-reduce included), launches {c['counts']}; "
                  f"{r['card']}, {r['backend']}; {smi}; {note}")

    sp = _shard_scene("spheres", 8, 8).to(dev).spheres
    rays = Rays(*_seeded_rays(dev, HIT_RAYS, HIT_SEED, -6.0, 6.0))
    want = closest_hit_spheres(rays, sp, use_pallas=True)
    got = rank0["search"]
    for k in ("t", "idx", "valid"):
        _check(np.array_equal(got[k], getattr(want, k).cpu().numpy()),
               f"phase 25 object-sharded search: {k} differs from the "
               "unsharded kernel-4 search")
    for r in res:
        c = r["cases"]["search"]
        print(f"phase 25 rank {r['rank']} object-sharded kernel 4 over "
              f"sphere_field({N_SPHERES})'s spheres, mesh {c['mesh']}, "
              f"{HIT_RAYS} rays: {c['ms'][len(c['ms']) // 2]:.3f} ms per "
              f"call (median of {SHARD_CALLS}; the all-gather included), "
              f"launches {c['counts']}; {r['card']}, {r['backend']}; "
              f"{smi}; {note}")
    print(f"phase 25 object-sharded search: (t, idx, valid) == unsharded, "
          f"bit for bit; {int(want.valid.sum())} hits")
    print(f"phase 25: {time.perf_counter() - t25:.1f} s")
    return {"ranks": n, "backend": backend}


def _numpy_tables(scene, cfg) -> dict:
    """A scene's leaves and prepared grids (scene_to_numpy) and kernel 1's
    tables of it (render/mega.scene_tables), as numpy on the host."""
    from raytracing_tpu_torch.core.types import scene_to_numpy
    from raytracing_tpu_torch.render import mega
    d = scene_to_numpy(scene)
    for name, t in zip(("par", "sph", "tri", "mat", "lig"),
                       mega.scene_tables(scene, cfg)):
        d[f"kernel.{name}"] = t.cpu().numpy()
    return d


def _call_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` after one warm-up call (host clock around
    ``reps`` calls and a synchronize)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _xml_torus(dev, root: str) -> None:
    """Phase 26 (1): the torus XML against phase 18's scene."""
    import numpy as np
    import torch
    from raytracing_tpu_torch import replace
    from raytracing_tpu_torch.accel import prepare_grids
    from raytracing_tpu_torch.io.scene_xml import load_scene
    from raytracing_tpu_torch.render import pathtracer as pt
    from raytracing_tpu_torch.render.direct import render_direct
    from torch_xml_scenes import cornell_torus_xml

    path = cornell_torus_xml(root, *TORUS_SEGMENTS)
    got = prepare_grids(load_scene(path, MAIN_W, MAIN_H, dev), "auto",
                        mesh_slabs="auto")
    want = _grid_scene("torus", MAIN_W, MAIN_H, dev)
    base = _grid_cfg("torus", MAIN_W, MAIN_H, "path", mega_block=GRID_BLOCK)
    a, b = _numpy_tables(got, base), _numpy_tables(want, base)
    _check(sorted(a) == sorted(b), "XML torus: other tables than phase 18's")
    diff = [k for k in a if a[k].dtype != b[k].dtype
            or not np.array_equal(a[k], b[k])]
    _check(not diff, f"XML torus tables differ from phase 18's: {diff}")
    films = {}
    for mode in ("direct", "path"):
        cfg = replace(base, bounces=0) if mode == "direct" else base
        out = []
        for scene in (got, want):
            if mode == "direct":
                out.append(render_direct(scene, cfg, n_passes=GRID_PASSES))
            else:
                out.append(pt.render_passes(scene, pt.init_state(cfg, dev),
                                            cfg, GRID_PASSES)["acc"])
        torch.cuda.synchronize()
        _check(bool(torch.isfinite(out[0]).all()) and out[0].max() > 0,
               f"XML torus {mode}: film not finite or black")
        films[mode] = torch.equal(out[0], out[1])
        _check(films[mode], f"XML torus {mode} film != phase 18's scene's")
    print(f"phase 26 (1) the torus written as XML + mesh JSON ({len(a)} "
          f"tables, {2 * TORUS_SEGMENTS[0] * TORUS_SEGMENTS[1]} faces): every "
          f"table equals phase 18's; kernel 1's films bit-equal at "
          f"{MAIN_W}x{MAIN_H}, {GRID_PASSES} passes, direct and path "
          f"b{BOUNCES}: {films}")


def _config3_xml(dev, smi: str, path: str) -> None:
    """Phase 26 (2): config 3 through assign07(scene_xml=...)."""
    import torch
    from raytracing_tpu_torch.core import rng
    from raytracing_tpu_torch.models.assignments import assign07
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import mega

    # kernel vs plain version at 256x192, one pass on the same draws
    fn, (scene, cfg), _ = assign07(SMALL_W, SMALL_H, n_slabs=3,
                                   scene_xml=path, mesh_slabs="auto",
                                   device=dev)
    tables = mega.scene_tables(scene, cfg)
    grid = mega.grid_tables(scene, tables[1], tables[2])
    key = rng.base_key(cfg.seed)
    u = mega.u_planes_for_direct(key, cfg, scene.lights.count, dev)
    zeros = torch.zeros((cfg.total_rays, 3), device=dev)
    one = dict(key=key, spp=1, width=SMALL_W, two_sided=False, grid=grid)
    want = MK.direct_pass_reference(*tables, zeros, u, **one)
    got = MK.direct_pass(*tables, zeros.clone(), u, block=GRID_BLOCK, **one)
    exact = MK.direct_pass(*tables, zeros.clone(), u, block=GRID_BLOCK,
                           build_flags=EXACT_FLAGS, **one)
    torch.cuda.synchronize()
    err = (got - want).abs()
    beyond = (err > TOL + TOL * want.abs()).any(-1).double().mean().item()
    rel = abs(got.double().mean().item() / want.double().mean().item() - 1)
    same = torch.equal(exact, want)
    print(f"phase 26 (2) config 3 via assign07(scene_xml=cornell_teapot "
          f"stand-in) {SMALL_W}x{SMALL_H}: kernel vs plain max|d acc| "
          f"{err.max().item():.6g}, rays beyond {TOL:g} {beyond:.6%}, mean "
          f"rel {rel:.3g}; --fmad=false build equal {same}")
    _check(bool(torch.isfinite(got).all()), "config 3 via XML: acc")
    _check(same, "config 3 via XML: the --fmad=false build differs from "
           "the plain version")
    _check(beyond <= 0.01 and rel <= TEAPOT_REL,
           f"config 3 via XML {SMALL_W}x{SMALL_H}: beyond {beyond:.4%}, "
           f"rel {rel:.3g} (limit {TEAPOT_REL:g})")

    fn, (scene, cfg), _ = assign07(MAIN_W, MAIN_H, n_slabs=3,
                                   scene_xml=path, mesh_slabs="auto",
                                   device=dev)
    n_grid = [g.n for g in scene.folded_tri_grid]
    grids = []
    launch = MK.direct_pass

    def spy(*args, **kw):
        grids.append(kw.get("grid") is not None)
        return launch(*args, **kw)
    MK.direct_pass = spy
    try:
        img = fn(scene, cfg, n_passes=GRID_PASSES)          # warm-up
        torch.cuda.synchronize()
        MK.launches = MK.direct_launches = MK.stream_launches = 0
        grids.clear()
        img = fn(scene, cfg, n_passes=GRID_PASSES)
        torch.cuda.synchronize()
        counts = (MK.direct_launches, MK.launches, MK.stream_launches)
        _check(counts == (1, 0, 0) and grids == [True],
               f"config 3 via XML: launches (direct, path, streamed) "
               f"{counts}, with the grids {grids}, for one call")
        ms = _call_ms(lambda: fn(scene, cfg, n_passes=GRID_PASSES),
                      GRID_REPS)
    finally:
        MK.direct_pass = launch
    _check(bool(torch.isfinite(img).all()) and img.max().item() > 0,
           "config 3 via XML: image not finite or black")
    n_rays = cfg.total_rays * (1 + scene.lights.count) * GRID_PASSES
    print(f"phase 26 (2) config 3 via XML (cornell_teapot stand-in: "
          f"{scene.triangles.count} walls, meshes "
          f"{[m.tris.count for m in scene.meshes]}, kernel grids {n_grid}) "
          f"{MAIN_W}x{MAIN_H} direct, {GRID_PASSES} passes per call, B = "
          f"{cfg.mega_block} on [{smi}]: one grid-mode launch per call; "
          f"{ms / GRID_PASSES:.6g} ms/pass ({ms:.6g} ms per call, "
          f"{GRID_REPS} calls after 1 warm-up), {n_rays / (ms / 1e3):.6g} "
          "rays/s")


def _cli_xml(dev, smi: str, path: str, root: str) -> None:
    """Phase 26 (3): the CLI on the XML scene and its orbit."""
    import contextlib
    import io

    import numpy as np
    from raytracing_tpu_torch import cli
    from raytracing_tpu_torch.io.png import read_png

    out = str(Path(root) / "cli.png")
    argv = ["--scene", path, "--grid", "3", "--block", str(GRID_BLOCK),
            "--width", str(MAIN_W), "--height", str(MAIN_H), "--passes",
            str(GRID_PASSES), "--bounces", str(BOUNCES), "-o", out]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = cli.main(argv)
    sec = time.perf_counter() - t0
    _check(rc == 0, f"the CLI exited {rc}")
    img = read_png(out)
    _check(img.shape == (MAIN_H, MAIN_W, 3) and img.max() > 0,
           f"the CLI's PNG reads back as {img.shape}")
    orbit = str(Path(root) / "orbit.png")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--scene", path, "--width", str(SMALL_W), "--height",
                       str(SMALL_H), "--passes", "4", "--orbit", "2", "-o",
                       orbit])
    frames = [read_png(str(Path(root) / f"orbit_frame{f:03d}.png"))
              for f in range(2)]
    _check(rc == 0 and frames[0].shape == (SMALL_H, SMALL_W, 3)
           and not np.array_equal(frames[0], frames[1]),
           "--orbit 2: two frames that differ")
    stats = [x.strip() for x in text.getvalue().splitlines()
             if ":" in x and not x.startswith("\r")][:7]
    print(f"phase 26 (3) the CLI on the XML at {MAIN_W}x{MAIN_H} b{BOUNCES} "
          f"--grid 3, {GRID_PASSES} passes: exit 0 in {sec:.3f} s on [{smi}] "
          f"(process already warm), PNG {img.shape}; printed {stats}; "
          f"--orbit 2 at {SMALL_W}x{SMALL_H}: two frames that differ")


def _viewer(dev, smi: str, path: str) -> None:
    """Phase 26 (4): the viewer's session, its HTTP surface and loop."""
    import tempfile
    import threading
    import urllib.request

    import torch
    from raytracing_tpu_torch import viewer
    from raytracing_tpu_torch.io.png import read_png
    from raytracing_tpu_torch.ops import megakernel as MK

    s = viewer.RenderSession(MAIN_W, MAIN_H, bounces=BOUNCES,
                             chunk_passes=4, scenes={
                                 "cornell": None, "spheres": None,
                                 "teapot": path}, device=dev)
    s.step(n_passes=4)                                   # warm-up
    torch.cuda.synchronize()
    passes0 = s.status()["passes"]
    MK.launches = MK.direct_launches = 0
    t0 = time.perf_counter()
    for _ in range(2):
        s.step(n_passes=4)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 2
    st = s.status()
    _check(MK.launches == 2 and MK.direct_launches == 0
           and st["passes"] == passes0 + 8,
           f"viewer: {MK.launches} launches, passes {passes0} -> "
           f"{st['passes']} for two steps")
    _check(st["engine"] == "megakernel" and st["device"] == "cuda:0",
           f"viewer status {st}")
    srv = viewer.make_server(s, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(p):
        return urllib.request.urlopen(base + p, timeout=60).read()
    try:
        _check(b"<canvas" in get("/"), "viewer: / has no canvas")
        _check(json.loads(get("/scenes")) == ["cornell", "spheres", "teapot"],
               "viewer: /scenes")
        devs = json.loads(get("/devices"))
        _check(torch.cuda.get_device_name(0) in devs[0], f"/devices {devs}")
        _check(json.loads(get("/status"))["engine"] == "megakernel",
               "viewer: /status")
        png = get("/frame.png")
        with tempfile.NamedTemporaryFile(suffix=".png") as f:
            f.write(png)
            f.flush()
            shape = read_png(f.name).shape
        _check(png[:8] == b"\x89PNG\r\n\x1a\n"
               and shape == (MAIN_H, MAIN_W, 3), f"/frame.png {shape}")
        t0 = time.perf_counter()
        frame0 = s.status()["frame"]
        s.start(scene="teapot", renderer="path", spp=1, focal=None,
                lens=None, device=0, orbit=False)
        # the start resets the passes; two of the loop's frames hold 8
        while not (s.status()["frame"] >= frame0 + 2
                   and s.status()["passes"] >= 8):
            _check(time.perf_counter() - t0 < VIEWER_DEADLINE
                   and s._thread.is_alive(),
                   "viewer: the loop on the XML scene made no passes")
            time.sleep(0.01)
        loop_s = time.perf_counter() - t0
        st = s.status()
        s.stop()
    finally:
        s.stop()
        srv.shutdown()
        srv.server_close()
    print(f"phase 26 (4) viewer {MAIN_W}x{MAIN_H} b{BOUNCES} on [{smi}]: "
          f"two 4-pass steps on cornell, one launch each, "
          f"{step_ms:.6g} ms per step (host clock); /, /scenes, /devices "
          f"{devs}, /status, /frame.png {shape}; the loop on the XML scene "
          f"made 8 passes in {loop_s:.3f} s (scene load and grids included), "
          f"{st['msegs_per_s']:.6g} M segments/s, engine {st['engine']}")


def _house(dev, smi: str, root: str) -> None:
    """Phase 26 (5): big_mesh_scene on the house stand-in, streamed."""
    import os

    import torch
    from raytracing_tpu_torch import RenderConfig
    from raytracing_tpu_torch.models.scenes import big_mesh_scene
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.render import pathtracer as pt
    from torch_xml_scenes import house_reference_dir

    before = os.environ.get("RT_REFERENCE_DIR")
    os.environ["RT_REFERENCE_DIR"] = house_reference_dir(
        str(Path(root) / "reference"))
    try:
        scene = big_mesh_scene(cols=MAIN_W, rows=MAIN_H, device=dev)
    finally:
        if before is None:
            del os.environ["RT_REFERENCE_DIR"]
        else:
            os.environ["RT_REFERENCE_DIR"] = before
    cfg = RenderConfig(width=MAIN_W, height=MAIN_H, bounces=BOUNCES,
                       use_megakernel=True, mega_block=GRID_BLOCK)
    state = pt.render_passes(scene, pt.init_state(cfg, dev), cfg,
                             GRID_PASSES)                       # warm-up
    torch.cuda.synchronize()
    MK.launches = MK.stream_launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    state = pt.render_passes(scene, state, cfg, GRID_PASSES)
    end.record()
    torch.cuda.synchronize()
    _check(MK.launches == 1 == MK.stream_launches,
           f"big_mesh_scene: {MK.launches} launches, {MK.stream_launches} "
           "streamed, for one call")
    _check(bool(torch.isfinite(state["acc"]).all())
           and state["acc"].max().item() > 0, "big_mesh_scene: acc")
    print(f"phase 26 (5) big_mesh_scene (house_of_parliament.json stand-in, "
          f"{scene.triangles.count} triangles, streamed) {MAIN_W}x{MAIN_H} "
          f"b{BOUNCES}, B = {GRID_BLOCK}, {GRID_PASSES} passes per call on "
          f"[{smi}]: one streamed launch per call, "
          f"{start.elapsed_time(end) / GRID_PASSES:.6g} ms/pass")


def surface(dev, smi: str) -> None:
    """Phase 26: XML scenes, mesh JSON, the CLI, the viewer and
    big_mesh_scene on stand-ins written to a temporary directory."""
    import tempfile

    sys.path.insert(0, str(HERE / "tests"))
    from torch_xml_scenes import cornell_teapot_xml

    t0 = time.perf_counter()
    parts = []
    with tempfile.TemporaryDirectory() as root:
        path = cornell_teapot_xml(str(Path(root) / "teapot"))
        for run in (lambda: _xml_torus(dev, str(Path(root) / "torus")),
                    lambda: _config3_xml(dev, smi, path),
                    lambda: _cli_xml(dev, smi, path, root),
                    lambda: _viewer(dev, smi, path),
                    lambda: _house(dev, smi, root)):
            t1 = time.perf_counter()
            run()
            parts.append(round(time.perf_counter() - t1, 1))
    print(f"phase 26: {time.perf_counter() - t0:.1f} s (parts 1-5 {parts} "
          "s)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(HERE))
    import raytracing_tpu_torch
    pkg = Path(raytracing_tpu_torch.__file__).resolve().parent
    _check(pkg.parent == HERE,
           f"raytracing_tpu_torch found at {pkg}, not beside this script")
    dev = torch.device("cuda", 0)

    _elapsed(1)
    # phase 1: the card
    smi = _smi("name,power.limit")
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)

    _elapsed(2)
    # phase 2: build the kernels
    from raytracing_tpu_torch.ops import _build
    from raytracing_tpu_torch.ops import hit_kernels as HK
    from raytracing_tpu_torch.ops import megakernel as MK
    from raytracing_tpu_torch.ops import megakernel_grad as MKG
    from raytracing_tpu_torch.ops import megakernel_soft as MKS
    t0 = time.perf_counter()
    # kernel 1's brute and grid-mode halves, each also as built without
    # contracted multiply-adds (phases 11 and 17)
    libs = [("megakernel", MK._SIGNATURES, ()),
            ("megakernel", MK._SIGNATURES, EXACT_FLAGS),
            ("megakernel", MK._SIGNATURES, EXACT_FLAGS + MK.GRID_FLAGS),
            ("megakernel", MK._SIGNATURES, MK.GRID_FLAGS),
            ("megakernel_grad", MKG._SIGNATURES, MKG.ADJ_FLAGS),
            ("megakernel_champ", MKG._CHAMP_SIGNATURES, MKG.ADJ_FLAGS),
            ("hit_kernels", HK._SIGNATURES, ()),
            ("sphere_tree", MK._TREE_SIGNATURES, ())]
    # kernel 2s: one build per mode (path, the roulette, direct)
    libs += [("megakernel_soft", MKS._SIGNATURES, flags)
             for flags in MKS.SOFT_BUILDS]
    _build.load_all(libs)
    print(f"phase 2 build ({len(libs)} nvcc at once): "
          f"{time.perf_counter() - t0:.2f} s ({_build.BUILD_DIR})")
    _print_builds(_build, libs)

    _elapsed(3)
    # phase 3: kernel vs plain version
    compare_with_plain(dev, 256, 192)
    max_err = compare_with_plain(dev, MAIN_W, MAIN_H)
    _elapsed(4)
    # phase 4: in-kernel PRNG vs u-planes
    prng_equals_u_planes(dev, 256, 192)
    _elapsed(5)
    # phase 5: the main path
    k = main_path(dev, smi)
    _elapsed(6)
    # phase 6: kernel 2 vs its plain version
    g_small = [kernel2_vs_plain(dev, name, SMALL_W, SMALL_H, MKG.DIFF_ALL,
                                max_gate=True)
               for name in ("cornell", f"sphere_field({UNROLL_SPHERES})")]
    g_main = kernel2_vs_plain(dev, "cornell", MAIN_W, MAIN_H, TRAIN_WRT,
                              max_gate=False)
    g_all = kernel2_vs_plain(dev, "cornell", MAIN_W, MAIN_H, MKG.DIFF_ALL,
                             max_gate=False)
    _elapsed(7)
    # phase 7: the training main path
    t = train_path(dev, smi)
    _elapsed(8)
    # phase 8: kernels 4 and 5 vs their plain versions
    h4, h4b, h5t, h5b = hit_kernels_vs_plain(dev)
    _elapsed(9)
    # phase 9: the stage pipeline's main path
    s9 = stage_main_path(dev, smi)
    _elapsed(10)
    # phase 10: the stage route against kernel 1
    s10 = stage_vs_megakernel(dev)
    _elapsed(11)
    # phase 11: the cell route's kernels against their plain versions
    r11 = record_vs_plain(dev, smi)
    c_main = kernel3_vs_plain(dev, f"sphere_field({N_SPHERES})", MAIN_W,
                              MAIN_H, TRAIN_WRT, max_gate=False)
    c_small = [kernel3_vs_plain(dev, name, SMALL_W, SMALL_H, MKG.DIFF_ALL,
                                max_gate=True)
               for name in (f"sphere_field({N_SPHERES})", "cornell")]
    kernel3_vs_kernel2(dev, SMALL_W, SMALL_H, MKG.DIFF_ALL, max_gate=True)
    kernel3_vs_kernel2(dev, MAIN_W, MAIN_H, MKG.DIFF_ALL, max_gate=False)
    _elapsed(12)
    # phase 12: the cell route's training main path
    c12 = train_cell_path(dev, smi)
    _elapsed(13)
    # phase 13: Russian roulette in kernels 1-3 against their plain versions
    # (sphere_field(N_SPHERES) runs the 8-row loop, <8, true>)
    r13 = [rr_vs_plain(dev, name, w, h) for name, w, h in (
        ("cornell", SMALL_W, SMALL_H), ("cornell", MAIN_W, MAIN_H),
        (f"sphere_field({SMALL_SPHERES})", SMALL_W, SMALL_H),
        (f"sphere_field({N_SPHERES})", SMALL_W, SMALL_H),
        (f"sphere_field({N_SPHERES})", MAIN_W, MAIN_H))]
    g13 = [kernel2_vs_plain(dev, "cornell", SMALL_W, SMALL_H, MKG.DIFF_ALL,
                            max_gate=True, rr=True),
           kernel2_vs_plain(dev, "cornell", MAIN_W, MAIN_H, TRAIN_WRT,
                            max_gate=False, rr=True)]
    c13_main = kernel3_vs_plain(dev, f"sphere_field({N_SPHERES})", MAIN_W,
                                MAIN_H, TRAIN_WRT, max_gate=False, rr=True)
    kernel3_vs_plain(dev, f"sphere_field({SMALL_SPHERES})", SMALL_W, SMALL_H,
                     MKG.DIFF_ALL, max_gate=True, rr=True)
    kernel3_vs_kernel2(dev, SMALL_W, SMALL_H, MKG.DIFF_ALL, max_gate=True,
                       rr=True)
    _elapsed(14)
    # phase 14: config 5 as specified (1024 spp with the roulette)
    f14 = full_render(dev, smi)
    t14, c14 = full_train(dev, smi)
    _elapsed(15)
    # phase 15: direct mode and fake shade
    d15 = direct_vs_plain(dev)
    m15 = direct_main_path(dev, smi)
    _elapsed(16)
    # phase 16: the grids of shapes 1 and 3
    grid_build(dev)
    _elapsed(17)
    # phase 17: kernel 1's grid mode vs its plain versions at 256x192
    g17 = {(shape, mode): grid_vs_plain(dev, shape, mode)
           for shape in ("torus", "spheres")
           for mode in ("direct", "path", "rr")}
    _elapsed(18)
    # phase 18: shapes 1-3 at 1024^2 (config 3's shape, BENCH_GRID=1, the
    # sphere grid), forward and the cell route's train step
    d18 = grid_direct_main(dev, smi, g17[("torus", "direct")]["work"])
    p18t, k18t = grid_path_main(dev, smi, "torus",
                                g17[("torus", "path")]["work"])
    p18s, k18s = grid_path_main(dev, smi, "spheres",
                                g17[("spheres", "path")]["work"])
    _elapsed(19)
    # phase 19: kernel 3 on the grid record
    # (at 1024^2 phase 18 holds kernel 3 to its plain version on both
    # train steps' records)
    c19 = {shape: kernel3_on_record(dev, shape, SMALL_W, SMALL_H,
                                    MKG.DIFF_ALL, max_gate=True)
           for shape in ("torus", "spheres")}
    g17_err = {shape: max(v["max_abs_err"] for (s_, _), v in g17.items()
                          if s_ == shape) for shape in ("torus", "spheres")}
    _elapsed(20)
    # phase 20: edge-aware gradients (kernel 2s)
    s20 = [kernel2s_vs_plain(dev, EDGE_W, EDGE_H, wrt, rr)
           for rr in (False, True) for wrt in (MKG.DIFF_ALL, TRAIN_WRT)]
    edge_grid_vs_brute(dev, EDGE_W, EDGE_H)
    t20 = edge_train(dev, smi)
    _elapsed(21)
    # phase 21: streamed Morton chunks (no grid): kernel 1 vs its plain
    # version, the plain streamed version vs the plain brute one, kernel 3
    # on the streamed record, the timings at 1024^2
    s21 = {(shape, mode): stream_vs_plain(dev, shape, mode)
           for shape, mode in (("torus", "path"), ("torus", "rr"),
                               ("torus", "direct"), ("spheres", "path"))}
    stream_plain_vs_brute(dev)
    c21 = kernel3_on_record(dev, "torus", SMALL_W, SMALL_H, MESH_WRT,
                            max_gate=True, stream=True)
    d21 = stream_direct_main(dev, smi, s21[("torus", "direct")]["work"])
    m21 = stream_main(dev, smi, {k: v["work"] for k, v in s21.items()},
                      p18s["ms"])
    stream_house(dev, smi)
    _elapsed(22)
    # phase 22: kernels 2 and 2s past 64 objects per type
    t22 = time.perf_counter()
    a22 = {shape: large_vs_plain(dev, shape, False, False, wrt)
           for shape, wrt in (("spheres", TRAIN_WRT),
                              ("spheres1024", TRAIN_WRT),
                              ("torus", MESH_WRT), ("torus-grid", MESH_WRT))}
    # the streamed torus against the brute plain version (no Morton build)
    a22["brute"] = large_vs_plain(dev, "torus", False, False, MESH_WRT,
                                  BRUTE_W, BRUTE_H, BRUTE_BOUNCES, brute=True)
    # kernel 2s past 64 in path mode, with the roulette and in direct mode:
    # the torus (its triangles in wrt), sphere_field(SMALL_SPHERES) (path
    # and roulette, as before the sparse kernel) and sphere_field(N_SPHERES),
    # the film whose rays all miss (every span mask empty), the cluster
    # whose warps' live rows fill every span and, at DIFF_TABLE_MAX, the
    # spheres and the triangle soup (one bounce, the roulette from depth 0)
    s22 = {(shape, mode): large_vs_plain(
               dev, shape, True, mode == "rr", wrt, direct=mode == "direct")
           for shape, wrt, modes in (("torus", MESH_WRT, SOFT_MODES),
                                     ("spheres", TRAIN_WRT, ("path", "rr")),
                                     ("spheres1024", TRAIN_WRT, SOFT_MODES),
                                     ("misses", MKG.DIFF_ALL, SOFT_MODES),
                                     ("cluster", MKG.DIFF_ALL, SOFT_MODES))
           for mode in modes}
    edge_grid_large(dev, LARGE_W, LARGE_H)
    c22 = {(shape, False, "path"): large_vs_plain(
               dev, shape, False, False, MKG.DIFF_ALL, CAP_W, CAP_H, 1)
           for shape in ("cap-spheres", "cap-triangles")}
    c22.update({(shape, True, mode): large_vs_plain(
                    dev, shape, True, mode == "rr", MKG.DIFF_ALL, CAP_W,
                    CAP_H, 1, direct=mode == "direct", rr_start=0)
                for shape in ("cap-spheres", "cap-triangles")
                for mode in SOFT_MODES})
    l22 = large_train(dev, smi, s21[("torus", "path")]["work"])
    excused = {f"{shape} {mode}": x["excused"]
               for (shape, mode), x in s22.items()}
    excused.update({f"{shape} {mode}": v["excused"]
                    for (shape, soft, mode), v in c22.items() if soft})
    print(f"phase 22 kernel 2s: {sum(excused.values())} rays excused in "
          f"all ({excused})")
    print(f"phase 22: {time.perf_counter() - t22:.1f} s")
    _elapsed(23)
    # phase 23: the differentiable direct pass through kernels 1
    # (recording), 2, 3 and 2s
    t23 = time.perf_counter()
    # sphere_field(N_SPHERES) runs the instances the 1024^2 steps on it
    # run (the 8-row sphere loop from kWideSpheres = 512 spheres): pieces
    # a-c; kernel 2s past 64 is held on sphere_field(SMALL_SPHERES)
    v23 = [direct_diff_vs_plain(dev, "cornell", MKG.DIFF_ALL),
           direct_diff_vs_plain(dev, "cornell", MKG.DIFF_ALL, 4, 0.25),
           direct_diff_vs_plain(dev, "spheres", TRAIN_WRT),
           direct_diff_vs_plain(dev, "torus", MESH_WRT),
           direct_diff_vs_plain(dev, "spheres1024", TRAIN_WRT, soft=False)]
    # past MK.SPH_BRUTE_MAX["direct"] spheres: the tree's build and walk
    # against MK.sphere_tree and the brute instances, card against card
    direct_walk_vs_brute(dev)
    d23 = {k: v for route in ("kernel2", "cell", "soft")
           for k, v in direct_train(dev, smi, "cornell", route).items()}
    b23 = {k: v for route in ("kernel2", "cell")
           for k, v in direct_train(dev, smi, "spheres1024", route).items()}
    print(f"phase 23: {time.perf_counter() - t23:.1f} s")
    _elapsed(24)
    # phase 24: the stage pipeline's main path on the torus scene (kernel
    # 5's tree instance)
    s24 = stage_torus(dev, smi)
    _elapsed(25)
    # phase 25: the sharded paths (parallel/), two ranks on one card or one
    # rank per card
    sharding(dev, smi)
    _elapsed(26)
    # phase 26: the surface (XML scenes, mesh JSON, the CLI, the viewer,
    # big_mesh_scene)
    surface(dev, smi)
    print(f"[{time.perf_counter() - START:.1f} s elapsed in all]")
    hard22 = max([x["max_abs_err"] for x in a22.values()]
                 + [v["max_abs_err"] for (_, soft, _), v in c22.items()
                    if not soft])

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "pathtrace_pass (megakernel)", "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel.py:284",
        "launches": k["launches"], "max_abs_err": max_err,
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}, {
        "name": "pathtrace_pass (megakernel, path mode walking a sphere "
                "tree built by its call: the cell step's recording, "
                f"sphere_field({N_SPHERES}))", "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel.py:873",
        "launches": c12["walk_launches"],
        "tree_builds": c12["tree_builds"],
        "max_abs_err": r11["max_abs_err"], "ms": r11["ms"],
        "brute_ms": r11["brute_ms"], "build_ms": r11["build_ms"],
        "plain_ms": r11["plain_ms"], "bound_ms": r11["bound_ms"],
        "bound_by": r11["bound_by"],
        "walk_bound_ms": r11["walk_bound_ms"],
        "brute_bound_ms": r11["brute_bound_ms"], "library_ms": None,
        "shape": f"{MAIN_W}x{MAIN_H} b{BOUNCES}, one recording pass, the "
                 "build included"}, {
        "name": "pathtrace_pass_bwd (adjoint megakernel)", "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_grad.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel_grad.py:2152",
        "launches": t["launches"],
        "max_abs_err": max(g["max_abs_err"]
                           for g in g_small + [g_main, g_all]),
        "ms": t["ms"], "plain_ms": g_main["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None}, {
        "name": "sphere_search (closest hit over spheres, box tree walk: "
                f"sphere_field({N_SPHERES}))", "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/hit_kernels.cu",
        "replaces": "raytracing_tpu/ops/pallas/hit_kernels.py:58",
        "launches": s9["launches"], **h4, "library_ms": None}, {
        "name": "sphere_search (closest hit over spheres, brute loop: "
                "cornell's 2)", "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/hit_kernels.cu",
        "replaces": "raytracing_tpu/ops/pallas/hit_kernels.py:58",
        "launches": s10["k4_launches"], **h4b, "library_ms": None}, {
        "name": "triangle_search (closest hit over triangles, box tree "
                f"walk: a {SOUP_TRIANGLES}-triangle soup; launches: the "
                "torus scene's stage pass)",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/hit_kernels.cu",
        "replaces": "raytracing_tpu/ops/pallas/hit_kernels.py:138",
        "launches": s24["launches"], **h5t,
        "stage_search_ms": s24["search_ms"], "library_ms": None}, {
        "name": "triangle_search (closest hit over triangles, brute loop: "
                "cornell's 10)",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/hit_kernels.cu",
        "replaces": "raytracing_tpu/ops/pallas/hit_kernels.py:138",
        "launches": s10["launches"], **h5b, "library_ms": None}, {
        "name": "triangle_tree_build (the box tree over a triangle table "
                "that kernel 5 walks, one launch per stage pass: cornell + "
                "torus)",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/sphere_tree.cu",
        "replaces": None, **s24["build"], "library_ms": None}, {
        "name": "pathtrace_pass_bwd_champ (champion adjoint)",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_champ.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel_grad.py:1173",
        "launches": c12["launches"],
        "max_abs_err": max([c12["max_abs_err"], c_main["max_abs_err"]]
                           + [c["max_abs_err"] for c in c_small]),
        "ms": c12["ms"], "plain_ms": c12["plain_ms"],
        "bound_ms": c12["bound_ms"], "bound_by": c12["bound_by"],
        "library_ms": None, "order_launches": c12["order_launches"],
        "order_ms": c12["order_ms"], "order_clock": c12["order_clock"]}, {
        "name": "pathtrace_pass (megakernel, Russian roulette)",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel.py:1486",
        "launches": f14["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in r13), "ms": f14["ms"],
        "plain_ms": r13[1]["plain_ms"], "bound_ms": f14["bound_ms"],
        "bound_by": f14["bound_by"], "library_ms": None}, {
        "name": "direct_pass (megakernel, direct mode)", "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel.py:1362",
        "launches": m15["launches"], "max_abs_err": d15["max_abs_err"],
        "ms": m15["ms"], "plain_ms": d15["plain_ms"],
        "bound_ms": m15["bound_ms"], "bound_by": m15["bound_by"],
        "library_ms": None}, {
        "name": "pathtrace_pass_bwd (adjoint megakernel, Russian roulette)",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_grad.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel_grad.py:909",
        "launches": t14["launches"],
        "max_abs_err": max(g["max_abs_err"] for g in g13), "ms": t14["ms"],
        "plain_ms": g13[1]["plain_ms"], "bound_ms": t14["bound_ms"],
        "bound_by": t14["bound_by"], "library_ms": None}, {
        "name": "pathtrace_pass_bwd_champ (champion adjoint, Russian "
                "roulette)",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_champ.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel_grad.py:1101",
        "launches": c14["launches"], "max_abs_err": c13_main["max_abs_err"],
        "ms": c14["ms"], "plain_ms": c13_main["plain_ms"],
        "bound_ms": c14["bound_ms"], "bound_by": c14["bound_by"],
        "library_ms": None}, {
        "name": "direct_pass (megakernel, grid mode: config 3's shape)",
        "route": "cuda", "source": "raytracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel.py:1146",
        "launches": d18["launches"],
        "max_abs_err": max(d18["max_abs_err"], g17_err["torus"]),
        "ms": d18["ms"], "plain_ms": d18["plain_ms"],
        "bound_ms": d18["bound_ms"], "bound_by": d18["bound_by"],
        "bound_from": d18["bound_from"],
        "march_bound_ms": d18["march_bound_ms"],
        "walk_bound_ms": d18["walk_bound_ms"], "library_ms": None}, {
        "name": "pathtrace_pass (megakernel, grid mode: mesh grid)",
        "route": "cuda", "source": "raytracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel.py:932",
        "launches": p18t["launches"],
        "max_abs_err": max(p18t["max_abs_err"], g17_err["torus"]),
        "ms": p18t["ms"], "plain_ms": p18t["plain_ms"],
        "bound_ms": p18t["bound_ms"], "bound_by": p18t["bound_by"],
        "bound_from": p18t["bound_from"],
        "march_bound_ms": p18t["march_bound_ms"],
        "walk_bound_ms": p18t["walk_bound_ms"], "library_ms": None}, {
        "name": "pathtrace_pass (megakernel, grid mode: sphere grid)",
        "route": "cuda", "source": "raytracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel.py:932",
        "launches": p18s["launches"],
        "max_abs_err": max(p18s["max_abs_err"], g17_err["spheres"]),
        "ms": p18s["ms"], "plain_ms": p18s["plain_ms"],
        "bound_ms": p18s["bound_ms"], "bound_by": p18s["bound_by"],
        "bound_from": p18s["bound_from"],
        "march_bound_ms": p18s["march_bound_ms"],
        "walk_bound_ms": p18s["walk_bound_ms"], "library_ms": None}, {
        "name": "pathtrace_pass_bwd_champ (champion adjoint, grid record: "
                "sphere grid)",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_champ.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel_grad.py:1173",
        "launches": k18s["launches"],
        "max_abs_err": max(k18s["max_abs_err"],
                           c19["spheres"]["max_abs_err"]),
        "ms": k18s["ms"], "plain_ms": k18s["plain_ms"],
        "bound_ms": k18s["bound_ms"], "bound_by": k18s["bound_by"],
        "library_ms": None}, {
        "name": "pathtrace_pass_bwd_champ (champion adjoint, grid record: "
                "mesh grid, with \"tri\")",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_champ.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel_grad.py:1173",
        "launches": k18t["launches"],
        "max_abs_err": max(k18t["max_abs_err"], c19["torus"]["max_abs_err"]),
        "ms": k18t["ms"], "plain_ms": k18t["plain_ms"],
        "bound_ms": k18t["bound_ms"], "bound_by": k18t["bound_by"],
        "library_ms": None}, {
        "name": "pathtrace_pass_bwd_soft (edge-aware adjoint, kernel 2s)",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_soft.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel_grad.py:1516",
        "launches": t20["launches"],
        "max_abs_err": max([t20["max_abs_err"]]
                           + [x["max_abs_err"] for x in s20]),
        "ms": t20["ms"], "plain_ms": t20["plain_ms"],
        "bound_ms": t20["bound_ms"], "bound_by": t20["bound_by"],
        "bound_sfu_ms": t20["bound_sfu_ms"], **t20["stats"],
        "library_ms": None}] + [{
        "name": name, "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel.cu",
        "replaces": f"raytracing_tpu/ops/pallas/megakernel.py:{line}",
        "launches": e["launches"],
        "max_abs_err": max([e["max_abs_err"]]
                           + [s21[k]["max_abs_err"] for k in keys]),
        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "bound_from": e["bound_from"],
        "morton_bound_ms": e["morton_bound_ms"],
        "tree_bound_ms": e["tree_bound_ms"], "library_ms": None}
        for name, line, e, keys in (
            ("pathtrace_pass (megakernel, streamed triangles: cornell + "
             "torus)", 903, m21["torus"], [("torus", "path")]),
            ("pathtrace_pass (megakernel, streamed spheres: "
             f"sphere_field({STREAM_SPHERES}))", 874, m21["spheres"],
             [("spheres", "path")]),
            ("pathtrace_pass (megakernel, streamed triangles, Russian "
             "roulette)", 1486, m21["torus rr"], [("torus", "rr")]),
            ("direct_pass (megakernel, direct mode, streamed triangles)",
             1248, d21, [("torus", "direct")]))] + [{
        "name": "pathtrace_pass_bwd_champ (champion adjoint, streamed "
                "record, with \"tri\")",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_champ.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel_grad.py:1173",
        "launches": m21["k3"]["launches"],
        "max_abs_err": max(m21["k3"]["max_abs_err"], c21["max_abs_err"]),
        "ms": m21["k3"]["ms"], "plain_ms": m21["k3"]["plain_ms"],
        "bound_ms": m21["k3"]["bound_ms"], "bound_by": m21["k3"]["bound_by"],
        "library_ms": None}] + [{
        "name": name, "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_champ.cu",
        "record_source": "raytracing_tpu_torch/csrc/megakernel.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel_grad.py:223",
        "launches": e["launches"], "max_abs_err": hard22, "ms": e["ms"],
        "record_ms": e["record_ms"], "sweep_ms": e["sweep_ms"],
        "plain_ms": plain["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": None,
        "shape": e["shape"], "plain_shape": plain["shape"]}
        for name, e, plain in (
            ("pathtrace_pass_bwd (adjoint past 64 objects, an uncontracted "
             "record by kernel 1 and kernel 3's sweep: "
             f"sphere_field({N_SPHERES}))",
             l22["spheres1024"], a22["spheres1024"]),
            ("pathtrace_pass_bwd (adjoint past 64 objects, an uncontracted "
             "record by kernel 1 and kernel 3's sweep: streamed cornell + "
             "torus)", l22["torus"], a22["torus"]))] + [{
        "name": "pathtrace_pass_bwd_soft (kernel 2s past 64 objects, "
                "two-level composite: cornell + torus)",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/megakernel_soft.cu",
        "replaces": "raytracing_tpu/ops/pallas/megakernel_grad.py:1883",
        "launches": l22["edge"]["launches"],
        "max_abs_err": max([x["max_abs_err"] for x in s22.values()]
                           + [v["max_abs_err"] for (_, soft, _), v
                              in c22.items() if soft]),
        "ms": l22["edge"]["ms"],
        "plain_ms": s22[("torus", "path")]["plain_ms"],
        "bound_ms": l22["edge"]["bound_ms"],
        "bound_by": l22["edge"]["bound_by"], "library_ms": None,
        "bound_sfu_ms": l22["edge"]["bound_sfu_ms"],
        "dense_bound_ms": l22["edge"]["dense_bound_ms"],
        **l22["edge"]["stats"], "shape": l22["edge"]["shape"],
        "plain_shape": s22[("torus", "path")]["shape"]}] + [{
        "name": name, "route": "cuda",
        "source": f"raytracing_tpu_torch/csrc/{src}",
        "replaces": f"raytracing_tpu/ops/pallas/{rep}",
        "launches": e[k]["launches"],
        "max_abs_err": (max(v["max_abs_err"][k] for v in v23[:4])
                        if e is d23 else v23[i]["max_abs_err"][k]),
        "ms": e[k]["ms"], "plain_ms": v23[i]["plain_ms"][k],
        "bound_ms": e[k]["bound_ms"], "bound_by": e[k]["bound_by"],
        **{x: e[k][x] for x in ("build_ms", "walk_bound_ms",
                                "brute_bound_ms") if x in e[k]},
        **({"bound_sfu_ms": e[k]["bound_sfu_ms"], **e[k]["stats"]}
           if k == "d" else {}),
        "library_ms": None, "shape": f"{shape} {MAIN_W}x{MAIN_H} spp 1",
        "plain_shape": f"{plain} "
                       f"{v23[i]['shape']['d' if k == 'd' else 'abc']} spp 1"}
        for k, e, i, shape, plain, name, src, rep in (
            ("a", d23, 0, "cornell", "cornell", "direct_pass (megakernel, "
             "direct mode recording)", "megakernel.cu",
             "megakernel.py:1393"),
            ("b", d23, 0, "cornell", "cornell", "pathtrace_pass_bwd (adjoint "
             "megakernel, direct mode)", "megakernel_grad.cu",
             "megakernel_grad.py:795"),
            ("c", d23, 0, "cornell", "cornell", "pathtrace_pass_bwd_champ "
             "(champion adjoint, direct mode)", "megakernel_champ.cu",
             "megakernel_grad.py:1031"),
            ("d", d23, 0, "cornell", "cornell", "pathtrace_pass_bwd_soft "
             "(kernel 2s, direct mode)", "megakernel_soft.cu",
             "megakernel_grad.py:2039"),
            ("a", b23, 4, f"sphere_field({N_SPHERES})",
             f"sphere_field({N_SPHERES})", "direct_pass (megakernel, direct "
             "mode recording, walking a sphere tree built by its call)",
             "megakernel.cu", "megakernel.py:1393"),
            ("b", b23, 4, f"sphere_field({N_SPHERES})",
             f"sphere_field({N_SPHERES})", "pathtrace_pass_bwd (adjoint, "
             "direct mode past 64 objects: an uncontracted record by "
             "kernel 1 walking the sphere tree, and kernel 3's sweep)",
             "megakernel_champ.cu", "megakernel_grad.py:795"),
            ("c", b23, 4, f"sphere_field({N_SPHERES})",
             f"sphere_field({N_SPHERES})", "pathtrace_pass_bwd_champ "
             "(champion adjoint, direct mode past 64 objects)",
             "megakernel_champ.cu", "megakernel_grad.py:1031"))] + [{
        "name": "sphere_tree_build (the box tree over a sphere table that "
                "kernel 1's direct mode walks, one launch per call: "
                f"sphere_field({N_SPHERES}))",
        "route": "cuda",
        "source": "raytracing_tpu_torch/csrc/sphere_tree.cu",
        "replaces": None,
        "launches": b23["build"]["launches"],
        "max_abs_err": b23["build"]["max_abs_err"],
        "ms": b23["build"]["ms"], "wrapper_ms": b23["build"]["wrapper_ms"],
        "plain_ms": b23["build"]["plain_ms"],
        "bound_ms": b23["build"]["bound_ms"],
        "bound_by": b23["build"]["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

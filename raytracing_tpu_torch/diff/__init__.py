"""Differentiable rendering: the finite-difference oracle and edge-aware
gradients (``raytracing_tpu.diff``).

Three tiers of gradients, from production to toy:

1. Production, interior-exact: the differentiable pass
   (``ops.megakernel_grad.pathtrace_pass_diff``, which
   ``render.mega.render_pass_mega`` takes whenever a table requires grad
   and ``render.mega.supported_diff(scene, cfg)`` holds). Cotangents follow
   the hard champion: exact wherever visibility is locally constant
   (almost everywhere), silent at silhouettes. Kernel 2
   (``csrc/megakernel_grad.cu``) up to 64 objects per type, the champion
   route (kernel 1 recording, kernel 3 ``csrc/megakernel_champ.cu``) past
   that and in grid mode.

2. Production, edge-aware: ``cfg.mega_edge_bandwidth > 0``. The forward
   stays kernel 1's hard pass; the backward is kernel 2s
   (``csrc/megakernel_soft.cu``), the adjoint of the soft reformulation of
   the pass (``ops.megakernel_soft``: sigmoid silhouette coverage, an
   alpha-composited soft depth order, soft shadow transmittance, a soft
   emitter race), so silhouette and shadow-boundary gradients are real.
   Up to ``DIFF_TABLE_MAX`` (4096) objects per type, grid mode included
   (the soft backward sweeps the scene's own rows; past 64 objects of a
   type it composites in JAX's two levels, the triangles in Morton
   order).

3. Toy references (this package): ``soft.render_fake_shade_soft``,
   ``soft.render_direct_soft`` and ``soft.render_pathtrace_soft`` --
   standalone soft renderers (soft forward and backward, eager PyTorch)
   for oracles and small experiments; ``fd.finite_difference`` and
   ``fd.check_grad`` -- the finite-difference harness gradient claims are
   tested against.

Choosing a bandwidth: it is the silhouette smoothing width in scene units;
about 1e-2 of the scene's scale gives a few pixels of support at 512-1024
pixel renders. Anneal it toward 0 during an optimization for a sharp
endpoint.
"""
from .fd import check_grad, finite_difference  # noqa: F401

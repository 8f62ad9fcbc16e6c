"""Render configuration: the same fields and defaults as
``raytracing_tpu.core.config.RenderConfig``, so a configuration reads the
same in both packages.

The route follows ``use_megakernel`` as in the JAX package: False (the
default) runs the wavefront stage pipeline (``render.stages``), whose hit
searches run in kernels 4 and 5 with ``use_pallas=True`` and in chunked
all-pairs scans of ``obj_chunk`` objects otherwise; True runs every pass
as kernel 1 (``render.mega``). The stage pipeline covers
``replicate_stale_poi``, which the megakernel route raises for
(``render.mega.supported``). ``use_grid`` renders through the grids of
``accel.prepare_grids`` on both routes (kernel 1's grid mode on the
megakernel route), ``mega_block`` is kernel 1's blocked layout, and
``n_slabs`` is read by ``models.assignments`` and the CLI, which prepare
the grids; ``ray_chunk`` (which no render path of either package reads)
is kept for the shared configuration.

Training fields (megakernel route; the stage route differentiates every
parameter through autograd): ``mega_grad_wrt`` names the table groups
("par", "sph", "tri", "mat", "lig") that a differentiable pass gives
cotangents to; the others get none. ``mega_bwd_impl`` picks the backward
as in the JAX package (``render.mega.bwd_impl_for``): "pallas" is kernel
2's hard route, "cell" the champion route (kernel 1 recording, then kernel
3), "auto" the first up to 64 objects per type and the second past that;
the TPU-only "xla" raises. ``mega_bwd_sublanes`` is the TPU
backward's tile height: TPU-only, kept for the shared configuration and
ignored. ``mega_edge_bandwidth > 0`` gives edge-aware gradients: the
forward stays kernel 1's hard pass, the backward is kernel 2s, the adjoint
of the soft program (``ops.megakernel_soft``) with that silhouette
bandwidth and ``mega_edge_tau`` (0: the bandwidth) as its depth-order
temperature; up to ``DIFF_TABLE_MAX`` (4096) objects per type, grid mode
included, and past that ``render.mega.supported_diff`` raises.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 320
    height: int = 240
    spp: int = 1                  # rays per pixel per pass (perfect square if >1)
    bounces: int = 5              # fixed indirect bounces
    exposure: float = 1.8         # tonemap scale
    shadow_eps: float = 1e-3      # shadow/bounce-ray origin offset
    ambient: float = 0.2          # direct-lighting ambient term
    two_sided_triangles: bool = False
    russian_roulette: bool = False
    rr_start_depth: int = 2
    normalize_emitter: bool = True     # emitter hits add normalized irradiance
    replicate_stale_poi: bool = False
    use_grid: bool = False
    n_slabs: int | tuple = 1
    ray_chunk: int = 1 << 17
    obj_chunk: int = 256
    use_pallas: bool = False
    use_megakernel: bool = False
    mega_grad_wrt: tuple = ("par", "sph", "tri", "mat", "lig")
    mega_bwd_sublanes: int = 0
    mega_bwd_impl: str = "auto"
    mega_edge_bandwidth: float = 0.0
    mega_edge_tau: float = 0.0
    mega_block: int = 0
    seed: int = 1234

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def total_rays(self) -> int:
        return self.width * self.height * self.spp

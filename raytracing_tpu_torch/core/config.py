"""Render configuration: the same fields and defaults as
``raytracing_tpu.core.config.RenderConfig``, so a configuration reads the
same in both packages.

Fields the port does not implement yet (``russian_roulette``, ``use_grid``,
``use_pallas``, ``replicate_stale_poi``, ``mega_block != 0``) are kept and
rejected by ``render.mega.supported`` with the ROADMAP item that covers
them. The port has only the kernel route, so ``use_megakernel`` is accepted
either way.
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

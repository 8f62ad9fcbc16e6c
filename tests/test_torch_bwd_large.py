"""Kernel 2's hard route past 64 objects per type (``mega_bwd_impl=
"pallas"`` on a larger table) against the JAX package, and the routing of
both backwards past 64.

* The port's plain hard backward (``pathtrace_pass_bwd_reference``, which
  the kernel's large-table instance is held to on the card) against JAX's
  ``_bwd_reference`` -- the backward of JAX's ``pathtrace_pass_diff`` on
  the CPU -- over sphere_field(130) (resident spheres, JAX's ``_loop_diff``
  without windows) and over the cornell + torus scene's 138 triangles
  streamed (JAX's Morton-sorted table with its ``tri_chunks`` windows; its
  sorted rows' cotangents mapped back through its order), all five groups,
  on the same tables, u-planes and cotangent at 16x12 b2.
* ``jax.grad`` through JAX's ``render_pass_mega`` with ``mega_bwd_impl=
  "pallas"`` (interpret mode) on the torus scene against ``render_pass`` +
  ``backward()``: every scene parameter group, float32.
* ``bwd_impl_for`` / ``supported_diff`` at 64, 65, 4096 and 4097 rows, edge
  x grid and "pallas" on a grid scene; a finite-gradient probe of the
  route.

Tolerances. The table-level cases run both sides in float64 (JAX under
``jax_enable_x64``): a sphere's discriminant b^2 - 4ac cancels at a
silhouette, where the hard gradient ~1/sqrt(dis) is largest, and JAX's
value-level backward computes the sphere tests in matmul form (``mm=True``),
another float32 rounding than the kernels' and the plain version's; in
float32 one grazing ray of sphere_field(130) at 16x12 moves the sph
cosine to 0.993 (measured), in float64 both agree to 6.5e-4 of scale.
Gates there: per group cosine >= 0.9999 and max |d| <= 1e-3 of the group's
largest entry (``tests/test_torch_edge_parity.py``'s). The torus scene's
adjacent faces share edges, where the port's champion (the least (t,
original id) pair) and JAX's streamed one (the first in Morton order) may
differ at an exact tie: its render-level case takes the cell route's
gates of ``tests/test_torch_stream.py`` (cosine >= 0.999, norm ratio within
1%).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.models.scenes import sphere_field as jax_sphere_field
from raytracing_tpu.ops.pallas.megakernel_grad import _bwd_reference
from raytracing_tpu.render import mega as jmega
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu.render.stages import _all_triangles as jall_triangles
from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.accel import prepare_grids
from raytracing_tpu_torch.core import types
from raytracing_tpu_torch.core.types import scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.models import scenes
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from torch_grid_scenes import cornell_torus, jax_cornell_torus
from torch_threads import one_thread  # noqa: F401

W, H, B = 16, 12, 2
TORUS = (16, 4)          # 128 faces + cornell's 10 walls: 138 triangles
N_SPHERES = 130
GRAD_SEED = 3
ALL = ("par", "sph", "tri", "mat", "lig")


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _kw():
    return dict(spp=1, width=W, bounces=B, two_sided=False,
                normalize_emitter=True, russian_roulette=False,
                rr_start_depth=0)


def _grad_gate(name, got, want):
    a, b = want.astype(np.float64).ravel(), got.astype(np.float64).ravel()
    assert np.isfinite(b).all(), name
    scale = np.abs(a).max()
    assert scale > 0, name
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos >= 0.9999, (name, cos)
    assert np.abs(a - b).max() <= 1e-3 * scale, (name, np.abs(a - b).max(),
                                                 scale)


@pytest.mark.parametrize("shape", ["spheres", "torus"])
def test_plain_hard_backward_past_64_matches_jax(shape):
    """All five groups in float64 (module docstring): the plain version on
    the original rows against JAX's _bwd_reference over its own route
    past 64 objects (brute spheres; Morton-sorted triangles in tri_chunks
    windows)."""
    if shape == "spheres":
        js = jax_sphere_field(N_SPHERES, cols=W, rows=H)
    else:
        js = jax_cornell_torus(W, H, *TORUS)
    jcfg = JaxConfig(width=W, height=H, bounces=B)
    par, sph, tri, mat, lig = (np.asarray(t)
                               for t in jmega.scene_tables(js, jcfg))
    u = np.asarray(jmega.u_planes_for_pass(jpt.init_state(jcfg)["key"], 0,
                                           jcfg, js.lights.count))
    g = np.random.default_rng(GRAD_SEED).normal(size=(W * H, 3))
    jtri, windows = tri, {}
    if shape == "torus":
        assert tri.shape[0] > MK.UNROLL_OBJECTS
        tris = jall_triangles(js)
        sorted_tri, chunks = jmega.tri_chunk_tables(js, jnp.asarray(tri),
                                                    tris)
        order = np.asarray(jnp.argsort(jmega._morton_codes(
            tris.v.mean(1), js.bounds.pmin, js.bounds.pmax)))
        jtri = np.asarray(sorted_tri)[:, :32]
        windows = dict(tri_chunks=np.asarray(chunks))
    else:
        assert sph.shape[0] > MK.UNROLL_OBJECTS

    def f64(x):
        return np.asarray(x, np.float64)

    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = [np.asarray(x) for x in _bwd_reference(
            f64(par), np.zeros(2, np.int32), f64(sph), f64(jtri), f64(mat),
            f64(lig), f64(g), f64(u), seed=1234, mode="path", **_kw(),
            **windows)]
    finally:
        jax.config.update("jax_enable_x64", x64)
    if shape == "torus":
        d = np.zeros((tri.shape[0], 32))
        d[order] = want[2][:tri.shape[0], :32]
        want[2] = d
    got = MKG.pathtrace_pass_bwd_reference(
        *(torch.as_tensor(f64(t)) for t in (par,)),
        torch.zeros(2, dtype=torch.int32),
        *(torch.as_tensor(f64(t)) for t in (sph, tri, mat, lig, g, u)),
        seed=1234, **_kw())
    for name, a, b in zip(ALL, want, got):
        if b.numel():
            assert b.shape == a.shape, name
            _grad_gate(name, b.numpy(), a)


PARAMS = ("center", "radius", "tv", "mat", "irr", "lpos", "eye")


def _params(sc):
    return {"center": sc.spheres.center, "radius": sc.spheres.radius,
            "tv": sc.meshes[0].tris.v, "mat": sc.materials,
            "irr": sc.lights.irradiance, "lpos": sc.lights.position,
            "eye": sc.camera.eye}


def _with(sc, p, rep):
    m = sc.meshes[0]
    return rep(sc, spheres=rep(sc.spheres, center=p["center"],
                               radius=p["radius"]),
               meshes=(rep(m, tris=rep(m.tris, v=p["tv"])),),
               lights=rep(sc.lights, irradiance=p["irr"],
                          position=p["lpos"]),
               materials=p["mat"], camera=rep(sc.camera, eye=p["eye"]))


def test_pallas_route_on_streamed_table_matches_jax():
    """render_pass with mega_bwd_impl="pallas" on the streamed torus scene
    (on the CPU the plain forward under autograd) against jax.grad through
    JAX's render_pass_mega on its "pallas" route (the streamed kernel in
    interpret mode, then _bwd_reference's _loop_diff windows), every
    parameter group, 8x6 b2: cosine >= 0.999, norm ratio within 1%."""
    w, h = 8, 6
    js = jax_cornell_torus(w, h, *TORUS)
    jcfg = JaxConfig(width=w, height=h, bounces=B, use_megakernel=True,
                     mega_bwd_impl="pallas", mega_grad_wrt=ALL)
    assert jmega.bwd_impl_for(js, jcfg) == "pallas"
    state0 = jpt.init_state(jcfg)

    def loss(p):
        st = jmega.render_pass_mega(_with(js, p, dataclasses.replace), state0,
                                    jcfg, interpret=True)
        return jnp.mean(st["acc"] ** 2)

    want = {k: np.asarray(x)
            for k, x in jax.grad(loss)(_params(js)).items()}
    ps = scene_from_numpy(scene_to_numpy(js))
    cfg = RenderConfig(width=w, height=h, bounces=B, use_megakernel=True,
                       mega_bwd_impl="pallas", mega_grad_wrt=ALL)
    assert mega.streamed(ps, cfg) == (True, False)
    assert mega.bwd_impl_for(ps, cfg) == "pallas"
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in _params(ps).items()}
    st = pt.render_pass(_with(ps, p, replace), pt.init_state(cfg, "cpu"), cfg)
    torch.mean(st["acc"] ** 2).backward()
    for k in PARAMS:
        a, b = want[k].ravel().astype(np.float64), p[k].grad.numpy().ravel()
        assert np.isfinite(b).all(), k
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert na > 0, k
        assert a @ b / (na * nb) >= 0.999, k
        assert abs(nb / na - 1.0) <= 0.01, k


def _spheres(n: int, sc):
    rng = np.random.default_rng(0)
    c = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    return types.build_scene(
        camera=sc.camera, spheres=types.make_spheres(
            c, np.full(n, 0.02, np.float32), np.zeros(n, np.int32)),
        lights=sc.lights, materials=sc.materials)


def _tris(n: int, sc):
    v = np.random.default_rng(0).uniform(-1, 1, (n, 3, 3))
    return types.build_scene(camera=sc.camera,
                             triangles=types.make_triangles(v),
                             lights=sc.lights, materials=sc.materials)


@pytest.mark.parametrize("n", [64, 65, 4096, 4097])
@pytest.mark.parametrize("kind", ["sph", "tri"])
def test_routes_at_the_budgets(n, kind):
    """JAX's thresholds: "auto" takes kernel 2 up to 64 objects and the
    cell route past; "pallas" and edge mode run kernels 2 and 2s up to
    DIFF_TABLE_MAX per type; past it the differentiable pass raises,
    naming the budget."""
    sc = scenes.cornell_box(cols=8, rows=8)
    s = _spheres(n, sc) if kind == "sph" else _tris(n, sc)
    cfg = RenderConfig(width=8, height=8, bounces=1, use_megakernel=True)
    edge = replace(cfg, mega_edge_bandwidth=2e-2)
    pallas = replace(cfg, mega_bwd_impl="pallas")
    if n > mega.DIFF_TABLE_MAX:
        for c in (cfg, edge, pallas):
            with pytest.raises(NotImplementedError, match="DIFF_TABLE_MAX"):
                mega.bwd_impl_for(s, c)
        return
    assert mega.supported_diff(s, cfg)
    assert mega.bwd_impl_for(s, cfg) == ("pallas" if n <= 64 else "cell")
    assert mega.bwd_impl_for(s, pallas) == "pallas"
    assert mega.bwd_impl_for(s, edge) == "pallas"
    assert mega.bwd_impl_for(s, replace(edge, mega_bwd_impl="pallas")) \
        == "pallas"
    # the large-table instances take what "pallas" and edge mode route past 64
    assert MKG.large_route(torch.zeros((n if kind == "sph" else 0, 8)),
                           torch.zeros((n if kind == "tri" else 0, 32))) \
        == (n > 64)


def test_grid_scene_routes():
    """Grid mode: "auto" keeps JAX's cell route, "pallas" runs kernel 2's
    large-table instance over the grids (on the CPU the plain brute
    forward, whose champions the grid walk's are), edge x grid kernel 2s over the scene's
    own rows, past 64 triangles in Morton order (a sorted copy built for
    the backward alone, as JAX's tri_chunk_tables at render/mega.py:696)."""
    ps = prepare_grids(cornell_torus(8, 6, *TORUS), 2)
    cfg = RenderConfig(width=8, height=6, bounces=1, use_megakernel=True,
                       use_grid=True)
    assert mega.bwd_impl_for(ps, cfg) == "cell"
    assert mega.bwd_impl_for(ps, replace(cfg, mega_bwd_impl="pallas")) \
        == "pallas"
    edge = replace(cfg, mega_edge_bandwidth=2e-2)
    assert mega.bwd_impl_for(ps, edge) == "pallas"
    tables = mega.scene_tables(ps, cfg)
    assert mega.chunk_tables(ps, cfg, tables[1], tables[2]) is None
    st = mega.soft_tri_order(ps, tables[2], None)
    assert st is not None and st.rows.shape[0] % MK.STREAM_CHUNK == 0
    n = tables[2].shape[0]
    assert torch.equal(st.rows[:n], tables[2][st.perm[:n].long()])
    small = scenes.cornell_box(cols=8, rows=6)
    assert mega.soft_tri_order(
        small, mega.scene_tables(small, cfg)[2], None) is None
    # the pallas route's grads on the grid scene equal the brute scene's
    def grads(sc, c):
        m = sc.meshes[0]
        tv = m.tris.v.detach().clone().requires_grad_(True)
        rad = sc.spheres.radius.detach().clone().requires_grad_(True)
        s = replace(sc, spheres=replace(sc.spheres, radius=rad),
                    meshes=(replace(m, tris=replace(m.tris, v=tv)),))
        out = pt.render_pass(s, pt.init_state(c, "cpu"), c)
        torch.mean(out["acc"] ** 2).backward()
        return out["acc"].detach(), tv.grad, rad.grad

    a = grads(ps, replace(cfg, mega_bwd_impl="pallas"))
    b = grads(cornell_torus(8, 6, *TORUS),
              replace(cfg, use_grid=False, mega_bwd_impl="pallas"))
    for x, y in zip(a, b):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scene", ["spheres", "torus"])
def test_pallas_route_gradient_is_finite(scene):
    """A finite-gradient probe of the "pallas" route past 64 objects at
    b5: every table group's cotangent finite, and nonzero where the scene
    has rows of that group."""
    cfg = RenderConfig(width=8, height=6, bounces=5, use_megakernel=True,
                       mega_bwd_impl="pallas", mega_grad_wrt=ALL)
    sc = (scenes.sphere_field(80, cols=8, rows=6) if scene == "spheres"
          else cornell_torus(8, 6, *TORUS))
    assert mega.bwd_impl_for(sc, cfg) == "pallas"
    tables = [t.detach().clone().requires_grad_(True)
              for t in mega.scene_tables(sc, cfg)]
    kw = dict(spp=1, width=8, bounces=5, two_sided=False,
              normalize_emitter=True, seed=0,
              chunks=mega.chunk_tables(sc, cfg, tables[1], tables[2]))
    acc = MKG.pathtrace_pass_diff(tables[0],
                                  torch.zeros(2, dtype=torch.int32),
                                  *tables[1:], torch.zeros((48, 3)), None,
                                  **kw)
    torch.mean(acc ** 2).backward()
    for name, t in zip(ALL, tables):
        if not t.shape[0]:
            continue      # sphere_field has no triangle rows
        assert torch.isfinite(t.grad).all(), name
        assert t.grad.abs().max() > 0, name

"""Kernel 1's streamed tables (``render/mega.chunk_tables``, the plain
streamed version in ``ops/megakernel.py``; the CUDA kernel on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 21) against the
JAX package's Morton-chunk streaming and against the port's own brute
route.

Scenes: the cornell box with a torus mesh of 16 x 8 segments (266
triangles, 3 chunks, streamed without patching anything) and
sphere_field(300) with the resident sphere budget patched to 64 on the
port's side and JAX's ``SMEM_TABLE_MAX`` to 64 rows of 8 on JAX's (3
chunks), as ``tests/test_megakernel.py`` streams it.

Tolerances and what they hold:

* chunk tables: JAX's Morton order exactly; each box encloses JAX's and
  exceeds it by at most the widening (``MK.CHUNK_PAD`` of the scene's
  scale) plus 1e-6;
* the streamed plain version against the brute one over the same tables:
  every champion id, occlusion bit and accumulator value equal (a
  candidate wins on the least (t, original id) pair, as the brute loops
  give it);
* against JAX's interpret-mode streamed kernel on the same draws (16x12
  b1): acc at rtol/atol 2e-4 on the torus (on the sphere field the
  port's streamed pass differs from JAX's streamed kernel exactly as the
  port's brute pass differs from JAX's unstreamed one, on sphere
  silhouettes: 3 of 192 rays beyond 2e-4, held to 2%, none beyond 5e-3,
  as ``tests/test_torch_champion.py`` explains); the record's ids after
  mapping JAX's Morton-sorted rows back through its order: at most 1% of
  id slots may differ (JAX keeps the first candidate in Morton order at
  an exact tie, the port the least original id; adjacent torus faces
  share edges), and the occlusion bits of live segments equal;
* the cell-route train step (wrt ("sph", "mat", "tri")) against jax.grad
  through JAX's streamed render_pass_mega: per group cosine >= 0.999 and
  norm ratio within 1% (``tests/test_torch_grid_train.py``'s gates).

JAX's interpret-mode streamed kernel takes ~9 s for a b1 pass at 16x12
and its gradient ~25 s: those comparisons share module fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.models import scenes as jscenes
from raytracing_tpu.ops.pallas import megakernel as JMK
from raytracing_tpu.render import mega as jmega
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu.render.stages import _all_triangles as jall_triangles
from raytracing_tpu_torch import RenderConfig, replace
from raytracing_tpu_torch.core import rng, types
from raytracing_tpu_torch.core.types import scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.models import scenes
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.ops import megakernel_grad as MKG
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from raytracing_tpu_torch.render.direct import render_direct
from torch_grid_scenes import jax_cornell_torus
from torch_threads import one_thread  # noqa: F401

W, H = 16, 12
TORUS = (16, 8)
N_SPHERES = 300
WRT = ("sph", "mat", "tri")
PARAMS = ("center", "radius", "mat", "tv")
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _jax_torus(w=W, h=H):
    return jax_cornell_torus(w, h, *TORUS)


def _port(js):
    return scene_from_numpy(scene_to_numpy(js))


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_encloses(got: torch.Tensor, want, scene) -> None:
    """Boxes ``got`` (nc, 8) enclose JAX's ``want`` and exceed them by at
    most the widening."""
    want = np.asarray(want)
    got = got.numpy()
    pad = MK.CHUNK_PAD * max(float(scene.bounds_min.abs().max()),
                             float(scene.bounds_max.abs().max()),
                             float(scene.camera.eye.abs().max()))
    assert got.shape == want.shape
    assert (got[:, 0:3] <= want[:, 0:3]).all()
    assert (got[:, 3:6] >= want[:, 3:6]).all()
    np.testing.assert_allclose(got[:, 0:6], want[:, 0:6], rtol=0,
                               atol=pad + 1e-6)


def test_tri_chunk_tables_match_jax():
    """The triangles in JAX's Morton order (perm -1 past the table), the
    sorted rows the table's rows in that order and zero rows after, each
    chunk's box enclosing JAX's."""
    js = _jax_torus()
    ps = _port(js)
    jtri = jmega.scene_tables(js, JaxConfig(width=W, height=H))[2]
    tris = jall_triangles(js)
    jrows, jboxes = jmega.tri_chunk_tables(js, jtri, tris)
    order = np.asarray(jnp.argsort(jmega._morton_codes(
        tris.v.mean(1), js.bounds.pmin, js.bounds.pmax)))
    tri = mega.scene_tables(ps, RenderConfig(width=W, height=H))[2]
    st = mega.tri_chunk_tables(ps, tri)
    n = tri.shape[0]
    assert n == 266 and st.n_chunks == 3 == jboxes.shape[0]
    np.testing.assert_array_equal(st.perm[:n].numpy(), order)
    assert (st.perm[n:] == -1).all() and (st.rows[n:] == 0).all()
    assert torch.equal(st.rows[:n], tri[st.perm[:n].long()])
    np.testing.assert_allclose(st.rows[:n].numpy(),
                               np.asarray(jrows)[:n, :MK.TRI_COLS],
                               rtol=1e-6, atol=1e-6)
    _assert_encloses(st.boxes, jboxes, ps)


def test_sph_chunk_tables_match_jax():
    """The spheres of sphere_field(300) in JAX's order, boxes over the
    rows whose mask is set enclosing JAX's."""
    js = jscenes.sphere_field(N_SPHERES, cols=W, rows=H)
    ps = _port(js)
    jsph = jmega.scene_tables(js, JaxConfig(width=W, height=H))[1]
    jrows, jboxes = jmega.sph_chunk_tables(jsph, js)
    order = np.asarray(jnp.argsort(jmega._morton_codes(
        jsph[:, 0:3], js.bounds.pmin, js.bounds.pmax)))
    sph = mega.scene_tables(ps, RenderConfig(width=W, height=H))[1]
    st = mega.sph_chunk_tables(ps, sph)
    assert st.n_chunks == 3 == jboxes.shape[0]
    np.testing.assert_array_equal(st.perm[:N_SPHERES].numpy(), order)
    np.testing.assert_array_equal(st.rows[:N_SPHERES].numpy(),
                                  np.asarray(jrows)[:N_SPHERES, :8])
    _assert_encloses(st.boxes, jboxes, ps)


def _scene(name, monkeypatch, w=W, h=H):
    if name == "torus":
        return _port(_jax_torus(w, h))
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
    return _port(jscenes.sphere_field(N_SPHERES, cols=w, rows=h))


@pytest.mark.parametrize("mode", ["path", "roulette", "direct"])
@pytest.mark.parametrize("name", ["torus", "spheres"])
def test_streamed_plain_equals_brute_plain(monkeypatch, name, mode):
    """The streamed plain version against the brute one over the same
    tables at 24x16 b2 (the roulette from depth 1; direct mode on its
    draws): every id, bit and accumulator value equal."""
    ps = _scene(name, monkeypatch, 24, 16)
    cfg = RenderConfig(width=24, height=16, bounces=0 if mode == "direct"
                       else 2, use_megakernel=True,
                       russian_roulette=mode == "roulette", rr_start_depth=1)
    tables = mega.scene_tables(ps, cfg)
    chunks = mega.chunk_tables(ps, cfg, tables[1], tables[2])
    assert (chunks.tri is not None) == (name == "torus")
    assert (chunks.sph is not None) == (name == "spheres")
    zeros = torch.zeros((cfg.total_rays, 3))
    if mode == "direct":
        key = torch.as_tensor(np.array([0, 7], np.uint32))
        u = mega.u_planes_for_direct(key, cfg, ps.lights.count)
        got, want = ((MK.direct_pass_reference(
            *tables, zeros, u, key=key, spp=1, width=24, two_sided=False,
            chunks=c),) for c in (chunks, None))
    else:
        u = mega.u_planes_for_pass(pt.init_state(cfg, "cpu")["key"], 0, cfg,
                                   ps.lights.count)
        work = {}
        got, want = (MK.pathtrace_pass_reference(
            tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:], zeros,
            u, spp=1, width=24, bounces=2, two_sided=False,
            normalize_emitter=cfg.normalize_emitter, seed=cfg.seed,
            russian_roulette=cfg.russian_roulette, rr_start_depth=1,
            record=True, chunks=c, work=w)
            for c, w in ((chunks, work), (None, None)))
        assert (got[1] >= 0).any()
        # the culling skipped rows: fewer (ray, row) tests than brute force
        st, kind = ((chunks.tri, "tri_tests") if name == "torus"
                    else (chunks.sph, "sph_tests"))
        n_rows = tables[2 if name == "torus" else 1].shape[0]
        traces = work["chunk_tests"] // st.n_chunks
        assert 0 < work[kind] < n_rows * traces
    assert got[0].max() > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_stream_work_counts_shadow_rows_to_first_occluder():
    """The plain version's work counts, which the chip run's bound prices:
    a closest hit tests every row of a chunk it visits, a shadow ray the
    rows up to its first occluder, as the kernel's any-hit loop stops
    there. One chunk of three spheres on the x axis (rows 0 and 1 on the
    first ray, row 2 alone on the second, then row 0 or none on the
    third)."""
    sph = torch.zeros((3, MK.SPH_COLS))
    sph[:, 0:6] = torch.tensor([[5.0, 0, 0, 1, 0, 1], [10.0, 0, 0, 1, 0, 1],
                                [15.0, 3, 0, 1, 0, 1]])
    perm = torch.full((MK.STREAM_CHUNK,), -1, dtype=torch.int32)
    perm[:3] = torch.arange(3, dtype=torch.int32)
    box = torch.tensor([[4.0, -6, -1, 16, 4, 1, 0, 0]])
    rows = torch.cat([sph, sph.new_zeros((MK.STREAM_CHUNK - 3, 8))])
    chunks = MK.KernelChunks(tri=None, sph=MK.Stream(rows=rows, boxes=box,
                                                     perm=perm))
    o = torch.tensor([[0.0, 0, 0], [0.0, 3, 0], [0.0, -0.5, 0]])
    d = torch.tensor([[1.0, 0, 0]]).expand(3, 3).contiguous()
    mint, maxt = torch.zeros(3), torch.full((3,), 100.0)
    tri = torch.zeros((0, MK.TRI_COLS))
    work = {}
    occ = MK._anyhit(o, d, mint, maxt, sph, tri, False, work=work,
                     chunks=chunks)
    assert occ.tolist() == [True, True, True]
    assert work == {"chunk_tests": 3, "chunk_visits": 3,
                    "sph_tests": 1 + 3 + 1}
    o[2, 1] = -5.0
    work = {}
    occ = MK._anyhit(o, d, mint, maxt, sph, tri, False, work=work,
                     chunks=chunks)
    assert occ.tolist() == [True, True, False]
    assert work["sph_tests"] == 1 + 3 + 3
    work = {}
    hit = MK._trace(o, d, mint, maxt, sph, tri, False, work=work,
                    chunks=chunks)
    assert hit[4].tolist() == [0, 2, -1]
    assert work["sph_tests"] == 3 * 3


@pytest.fixture(scope="module")
def jax_torus_grads():
    """JAX's streamed render_pass_mega (interpret mode) on the torus scene,
    b1, the cell route: its accumulator and the gradients of the mean
    square accumulator wrt sphere centres and radii, materials and the
    mesh's vertices."""
    js = _jax_torus()
    jcfg = JaxConfig(width=W, height=H, bounces=1, use_megakernel=True,
                     mega_grad_wrt=WRT)
    assert jmega.bwd_impl_for(js, jcfg) == "cell"
    state0 = jpt.init_state(jcfg)
    m = js.meshes[0]

    def loss(p):
        sc = dataclasses.replace(
            js, spheres=dataclasses.replace(js.spheres, center=p["center"],
                                            radius=p["radius"]),
            materials=p["mat"],
            meshes=(dataclasses.replace(m, tris=dataclasses.replace(
                m.tris, v=p["tv"])),))
        acc = jmega.render_pass_mega(sc, state0, jcfg, interpret=True)["acc"]
        return jnp.mean(acc ** 2), acc

    params = {"center": js.spheres.center, "radius": js.spheres.radius,
              "mat": js.materials, "tv": m.tris.v}
    (_, acc), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(acc), {k: np.asarray(v) for k, v in grads.items()}


def _port_grads(ps, cfg):
    m = ps.meshes[0]
    p = {"center": ps.spheres.center, "radius": ps.spheres.radius,
         "mat": ps.materials, "tv": m.tris.v}
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    sc = replace(ps, spheres=replace(ps.spheres, center=p["center"],
                                     radius=p["radius"]),
                 materials=p["mat"],
                 meshes=(replace(m, tris=replace(m.tris, v=p["tv"])),))
    st = pt.render_pass(sc, pt.init_state(cfg, "cpu"), cfg)
    torch.mean(st["acc"] ** 2).backward()
    return st["acc"].detach().numpy(), {k: p[k].grad.numpy()
                                        for k in PARAMS}


def test_stream_path_pass_matches_jax_kernel(jax_torus_grads):
    """The differentiable pass's forward (kernel 1 recording over the
    streamed triangles, "auto" -> "cell") against JAX's streamed
    render_pass_mega on the same draws."""
    want, _ = jax_torus_grads
    ps = _port(_jax_torus())
    cfg = RenderConfig(width=W, height=H, bounces=1, use_megakernel=True,
                       mega_grad_wrt=WRT)
    assert mega.streamed(ps, cfg) == (True, False)
    assert mega.bwd_impl_for(ps, cfg) == "cell"
    got, _ = _port_grads(ps, cfg)
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # forward-only, the same pass through the wrapper's plain version
    with torch.no_grad():
        fwd = mega.render_pass_mega(ps, pt.init_state(cfg, "cpu"), cfg)
    np.testing.assert_array_equal(fwd["acc"].numpy(), got)


def test_stream_training_matches_jax(jax_torus_grads):
    """Cotangents of the sphere centres and radii, materials and mesh
    vertices through the cell route over the streamed table against
    jax.grad: cosine >= 0.999, norm ratio within 1%."""
    _, want = jax_torus_grads
    _, got = _port_grads(_port(_jax_torus()), RenderConfig(
        width=W, height=H, bounces=1, use_megakernel=True, mega_grad_wrt=WRT))
    for k in PARAMS:
        a, b = want[k].ravel().astype(np.float64), got[k].ravel()
        assert np.isfinite(b).all(), k
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert na > 0, k
        assert a @ b / (na * nb) >= 0.999, k
        assert abs(nb / na - 1.0) <= 0.01, k


def test_stream_record_matches_jax_kernel():
    """Kernel 1's record over the streamed triangles (plain version)
    against JAX's interpret-mode recording kernel on its sorted table,
    b1: JAX's sorted rows mapped back through its Morton order, at most 1%
    of id slots differing (exact ties, module docstring), occlusion bits of
    live segments equal, acc at 2e-4."""
    js = _jax_torus()
    jcfg = JaxConfig(width=W, height=H, bounces=1)
    par, sph, tri, mat, lig = jmega.scene_tables(js, jcfg)
    tris = jall_triangles(js)
    jtri, jchunks = jmega.tri_chunk_tables(js, tri, tris)
    order = np.asarray(jnp.argsort(jmega._morton_codes(
        tris.v.mean(1), js.bounds.pmin, js.bounds.pmax)))
    u = jmega.u_planes_for_pass(jpt.init_state(jcfg)["key"], 0, jcfg,
                                js.lights.count)
    kw = dict(spp=1, width=W, bounces=1, two_sided=False,
              normalize_emitter=jcfg.normalize_emitter, seed=jcfg.seed)
    jacc, jids, joccs = (np.asarray(x) for x in JMK.pathtrace_pass_pallas(
        par, jnp.zeros((2,), jnp.int32), sph, jtri, mat, lig,
        jnp.zeros((W * H, 3)), u, chunks=jchunks, record=True,
        rec_sph_rows=sph.shape[0], interpret=True, **kw))
    n_sph = sph.shape[0]
    jids = jids.astype(np.int64)
    tri_rows = jids >= n_sph
    jids[tri_rows] = order[jids[tri_rows] - n_sph] + n_sph
    ps = _port(js)
    cfg = RenderConfig(width=W, height=H, bounces=1, use_megakernel=True)
    tables = mega.scene_tables(ps, cfg)
    acc, ids, occs = MK.pathtrace_pass(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:],
        torch.zeros((W * H, 3)), _t(u), record=True,
        chunks=mega.chunk_tables(ps, cfg, tables[1], tables[2]), **kw)
    np.testing.assert_allclose(acc.numpy(), jacc, rtol=TOL, atol=TOL)
    assert (ids.numpy() >= n_sph).any()
    assert (ids.numpy() != jids).mean() <= 0.01
    live = np.repeat(jids >= 0, lig.shape[0], axis=0)
    np.testing.assert_array_equal(occs.numpy()[live], joccs[live] > 0.5)


def test_stream_direct_matches_jax_kernel():
    """render_direct_mega over the streamed triangles against JAX's
    interpret-mode streamed render_direct_mega (same key)."""
    js = _jax_torus()
    want = np.asarray(jmega.render_direct_mega(
        js, JaxConfig(width=W, height=H, bounces=0, use_megakernel=True),
        interpret=True))
    got = mega.render_direct_mega(_port(js), RenderConfig(
        width=W, height=H, bounces=0, use_megakernel=True)).numpy()
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_stream_spheres_match_jax_kernel(monkeypatch):
    """sphere_field(300) streamed on both sides (the resident budgets
    patched), one path pass b1 on the same draws: streaming adds no
    disagreement with JAX. The port's streamed pass differs from JAX's
    streamed kernel exactly as the port's brute pass differs from JAX's
    unstreamed one (both sides' streamed passes equal their brute ones).
    That difference is the sphere silhouettes' of the module docstring: 3
    of 192 rays beyond 2e-4 and at most 1.4e-3 measured here, held to 2%
    and 5e-3."""
    js = jscenes.sphere_field(N_SPHERES, cols=W, rows=H)
    jcfg = JaxConfig(width=W, height=H, bounces=1, use_megakernel=True)
    u = jmega.u_planes_for_pass(jpt.init_state(jcfg)["key"], 0, jcfg,
                                js.lights.count)
    ps = _port(js)
    cfg = RenderConfig(width=W, height=H, bounces=1, use_megakernel=True)

    def both():
        want = np.asarray(jmega.render_pass_mega(
            js, jpt.init_state(jcfg), jcfg, u_planes=u,
            interpret=True)["acc"])
        got = mega.render_pass_mega(ps, pt.init_state(cfg, "cpu"), cfg,
                                    u_planes=_t(u))["acc"].numpy()
        return got, want

    brute, jbrute = both()
    assert mega.streamed(ps, cfg) == (False, False)
    monkeypatch.setattr(JMK, "SMEM_TABLE_MAX", 64 * 8)
    monkeypatch.setattr(MK, "SPH_RESIDENT_MAX", 64)
    assert mega.streamed(ps, cfg) == (False, True)
    got, want = both()
    assert got.max() > 0
    np.testing.assert_array_equal(got, brute)
    np.testing.assert_array_equal(want, jbrute)
    err = np.abs(got - want)
    assert (err > TOL + TOL * np.abs(want)).any(-1).mean() <= 0.02
    assert err.max() <= 5e-3


def test_streamed_blocked_layout_is_bit_equal():
    """mega_block on a streamed scene (JAX allows it; bench.py's mesh
    scenes run block 64) only maps the kernel's threads to pixels: B = 4
    renders the image and the pass of B = 0 bit for bit."""
    ps = _port(_jax_torus())
    cfg = RenderConfig(width=W, height=H, bounces=0, use_megakernel=True)
    assert mega.effective_block(replace(cfg, mega_block=4)) == 4
    img0 = render_direct(ps, cfg)
    img4 = render_direct(ps, replace(cfg, mega_block=4))
    assert img0.max() > 0 and torch.equal(img0, img4)
    c1 = replace(cfg, bounces=1)
    st0 = pt.render_pass(ps, pt.init_state(c1, "cpu"), c1)
    st4 = pt.render_pass(ps, pt.init_state(c1, "cpu"),
                         replace(c1, mega_block=4))
    assert torch.equal(st0["acc"], st4["acc"])


def _tris(n: int, sc):
    v = np.random.default_rng(0).uniform(-1, 1, (n, 3, 3))
    return types.build_scene(camera=sc.camera,
                             triangles=types.make_triangles(v),
                             lights=sc.lights, materials=sc.materials)


def test_routing_follows_jax():
    """streamed, supported_diff and bwd_impl_for route as JAX's do:
    triangles past 64 stream outside grid mode, spheres past 4608 without
    a sphere grid (grid mode included); "auto" takes the cell route past 64
    objects; the differentiable pass covers 4096 objects per type."""
    cfg = RenderConfig(width=8, height=8, use_megakernel=True)
    jcfg = JaxConfig(width=8, height=8, use_megakernel=True)
    corn = jscenes.cornell_box(cols=8, rows=8)
    cases = {"cornell": corn,
             "torus": jax_cornell_torus(8, 8, *TORUS),
             "spheres65": jscenes.sphere_field(65, cols=8, rows=8),
             "spheres4609": jscenes.sphere_field(4609, cols=8, rows=8)}
    for name, js in cases.items():
        ps = _port(js)
        jtri = jmega.scene_tables(js, jcfg)[2]
        jsph = jmega.scene_tables(js, jcfg)[1]
        want = (jtri.shape[0] > JMK.STREAM_MIN_TRIS,
                jsph.size > JMK.SMEM_TABLE_MAX)
        assert mega.streamed(ps, cfg) == want, name
        assert mega.supported(ps, cfg), name
        if jmega.supported_diff(js, jcfg):
            assert mega.bwd_impl_for(ps, cfg) == jmega.bwd_impl_for(
                js, jcfg), name
        else:
            # JAX renders it forward-only; the port raises, naming why
            with pytest.raises(NotImplementedError, match="DIFF_TABLE_MAX"):
                mega.supported_diff(ps, cfg)
    # grid mode: no sphere grid, so the 4609 spheres stream there too
    gcfg = replace(cfg, use_grid=True)
    big = _port(cases["spheres4609"])
    assert mega.streamed(big, gcfg) == (False, True)
    assert mega.supported(big, gcfg)
    # the diff budget covers triangles too (JAX's supported_diff)
    sc = scenes.cornell_box(cols=8, rows=8)
    assert mega.supported_diff(_tris(4096, sc), cfg)
    with pytest.raises(NotImplementedError, match="DIFF_TABLE_MAX"):
        mega.supported_diff(_tris(4097, sc), cfg)


def test_unported_routes_name_item_16():
    """What item 16 left unported now routes: "pallas" over streamed tables
    (JAX's _loop_diff windows) is kernel 2's large-table instance, edge mode
    past 64 objects is kernel 2s, and the pass with bwd_cell=False takes
    the chunks (on the CPU the plain brute forward under autograd, whose
    champions the streamed forward's are); past DIFF_TABLE_MAX the pass
    still raises, naming the budget, not item 16."""
    ps = _port(_jax_torus(8, 8))
    cfg = RenderConfig(width=8, height=8, bounces=1, use_megakernel=True)
    assert mega.bwd_impl_for(ps, replace(cfg, mega_bwd_impl="pallas")) \
        == "pallas"
    assert mega.bwd_impl_for(ps, replace(cfg, mega_edge_bandwidth=1e-2)) \
        == "pallas"
    tables = [t.clone().requires_grad_(True)
              for t in mega.scene_tables(ps, cfg)]
    chunks = mega.chunk_tables(ps, cfg, tables[1], tables[2])
    kw = dict(spp=1, width=8, bounces=1, two_sided=False,
              normalize_emitter=True, seed=0)
    u = mega.u_planes_for_pass(rng.base_key(0), 0, cfg, ps.lights.count)
    acc = MKG.pathtrace_pass_diff(
        tables[0], torch.zeros(2, dtype=torch.int32), *tables[1:],
        torch.zeros((64, 3)), u, chunks=chunks, **kw)
    brute = MK.pathtrace_pass_reference(
        tables[0].detach(), torch.zeros(2, dtype=torch.int32),
        *(t.detach() for t in tables[1:]), torch.zeros((64, 3)), u, **kw)
    assert torch.equal(acc.detach(), brute)
    acc.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in tables)
    with pytest.raises(NotImplementedError, match="DIFF_TABLE_MAX"):
        mega.bwd_impl_for(_tris(4097, scenes.cornell_box(cols=8, rows=8)),
                          replace(cfg, mega_edge_bandwidth=1e-2))


def test_wrapper_rejects_bad_chunks():
    """The wrapper checks the streamed tables' shapes and types, and a
    table streamed and gridded at once."""
    ps = _port(_jax_torus(8, 8))
    cfg = RenderConfig(width=8, height=8, bounces=0, use_megakernel=True)
    tables = mega.scene_tables(ps, cfg)
    chunks = mega.chunk_tables(ps, cfg, tables[1], tables[2])
    acc = torch.zeros((64, 3))
    kw = dict(key=torch.zeros(2, dtype=torch.int32), spp=1, width=8,
              two_sided=False)
    st = chunks.tri
    for bad in (st._replace(perm=st.perm.long()),
                st._replace(rows=st.rows[:-1].contiguous()),
                st._replace(boxes=st.boxes[:, :6].contiguous())):
        with pytest.raises(ValueError, match="stream"):
            MK.direct_pass(*tables, acc, None,
                           chunks=chunks._replace(tri=bad), **kw)
    grid = MK.KernelGrids(tri=(), sph=None, start=0, rows=(0, 0))
    with pytest.raises(ValueError, match="streamed or gridded"):
        MK.direct_pass(*tables, acc, None, chunks=chunks, grid=grid, **kw)
    # without the chunks the table is past the resident budget
    with pytest.raises(ValueError, match="resident"):
        MK.direct_pass(*tables, acc, None, **kw)

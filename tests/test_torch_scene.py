"""The port's scene constructors, table packing, samplers, primary rays and
gates against the JAX package, and the rule that the port imports no jax."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.core import sampling as jsampling
from raytracing_tpu.core import types as jtypes
from raytracing_tpu.io.png import read_png
from raytracing_tpu.models import scenes as jscenes
from raytracing_tpu.ops import intersect as jintersect
from raytracing_tpu.render import camera as jcamera
from raytracing_tpu.render import mega as jmega
from raytracing_tpu.render import stages as jstages
from raytracing_tpu_torch import RenderConfig, default_device, replace
from raytracing_tpu_torch.core import sampling
from raytracing_tpu_torch.core import types
from raytracing_tpu_torch.io.png import write_png
from raytracing_tpu_torch.models import scenes
from raytracing_tpu_torch.ops import intersect
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import camera, mega, stages
from torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scene constructors run tan/norm/cross in float32 on both sides; libraries may
# round the last bit differently
BUILD_TOL = dict(rtol=1e-6, atol=1e-7)

SCENES = {
    "cornell": (lambda: jscenes.cornell_box(cols=64, rows=48),
                lambda: scenes.cornell_box(cols=64, rows=48)),
    "sphere_field32": (lambda: jscenes.sphere_field(32, cols=64, rows=48),
                       lambda: scenes.sphere_field(32, cols=64, rows=48)),
}


def _assert_leaves_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **BUILD_TOL)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_constructor_matches_jax(name):
    jax_build, port_build = SCENES[name]
    _assert_leaves_close(types.scene_to_numpy(port_build()),
                         types.scene_to_numpy(jax_build()))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_tables_match_jax(name):
    jax_build, port_build = SCENES[name]
    cfg = RenderConfig(width=64, height=48)
    want = jmega.scene_tables(jax_build(), JaxConfig(width=64, height=48))
    carried = types.scene_from_numpy(types.scene_to_numpy(jax_build()))
    for scene in (port_build(), carried):
        got = mega.scene_tables(scene, cfg)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.is_contiguous()
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **BUILD_TOL)


def test_scene_numpy_round_trip():
    d = types.scene_to_numpy(scenes.cornell_box(cols=32, rows=24))
    back = types.scene_to_numpy(types.scene_from_numpy(d))
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    s = types.scene_from_numpy(d)
    assert s.camera.cols == 32 and s.camera.rows == 24
    assert s.to("cpu").spheres.mat_id.dtype == torch.int32


def test_auto_frame_matches_jax():
    lo, hi = [-1.0, -2.0, 0.5], [3.0, 1.0, 2.0]
    got = types.Camera.auto_frame(
        types.AABB(pmin=torch.tensor(lo), pmax=torch.tensor(hi)), 40, 30)
    want = jtypes.Camera.auto_frame(
        jtypes.AABB(pmin=jnp.asarray(lo), pmax=jnp.asarray(hi)), 40, 30)
    for name in ("eye", "u", "v", "w", "width", "height"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **BUILD_TOL)
    assert (got.cols, got.rows) == (want.cols, want.rows)


def test_tri_constants_match_jax():
    v = np.random.default_rng(5).normal(size=(16, 3, 3)).astype(np.float32)
    got = intersect.tri_constants(torch.from_numpy(v))
    want = jintersect.tri_constants(jnp.asarray(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


def test_samplers_match_jax():
    g = np.random.default_rng(11)
    u = g.uniform(size=(4096, 2)).astype(np.float32)
    u[0] = 0.0
    u[1] = (0.5, 0.25)
    n = g.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[2] = (0.0, 0.0, 1.0)
    n[3] = (0.6, 0.0, 0.8)            # tie between two min components
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        sampling.concentric_disk(torch.from_numpy(u)).numpy(),
        np.asarray(jsampling.concentric_disk(jnp.asarray(u))), **tol)
    for got, want in zip(types.tangent_frame(torch.from_numpy(n)),
                         jtypes.tangent_frame(jnp.asarray(n))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(
        sampling.cosine_hemisphere(torch.from_numpy(n),
                                   torch.from_numpy(u)).numpy(),
        np.asarray(jsampling.cosine_hemisphere(jnp.asarray(n),
                                               jnp.asarray(u))), **tol)


@pytest.mark.parametrize("lens", [0.0, 0.2])
def test_primary_rays_match_jax(lens):
    js = jscenes.cornell_box(cols=32, rows=24, lens_diameter=lens)
    ps = types.scene_from_numpy(types.scene_to_numpy(js))
    uv = np.random.default_rng(2).uniform(size=(32 * 24, 2)) \
        .astype(np.float32)
    want = jcamera.generate_primary_rays(
        js.camera, js.bounds, js.focal_length, js.lens_radius, 1,
        lens_uv=jnp.asarray(uv))
    idx = torch.arange(32 * 24)
    row, col = idx // 32, idx % 32
    fp = camera.focal_points(ps.camera, col.float(), row.float(),
                             ps.focal_length)
    got = camera.clip_to_bounds(
        camera.thin_lens_rays(ps.camera, fp, ps.lens_radius,
                              torch.from_numpy(uv)), ps.bounds)
    for name in ("o", "d", "mint", "maxt"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_copy_to_pixel_matches_jax():
    cfg = RenderConfig(width=8, height=6, spp=4)
    acc = np.random.default_rng(4).uniform(0, 3, (8 * 6 * 4, 3)) \
        .astype(np.float32)
    got = stages.copy_to_pixel(torch.from_numpy(acc), 3, cfg)
    want = jstages.copy_to_pixel(jnp.asarray(acc), jnp.int32(3),
                                 JaxConfig(width=8, height=6, spp=4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


def test_png_written_by_port_reads_back(tmp_path):
    img = np.random.default_rng(8).uniform(size=(5, 7, 3)) \
        .astype(np.float32)
    path = str(tmp_path / "x.png")
    write_png(path, torch.from_numpy(img))
    np.testing.assert_array_equal(
        read_png(path), (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))


UNSUPPORTED = {
    "grid": (dict(use_grid=True), ValueError, "accel.prepare_grids"),
    "stale_poi": (dict(replicate_stale_poi=True), NotImplementedError,
                  "stage-pipeline option.*set use_megakernel=False"),
    "rays": (dict(width=4096, height=4096), NotImplementedError,
             "stage pipeline.*set use_megakernel=False"),
    # inside the slice since the brute instances take mega_block
    "block": (dict(mega_block=8), None, None),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_supported_raises_outside_the_slice(case):
    """Outside what kernel 1 covers ``supported`` raises; a grid-mode
    render of a scene without its grids names prepare_grids; 2^24 rays or
    more name the stage pipeline, which the JAX package takes there. The
    blocked layout on brute tables is inside: ``supported`` returns True
    and the blocked image equals the row-major one (the brute instances
    keep the row-major map; tests/test_torch_direct_diff.py holds values
    and gradients)."""
    kw, exc, match = UNSUPPORTED[case]
    scene = scenes.cornell_box(cols=8, rows=8)
    cfg = RenderConfig(**{"width": 8, "height": 8, **kw})
    if exc is None:
        assert mega.supported(scene, cfg)
        one = replace(cfg, mega_block=0)
        assert torch.equal(mega.render_direct_mega(scene, cfg),
                           mega.render_direct_mega(scene, one))
        return
    with pytest.raises(exc, match=match):
        mega.supported(scene, cfg)


def test_supported_object_budget():
    """Kernel 1 keeps up to 4608 spheres resident (JAX's SMEM_TABLE_MAX //
    8) and 64 triangles; past that a table streams in Morton chunks (JAX's
    routing: triangles outside grid mode, spheres without a sphere grid,
    grid mode included) or, with a grid, is walked from global memory."""
    from raytracing_tpu_torch.accel import prepare_grids
    cfg = RenderConfig(width=8, height=8)
    gcfg = RenderConfig(width=8, height=8, use_grid=True)
    assert mega.supported(scenes.cornell_box(cols=8, rows=8), cfg)
    assert mega.supported(scenes.sphere_field(64, cols=8, rows=8), cfg)
    assert mega.supported(scenes.sphere_field(65, cols=8, rows=8), cfg)
    small = scenes.sphere_field(4608, cols=8, rows=8)
    assert mega.supported(small, cfg)
    assert mega.streamed(small, cfg) == (False, False)
    big = scenes.sphere_field(4609, cols=8, rows=8)
    for c in (cfg, gcfg):
        assert mega.supported(big, c) and mega.streamed(big, c) == (False,
                                                                    True)
    gridded = prepare_grids(big, 1)
    assert mega.supported(gridded, gcfg)
    assert mega.streamed(gridded, gcfg) == (False, False)
    v = np.random.default_rng(0).uniform(-1, 1, (65, 3, 3))
    sc = scenes.cornell_box(cols=8, rows=8)
    tris65 = types.build_scene(camera=sc.camera,
                               triangles=types.make_triangles(v),
                               lights=sc.lights, materials=sc.materials)
    assert mega.supported(tris65, cfg)
    assert mega.streamed(tris65, cfg) == (True, False)
    with pytest.raises(ValueError, match="prepare_grids"):
        mega.supported(tris65, gcfg)
    assert mega.supported(prepare_grids(tris65, 2), gcfg)
    assert mega.streamed(prepare_grids(tris65, 2), gcfg) == (False, False)


def test_wrapper_rejects_bad_arguments():
    scene = scenes.cornell_box(cols=8, rows=8)
    cfg = RenderConfig(width=8, height=8, bounces=1)
    par, sph, tri, mat, lig = mega.scene_tables(scene, cfg)
    acc = torch.zeros((64, 3))
    ipar = torch.tensor([0, 0], dtype=torch.int32)
    kw = dict(spp=1, width=8, bounces=1, two_sided=False,
              normalize_emitter=True, seed=1)
    u = torch.zeros((2 * MK.n_draws_of(1, 1), 64))
    bad = [
        dict(acc=acc.double()),
        dict(acc=torch.zeros((64, 4))),
        dict(sph=sph[:, :6].contiguous()),
        dict(tri=tri.t().contiguous().t()),
        dict(ipar=ipar.long()),
        dict(u_planes=u[:, :32].contiguous()),
    ]
    args = dict(par=par, ipar=ipar, sph=sph, tri=tri, mat=mat, lig=lig,
                acc=acc, u_planes=None)
    for change in bad:
        with pytest.raises(ValueError):
            MK.pathtrace_pass(**{**args, **change}, **kw)
    with pytest.raises(ValueError, match="one pass"):
        MK.pathtrace_pass(**{**args, "u_planes": u}, **{**kw, "n_passes": 2})
    before = MK.launches
    MK.pathtrace_pass(**args, **kw)       # CPU tensors: plain version
    assert MK.launches == before


def test_default_device(monkeypatch):
    assert default_device(cpu=True) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        default_device()


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import raytracing_tpu_torch, raytracing_tpu_torch.cli\n"
            "import raytracing_tpu_torch.render.pathtracer\n"
            "import raytracing_tpu_torch.models.scenes\n"
            "import raytracing_tpu_torch.ops.megakernel\n"
            "import raytracing_tpu_torch.ops.hit_kernels\n"
            "import raytracing_tpu_torch.ops.closest_hit\n"
            "import raytracing_tpu_torch.render.stages\n"
            "import raytracing_tpu_torch.render.direct\n"
            "import raytracing_tpu_torch.parallel.mesh\n"
            "import raytracing_tpu_torch.parallel.obj_parallel\n"
            "import raytracing_tpu_torch.parallel.scaling\n"
            "import raytracing_tpu_torch.parallel.dryrun\n"
            "import raytracing_tpu_torch.utils.runtime\n"
            "import raytracing_tpu_torch.io.mesh_json\n"
            "import raytracing_tpu_torch.io.scene_xml\n"
            "import raytracing_tpu_torch.io.png\n"
            "import raytracing_tpu_torch.core.sampling\n"
            "import raytracing_tpu_torch.render.camera\n"
            "import raytracing_tpu_torch.models.assignments\n"
            "import raytracing_tpu_torch.viewer\n"
            "import raytracing_tpu_torch.examples.smoke_render\n"
            "import raytracing_tpu_torch.examples.inverse_render\n"
            "import raytracing_tpu_torch.examples.silhouette_optim\n"
            "bad = [m for m in sys.modules if m in ('jax', 'raytracing_tpu') "
            "or m.startswith(('jax.', 'jaxlib', 'raytracing_tpu.'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)

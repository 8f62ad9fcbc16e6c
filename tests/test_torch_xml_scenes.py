"""The port's XML scenes against the JAX package: ``io/scene_xml.py``,
``models/scenes.big_mesh_scene``, ``models/assignments``' ``scene_xml=``
and the CLI's XML scenes and ``--orbit``.

Same files on both sides, written by ``tests/torch_xml_scenes.py`` (the
reference's scene and mesh files are not in the repository: tori stand in
for its meshes). Tolerances: every table, bound, mesh, ``nslabs``, focal
length and lens radius that ``load_scene`` and ``big_mesh_scene`` give
equal JAX's exactly (the camera's film width and height within one
float32 ulp: ``FILM``), and the torus written as XML equals
``torch_grid_scenes.cornell_torus`` exactly; images at rtol/atol 2e-4.
The cornell_teapot stand-in has a lens (diameter 0.01, one sample per
pixel), and the port makes the thin-lens ray in kernel 1's arithmetic
order, JAX in its own (origins 5e-10, directions 2e-7 apart at 32x24):
a shadow or bounce ray that grazes an edge then takes the other side, so
there at most 1% of pixels may pass 2e-4 (measured: 1 of 768 in direct
mode, 3 in path mode at one bounce), every other pixel within it. The
CLI's files equal the PNGs of the port's own renders byte for byte."""
import os

import jax
import numpy as np
import pytest
import torch

from raytracing_tpu.io.scene_xml import load_scene as jload_scene
from raytracing_tpu.models import assignments as JA
from raytracing_tpu.models import scenes as jscenes
from raytracing_tpu_torch import RenderConfig, cli, replace
from raytracing_tpu_torch.accel import prepare_grids
from raytracing_tpu_torch.core.types import scene_to_numpy
from raytracing_tpu_torch.io.png import encode_png, read_png
from raytracing_tpu_torch.io.scene_xml import load_scene
from raytracing_tpu_torch.models import assignments as A
from raytracing_tpu_torch.models import scenes
from raytracing_tpu_torch.render import pathtracer as pt
from torch_grid_scenes import cornell_torus, torus_arrays
from torch_threads import one_thread  # noqa: F401
from torch_xml_scenes import (cornell_arrays, cornell_teapot_xml,
                              cornell_torus_xml, house_reference_dir,
                              write_mesh_json, write_scene_xml)

W, H = 32, 24
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


# the film's size 2 tan(fov / 2) (and its width, times the aspect) is one
# float32 ulp apart in every camera of the two packages (XLA's tan against
# torch's; Camera.look_at and auto_frame, not the loaders): held at 1 ulp
FILM = ("camera.width", "camera.height")


def _same_tables(got, want, film_ulp: bool = False) -> None:
    a, b = scene_to_numpy(got), scene_to_numpy(want)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        if film_ulp and k in FILM:
            assert abs(np.int64(a[k].view(np.int32))
                       - np.int64(b[k].view(np.int32))) <= 1, k
            continue
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _point_lights_xml(root: str) -> str:
    """Assign08-era point lights (only <position>) over cornell's walls
    and spheres, no meshes."""
    c = cornell_arrays()
    names = [f"m{i}" for i in range(c["materials"].shape[0])]
    return write_scene_xml(
        os.path.join(root, "scenes", "cornell.xml"),
        eye=(0.0, 0.0, 2.6), lookat=(0.0, -0.1, 0.0), vup=(0.0, 1.0, 0.0),
        fov=60.0, focal_length=2.8, lens_diameter=0.0,
        lights=[{"position": (0.0, 0.85, 0.0)},
                {"position": (-0.5, 0.8, 0.4)}],
        materials=list(zip(names, c["materials"])),
        spheres=[(c["sph_c"][i], c["sph_r"][i], names[c["sph_m"][i]])
                 for i in range(2)],
        triangles=[(c["v"][i], c["vn"][i], names[c["tri_mat"][i]])
                   for i in range(10)])


def _no_spheres_xml(root: str) -> str:
    """Walls and a mesh, no spheres, no lights, a nodes-free mesh file."""
    c = cornell_arrays()
    write_mesh_json(os.path.join(root, "tri", "ring.json"),
                    *torus_arrays(6, 3))
    return write_scene_xml(
        os.path.join(root, "scenes", "bare.xml"), eye=(0.5, 0.3, 3.0),
        lookat=(0.0, 0.0, 0.0), vup=(0.0, 1.0, 0.0), fov=45.0,
        focal_length=1.5, lens_diameter=0.2, lights=[],
        materials=[("white", (1, 1, 1, 1)), ("ring", (0.3, 0.6, 0.9, 1))],
        triangles=[(c["v"][i], c["vn"][i], "white") for i in range(10)],
        meshes=[{"file": "./tri/ring.json", "nslabs": 4, "normalize": "yes",
                 "scale": (0.5, 0.8, 0.5), "translate": (0.1, -0.2, 0.3),
                 "mat": "ring"}])


def _mesh_only_xml(root: str) -> str:
    """A mesh and one disk light, no spheres, no triangles."""
    write_mesh_json(os.path.join(root, "scenes", "tri", "knot.json"),
                    *torus_arrays(9, 4))
    return write_scene_xml(
        os.path.join(root, "scenes", "mesh_only.xml"), eye=(0.0, 0.0, 3.0),
        lookat=(0.0, 0.2, -0.3), vup=(0.0, 1.0, 0.0), fov=60.0,
        focal_length=1.0, lens_diameter=0.0,
        lights=[{"position": (0.0, 2.0, 0.0), "normal": (0.0, -1.0, 0.0),
                 "irradiance": (3.0, 3.0, 3.0), "radius": 0.5}],
        materials=[("knot", (0.8, 0.4, 0.2, 1.0))],
        meshes=[{"file": "./tri/knot.json", "nslabs": 2, "normalize": "no",
                 "scale": (1.0, 1.0, 1.0), "translate": (0.0, 0.0, 0.0),
                 "mat": "knot"}])


SCENES = {"cornell_teapot": cornell_teapot_xml, "torus": cornell_torus_xml,
          "point_lights": _point_lights_xml, "no_spheres": _no_spheres_xml,
          "mesh_only": _mesh_only_xml}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_load_scene_matches_jax(tmp_path, name):
    path = SCENES[name](str(tmp_path))
    got, want = load_scene(path, W, H, "cpu"), jload_scene(path, W, H)
    _same_tables(got, want, film_ulp=True)
    assert [m.nslabs for m in got.meshes] == [m.nslabs for m in want.meshes]
    assert got.focal_length.item() == float(want.focal_length)
    assert got.lens_radius.item() == float(want.lens_radius)
    if name == "cornell_teapot":   # the schema of the reference's file
        assert (got.spheres.count, got.triangles.count, got.lights.count,
                got.materials.shape[0]) == (1, 10, 1, 8)
        assert [m.tris.count for m in got.meshes] == [992, 20]
        assert [m.nslabs for m in got.meshes] == [10, 5]
        span = got.meshes[0].bounds_max - got.meshes[0].bounds_min
        assert abs(span.max().item() - 0.7) < 1e-6
    if name == "point_lights":     # radius, normal, irradiance defaults
        assert got.lights.radius.tolist() == [0.0, 0.0]
        assert got.lights.irradiance.tolist() == [[1.0] * 3] * 2
    if name == "no_spheres":
        assert got.spheres.count == 0 and got.lights.count == 0


def test_load_scene_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_scene(cornell_torus_xml(str(tmp_path)), W, H)


def test_torus_xml_equals_cornell_torus(tmp_path):
    """The torus scene written as XML and JSON (floats as the repr of their
    float32 values) is cornell_torus element for element, before and
    after prepare_grids("auto", mesh_slabs="auto")."""
    path = cornell_torus_xml(str(tmp_path), 31, 16)
    got, want = load_scene(path, W, H, "cpu"), cornell_torus(W, H, 31, 16,
                                                              device="cpu")
    _same_tables(got, want)
    _same_tables(prepare_grids(got, "auto", mesh_slabs="auto"),
                 prepare_grids(want, "auto", mesh_slabs="auto"))


def test_big_mesh_scene_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("RT_REFERENCE_DIR", str(tmp_path))
    monkeypatch.setattr(JA, "REF_ROOT", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        scenes.big_mesh_scene(cols=W, rows=H, device="cpu")
    with pytest.raises(FileNotFoundError):
        jscenes.big_mesh_scene(cols=W, rows=H)
    house_reference_dir(str(tmp_path))
    got = scenes.big_mesh_scene(cols=W, rows=H, device="cpu")
    _same_tables(got, jscenes.big_mesh_scene(cols=W, rows=H), film_ulp=True)
    assert got.triangles.count == 5312 and got.spheres.count == 0
    span = (got.bounds_max - got.bounds_min).max().item()
    assert abs(span - 1.0) < 1e-6           # normalised to the unit cube


def _image_close(got, want, lens: bool) -> None:
    err = np.abs(got - want)
    beyond = (err > TOL + TOL * np.abs(want)).any(-1)
    assert beyond.mean() <= (0.01 if lens else 0.0), beyond.sum()


CASES = {"assign07-torus": ("assign07", cornell_torus_xml,
                            dict(n_slabs=2, mesh_slabs="auto")),
         "assign07-teapot": ("assign07", cornell_teapot_xml,
                             dict(n_slabs=3, mesh_slabs="auto")),
         "assign08-reference": ("assign08", _point_lights_xml, {}),
         "assign10-teapot": ("assign10", cornell_teapot_xml,
                             dict(passes=1, bounces=1))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_assignment_xml_matches_jax(tmp_path, monkeypatch, case):
    """assign07 (kernel 1's grid mode, its plain version here), assign08
    (direct mode; the reference's cornell.xml, found through
    RT_REFERENCE_DIR) and assign10 (path mode) on XML scenes."""
    name, write, kw = CASES[case]
    path = write(str(tmp_path))
    if case == "assign08-reference":
        ref = tmp_path / "ref" / "Assign08-Shadow_Tracing" / "scenes"
        ref.mkdir(parents=True)
        os.replace(path, ref / "cornell.xml")
        monkeypatch.setenv("RT_REFERENCE_DIR", str(tmp_path / "ref"))
        monkeypatch.setattr(JA, "REF_ROOT", str(tmp_path / "ref"))
    else:
        kw = dict(kw, scene_xml=path)
    fn, args, cfg = getattr(A, name)(W, H, device="cpu", **kw)
    if name == "assign07":
        assert cfg.use_grid and cfg.use_megakernel and cfg.mega_block == 64
        assert args[0].folded_tri_grid is not None
    if name == "assign08":
        assert args[0].lights.count == 2     # the XML's, not cornell's
    got = fn(*args).numpy()
    assert got.shape == (H, W, 3) and np.isfinite(got).all() and got.max() > 0
    jfn, jargs, _ = getattr(JA, name)(W, H, **kw)
    _image_close(got, np.asarray(jfn(*jargs)), "teapot" in case)


def test_cli_renders_xml_scenes_and_orbits(tmp_path, capsys):
    """--scene X.xml --grid N renders what load_scene, prepare_grids and
    render_passes give; --orbit 2 writes two frames, each render_passes of
    a fresh state with the camera orbited by 360 f / 2 degrees."""
    path = cornell_torus_xml(str(tmp_path))
    out = str(tmp_path / "x.png")
    base = ["--cpu", "--scene", path, "--width", "16", "--height", "12",
            "--passes", "2", "--bounces", "1"]
    assert cli.main(base + ["--grid", "2", "--block", "4", "-o", out]) == 0
    printed = capsys.readouterr().out
    assert "mesh_triangles: 128" in printed and "meshes: 1" in printed
    cfg = RenderConfig(width=16, height=12, bounces=1, use_grid=True,
                       n_slabs=2, use_megakernel=True, mega_block=4)
    scene = prepare_grids(load_scene(path, 16, 12, "cpu"), 2,
                          mesh_slabs="auto")
    state = pt.render_passes(scene, pt.init_state(cfg, "cpu"), cfg, 2)
    assert open(out, "rb").read() == encode_png(pt.image(state, cfg))

    orbit = str(tmp_path / "o.png")
    assert cli.main(base + ["--orbit", "2", "-o", orbit]) == 0
    cfg = RenderConfig(width=16, height=12, bounces=1, use_megakernel=True)
    scene = load_scene(path, 16, 12, "cpu")
    frames = []
    for f in range(2):
        cam = scene.camera.orbit(scene.bounds, 180.0 * f)
        state = pt.render_passes(replace(scene, camera=cam),
                                 pt.init_state(cfg, "cpu"), cfg, 2)
        frame = str(tmp_path / f"o_frame{f:03d}.png")
        assert open(frame, "rb").read() == encode_png(pt.image(state, cfg))
        frames.append(read_png(frame))
    assert frames[0].shape == (12, 16, 3)
    assert not np.array_equal(frames[0], frames[1])

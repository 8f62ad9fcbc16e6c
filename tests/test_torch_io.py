"""The port's readers and small functions against the JAX package: the
mesh JSON parser and its transforms (``io/mesh_json.py``), the PNG reader
and tonemap (``io/png.py``), ``core/sampling.distort`` and
``stratified_lens_coords``, and ``render/camera.parallel_rays``.

Same inputs on both sides (inline JSON, PNGs encoded here with each of the
five scanline filters, seeded numpy arrays). Tolerances: the parser, the
transforms, the PNG reader and the tonemap equal JAX's exactly (field for
field); the lens coordinates, the distort map and the parallel rays
within 1e-7 (``stratified_lens_coords`` is the kernel's (j + 0.5) / k,
JAX's (j + 0.5) * (1 / k), one rounding apart)."""
import json
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_tpu.core import sampling as jsampling
from raytracing_tpu.core import types as jtypes
from raytracing_tpu.io import mesh_json as JMJ
from raytracing_tpu.io import png as jpng
from raytracing_tpu.render import camera as jcamera
from raytracing_tpu_torch.core import sampling
from raytracing_tpu_torch.core.types import Camera
from raytracing_tpu_torch.io import mesh_json as MJ
from raytracing_tpu_torch.io import png
from raytracing_tpu_torch.render import camera
from torch_threads import one_thread  # noqa: F401

QUAD = """{
  "meshes": [{
    "materialIndex": 0,
    "vertexPositions": [0,0,0, 1,0,0, 0,1,0, 1,1,0],
    "vertexNormals":   [0,0,1, 0,0,1, 0,0,1, 0,0,1],
    "indices": [0,1,2, 2,1,3]
  }],
  "materials": [{"diffuseReflectance": [0.5, 0.6, 0.7, 1.0]}]
}"""


def _nodes_doc() -> str:
    """Two meshes under two nodes: a rotated, scaled, translated
    column-major modelMatrix (non-uniform scale, so the normal matrix is
    not the model matrix), texture coordinates on one mesh only, and two
    materials."""
    g = np.random.default_rng(11)
    vp = g.uniform(-1, 1, (6, 3)).round(4)
    vn = g.normal(size=(6, 3)).round(4)
    c, s = np.cos(0.7), np.sin(0.7)
    m = np.array([[c, 0, s, 0.3], [0, 2.0, 0, -0.2], [-s, 0, c, 1.5],
                  [0, 0, 0, 1]])
    return json.dumps({
        "meshes": [
            {"materialIndex": 1, "vertexPositions": vp.ravel().tolist(),
             "vertexNormals": vn.ravel().tolist(),
             "vertexTexCoordinates": [g.uniform(0, 1, 12).tolist()],
             "indices": [0, 1, 2, 3, 4, 5, 5, 1, 0]},
            {"vertexPositions": vp[::-1].ravel().tolist(),
             "vertexNormals": vn[::-1].ravel().tolist()}],
        "nodes": [{"modelMatrix": m.T.ravel().tolist(), "meshIndices": [0]},
                  {"modelMatrix": np.eye(4).ravel().tolist(),
                   "meshIndices": [1, 0]}],
        "materials": [{"diffuseReflectance": [0.1, 0.2, 0.3, 1.0]},
                      {"diffuseReflectance": [0.9, 0.8, 0.7, 0.5]}]})


def _unindexed_doc() -> str:
    """An unindexed mesh (three vertices per face) and no materials."""
    g = np.random.default_rng(12)
    return json.dumps({"meshes": [{
        "vertexPositions": g.uniform(-2, 2, 27).tolist(),
        "vertexNormals": g.normal(size=27).tolist()}]})


DOCS = {"quad": QUAD, "nodes": _nodes_doc(), "unindexed": _unindexed_doc(),
        "empty": json.dumps({"meshes": []})}


def _equal(got, want) -> None:
    for f in ("n_triangles", "positions", "normals", "material_indices",
              "materials", "tcoords", "bounds_min", "bounds_max"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("doc", sorted(DOCS))
def test_parse_mesh_json_matches_jax(doc):
    got, want = MJ.parse_mesh_json(DOCS[doc]), JMJ.parse_mesh_json(DOCS[doc])
    _equal(got, want)
    if doc == "empty":
        assert got.n_triangles == 0 and np.isinf(got.bounds_min).all()
        np.testing.assert_array_equal(got.materials, np.ones((1, 4)))
        return
    _equal(MJ.normalize_unit_cube(got), JMJ.normalize_unit_cube(want))
    _equal(MJ.scale(got, 0.7, 0.3, 1.5), JMJ.scale(want, 0.7, 0.3, 1.5))
    _equal(MJ.translate(got, -0.25, 0.5, 2.0),
           JMJ.translate(want, -0.25, 0.5, 2.0))


def test_load_mesh_json_matches_jax(tmp_path):
    path = tmp_path / "m.json"
    path.write_text(DOCS["nodes"])
    _equal(MJ.load_mesh_json(str(path)), JMJ.load_mesh_json(str(path)))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _encode(img: np.ndarray, filters) -> bytes:
    """A PNG of (H, W, C) uint8 whose row y uses filter filters[y % len]."""
    h, w, c = img.shape
    nch, stride = c, w * c
    rows = img.reshape(h, stride).astype(np.int64)
    raw = b""
    for y in range(h):
        ft = filters[y % len(filters)]
        cur, prev = rows[y], rows[y - 1] if y else np.zeros(stride, np.int64)
        out = []
        for x in range(stride):
            a = int(cur[x - nch]) if x >= nch else 0
            b = int(prev[x])
            cc = int(prev[x - nch]) if x >= nch else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[ft]
            out.append((int(cur[x]) - pred) & 0xFF)
        raw += bytes([ft]) + bytes(out)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_read_png_matches_jax(tmp_path, channels, filters):
    img = np.random.default_rng(channels).integers(
        0, 256, (7, 9, channels)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, filters))
    got, want = png.read_png(str(path)), jpng.read_png(str(path))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


def test_write_then_read_png(tmp_path):
    img = torch.rand((12, 10, 3), generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), jpng.read_png(path))
    assert png.read_png(path).shape == (12, 10, 3)


def test_tonemap_u8_matches_jax():
    acc = np.random.default_rng(4).uniform(0, 40, (64, 3)).astype(np.float32)
    for divisor, exposure in ((16.0, 1.8), (1.0, 1.0), (0.0, 2.0)):
        want = jpng.tonemap_u8(acc, divisor, exposure)
        np.testing.assert_array_equal(
            png.tonemap_u8(acc, divisor, exposure), want)
        np.testing.assert_array_equal(
            png.tonemap_u8(torch.as_tensor(acc), divisor, exposure), want)


def test_distort_matches_jax():
    u = np.random.default_rng(5).uniform(0, 1, (50, 2)).astype(np.float32)
    u[:3] = [[0, 0], [0, 0.5], [0.25, 0]]           # (0, 0) stays pinned
    got = sampling.distort(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsampling.distort(
        jnp.asarray(u))), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[0], [0, 0])


@pytest.mark.parametrize("spp", [1, 4, 9, 16])
def test_stratified_lens_coords_matches_jax(spp):
    got = sampling.stratified_lens_coords(spp).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jsampling.stratified_lens_coords(spp)), rtol=0,
        atol=1e-7)
    # one implementation: the kernel's lens cells of a pixel's sub-rays
    np.testing.assert_array_equal(
        got, camera.stratified_lens_uv(torch.arange(spp), spp).numpy())
    with pytest.raises(ValueError, match="perfect square"):
        sampling.stratified_lens_coords(spp + 1 if spp > 1 else 2)


def test_parallel_rays_matches_jax():
    args = ([0.3, 0.2, 2.5], [0.0, -0.1, 0.0], [0.0, 1.0, 0.0], 50.0, 20, 14)
    cam, jcam = Camera.look_at(*args), jtypes.Camera.look_at(*args)
    col, row = camera.pixel_grid(cam)
    got = camera.parallel_rays(cam, col, row)
    want = jcamera.parallel_rays(jcam, *jcamera.pixel_grid(jcam))
    for f in ("o", "d", "mint", "maxt"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-7, err_msg=f)

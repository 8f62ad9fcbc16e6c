"""The port's live viewer (``viewer.py``) on the CPU at 32x24, one bounce:
the page's controls, progressive accumulation and reset, the direct and
fake-shade renderers, the orbit, the HTTP surface on port 0, the engine
label and device list, the background loop, an XML scene, and a path
step's image against the JAX package's ``RenderSession.step`` at
rtol/atol 2e-4 (the same draws: kernel 1's plain version here, JAX's
interpret-mode kernel there)."""
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from raytracing_tpu import viewer as jviewer
from raytracing_tpu_torch import viewer
from raytracing_tpu_torch.io.png import read_png
from raytracing_tpu_torch.render import mega
from torch_threads import one_thread  # noqa: F401
from torch_xml_scenes import cornell_torus_xml

W, H = 32, 24
TOL = 2e-4
PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _session(**kw):
    return viewer.RenderSession(width=W, height=H, bounces=1,
                                chunk_passes=1, device="cpu", **kw)


def _png_image(data: bytes) -> np.ndarray:
    fd, path = tempfile.mkstemp(suffix=".png")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        return read_png(path)
    finally:
        os.remove(path)


def test_viewer_page_has_the_controls():
    for needle in ['id="device"', 'id="scene"', 'id="renderer"',
                   'id="sqspp"', 'id="focal"', 'id="lens"', 'id="orbit"',
                   'id="start"', 'id="stop"', "<canvas"]:
        assert needle in viewer.INDEX_HTML


def test_viewer_accumulates_and_resets():
    s = _session()
    s.step(n_passes=2)
    assert s.status()["passes"] == 2
    assert s.frame_png()[:8] == PNG
    f0 = s.status()["frame"]
    s.step(n_passes=1)                     # same settings: accumulates
    assert s.status()["passes"] == 3 and s.status()["frame"] == f0 + 1
    s.step(n_passes=1, spp=4)              # changed settings: reset
    assert s.status()["passes"] == 1


def test_viewer_path_step_matches_jax():
    """One path-mode step of the port's session against JAX's session's:
    cornell with grids prepared ("auto"), kernel 1's route, same seed."""
    s, js = _session(), jviewer.RenderSession(width=W, height=H, bounces=1,
                                              chunk_passes=1)
    s.step(n_passes=1)
    js.step(n_passes=1)
    assert s.status()["engine"] == js.status()["engine"] == "megakernel"
    got = s._img.numpy()
    assert got.shape == (H, W, 3) and got.max() > 0
    np.testing.assert_allclose(got, np.asarray(js._img), rtol=TOL, atol=TOL)


def test_viewer_direct_fake_and_focus():
    s = _session()
    s.step(renderer="direct", n_passes=2)
    assert s.status()["passes"] == 2 and s.status()["engine"] == "megakernel"
    direct = s._img.clone()
    s.step(renderer="direct", n_passes=1, focal=2.0, lens=0.3)
    assert s.status()["passes"] == 1       # focus changed: reset
    assert not torch.equal(s._img, direct)
    s.step(renderer="fake", n_passes=1)
    assert s.status()["engine"] == "pytorch"   # no kernel: named as such
    assert s._img.shape == (H, W, 3) and s._img.max() > 0
    assert _png_image(s.frame_png()).shape == (H, W, 3)


def test_viewer_orbit_moves_the_camera():
    s = _session()
    s.step(n_passes=1, orbit=True)
    a = s._img.clone()
    s.step(n_passes=1, orbit=True)         # each chunk restarts
    assert s.status()["passes"] == 1 and s._angle == 6.0
    assert not torch.equal(a, s._img)


def test_viewer_engine_label_never_names_a_route_not_taken(monkeypatch):
    """The label comes from kernel 1's own check (render.mega.supported),
    which raises where kernel 1 cannot render: the step raises too."""
    s = _session()
    assert s.devices() == ["[0] cpu: cpu"]
    assert s.status()["device"] == "cpu" and s.status()["engine"] == "?"

    def refuse(scene, cfg):
        raise NotImplementedError("not on kernel 1")
    monkeypatch.setattr(mega, "supported", refuse)
    with pytest.raises(NotImplementedError):
        s.step(n_passes=1)
    assert s.status()["engine"] == "?" and s.status()["passes"] == 0


def test_viewer_raises_on_a_scene_it_cannot_load(tmp_path, monkeypatch):
    """A step raises; in the loop the raise ends the loop, and the status
    says it stopped."""
    s = _session(scenes={"cornell": None, "gone": str(tmp_path / "x.xml")})
    with pytest.raises(FileNotFoundError):
        s.step(scene="gone")
    raised = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda a: raised.append(a.exc_type))
    s.start(scene="gone", renderer="path", spp=1)
    s._thread.join(timeout=60)
    assert not s._thread.is_alive() and raised == [FileNotFoundError]
    assert not s.status()["running"] and s.status()["passes"] == 0
    s.stop()


def test_viewer_http_surface_and_loop(tmp_path):
    """/, /scenes, /devices, /status and /frame.png on port 0; /start runs
    the loop on an XML scene (kernel 1's grid mode over the torus) until
    /stop."""
    xml = cornell_torus_xml(str(tmp_path))
    s = _session(scenes={"cornell": None, "spheres": None, "torus": xml})
    srv = viewer.make_server(s, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        return urllib.request.urlopen(base + path, timeout=60).read()
    try:
        assert b"<canvas" in get("/")
        assert json.loads(get("/scenes")) == ["cornell", "spheres", "torus"]
        assert json.loads(get("/devices")) == ["[0] cpu: cpu"]
        with pytest.raises(urllib.error.HTTPError, match="404"):
            get("/frame.png")              # no frame yet: 404
        assert get("/start?scene=torus&renderer=path&sqspp=1") == b"started"
        deadline = time.time() + 120
        while json.loads(get("/status"))["passes"] < 2:
            assert time.time() < deadline, "the loop made no passes"
            time.sleep(0.05)
        st = json.loads(get("/status"))
        assert st["running"] and st["engine"] == "megakernel"
        assert st["device"] == "cpu" and st["msegs_per_s"] >= 0.0
        png = get("/frame.png")
        assert png[:8] == PNG and _png_image(png).shape == (H, W, 3)
        assert get("/stop") == b"stopped"
        assert not json.loads(get("/status"))["running"]
        assert s._scene_cache[("torus", "cpu")].folded_tri_grid is not None
    finally:
        s.stop()
        srv.shutdown()
        srv.server_close()

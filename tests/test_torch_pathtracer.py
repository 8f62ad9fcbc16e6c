"""The port's entry points against the JAX package: the Pallas kernel in
interpret mode, ``pathtracer.render``, npz checkpoints both ways, and the
CLI."""
import numpy as np
import pytest
import torch

from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.io.png import read_png
from raytracing_tpu.models.scenes import cornell_box
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu.render.mega import render_pass_mega, u_planes_for_pass
from raytracing_tpu_torch import RenderConfig, cli
from raytracing_tpu_torch.core.types import scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.ops import megakernel as MK
from raytracing_tpu_torch.render import pathtracer as pt
from torch_threads import one_thread  # noqa: F401

W, H = 32, 24


@pytest.fixture(scope="module")
def scenes():
    js = cornell_box(cols=W, rows=H)
    return js, scene_from_numpy(scene_to_numpy(js))


def test_plain_pass_matches_jax_kernel_interpret(scenes):
    """The JAX Pallas kernel itself (interpret mode) and the port's pass,
    same draws: the JAX kernel's tolerance against its own oracle."""
    js, ps = scenes
    jcfg = JaxConfig(width=W, height=H, bounces=1)
    st = jpt.init_state(jcfg)
    u = u_planes_for_pass(st["key"], st["passes"], jcfg, 1)
    want = np.asarray(render_pass_mega(js, st, jcfg, u_planes=u,
                                       interpret=True)["acc"])
    cfg = RenderConfig(width=W, height=H, bounces=1, use_megakernel=True)
    got = pt.render_pass(ps, pt.init_state(cfg, "cpu"), cfg)["acc"].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_render_matches_jax_render(scenes):
    js, ps = scenes
    kw = dict(width=W, height=H, bounces=2)
    want = np.asarray(jpt.render(js, JaxConfig(**kw), n_passes=3))
    before = MK.launches
    got = pt.render(ps, RenderConfig(use_megakernel=True, **kw), n_passes=3)
    assert MK.launches == before        # CPU tensors: no kernel launch
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def _jax_state(js, cfg, n):
    st = jpt.init_state(cfg)
    for _ in range(n):
        st = jpt._render_pass(js, st, cfg)
    return st


def test_jax_checkpoint_resumes_in_port(scenes, tmp_path):
    js, ps = scenes
    jcfg = JaxConfig(width=W, height=H, bounces=1)
    path = str(tmp_path / "jax.npz")
    jpt.save_checkpoint(path, _jax_state(js, jcfg, 1))
    cfg = RenderConfig(width=W, height=H, bounces=1, use_megakernel=True)
    st = pt.load_checkpoint(path, "cpu")
    assert st["passes"] == 1
    st = pt.render_pass(ps, st, cfg)
    want = np.asarray(_jax_state(js, jcfg, 2)["acc"])
    np.testing.assert_allclose(st["acc"].numpy(), want, rtol=5e-4, atol=5e-4)


def test_port_checkpoint_resumes_in_jax(scenes, tmp_path):
    js, ps = scenes
    cfg = RenderConfig(width=W, height=H, bounces=1, use_megakernel=True)
    path = str(tmp_path / "port.npz")
    pt.save_checkpoint(path, pt.render_pass(ps, pt.init_state(cfg, "cpu"),
                                            cfg))
    jcfg = JaxConfig(width=W, height=H, bounces=1)
    st = jpt._render_pass(js, jpt.load_checkpoint(path), jcfg)
    assert int(st["passes"]) == 2
    want = np.asarray(_jax_state(js, jcfg, 2)["acc"])
    np.testing.assert_allclose(np.asarray(st["acc"]), want,
                               rtol=5e-4, atol=5e-4)


def test_cli_writes_png_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "x.png")
    args = ["--cpu", "--scene", "cornell", "--width", str(W), "--height",
            str(H), "--passes", "2", "--bounces", "1", "-o", out]
    assert cli.main(args) == 0
    img = read_png(out)
    assert img.shape == (H, W, 3) and img.max() > 0
    assert cli.main(args + ["--resume"]) == 0
    st = pt.load_checkpoint(out + ".ckpt.npz", "cpu")
    assert st["passes"] == 4
    assert "wrote" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--scene", "room.xml"],
                                  ["--grid", "2", "--scene", "room.xml"],
                                  ["--orbit", "2", "--scene", "room"]])
def test_cli_rejects_what_is_not_ported(flag):
    """XML scenes and the orbit animation are ported
    (tests/test_torch_xml_scenes.py); what the CLI still rejects is a
    scene it does not have: an XML file that is not there
    (FileNotFoundError, as the JAX CLI raises), a builtin name it does not
    know (SystemExit)."""
    with pytest.raises((FileNotFoundError, SystemExit), match="room"):
        cli.main(["--cpu", "--width", "8", "--height", "8", *flag])

"""The port's sharding (``raytracing_tpu_torch/parallel/``) and
``utils/runtime`` against the single-process port and the JAX package.

Each group of gloo ranks (2 and 4) is spawned once per module
(``parallel.mesh.spawn`` over a ``file://`` store under pytest's temporary
directory, so xdist workers never race for a port) and runs every case of
``tests/torch_parallel_cases.py``; the tests read its results.

Tolerances: a sharded render keys every ray by its global id, so the
gathered accumulator equals the single-process render element for element
(both routes, even, uneven and padded films); against JAX's
``pathtracer.render_passes`` on the same scene, 2e-4 as
``tests/test_torch_megakernel.py`` holds the port. Train-step losses and
cotangents equal the single-process port's to rtol 1e-5, with atol 1e-6 x
each group's largest entry: the ranks' float32 cotangents are summed by
the all-reduce in another order than one process sums them (measured
<= 2e-7 of the largest entry). The stage route's against JAX's
``make_train_step(make_mesh(1), cfg)``: the loss to 1e-5, the cotangents to
``tests/test_torch_stages.py``'s tolerance (rtol 5e-3, atol 5e-3 x the
largest entry). The object-sharded search: idx, validity and t exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as C
from raytracing_tpu import RenderConfig as JaxConfig
from raytracing_tpu.models.scenes import cornell_box as jax_cornell_box
from raytracing_tpu.models.scenes import sphere_field as jax_sphere_field
from raytracing_tpu.parallel import mesh as jpm
from raytracing_tpu.render import pathtracer as jpt
from raytracing_tpu_torch import RenderConfig
from raytracing_tpu_torch.core.types import map_tensors, replace, \
    scene_from_numpy, scene_to_numpy
from raytracing_tpu_torch.ops.closest_hit import closest_hit_spheres
from raytracing_tpu_torch.parallel import mesh as pm
from raytracing_tpu_torch.parallel import scaling
from raytracing_tpu_torch.parallel.dryrun import dryrun_multichip
from raytracing_tpu_torch.render import mega
from raytracing_tpu_torch.render import pathtracer as pt
from raytracing_tpu_torch.utils import runtime
from torch_threads import one_thread  # noqa: F401

TOL = 2e-4
WORLDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def partitionable_threefry():
    """The port reproduces the draws of the partitionable threefry layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _jax_scene(fields: dict):
    return jax_cornell_box(cols=fields["width"], rows=fields["height"])


def _port_scene(fields: dict):
    return scene_from_numpy(scene_to_numpy(_jax_scene(fields)))


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{world size: rank 0's results}; the 4-rank group also loads the
    checkpoint the 2-rank group wrote."""
    arrays = {k: scene_to_numpy(_jax_scene(f))
              for d in (C.RENDERS, C.STEPS, C.CUSTOM) for k, f in d.items()}
    out, ckpt = {}, None
    for n in WORLDS:
        d = tmp_path_factory.mktemp(f"group{n}")
        out[n] = pm.spawn(C.run_cases, n, arrays, str(d), ckpt, cpu=True,
                          store_dir=str(d), timeout=600)[0]
        ckpt = str(d / f"ckpt{n}")
    return out


def _single_render(fields: dict) -> np.ndarray:
    cfg = RenderConfig(**fields)
    st = pt.render_passes(_port_scene(fields), pt.init_state(cfg, "cpu"),
                          cfg, C.RENDER_PASSES)
    return st["acc"].numpy()


def _single_step(fields: dict, loss=None):
    """(loss, grads, acc) of one step of the single-process port: the pass,
    the image, the loss and autograd, no mesh."""
    cfg = RenderConfig(**fields)
    scene = _port_scene(fields)
    if loss is None:
        params, fn, apply = (C.default_params(scene), pm._l2,
                             pm.apply_default_params)
    else:
        fn, apply = C.LOSSES[loss]
        params = C.custom_params(scene)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    st = pt.render_pass(apply(scene, leaves), pt.init_state(cfg, "cpu"), cfg)
    value = fn(pt.image(st, cfg), torch.zeros((cfg.height, cfg.width, 3)))
    grads = torch.autograd.grad(value, list(leaves.values()),
                                allow_unused=True, materialize_grads=True)
    return (value.item(), {k: g.numpy() for k, g in zip(leaves, grads)},
            st["acc"].detach().numpy())


def _hold_grads(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(C.RENDERS))
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_render_equals_single_process(groups, n, name):
    np.testing.assert_array_equal(groups[n]["renders"][name],
                                  _single_render(C.RENDERS[name]))


@pytest.mark.parametrize("name", [k for k in C.RENDERS
                                  if "uneven" not in k])
def test_sharded_render_matches_jax_render_passes(groups, name):
    fields = C.RENDERS[name]
    jcfg = JaxConfig(**{k: v for k, v in fields.items()
                        if k not in ("use_megakernel", "use_pallas")})
    want = np.asarray(jpt.render_passes(_jax_scene(fields),
                                        jpt.init_state(jcfg), jcfg,
                                        C.RENDER_PASSES)["acc"])
    for n in WORLDS:
        np.testing.assert_allclose(groups[n]["renders"][name], want,
                                   rtol=TOL, atol=TOL, err_msg=str(n))


@pytest.mark.parametrize("name", list(C.STEPS))
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_train_step_equals_single_process(groups, n, name):
    got = groups[n]["steps"][name]
    value, grads, acc = _single_step(C.STEPS[name])
    np.testing.assert_allclose(got["loss"], value, rtol=1e-5)
    np.testing.assert_array_equal(got["acc"], acc)
    assert got["passes"] == 1
    _hold_grads(got["grads"], grads)


@pytest.mark.parametrize("name", list(C.CUSTOM))
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_train_step_custom_loss_and_params(groups, n, name):
    """A loss and a parameterization of the caller's (JAX's light
    irradiance with L1, and a loss of every pixel against the image's
    mean, which no ray's rows decide alone) give the single-process
    gradient."""
    got = groups[n]["custom"][name]
    value, grads, _ = _single_step(C.CUSTOM[name], loss=name)
    np.testing.assert_allclose(got["loss"], value, rtol=1e-5)
    _hold_grads(got["grads"], grads)
    assert np.isfinite(got["grads"]["irradiance"]).all()


def test_sharded_stage_step_matches_jax_make_train_step(groups):
    fields = C.STEPS["stage"]
    jcfg = JaxConfig(width=fields["width"], height=fields["height"],
                     bounces=fields["bounces"], seed=fields["seed"])
    js = _jax_scene(fields)
    m1 = jpm.make_mesh(1)
    params = {"center": js.spheres.center, "radius": js.spheres.radius,
              "materials": js.materials}
    (loss, _), grads = jpm.make_train_step(m1, jcfg)(
        params, js, jpm.shard_state(jpt.init_state(jcfg), m1),
        jnp.zeros((jcfg.height, jcfg.width, 3)))
    for n in WORLDS:
        got = groups[n]["steps"]["stage"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        for k in C.PARAMS:
            a = np.asarray(grads[k])
            assert np.abs(a).max() > 0, k
            np.testing.assert_allclose(got["grads"][k], a, rtol=5e-3,
                                       atol=5e-3 * np.abs(a).max(),
                                       err_msg=f"{n} {k}")


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_shapes_and_ray_slices_on_ranks(groups, n):
    res = groups[n]
    assert res["mesh"] == ((n,), ("rays",))
    assert res["searches"][2]["mesh"] == ((n // 2, 2), ("rays", "obj"))
    # ceil(525 / n) rays per rank, consecutive; the last slice padded
    local = -(-525 // n)
    assert [r["slice"] for r in res["ranks"]] == [(i * local, local)
                                                  for i in range(n)]
    assert [d["rank"] for d in res["devices"]] == list(range(n))
    assert all(d["platform"] == "cpu" for d in res["devices"])


@pytest.mark.parametrize("n", WORLDS)
def test_objsharded_search_equals_unsharded(groups, n):
    rays, spheres = C.search_inputs()
    want = closest_hit_spheres(rays, spheres, use_pallas=True)
    # every hit ties with its copy in the other half: the lower index wins
    assert want.valid.sum() > 0 and (want.idx < spheres.count // 2).all()
    for obj, got in groups[n]["searches"].items():
        assert got["mesh"][0] == (n // obj, obj)
        np.testing.assert_array_equal(got["valid"], want.valid.numpy())
        np.testing.assert_array_equal(got["idx"], want.idx.numpy())
        np.testing.assert_array_equal(got["t"], want.t.numpy())


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_checkpoint_round_trip(groups, n):
    c = groups[n]["checkpoint"]
    np.testing.assert_array_equal(c["loaded"], c["saved"])
    np.testing.assert_array_equal(c["on"], c["on_saved"])
    assert c["passes"] == 1 and list(c["key"]) == [0, 4]
    assert np.abs(c["saved"]).max() > 0


def test_sharded_checkpoint_loads_on_another_mesh(groups):
    """The 4-rank group reads the 2-rank group's checkpoint: rows go to
    their new ranks by the film's offsets."""
    c = groups[4]["checkpoint"]
    np.testing.assert_array_equal(c["other"], groups[2]["checkpoint"]
                                  ["saved"])
    assert c["other_passes"] == 1


def test_dryrun_multichip_two_ranks():
    out = dryrun_multichip(2)
    assert set(out) == {"stage", "pallas", "cell", "rank"}
    assert all(np.isfinite(v) for v in out.values())


def test_scaling_report_counts_segments_on_cpu_ranks(groups):
    """One group per count (here one rank); the groups' own measurement
    (``measure_rays_per_s`` on 2 and 4 ranks) is positive."""
    rows = scaling.scaling_report(scaling._cornell, 8, 4,
                                  device_counts=(1, 2 * os.cpu_count()),
                                  bounces=1, cpu=True)
    assert [r["devices"] for r in rows] == [1]
    assert rows[0]["efficiency"] == 1.0 and rows[0]["rays_per_s"] > 0
    assert all(groups[n]["rays_per_s"] > 0 for n in WORLDS)
    # a camera ray and a shadow ray, then a bounce ray and its shadow ray
    assert scaling.segments_per_pass(RenderConfig(width=8, height=4,
                                                  bounces=1), 1) == 32 * 4


def test_render_pass_mega_slices_whole_film_u_planes():
    """A shard given the film's u-planes takes its own columns (after a
    zero pad: the padded last shard keeps its window): the rows of the
    whole film's pass on the same planes."""
    fields = C.RENDERS["mega padded"]
    cfg = RenderConfig(**fields)
    scene = _port_scene(fields)
    st0 = pt.init_state(cfg, "cpu")
    u = mega.u_planes_for_pass(st0["key"], 0, cfg, scene.lights.count)
    full = mega.render_pass_mega(scene, pt.init_state(cfg, "cpu"), cfg,
                                 u_planes=u)["acc"]
    local = -(-cfg.total_rays // 2)
    st = {**st0, "acc": torch.zeros((local, 3))}
    last = mega.render_pass_mega(scene, st, cfg, u_planes=u,
                                 ray_offset=local)["acc"]
    np.testing.assert_array_equal(last[:cfg.total_rays - local].numpy(),
                                  full[local:].numpy())
    with pytest.raises(ValueError, match="columns"):
        mega.render_pass_mega(scene, st, cfg, u_planes=u[:, :7],
                              ray_offset=local)


def test_padded_shard_past_2_24_rays_raises():
    """A film just under 2^24 rays is supported, but its padded last
    shard over 2 ranks reaches 2^24: the launch raises, naming the cap."""
    cfg = RenderConfig(width=4095, height=4097, bounces=0,
                       use_megakernel=True)
    assert cfg.total_rays == (1 << 24) - 1
    assert mega.supported(None, cfg)
    local = -(-cfg.total_rays // 2)
    scene = _port_scene(dict(width=8, height=8))
    st = {**pt.init_state(RenderConfig(width=8, height=8), "cpu"),
          "acc": torch.empty((local, 3))}
    with pytest.raises(ValueError, match=r"2\^24"):
        mega.render_pass_mega(scene, st, cfg, ray_offset=local)


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_spawn_fails_with_the_failing_rank(tmp_path, how):
    """A rank that raises fails the call with its traceback; one that dies
    without a result fails it at once, not at the timeout (by its exit
    code, or by the other rank's broken barrier, whichever comes first);
    the waiting ranks are killed."""
    import time
    match = "ValueError: rank 1 fails" if how == "raise" else "rank"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        pm.spawn(C.fail_on_rank, 2, 1, how, cpu=True,
                 store_dir=str(tmp_path), timeout=300)
    assert time.monotonic() - t0 < 120


def test_init_distributed_one_process_is_a_noop():
    assert pm.init_distributed() is None
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="init_method"):
        pm.init_distributed(0, 2)


def test_pick_backend(monkeypatch):
    assert pm.pick_backend(4, cpu=True)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.pick_backend(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    backend, why = pm.pick_backend(2)
    assert backend == "gloo" and "share" in why
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pm.pick_backend(4)[0] == "nccl"


# ---------------------------------------------------------------------------
# utils/runtime (after tests/test_runtime.py, without its CLI and orbax
# cases)
# ---------------------------------------------------------------------------

def test_runtime_scene_stats_and_validate():
    scene = _port_scene(dict(width=16, height=12))
    stats = runtime.scene_stats(scene)
    assert stats["spheres"] == 2 and stats["triangles"] == 10
    assert stats["lights"] == 1 and stats["materials"] == 5
    assert runtime.validate_scene(scene) == []


def test_runtime_validate_catches_bad_mat_id():
    scene = _port_scene(dict(width=16, height=12))
    bad = replace(scene.spheres,
                  mat_id=torch.tensor([99, 0], dtype=torch.int32))
    issues = runtime.validate_scene(replace(scene, spheres=bad))
    assert any("out of range" in i for i in issues)


def test_runtime_device_info_and_fence(monkeypatch):
    info = runtime.device_info(cpu=True)
    assert len(info) == 1 and info[0]["platform"] == "cpu"
    runtime.fence({"x": torch.ones(4), "n": 3})     # no card: no-op
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runtime.device_info()


def test_runtime_timeit_and_stage_timer():
    def f(x):
        return x * 2 + 1
    assert runtime.timeit(f, torch.ones(128), iters=3) >= 0
    st = runtime.StageTimer()
    st.run("double", f, torch.ones(64))
    st.run("double", f, torch.ones(64))
    assert "double" in st.summary()
    assert len(st.records["double"]) == 2


def test_runtime_sphere_field_scene_renders():
    scene = scene_from_numpy(scene_to_numpy(
        jax_sphere_field(64, cols=24, rows=18)))
    cfg = RenderConfig(width=24, height=18, spp=1, bounces=1, seed=9)
    st = pt.render_passes(scene, pt.init_state(cfg, "cpu"), cfg, 2)
    img = pt.image(st, cfg).numpy()
    assert np.isfinite(img).all() and img.max() > 0


def test_runtime_profile_trace_writes_a_trace(tmp_path):
    with runtime.profile_trace(str(tmp_path / "trace")) as prof:
        _ = torch.ones(8) * 2
    assert (tmp_path / "trace" / "trace.json").exists()
    assert prof.key_averages() is not None


def test_replicate_scene_walk_maps_every_tensor():
    """``replicate_scene``'s walk (``core.types.map_tensors``) maps every
    tensor of the scene, nested dataclasses included, and keeps every
    other field."""
    scene = _port_scene(dict(width=8, height=6))
    out = map_tensors(scene, lambda t: t + 1)
    assert out.camera.cols == 8 and out.camera.rows == 6
    for group in ("camera", "spheres", "triangles", "lights"):
        for f in dataclasses.fields(getattr(scene, group)):
            a = getattr(getattr(scene, group), f.name)
            if isinstance(a, torch.Tensor):
                torch.testing.assert_close(
                    getattr(getattr(out, group), f.name), a + 1)
    torch.testing.assert_close(out.materials, scene.materials + 1)

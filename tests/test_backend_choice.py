"""One function picks the raster backend from the platform
(pipelines.frame.resolve_backend): the GPU gets the Triton kernel, the CPU
the dense jnp raster, anything else an error — never a silent fallback."""

import jax
import numpy as np
import pytest

from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.pipelines import frame
from tiny_renderer_tpu.pipelines.frame import BACKENDS, resolve_backend


@pytest.mark.parametrize("platform,expect", [("gpu", "pallas"), ("cpu", "jnp")])
def test_auto_follows_platform(monkeypatch, platform, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert resolve_backend("auto") == expect
    assert resolve_backend() == expect


@pytest.mark.parametrize("platform", ["neuron", "METAL", "rocm"])
def test_auto_rejects_other_platforms(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(ValueError, match="no raster backend"):
        resolve_backend("auto")


def test_pallas_needs_a_gpu(monkeypatch):
    """An explicit "pallas" compiles for the card only; elsewhere it raises
    instead of trying to compile (and never drops to interpret mode)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(ValueError, match="compiles for a GPU"):
        resolve_backend("pallas")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_backend("pallas") == "pallas"


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
def test_explicit_backends_pass_through(monkeypatch, backend):
    """The reference raster and the interpreter run anywhere when named;
    "auto" never picks the interpreter."""
    for platform in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda p=platform: p)
        assert resolve_backend(backend) == backend
        assert resolve_backend("auto") != "pallas_interpret"


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown raster backend"):
        resolve_backend("cuda")
    assert set(BACKENDS) == {"pallas", "pallas_interpret", "jnp"}


def test_frame_and_burst_fns_resolve_auto(monkeypatch):
    """make_frame_fn / make_burst_fn key their jit on the resolved name."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = RenderConfig(width=32, height=32)
    assert frame.make_frame_fn("phong", cfg).keywords["backend"] == "pallas"
    assert frame.make_burst_fn("phong", cfg).keywords["backend"] == "pallas"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert frame.make_frame_fn("phong", cfg).keywords["backend"] == "jnp"


def test_scene_auto_renders_on_cpu(head_model):
    """Scene's default backend resolves through the same function: on the
    CPU it renders with the jnp raster."""
    from tiny_renderer_tpu import Scene

    scene = Scene(head_model, "phong", RenderConfig(width=48, height=48))
    assert scene._frame_fn.keywords["backend"] == "jnp"
    scene.set_light_direction([0.35, 0.0, 0.94])
    scene.render()
    assert scene.get_frame_buffer().shape == (48, 48, 3)
    assert np.asarray(scene.get_frame_buffer()).any()


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(head_model, camera):
    """On the card: the compiled kernel against the jnp raster at a
    non-tile-multiple frame (chip_smoke.py checks the full size)."""
    import jax.numpy as jnp

    from conftest import geom_dict, tex_dict
    from tiny_renderer_tpu.ops.mathlib import F32_MIN

    cfg = RenderConfig(width=200, height=120)
    args = (
        jax.tree.map(jnp.asarray, geom_dict(head_model.mesh)),
        jax.tree.map(jnp.asarray, tex_dict(head_model)),
        *map(jnp.asarray, camera),
    )
    k = frame.make_frame_fn("shadow", cfg, backend="pallas")(*args)
    r = frame.make_frame_fn("shadow", cfg, backend="jnp")(*args)
    np.testing.assert_array_equal(
        np.asarray(k["z"]) > F32_MIN, np.asarray(r["z"]) > F32_MIN)
    mismatch = (np.asarray(k["frame"]) != np.asarray(r["frame"])).any(-1).mean()
    assert mismatch < 0.005

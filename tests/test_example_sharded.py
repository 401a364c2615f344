"""Smoke tests for examples/sharded_render.py — the one example script not
already exercised elsewhere (serve_http: test_serve_http; custom_pipeline:
test_register_pipeline).

Runs the example as a real subprocess so its self-bootstrap (XLA_FLAGS
virtual-device injection before jax init) is exercised, at --size 128 to
stay in the fast suite.  Bit-identity of the sharded paths themselves is
pinned by tests/test_parallel.py; this guards the user-facing script.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "sharded_render.py")


def _run(args, out):
    env = dict(os.environ)
    # The example injects its own --xla_force_host_platform_device_count;
    # drop the conftest's copy so the two don't conflict in one flag string.
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, EXAMPLE, "-", out] + args,
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc


def _read_png(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def test_sharded_example_renders(tmp_path):
    out = str(tmp_path / "sharded.png")
    proc = _run(["--size", "128"], out)
    assert "overflow=False" in proc.stdout
    img = _read_png(out)
    assert img.shape == (128, 128, 3)
    assert img.any(), "frame is all black"


@pytest.mark.slow  # second subprocess mesh-compile; the pipelined path's
# fast coverage lives in test_parallel.py's in-process pp tests
def test_sharded_example_pipelined(tmp_path):
    out = str(tmp_path / "pp.png")
    _run(["--size", "128", "--pipelined"], out)
    frames = [_read_png(str(tmp_path / f"pp-{i}.png")) for i in range(3)]
    for img in frames:
        assert img.shape == (128, 128, 3)
        assert img.any()
    # The orbit moves the camera; consecutive frames must differ.
    assert not np.array_equal(frames[0], frames[2])


@pytest.mark.parametrize("args,msg", [
    (["--size"], "--size needs a value"),
    (["--size", "abc"], "--size must be an integer"),
    (["--size", "100"], "positive multiple of the mesh's row axis"),
    (["--size", "128", "--pipelined", "--replicate-pass1"],
     "mutually exclusive"),
])
def test_sharded_example_flag_errors(tmp_path, args, msg):
    """Bad flag combinations exit cleanly with a clear message, not a
    traceback."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, EXAMPLE, "-", str(tmp_path / "x.png")] + args,
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert proc.returncode != 0
    assert msg in proc.stderr
    assert "Traceback" not in proc.stderr


@pytest.mark.slow
def test_sharded_example_replicate_pass1_identical(tmp_path):
    """--replicate-pass1 is an execution-strategy knob: same pixels."""
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    _run(["--size", "128"], a)
    _run(["--size", "128", "--replicate-pass1"], b)
    assert np.array_equal(_read_png(a), _read_png(b))


@pytest.mark.parametrize("n_devices,args", [
    (8, ["--size", "800"]),                 # 100-row shards
    (4, ["--size", "800"]),                 # 200-row shards
    (8, ["--size", "1000", "--pipelined"]),  # 250-row shards over 4 rows
])
def test_sharded_example_rejects_partial_tiles(monkeypatch, tmp_path,
                                               n_devices, args):
    """With the GPU kernel every row shard must be whole tile_h-row tiles;
    the example says so instead of failing inside the sharded render."""
    import importlib.util

    from tiny_renderer_tpu.pipelines import frame

    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    spec = importlib.util.spec_from_file_location("sharded_render", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "N_DEVICES", n_devices)
    monkeypatch.setattr(frame, "resolve_backend", lambda backend: "pallas")
    monkeypatch.setattr(sys, "argv",
                        [EXAMPLE, "-", str(tmp_path / "x.png")] + args)
    with pytest.raises(SystemExit, match="multiple of tile_h=16"):
        mod.main()

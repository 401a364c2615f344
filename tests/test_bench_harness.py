"""Bench harness self-checks (CPU): the burst timer's numbers and its JSON
line, which names the device every number was measured on."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def test_bench_headline_json_keys():
    """The stdout JSON line's keys are a contract."""
    import json

    import bench

    results = [
        {"asset": "diablo", "pipeline": "phong", "ms_per_frame": 2.0},
        {"asset": "diablo", "pipeline": "shadow", "ms_per_frame": 5.0},
    ]
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    back = json.loads(json.dumps(
        bench.headline_payload(results, device, "NVIDIA H100 80GB HBM3, 700.00 W")))
    assert back["value"] == 5.0 and back["unit"] == "ms"
    assert back["metric"] == "ms/frame diablo shadow burst"
    assert back["device"] == device
    assert back["gpu"].endswith("700.00 W")
    assert back["configs"] == {"diablo:phong": 2.0, "diablo:shadow": 5.0}
    assert "knobs" not in back
    knobbed = bench.headline_payload(results, device, None, ["tex_tile=16"])
    assert knobbed["knobs"] == ["tex_tile=16"] and knobbed["gpu"] is None


def test_bench_config_times_a_burst_on_cpu():
    """A tiny burst through the real timer: finite, positive numbers and
    the seeded scene's triangle count."""
    import bench

    r = bench.bench_config("african_head", "phong", False, frames=2, reps=1,
                           backend="jnp", size=32)
    assert r["triangles"] == 2492
    assert 0 < r["ms_per_frame"] < 1e5
    assert r["fps"] == pytest.approx(1e3 / r["ms_per_frame"])
    assert r["compile_and_first_run_s"] > 0


def test_gpu_name_power_without_nvidia_smi(monkeypatch):
    """No nvidia-smi on PATH (a CPU host): no card line, no crash."""
    from tiny_renderer_tpu.utils.timing import device_summary, gpu_name_power

    monkeypatch.setenv("PATH", "/nonexistent")
    assert gpu_name_power() is None
    assert device_summary()["platform"] == "cpu"


def test_bench_rejects_bad_knob_before_device_init(monkeypatch, capsys):
    """--knob typos must fail during argument validation, before any
    device work."""
    import bench

    monkeypatch.setattr(sys, "argv", ["bench.py", "--knob", "tex_tle=16"])
    with pytest.raises(ValueError, match="tex_tle"):
        bench.main()

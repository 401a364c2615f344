"""Error-surface coverage: validation and guard paths must RAISE, not
silently truncate — config constraints, sharded-mesh divisibility, the
binning key-packing guard, and asset index validation."""

import numpy as np
import jax
import pytest

from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.assets.obj import parse_obj
from tiny_renderer_tpu.ops.binning import bin_triangles
from tiny_renderer_tpu.parallel.sharding import (
    make_row_mesh,
    render_batch_sharded,
    render_frame_sharded,
)

BAD_CONFIGS = [
    (dict(width=0, height=64), "frame size"),
    (dict(width=64, height=-1), "frame size"),
    (dict(width=64, height=64, tile_w=96), "tile_w"),
    (dict(width=64, height=64, tile_h=12), "tile_h"),
    (dict(width=64, height=64, max_span_y=0), "span caps"),
    (dict(width=64, height=64, max_incidences=4), "max_incidences"),
    (dict(width=64, height=64, occlusion_samples=0), "occlusion_samples"),
    (dict(width=64, height=64, strip_batch=0), "strip_batch"),
    (dict(width=64, height=64, tile_w=0), "tile_w"),
    # 1 * 3 = 3 is not a multiple of 128 (the strip shade's lane width)
    (dict(width=64, height=64, strip_batch=1, strip_len=3), "strip_len"),
]


@pytest.mark.parametrize("kwargs,match", BAD_CONFIGS)
def test_config_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        RenderConfig(**kwargs)


def test_binning_key_overflow_guard():
    """tile_id * K + tri_id must fit in i32; a pathological tiles x
    triangles product is rejected with the sharding hint, not wrapped."""
    cfg = RenderConfig(width=128 * 2048, height=8 * 2048)  # 2^22 tiles
    setup = {"valid": np.zeros(1024, np.bool_)}  # K = 2^11 -> 2^33 keys
    with pytest.raises(ValueError, match="binning key overflow"):
        bin_triangles(setup, cfg)


def test_obj_index_out_of_range():
    text = "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvn 0 0 1\nf 1/1/1 2/1/1 5/1/1\n"
    with pytest.raises(ValueError, match="position index out of range"):
        parse_obj(text)


@pytest.fixture(scope="module")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices (xla_force_host_platform_device_count)")
    return devs[:8]


def test_mesh_batch_divisibility(eight_devices):
    with pytest.raises(ValueError, match="not divisible by batch"):
        make_row_mesh(eight_devices, batch=3)


def test_sharded_height_divisibility(eight_devices):
    mesh = make_row_mesh(eight_devices, batch=1)
    cfg = RenderConfig(width=64, height=100)  # 100 % 8 != 0
    with pytest.raises(ValueError, match="not divisible by rows"):
        render_frame_sharded(
            None, None, None, None, None, None,
            pipeline="phong", config=cfg, mesh=mesh,
        )


def test_sharded_tile_h_divisibility(eight_devices):
    mesh = make_row_mesh(eight_devices, batch=1)
    cfg = RenderConfig(width=64, height=96, tile_h=16)  # 96/8=12 rows/shard
    with pytest.raises(ValueError, match="tile_h"):
        render_frame_sharded(
            None, None, None, None, None, None,
            pipeline="phong", config=cfg, mesh=mesh,
            backend="pallas_interpret",
        )


def test_batch_sharded_batch_divisibility(eight_devices):
    mesh = make_row_mesh(eight_devices, batch=2)
    cfg = RenderConfig(width=64, height=64)
    lights = np.zeros((3, 3), np.float32)  # B=3 on a batch=2 axis
    with pytest.raises(ValueError, match="batch 3 not divisible"):
        render_batch_sharded(
            None, None, lights, None, None, None,
            pipeline="phong", config=cfg, mesh=mesh,
        )


# ---- native loader robustness: failures return None, never crash ----

from tiny_renderer_tpu.assets import native


@pytest.mark.parametrize("fn", ["read_tga_native", "read_obj_native"])
def test_native_missing_file_returns_none(fn):
    if not native.native_available():
        pytest.skip("native loader not built")
    assert getattr(native, fn)("/nonexistent/file.xyz") is None


def test_native_truncated_tga_returns_none(tmp_path):
    if not native.native_available():
        pytest.skip("native loader not built")
    p = tmp_path / "trunc.tga"
    p.write_bytes(b"\x00\x00\x02")  # 3 bytes: shorter than the 18-byte header
    assert native.read_tga_native(str(p)) is None

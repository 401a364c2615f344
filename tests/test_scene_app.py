"""Scene API + CLI app + PNG writer tests."""

import os

import numpy as np
import pytest

from tiny_renderer_tpu import RenderConfig, Scene
from tiny_renderer_tpu.utils.png import write_png


def test_scene_api_mirrors_reference(head_model):
    cfg = RenderConfig(width=96, height=96, tri_block=32)
    scene = Scene(head_model, "phong", cfg, backend="jnp")
    scene.set_light_direction([0.0, 0.0, 1.0])
    scene.set_camera([0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    scene.render()
    frame = scene.get_frame_buffer()
    assert frame.shape == (96, 96, 3) and frame.dtype == np.uint8
    assert frame.any(), "frame is all black"
    z = scene.get_z_buffer()
    assert z.shape == (96, 96, 3)
    assert (z[:, :, 0] == z[:, :, 1]).all()
    s = scene.get_shadow_buffer()
    assert (s == 0).all()  # single-pass pipeline: shadow buffer untouched


def test_scene_rejects_unknown_pipeline(head_model):
    # Reference panics: "Provided pipeline name is not supported!" (shader.rs:108)
    with pytest.raises(ValueError, match="not supported"):
        Scene(head_model, "true_normal")


def test_frame_buffer_is_vertically_flipped(head_model):
    """(0,0) is bottom-left internally; presentation flips (scene.rs:92-97)."""
    cfg = RenderConfig(width=64, height=64, tri_block=32)
    scene = Scene(head_model, "default", cfg, backend="jnp")
    scene.render()
    flipped = scene.get_frame_buffer()
    raw = np.asarray(scene._out["frame"])
    np.testing.assert_array_equal(flipped, raw[::-1])


def test_shadow_pipeline_buffers(head_model):
    cfg = RenderConfig(width=64, height=64, tri_block=32)
    scene = Scene(head_model, "shadow", cfg, backend="jnp")
    scene.render()
    assert scene.get_shadow_buffer().any()


def test_scene_render_sequence_matches_per_frame_renders(head_model):
    """Scene.render_sequence (the public burst API) must return exactly the
    frames a per-pose render()/get_frame_buffer() loop produces — same orbit
    angle mapping (src/app.rs:200-207), same presentation flip, and the
    Scene's own backend (a Scene built with backend="jnp" must not
    silently burst on another backend)."""
    cfg = RenderConfig(width=64, height=64, tri_block=32)
    scene = Scene(head_model, "shadow", cfg, backend="jnp")
    cam = np.array([0.3, 1.7, 4.0], np.float32)
    lig = np.array([-0.6, 0.9, 2.2], np.float32)
    seq = scene.render_sequence(cam, lig)
    assert seq.shape == (3, 64, 64, 3) and seq.dtype == np.uint8
    for i, (ca, la) in enumerate(zip(cam, lig)):
        scene.set_camera(
            [np.sin(ca), 0.0, np.cos(ca)], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0]
        )
        scene.set_light_direction([np.sin(la), 0.0, np.cos(la)])
        scene.render()
        np.testing.assert_array_equal(
            seq[i], scene.get_frame_buffer(), err_msg=f"frame {i} (cam {ca})"
        )


def test_png_roundtrip(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    img = (np.arange(32 * 16 * 3, dtype=np.int64) % 256).astype(np.uint8).reshape(16, 32, 3)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    back = np.asarray(PIL.open(path))
    np.testing.assert_array_equal(back, img)


def test_app_headless_end_to_end(tmp_path, capsys):
    from tiny_renderer_tpu.app import main

    out = str(tmp_path / "frame.png")
    z = str(tmp_path / "z.png")
    rc = main([
        "--scene", "african_head", "-s", "default",
        "--size", "64", "64", "--frames", "2", "--orbit",
        "--save", out, "--dump-z", z, "--backend", "jnp",
    ])
    assert rc == 0
    assert os.path.exists(out) and os.path.exists(z)
    captured = capsys.readouterr()
    assert "cooking up a scene with 'default' shader pipeline" in captured.out


def test_app_rejects_bad_pipeline():
    from tiny_renderer_tpu.app import main

    with pytest.raises(SystemExit):
        main(["-s", "nope"])


@pytest.mark.slow  # jax.profiler.trace setup dominates (~25 s on CPU)
def test_app_profile_writes_trace(tmp_path):
    """--profile wraps the run in jax.profiler.trace (SURVEY.md §5.1) and
    must leave a trace dump in the given directory."""
    from tiny_renderer_tpu.app import main

    prof = str(tmp_path / "prof")
    rc = main([
        "--scene", "african_head", "-s", "default",
        "--size", "64", "64", "--frames", "1",
        "--save", str(tmp_path / "f.png"), "--backend", "jnp",
        "--profile", prof,
    ])
    assert rc == 0
    dumped = [f for _, _, fs in os.walk(prof) for f in fs]
    assert dumped, "profiler trace directory is empty"


def test_app_ignores_unknown_args(tmp_path, capsys):
    """The reference silently ignores unknown argv tokens (main.rs:16-26);
    we ignore them with a stderr warning (divergence #9)."""
    from tiny_renderer_tpu.app import main

    out = str(tmp_path / "frame.png")
    rc = main([
        "--scene", "african_head", "-s", "default",
        "--size", "64", "64", "--frames", "1", "--backend", "jnp",
        "--save", out, "--bogus-flag", "junkvalue",
    ])
    assert rc == 0
    assert os.path.exists(out)
    captured = capsys.readouterr()
    assert "ignoring unrecognized arguments" in captured.err
    assert "--bogus-flag" in captured.err


def test_stage_breakdown(head_model, capsys):
    """--timing's per-stage breakdown: all stages measured, deltas sane."""
    from tiny_renderer_tpu import RenderConfig, Scene
    from tiny_renderer_tpu.pipelines.profile import print_stage_breakdown

    cfg = RenderConfig(width=64, height=64, tri_block=32)
    scene = Scene(head_model, "shadow", cfg, backend="jnp")
    deltas = print_stage_breakdown(scene, iters=2)
    out = capsys.readouterr().out
    for label in ("vertex setup", "+ raster", "+ shade", "frame fetch"):
        assert label in out
    assert set(deltas) == {"vertex", "bin", "raster", "full", "fetch"}
    assert all(np.isfinite(v) for v in deltas.values())
    assert deltas["full"] > -deltas["raster"]  # cumulative ordering sanity


@pytest.mark.slow  # kernel-path compile of every stage prefix (~1 min)
def test_stage_breakdown_pallas_interpret(head_model):
    """The binning/raster prefixes must also compile on the kernel path."""
    from tiny_renderer_tpu import RenderConfig, Scene
    from tiny_renderer_tpu.pipelines.profile import stage_breakdown

    cfg = RenderConfig(width=128, height=64, tile_h=8, tri_block=32)
    scene = Scene(head_model, "phong", cfg, backend="pallas_interpret")
    deltas, cumulative = stage_breakdown(scene, iters=1)
    assert set(cumulative) == {"vertex", "bin", "raster", "full"}


def test_cli_projection_knobs(tmp_path):
    """--depth/--projection-distance reach RenderConfig; a longer projection
    distance flattens perspective, changing the render."""
    from tiny_renderer_tpu.app import main

    out1 = tmp_path / "near.png"
    out2 = tmp_path / "far.png"
    base = ["--scene", "african_head", "-s", "default",
            "--size", "64", "64", "--frames", "1", "--backend", "jnp",
            "--no-fps"]
    assert main(base + ["--save", str(out1)]) == 0
    assert main(base + ["--save", str(out2),
                        "--projection-distance", "50", "--depth", "127"]) == 0
    a, b = out1.read_bytes(), out2.read_bytes()
    assert a and b and a != b
    assert main(base + ["--projection-distance", "0"]) == 2


def test_cli_knob_overrides(tmp_path, capsys):
    """--knob NAME=VALUE overrides RenderConfig fields (bit-identity-pinned
    knobs, so the frame must not change); bad names/values exit 2 with the
    field list (a silently-ignored typo would invalidate an experiment)."""
    from tiny_renderer_tpu.app import apply_knobs, main
    from tiny_renderer_tpu.config import RenderConfig

    cfg = apply_knobs(
        RenderConfig(), ["tex_tile=16", "strip_planes=true", "strip_len=32"]
    )
    assert cfg.tex_tile == 16 and cfg.strip_planes and cfg.strip_len == 32
    with pytest.raises(ValueError, match="tex_tile"):
        apply_knobs(RenderConfig(), ["no_such_knob=1"])
    with pytest.raises(ValueError, match="not a bool"):
        apply_knobs(RenderConfig(), ["strip_planes=maybe"])

    base = str(tmp_path / "base.png")
    knobbed = str(tmp_path / "knobbed.png")
    argv = ["--scene", "african_head", "-s", "shadow",
            "--size", "64", "64", "--frames", "1", "--backend", "jnp"]
    assert main(argv + ["--save", base]) == 0
    assert main(argv + ["--save", knobbed, "--knob", "shadow_tile=16",
                        "--knob", "strip_batch=32"]) == 0
    # Deterministic renders + deterministic encoder: byte-equal PNGs.
    with open(base, "rb") as f1, open(knobbed, "rb") as f2:
        assert f1.read() == f2.read()

    rc = main(argv + ["--knob", "bogus=1"])
    assert rc == 2
    assert "bogus" in capsys.readouterr().err


def test_cli_ssaa(tmp_path):
    """--ssaa N renders at N x and box-averages to the requested size;
    the resolve matches a manual downsample of the N x render (quality
    feature beyond the reference)."""
    import numpy as np

    from tiny_renderer_tpu.app import main
    from tiny_renderer_tpu.utils.png import downsample_box

    big = str(tmp_path / "big.png")
    aa = str(tmp_path / "aa.png")
    base = ["--scene", "african_head", "-s", "phong",
            "--frames", "1", "--backend", "jnp"]
    assert main(base + ["--size", "64", "64", "--ssaa", "2",
                        "--save", aa]) == 0
    assert main(base + ["--size", "128", "128", "--save", big]) == 0

    import struct
    import zlib

    def read_png(p):
        d = open(p, "rb").read()
        w, h = struct.unpack(">II", d[16:24])
        raw, pos = b"", 8
        while pos < len(d):
            (ln,), tag = struct.unpack(">I", d[pos:pos+4]), d[pos+4:pos+8]
            if tag == b"IDAT":
                raw += d[pos+8:pos+8+ln]
            pos += 12 + ln
        px = zlib.decompress(raw)
        rows = np.frombuffer(px, np.uint8).reshape(h, w * 3 + 1)
        assert (rows[:, 0] == 0).all()  # filter 0
        return rows[:, 1:].reshape(h, w, 3)

    aa_img = read_png(aa)
    assert aa_img.shape == (64, 64, 3)
    np.testing.assert_array_equal(aa_img, downsample_box(read_png(big), 2))

    # SSAA is headless-only.
    rc = main(base + ["--size", "64", "64", "--ssaa", "2", "--interactive"])
    assert rc == 2

    # --knob width/height overrides compose with --ssaa: knobs apply at
    # the requested size, THEN the ssaa scale (regression: knobs used to
    # clobber the scaled size and crash the divisibility check).
    kn = str(tmp_path / "knob_aa.png")
    assert main(base + ["--size", "32", "32", "--ssaa", "2",
                        "--knob", "width=64", "--knob", "height=64",
                        "--save", kn]) == 0
    assert read_png(kn).shape == (64, 64, 3)
    np.testing.assert_array_equal(read_png(kn), aa_img)


def test_downsample_box_units():
    import numpy as np

    from tiny_renderer_tpu.utils.png import downsample_box

    img = np.zeros((4, 4, 3), np.uint8)
    img[:2, :2] = 255
    out = downsample_box(img, 2)
    assert out.shape == (2, 2, 3)
    assert out[0, 0, 0] == 255 and out[1, 1, 0] == 0
    # Rounded-to-nearest average.
    img = np.array([[[0], [1]], [[1], [1]]], np.uint8).repeat(3, axis=-1)
    assert downsample_box(img, 2)[0, 0, 0] == 1  # (3 + 2) // 4
    with pytest.raises(ValueError):
        downsample_box(np.zeros((3, 4, 3), np.uint8), 2)


class TestOverflowWarning:
    """Coverage-cap truncation warns once at presentation time.

    The auto-tuned span caps (config.resolve_for_pipeline) are sized for
    the reference orbit envelope; a custom scene can exceed them without
    ever polling Scene.overflowed — get_frame_buffer/render_sequence are
    the fetch points where the flag is already on the host for free."""

    def test_warns_once_on_overflow(self, head_model):
        import warnings as w

        cfg = RenderConfig(width=96, height=96, tile_h=8, max_incidences=64)
        scene = Scene(head_model, "default", cfg, backend="pallas_interpret")
        scene.render()
        with pytest.warns(RuntimeWarning, match="coverage cap"):
            scene.get_frame_buffer()
        scene.render()
        with w.catch_warnings():
            w.simplefilter("error")  # a second warning would raise
            scene.get_frame_buffer()

    def test_no_warning_without_overflow(self, head_model):
        import warnings as w

        cfg = RenderConfig(width=96, height=96, tri_block=32)
        scene = Scene(head_model, "default", cfg, backend="jnp")
        scene.render()
        with w.catch_warnings():
            w.simplefilter("error")
            scene.get_frame_buffer()

    def test_sequence_warns_and_carries_overflow(self, head_model):
        cfg = RenderConfig(width=96, height=96, tile_h=8, max_incidences=64)
        scene = Scene(head_model, "default", cfg, backend="pallas_interpret")
        angles = np.linspace(0.0, 0.4, 3, dtype=np.float32)
        with pytest.warns(RuntimeWarning, match="coverage cap"):
            frames = scene.render_sequence(angles, -angles)
        assert frames.shape == (3, 96, 96, 3)

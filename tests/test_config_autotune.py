"""Per-pipeline tuned defaults (config.resolve_for_pipeline).

Layout choices that suit one pipeline and not another (tex_tile=16 for
all but specular, SL8 with 1k-strip batches for occlusion only) ship as
PER-PIPELINE tuned defaults applied at render entry, not as global
RenderConfig defaults; output is bit-identical either way.
These tests pin the resolution semantics (atomic groups, explicit
settings win, auto_tune=False inert) and that every entry point resolves.
"""

import dataclasses

import numpy as np
import pytest

from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.config import PIPELINE_TUNED_DEFAULTS, resolve_for_pipeline


def test_tuned_defaults_per_pipeline():
    c = RenderConfig()
    r = resolve_for_pipeline(c, "shadow")
    assert (r.tex_tile, r.strip_len, r.strip_batch) == (16, 16, 512)
    r = resolve_for_pipeline(c, "occlusion")
    assert (r.tex_tile, r.strip_len, r.strip_batch) == (0, 8, 1024)
    for p in ("phong", "default", "normal_map", "darboux"):
        assert resolve_for_pipeline(c, p).tex_tile == 16
    # specular keeps the row-major layout.
    assert resolve_for_pipeline(c, "specular").tex_tile == 0


def test_span_tuning_by_resolution():
    # Pipeline-independent span shrink at the resolution tiers (128x256 px
    # at <=800, 160x384 px at <=1200 with 16x64 tiles); default projection
    # only; explicit spans or projection opt out.
    for p in ("shadow", "phong", "default"):
        r = resolve_for_pipeline(RenderConfig(), p)
        assert (r.max_span_y, r.max_span_x) == (8, 4), p
    r = resolve_for_pipeline(RenderConfig(width=1200, height=1200), "shadow")
    assert (r.max_span_y, r.max_span_x) == (10, 6)
    r = resolve_for_pipeline(RenderConfig(width=1600, height=1600), "shadow")
    assert (r.max_span_y, r.max_span_x) == (16, 8)
    # max(w, h) picks the tier (the worst bbox scales with the larger dim).
    r = resolve_for_pipeline(RenderConfig(width=400, height=1100), "shadow")
    assert (r.max_span_y, r.max_span_x) == (10, 6)
    r = resolve_for_pipeline(
        dataclasses.replace(RenderConfig(), max_span_x=3), "shadow"
    )
    # Atomic group: one explicitly non-default member disables the whole
    # span group.  (Explicitly re-stating a DEFAULT value is, by design,
    # indistinguishable from leaving it untouched — value-based check.)
    assert (r.max_span_y, r.max_span_x) == (16, 3)
    r = resolve_for_pipeline(
        dataclasses.replace(RenderConfig(), projection_coef=-0.5), "shadow"
    )
    assert (r.max_span_y, r.max_span_x) == (16, 8)  # default projection only


def test_explicit_settings_always_win_and_groups_are_atomic():
    # Explicitly setting ANY member of a tuning group disables the whole
    # group (occlusion's strip_len/strip_batch pair preserves the
    # 8192-fragments-per-step product; half-applying would not).
    c = dataclasses.replace(RenderConfig(), strip_batch=256)
    r = resolve_for_pipeline(c, "occlusion")
    assert (r.strip_len, r.strip_batch) == (16, 256)
    c = dataclasses.replace(RenderConfig(), tex_tile=8)
    assert resolve_for_pipeline(c, "shadow").tex_tile == 8


def test_auto_tune_off_is_inert_and_resolve_is_idempotent():
    c = dataclasses.replace(RenderConfig(), auto_tune=False)
    for p in ("shadow", "occlusion"):
        assert resolve_for_pipeline(c, p) == c
    once = resolve_for_pipeline(RenderConfig(), "shadow")
    assert resolve_for_pipeline(once, "shadow") == once


def test_tuned_groups_reference_real_validated_fields():
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    for pipe, group in PIPELINE_TUNED_DEFAULTS.items():
        for name, value in group.items():
            assert name in fields, f"{pipe}: unknown field {name}"
            # The tuned config must pass RenderConfig's own validation.
            dataclasses.replace(RenderConfig(), **group)


def test_scene_stores_resolved_config(head_model):
    from tiny_renderer_tpu import Scene

    s = Scene(head_model, "shadow", RenderConfig(width=64, height=64))
    assert s.config.tex_tile == 16
    s = Scene(head_model, "occlusion", RenderConfig(width=64, height=64))
    assert (s.config.strip_len, s.config.strip_batch) == (8, 1024)
    # Explicit opt-out flows through.
    s = Scene(head_model, "shadow",
              RenderConfig(width=64, height=64, auto_tune=False))
    assert s.config.tex_tile == 0


def test_autotuned_render_bit_identical_to_explicit_knobs(head_scene_data, camera):
    """The tuned defaults are pure permutations / batching changes: the
    auto-tuned render must equal both the explicit-knob render AND the
    raw (auto_tune=False) render bit-for-bit."""
    import jax
    import jax.numpy as jnp

    from tiny_renderer_tpu.pipelines.frame import make_frame_fn

    geom, tex = head_scene_data
    light, look_from, look_at, up = camera
    gj = jax.tree.map(jnp.asarray, geom)
    tj = jax.tree.map(jnp.asarray, tex)
    args = (gj, tj, jnp.asarray(light), jnp.asarray(look_from),
            jnp.asarray(look_at), jnp.asarray(up))

    for pipeline, explicit in [
        ("shadow", {"tex_tile": 16}),
        ("default", {"tex_tile": 16}),  # r4c flip
        ("occlusion", {"strip_len": 8, "strip_batch": 1024}),
    ]:
        base = RenderConfig(width=64, height=64, tile_h=8)
        auto = np.asarray(make_frame_fn(pipeline, base, "jnp")(*args)["frame"])
        exp_cfg = dataclasses.replace(base, **explicit)
        exp = np.asarray(make_frame_fn(pipeline, exp_cfg, "jnp")(*args)["frame"])
        raw_cfg = dataclasses.replace(base, auto_tune=False)
        raw = np.asarray(make_frame_fn(pipeline, raw_cfg, "jnp")(*args)["frame"])
        np.testing.assert_array_equal(auto, exp, err_msg=pipeline)
        np.testing.assert_array_equal(auto, raw, err_msg=f"{pipeline} vs raw")

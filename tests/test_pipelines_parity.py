"""Golden parity: JAX renderer vs the NumPy oracle across all 7 pipelines.

The oracle (tiny_renderer_tpu.oracle) encodes the Rust reference's serial
semantics; no Rust toolchain exists here, so it is the parity anchor
(SURVEY.md §4.1b).  Divergence budget: the only known difference is XLA's
FMA fusion producing 1-ulp z differences that flip winners at exact-tie
pixels on shared triangle edges — a small fraction of pixels; everywhere
else output must match exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.oracle import render_oracle
from tiny_renderer_tpu.pipelines.frame import PIPELINES, make_frame_fn

SIZE = 160
MISMATCH_BUDGET = 0.005  # fraction of pixels allowed to differ (tie flips)


def _render_pair(scene_data, camera, pipeline, backend="jnp", size=SIZE):
    geom, tex = scene_data
    light, look_from, look_at, up = camera
    cfg = RenderConfig(width=size, height=size, tri_block=64,
                       tile_h=8, tile_w=128)
    o = render_oracle(geom, tex, light, look_from, look_at, up,
                      pipeline=pipeline, config=cfg)
    fn = make_frame_fn(pipeline, cfg, backend=backend)
    gj = jax.tree.map(jnp.asarray, geom)
    tj = jax.tree.map(jnp.asarray, tex)
    r = fn(gj, tj, jnp.asarray(light), jnp.asarray(look_from),
           jnp.asarray(look_at), jnp.asarray(up))
    return o, jax.tree.map(np.asarray, r)


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_head_parity(head_scene_data, camera, pipeline):
    o, r = _render_pair(head_scene_data, camera, pipeline)
    mismatch = (o["frame"] != r["frame"]).any(axis=-1).mean()
    assert mismatch <= MISMATCH_BUDGET, f"{pipeline}: pixel mismatch {mismatch:.4%}"
    # Coverage (raster winner presence) must agree except at tie flips.
    cov_o = o["frame"].any(axis=-1)
    cov_r = r["frame"].any(axis=-1)
    assert (cov_o != cov_r).mean() <= MISMATCH_BUDGET


@pytest.mark.parametrize("pipeline", ["default", "shadow"])
def test_diablo_parity(diablo_scene_data, camera, pipeline):
    o, r = _render_pair(diablo_scene_data, camera, pipeline)
    mismatch = (o["frame"] != r["frame"]).any(axis=-1).mean()
    assert mismatch <= MISMATCH_BUDGET, f"{pipeline}: pixel mismatch {mismatch:.4%}"


from conftest import ORBIT_POSES, pose_camera


# Fast reps: the two grazing-light poses (the regression-prone regime);
# the remaining poses run in -m slow.
@pytest.mark.parametrize(
    "pose",
    [ORBIT_POSES[1], ORBIT_POSES[4]] + [
        pytest.param(p, marks=pytest.mark.slow)
        for p in (ORBIT_POSES[0], ORBIT_POSES[2], ORBIT_POSES[3])
    ],
    ids=lambda p: f"cam{p[0]:.0f}_light{p[1]:.0f}")
@pytest.mark.parametrize("pipeline", ["phong", "shadow", "occlusion"])
def test_orbit_sweep_parity(head_scene_data, pose, pipeline):
    """Angle-parametrized oracle parity: grazing light and oblique camera
    poses stress shadow-index saturation and the occlusion probe's
    off-axis sample scatter — bugs a single fixed pose cannot catch."""
    o, r = _render_pair(head_scene_data, pose_camera(*pose), pipeline, size=128)
    mismatch = (o["frame"] != r["frame"]).any(axis=-1).mean()
    assert mismatch <= MISMATCH_BUDGET, (
        f"{pipeline}@{pose}: pixel mismatch {mismatch:.4%}"
    )


@pytest.mark.parametrize(
    "pose",
    [ORBIT_POSES[4]] + [
        pytest.param(p, marks=pytest.mark.slow)
        for p in (ORBIT_POSES[0], ORBIT_POSES[2])
    ],
    ids=lambda p: f"cam{p[0]:.0f}_light{p[1]:.0f}")
@pytest.mark.parametrize("pipeline", ["default", "normal_map", "specular", "darboux"])
def test_orbit_sweep_parity_one_pass(head_scene_data, pose, pipeline):
    """Angle coverage for the one-pass pipelines (lighting terms flip sign
    at grazing angles — intensity clamps, specular exponent saturation,
    Darboux basis conditioning all vary with pose)."""
    o, r = _render_pair(head_scene_data, pose_camera(*pose), pipeline, size=128)
    mismatch = (o["frame"] != r["frame"]).any(axis=-1).mean()
    assert mismatch <= MISMATCH_BUDGET, (
        f"{pipeline}@{pose}: pixel mismatch {mismatch:.4%}"
    )


@pytest.mark.parametrize(
    "pose",
    [ORBIT_POSES[1],
     pytest.param(ORBIT_POSES[3], marks=pytest.mark.slow)],
    ids=lambda p: f"cam{p[0]:.0f}_light{p[1]:.0f}")
@pytest.mark.parametrize("pipeline", ["shadow", "occlusion"])
def test_orbit_sweep_strip_shade_parity(head_scene_data, pose, pipeline):
    """The strip-compacted kernel path must hold the same budget across
    poses (covered-strip geometry changes completely with the angle)."""
    o, r = _render_pair(
        head_scene_data, pose_camera(*pose), pipeline,
        backend="pallas_interpret", size=64,
    )
    mismatch = (o["frame"] != r["frame"]).any(axis=-1).mean()
    assert mismatch <= 0.01, f"{pipeline}@{pose}: pixel mismatch {mismatch:.4%}"


@pytest.mark.parametrize(
    "pipeline",
    ["default", "phong", "normal_map", "specular", "darboux", "shadow",
     "occlusion"],
)
def test_pallas_interpret_parity(head_scene_data, camera, pipeline):
    """Pallas (interpret mode on CPU) against the oracle on a small frame."""
    o, r = _render_pair(head_scene_data, camera, pipeline,
                        backend="pallas_interpret", size=64)
    mismatch = (o["frame"] != r["frame"]).any(axis=-1).mean()
    assert mismatch <= 0.01, f"{pipeline}: pixel mismatch {mismatch:.4%}"


def test_shadow_buffer_parity(head_scene_data, camera):
    o, r = _render_pair(head_scene_data, camera, "shadow")
    # Shadow map z values: max-reduction over fragments; FMA tie flips don't
    # change a max over equal values, but 1-ulp z differences show as atol.
    np.testing.assert_allclose(o["shadow"], r["shadow"], rtol=1e-5, atol=1e-3)


@pytest.mark.slow  # construction-time-expansion contract; interpret-heavy
def test_pre_expanded_geometry_identical(head_scene_data, camera):
    """expand_geometry (Scene's one-time attribute pre-gather) must not
    change any output bit — it only hoists frame-invariant gathers."""
    from tiny_renderer_tpu.ops.vertex import expand_geometry

    geom, tex = head_scene_data
    light, look_from, look_at, up = camera
    cfg = RenderConfig(width=96, height=96, tri_block=32, tile_h=8)
    gj = jax.tree.map(jnp.asarray, geom)
    tj = jax.tree.map(jnp.asarray, tex)
    args = (jnp.asarray(light), jnp.asarray(look_from), jnp.asarray(look_at),
            jnp.asarray(up))
    for backend in ("jnp", "pallas_interpret"):
        fn = make_frame_fn("shadow", cfg, backend=backend)
        a = fn(gj, tj, *args)
        b = fn(expand_geometry(gj), tj, *args)
        np.testing.assert_array_equal(np.asarray(a["frame"]), np.asarray(b["frame"]))
        np.testing.assert_array_equal(np.asarray(a["z"]), np.asarray(b["z"]))
        np.testing.assert_array_equal(np.asarray(a["shadow"]), np.asarray(b["shadow"]))


@pytest.mark.parametrize("knob", ["csr_indirect", "binning_compact"])
def test_layout_knobs_bit_identical(head_scene_data, camera, knob):
    """csr_indirect (record layout) and binning_compact (sort before or
    after compaction) are pure layout/traffic changes on the kernel path:
    frames must be bit-identical with the knob flipped."""
    import dataclasses

    geom, tex = head_scene_data
    light, look_from, look_at, up = camera
    gj = jax.tree.map(jnp.asarray, geom)
    tj = jax.tree.map(jnp.asarray, tex)
    args = (jnp.asarray(light), jnp.asarray(look_from), jnp.asarray(look_at),
            jnp.asarray(up))
    base = RenderConfig(width=96, height=96, tri_block=32, tile_h=8)
    frames = {}
    for v in (False, True):
        cfg = dataclasses.replace(base, **{knob: v})
        fn = make_frame_fn("shadow", cfg, backend="pallas_interpret")
        frames[v] = np.asarray(fn(gj, tj, *args)["frame"])
    np.testing.assert_array_equal(frames[False], frames[True])


def test_dedup_gather_exact():
    """dedup_gather == plain gather for heavy-duplication, light-duplication
    (unique-cap overflow -> fallback), and all-equal index patterns."""
    from tiny_renderer_tpu.pipelines.shaders import dedup_gather

    rng = np.random.default_rng(7)
    table = jnp.asarray(rng.random(4096).astype(np.float32))
    for idx_np in (
        rng.integers(0, 64, size=(17, 24, 128)),       # ~64 unique << cap
        rng.integers(0, 4096, size=(17, 24, 128)),     # ~unique > M/8: fallback
        np.zeros((17, 4, 128), np.int64),              # degenerate all-equal
    ):
        idx = jnp.asarray(idx_np.astype(np.int32))
        expect = np.asarray(table)[idx_np]
        got = np.asarray(jax.jit(dedup_gather)(table, idx))
        np.testing.assert_array_equal(got, expect)


@pytest.mark.slow  # dedup is a default-off knob
def test_occlusion_dedup_bit_identical(head_scene_data, camera):
    """occlusion_dedup collapses duplicate fetches of equal values — the
    frame must be bit-identical with the knob flipped."""
    import dataclasses

    geom, tex = head_scene_data
    light, look_from, look_at, up = camera
    gj = jax.tree.map(jnp.asarray, geom)
    tj = jax.tree.map(jnp.asarray, tex)
    args = (jnp.asarray(light), jnp.asarray(look_from), jnp.asarray(look_at),
            jnp.asarray(up))
    base = RenderConfig(width=96, height=96, tri_block=32, tile_h=8)
    frames = {}
    for v in (False, True):
        cfg = dataclasses.replace(base, occlusion_dedup=v)
        fn = make_frame_fn("occlusion", cfg, backend="pallas_interpret")
        frames[v] = np.asarray(fn(gj, tj, *args)["frame"])
    np.testing.assert_array_equal(frames[False], frames[True])


def test_two_runs_bit_identical(head_scene_data, camera):
    """Determinism: the bit-stable z-buffer requirement (SURVEY.md §4.4)."""
    o1, r1 = None, None
    geom, tex = head_scene_data
    light, look_from, look_at, up = camera
    cfg = RenderConfig(width=96, height=96, tri_block=32)
    fn = make_frame_fn("shadow", cfg, backend="jnp")
    gj = jax.tree.map(jnp.asarray, geom)
    tj = jax.tree.map(jnp.asarray, tex)
    args = (jnp.asarray(light), jnp.asarray(look_from), jnp.asarray(look_at), jnp.asarray(up))
    a = jax.tree.map(np.asarray, fn(gj, tj, *args))
    b = jax.tree.map(np.asarray, fn(gj, tj, *args))
    np.testing.assert_array_equal(a["frame"], b["frame"])
    np.testing.assert_array_equal(a["z"], b["z"])
    np.testing.assert_array_equal(a["shadow"], b["shadow"])


def _strip_args(head_scene_data, camera):
    geom, tex = head_scene_data
    light, look_from, look_at, up = camera
    return (
        jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
        jnp.asarray(light), jnp.asarray(look_from), jnp.asarray(look_at),
        jnp.asarray(up),
    )


# strip_planes is a default-off knob; the SHIPPED
# compact-shade path's fast coverage is test_strip_shade_within_tie_flip_
# budget_of_jnp, so the planes-vs-compact pins all run in -m slow.
@pytest.mark.slow
@pytest.mark.parametrize(
    "pipeline",
    ["shadow", "default", "phong", "normal_map", "specular", "darboux"],
)
def test_compact_shade_matches_planes(head_scene_data, camera, pipeline):
    """Compacted shading vs the varying-plane shade on the same kernel
    raster: the compaction changes only which pixels the (identical)
    fragment math runs on.  In interpret mode the two graphs may fuse FMAs
    differently, so a sliver of cast/compare-boundary pixels may flip —
    budgeted at 0.3%; coverage itself is integer-exact and cannot differ.
    (Versus the jnp backend only the raster tie-flip budget applies — the
    two rasters may resolve equal-z fragments to different triangles,
    which flat-shaded pipelines expose as full color changes.)"""
    from tiny_renderer_tpu.pipelines.frame import make_frame_fn

    args = _strip_args(head_scene_data, camera)
    cfg = RenderConfig(width=96, height=96, tile_h=8, tri_block=32)
    assert cfg.compact_shade  # default on kernel backends
    compact = make_frame_fn(pipeline, cfg, backend="pallas_interpret")(*args)
    cfg_planes = RenderConfig(
        width=96, height=96, tile_h=8, tri_block=32, compact_shade=False
    )
    planes = make_frame_fn(pipeline, cfg_planes, backend="pallas_interpret")(*args)

    def mismatch(a, b):
        return (np.asarray(a["frame"]) != np.asarray(b["frame"])).any(axis=-1).mean()

    assert mismatch(compact, planes) <= 0.003
    # Coverage must agree exactly (integer-exact edge tests).  Compare the
    # rasterized z coverage, not frame non-blackness: a covered pixel can
    # legitimately shade to (0,0,0) (grazing light saturates to black).
    from tiny_renderer_tpu.ops.mathlib import F32_MIN

    np.testing.assert_array_equal(
        np.asarray(compact["z"]) > F32_MIN,
        np.asarray(planes["z"]) > F32_MIN,
    )

    # Tiny compaction batches force the full lax.cond cascade; same graph
    # as the default compact config except batch count -> same budget.
    cfg_small = RenderConfig(
        # strip_len pinned: strip_batch * strip_len must stay a multiple of
        # 128 regardless of the shipping strip_len default.
        width=96, height=96, tile_h=8, tri_block=32, strip_batch=8,
        strip_len=16,
    )
    small = make_frame_fn(pipeline, cfg_small, backend="pallas_interpret")(*args)
    assert mismatch(small, planes) <= 0.003


@pytest.mark.parametrize("pipeline", ["phong", "shadow"])
def test_strip_shade_within_tie_flip_budget_of_jnp(head_scene_data, camera, pipeline):
    from tiny_renderer_tpu.pipelines.frame import make_frame_fn

    args = _strip_args(head_scene_data, camera)
    cfg = RenderConfig(width=96, height=96, tile_h=8, tri_block=32)
    ref = np.asarray(make_frame_fn(pipeline, cfg, backend="jnp")(*args)["frame"])
    strips = np.asarray(
        make_frame_fn(pipeline, cfg, backend="pallas_interpret")(*args)["frame"]
    )
    mismatch = (ref != strips).any(axis=-1).mean()
    assert mismatch <= MISMATCH_BUDGET, f"{pipeline}: mismatch {mismatch:.4%}"


# strip_pack_words is a non-default layout knob: its bit-identity pin
# runs in -m slow.
@pytest.mark.slow
@pytest.mark.parametrize("pipeline", ["phong", "shadow"])
def test_writeback_variants_identical(head_scene_data, camera, pipeline):
    """The direct-u8 strip writeback is a pure layout change: frames must
    be bit-identical to the word-packed default on the same backend."""
    import dataclasses

    geom, tex = head_scene_data
    gj = jax.tree.map(jnp.asarray, geom)
    tj = jax.tree.map(jnp.asarray, tex)
    cam = tuple(jnp.asarray(v) for v in camera)
    base = RenderConfig(width=128, height=128)
    ref = make_frame_fn(pipeline, base, backend="pallas_interpret")(gj, tj, *cam)
    for cfg in (dataclasses.replace(base, strip_pack_words=False),):
        out = make_frame_fn(pipeline, cfg, backend="pallas_interpret")(gj, tj, *cam)
        np.testing.assert_array_equal(
            np.asarray(out["frame"]), np.asarray(ref["frame"])
        )

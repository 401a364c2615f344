"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.parallel import (
    make_row_mesh,
    render_batch_sharded,
    render_frame_sharded,
)
from tiny_renderer_tpu.pipelines.frame import make_frame_fn


@pytest.fixture(scope="module")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices (xla_force_host_platform_device_count)")
    return devs[:8]


def _args(scene_data, camera):
    geom, tex = scene_data
    light, look_from, look_at, up = camera
    return (
        jax.tree.map(jnp.asarray, geom),
        jax.tree.map(jnp.asarray, tex),
        jnp.asarray(light),
        jnp.asarray(look_from),
        jnp.asarray(look_at),
        jnp.asarray(up),
    )


# Fast set keeps one single-pass (phong) + one two-pass (shadow) rep;
# darboux/occlusion exercise the same sharded path and run in -m slow.
@pytest.mark.parametrize("pipeline", [
    "phong", "shadow",
    pytest.param("darboux", marks=pytest.mark.slow),
    pytest.param("occlusion", marks=pytest.mark.slow),
])
def test_row_sharded_matches_single_device(head_scene_data, camera, pipeline, eight_devices):
    cfg = RenderConfig(width=96, height=96, tri_block=32)
    mesh = make_row_mesh(eight_devices, batch=1)
    gj, tj, *cam = _args(head_scene_data, camera)

    sharded = render_frame_sharded(gj, tj, *cam, pipeline=pipeline, config=cfg, mesh=mesh)
    single = make_frame_fn(pipeline, cfg, backend="jnp")(gj, tj, *cam)

    np.testing.assert_array_equal(
        np.asarray(sharded["frame"]), np.asarray(single["frame"])
    )
    np.testing.assert_array_equal(np.asarray(sharded["z"]), np.asarray(single["z"]))


@pytest.mark.parametrize("pipeline,backend",
                         [("shadow", "jnp"),
                          pytest.param("occlusion", "jnp",
                                       marks=pytest.mark.slow),
                          pytest.param("shadow", "pallas_interpret",
                                       marks=pytest.mark.slow)])
def test_replicate_pass1_bit_identical(head_scene_data, camera, pipeline,
                                       backend, eight_devices):
    """replicate_pass1 swaps the shadow map's all_gather for full-height
    per-device pass-1 raster (interconnect vs FLOPs knob) — the output must be
    bit-identical both to the collective variant and to single-device,
    and the returned per-shard shadow debug view must reassemble."""
    size = 96 if backend == "jnp" else 64  # pallas: 8 rows/shard = tile_h
    cfg = RenderConfig(width=size, height=size, tri_block=32,
                       **({"tile_h": 8} if backend != "jnp" else {}))
    import dataclasses

    rep = dataclasses.replace(cfg, replicate_pass1=True)
    mesh = make_row_mesh(eight_devices, batch=1)
    gj, tj, *cam = _args(head_scene_data, camera)

    a = render_frame_sharded(gj, tj, *cam, pipeline=pipeline, config=cfg,
                             mesh=mesh, backend=backend)
    b = render_frame_sharded(gj, tj, *cam, pipeline=pipeline, config=rep,
                             mesh=mesh, backend=backend)
    np.testing.assert_array_equal(np.asarray(a["frame"]), np.asarray(b["frame"]))
    np.testing.assert_array_equal(np.asarray(a["shadow"]), np.asarray(b["shadow"]))
    single = make_frame_fn(pipeline, rep, backend=backend)(gj, tj, *cam)
    np.testing.assert_array_equal(
        np.asarray(b["frame"]), np.asarray(single["frame"])
    )


def test_batch_sharded_2d_mesh(head_scene_data, camera, eight_devices):
    cfg = RenderConfig(width=64, height=64, tri_block=32)
    mesh = make_row_mesh(eight_devices, batch=2)
    gj, tj, light, look_from, look_at, up = _args(head_scene_data, camera)

    B = 4
    angles = np.linspace(0, 0.8, B, dtype=np.float32)
    lights = np.stack([[np.sin(a), 0, np.cos(a)] for a in angles]).astype(np.float32)
    froms = np.stack([[np.sin(a + 0.1), 0, np.cos(a + 0.1)] for a in angles]).astype(np.float32)

    out = render_batch_sharded(
        gj, tj, jnp.asarray(lights), jnp.asarray(froms), look_at, up,
        pipeline="phong", config=cfg, mesh=mesh,
    )
    frames = np.asarray(out["frame"])
    assert frames.shape == (B, 64, 64, 3)

    # Each batch entry must equal its single-device render.
    fn = make_frame_fn("phong", cfg, backend="jnp")
    for b in range(B):
        single = fn(gj, tj, jnp.asarray(lights[b]), jnp.asarray(froms[b]), look_at, up)
        np.testing.assert_array_equal(frames[b], np.asarray(single["frame"]))


@pytest.mark.slow  # same entry as test_graft_entry's fast standalone[8] run
def test_dryrun_multichip_entrypoint(eight_devices):
    import importlib.util, os

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


@pytest.mark.parametrize("pipeline", [
    pytest.param("phong", marks=pytest.mark.slow),  # one-pass mirror
    "shadow",  # fast rep: two-pass covers the kernel-in-shard_map path
])
def test_row_sharded_pallas_matches_single(head_scene_data, camera, pipeline, eight_devices):
    """The Pallas kernel inside shard_map (row-tile offsets + local binning
    windows) must reproduce the single-device Pallas render.

    Coverage is integer-exact, so frames may differ only on the rare
    pixels where interpret-mode cross-graph FMA fusion shifts an
    interpolated z/intensity by ULPs across a cast or compare boundary
    (on the card the kernel is a standalone compiled binary and such noise
    cannot occur in the raster outputs; chip_smoke.py --four-cards checks
    bit-equality there); z/shadow get the matching ULP tolerance."""
    cfg = RenderConfig(width=64, height=64, tile_h=8, tri_block=32)
    mesh = make_row_mesh(eight_devices, batch=1)
    gj, tj, *cam = _args(head_scene_data, camera)

    sharded = render_frame_sharded(
        gj, tj, *cam, pipeline=pipeline, config=cfg, mesh=mesh,
        backend="pallas_interpret",
    )
    single = make_frame_fn(pipeline, cfg, backend="pallas_interpret")(gj, tj, *cam)

    frame_mismatch = (
        (np.asarray(sharded["frame"]) != np.asarray(single["frame"]))
        .any(axis=-1)
        .mean()
    )
    assert frame_mismatch <= 0.005, f"frame mismatch {frame_mismatch:.4%}"
    np.testing.assert_allclose(
        np.asarray(sharded["z"]), np.asarray(single["z"]), rtol=1e-5, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(sharded["shadow"]), np.asarray(single["shadow"]),
        rtol=1e-5, atol=1e-3,
    )


def test_sharded_overflow_no_false_positive(head_scene_data, camera, eight_devices):
    """Normal scenes must report overflow=False on the sharded paths."""
    cfg = RenderConfig(width=64, height=64, tile_h=8, tri_block=32)
    mesh = make_row_mesh(eight_devices, batch=1)
    gj, tj, *cam = _args(head_scene_data, camera)
    out = render_frame_sharded(
        gj, tj, *cam, pipeline="shadow", config=cfg, mesh=mesh,
        backend="pallas_interpret",
    )
    assert not bool(np.asarray(out["overflow"]))


def test_sharded_overflow_propagates_coord_overflow(camera, eight_devices):
    """A triangle beyond the int32 exactness envelope must flip overflow on
    the sharded path, matching render_frame's single-device contract."""
    cfg = RenderConfig(width=64, height=64, tri_block=32)
    mesh = make_row_mesh(eight_devices, batch=1)
    positions = np.array(
        [
            [-0.3, -0.3, 0.0], [0.3, -0.3, 0.0], [0.0, 0.3, 0.0],
            # vertex near the projection singularity (w ~ 0): coords ~ 2^18
            [-0.2, -0.2, 0.0], [0.2, -0.2, 0.0], [0.3, 0.2, 5.9999],
        ],
        np.float32,
    )
    idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    geom = {
        "positions": positions,
        "tex_coords": np.full((6, 2), 0.5, np.float32),
        "normals": np.tile(np.array([[0, 0, 1]], np.float32), (6, 1)),
        "pos_idx": idx,
        "tex_idx": idx,
        "normal_idx": idx,
    }
    tex = {
        "texture": np.zeros((16, 16, 3), np.uint8),
        "normal_map": np.zeros((16, 16, 3), np.uint8),
        "normal_map_tangent": np.zeros((16, 16, 3), np.uint8),
        "specular_map": np.zeros((16, 16, 3), np.uint8),
    }
    _, _, light, look_from, look_at, up = _args((geom, tex), camera)
    out = render_frame_sharded(
        jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
        jnp.asarray(np.array([0, 0, 1], np.float32)),
        jnp.asarray(np.array([0, 0, 1], np.float32)),
        look_at, up, pipeline="phong", config=cfg, mesh=mesh,
    )
    assert bool(np.asarray(out["overflow"]))


def test_sharded_needs_z_false_matches(head_scene_data, camera, eight_devices):
    """needs_z=False (kernel backends skip the z-target write; depth stays
    in the kernel's registers) must not change the frame, and returns z=None
    — mirroring the single-device strip-shade strategy."""
    cfg = RenderConfig(width=64, height=64, tile_h=8, tri_block=32)
    mesh = make_row_mesh(eight_devices, batch=1)
    gj, tj, *cam = _args(head_scene_data, camera)
    for backend in ("jnp", "pallas_interpret"):
        withz = render_frame_sharded(
            gj, tj, *cam, pipeline="shadow", config=cfg, mesh=mesh,
            backend=backend,
        )
        noz = render_frame_sharded(
            gj, tj, *cam, pipeline="shadow", config=cfg, mesh=mesh,
            backend=backend, needs_z=False,
        )
        assert noz["z"] is None
        np.testing.assert_array_equal(
            np.asarray(noz["frame"]), np.asarray(withz["frame"])
        )
        np.testing.assert_array_equal(
            np.asarray(noz["shadow"]), np.asarray(withz["shadow"])
        )


@pytest.mark.slow  # fast rep: test_sharded_needs_z_false_matches
def test_batch_sharded_needs_z_false(head_scene_data, camera, eight_devices):
    cfg = RenderConfig(width=64, height=64, tile_h=8, tri_block=32)
    mesh = make_row_mesh(eight_devices, batch=2)
    gj, tj, light, look_from, look_at, up = _args(head_scene_data, camera)
    B = 2
    angles = np.linspace(0, 0.5, B, dtype=np.float32)
    lights = np.stack([[np.sin(a), 0, np.cos(a)] for a in angles]).astype(np.float32)
    froms = np.stack([[np.sin(a + 0.1), 0, np.cos(a + 0.1)] for a in angles]).astype(np.float32)
    ref = render_batch_sharded(
        gj, tj, jnp.asarray(lights), jnp.asarray(froms), look_at, up,
        pipeline="phong", config=cfg, mesh=mesh, backend="pallas_interpret",
    )
    out = render_batch_sharded(
        gj, tj, jnp.asarray(lights), jnp.asarray(froms), look_at, up,
        pipeline="phong", config=cfg, mesh=mesh, backend="pallas_interpret",
        needs_z=False,
    )
    assert out["z"] is None
    np.testing.assert_array_equal(np.asarray(out["frame"]), np.asarray(ref["frame"]))


# Fast reps cover both backends with one pipeline each; the mirrored
# pair runs in -m slow.
@pytest.mark.parametrize("pipeline,backend", [
    ("phong", "jnp"), ("shadow", "pallas_interpret"),
    pytest.param("shadow", "jnp", marks=pytest.mark.slow),
    pytest.param("phong", "pallas_interpret", marks=pytest.mark.slow),
])
def test_triangle_sharded_vertex_bit_identical(
    head_scene_data, camera, pipeline, backend, eight_devices
):
    """shard_triangles (vertex stage sharded over the triangle axis +
    all_gather'ed setup) must be bit-identical to the replicated vertex
    stage: the gathered setup preserves original triangle order, so every
    downstream stage sees the same data.  head's T=2492 is not divisible
    by 8, so the padded-tail path is exercised."""
    import dataclasses

    cfg = RenderConfig(width=64, height=64, tile_h=8, tri_block=32)
    mesh = make_row_mesh(eight_devices, batch=1)
    gj, tj, *cam = _args(head_scene_data, camera)
    outs = {}
    for v in (False, True):
        c = dataclasses.replace(cfg, shard_triangles=v)
        outs[v] = render_frame_sharded(
            gj, tj, *cam, pipeline=pipeline, config=c, mesh=mesh,
            backend=backend,
        )
    np.testing.assert_array_equal(
        np.asarray(outs[True]["frame"]), np.asarray(outs[False]["frame"])
    )
    np.testing.assert_array_equal(
        np.asarray(outs[True]["z"]), np.asarray(outs[False]["z"])
    )
    np.testing.assert_array_equal(
        np.asarray(outs[True]["shadow"]), np.asarray(outs[False]["shadow"])
    )
    assert not bool(np.asarray(outs[True]["overflow"]))


@pytest.mark.slow
def test_flagship_shape_sharded_bit_equal(diablo_scene_data, camera, eight_devices):
    """The actual headline workload — diablo shadow 800x800 — sharded over
    8 row shards must be BIT-equal to the single-device render: exercises
    shard-window binning, the binning key-overflow guard, and strip
    y_offset arithmetic at real scale."""
    cfg = RenderConfig(width=800, height=800, tri_block=64)
    mesh = make_row_mesh(eight_devices, batch=1)
    gj, tj, *cam = _args(diablo_scene_data, camera)

    sharded = render_frame_sharded(
        gj, tj, *cam, pipeline="shadow", config=cfg, mesh=mesh, backend="jnp"
    )
    single = make_frame_fn("shadow", cfg, backend="jnp")(gj, tj, *cam)
    np.testing.assert_array_equal(
        np.asarray(sharded["frame"]), np.asarray(single["frame"])
    )
    np.testing.assert_array_equal(np.asarray(sharded["z"]), np.asarray(single["z"]))
    np.testing.assert_array_equal(
        np.asarray(sharded["shadow"]), np.asarray(single["shadow"])
    )
    assert not bool(np.asarray(sharded["overflow"]))


@pytest.mark.slow
def test_flagship_shape_sharded_kernel_smoke(diablo_scene_data, camera, eight_devices):
    """One pallas_interpret run at flagship XY shape (reduced to a 400x800
    slab grid would change binning windows — keep 800x800, just accept the
    interpret-mode runtime): asserts coverage agreement with the jnp
    sharded render within the tie-flip budget.  5 row shards: 160 rows per
    shard divides tile_h=16 (800/8=100 would not)."""
    cfg = RenderConfig(width=800, height=800, tri_block=64)
    mesh = make_row_mesh(eight_devices[:5], batch=1)
    gj, tj, *cam = _args(diablo_scene_data, camera)
    kern = render_frame_sharded(
        gj, tj, *cam, pipeline="shadow", config=cfg, mesh=mesh,
        backend="pallas_interpret",
    )
    ref = render_frame_sharded(
        gj, tj, *cam, pipeline="shadow", config=cfg, mesh=mesh, backend="jnp"
    )
    mismatch = (
        (np.asarray(kern["frame"]) != np.asarray(ref["frame"])).any(axis=-1).mean()
    )
    assert mismatch <= 0.005, f"kernel-vs-jnp sharded mismatch {mismatch:.4%}"
    assert not bool(np.asarray(kern["overflow"]))


def test_batch_sharded_pallas_backend(head_scene_data, camera, eight_devices):
    """The batch axis must exercise the Pallas kernel too and report a
    per-frame overflow vector."""
    cfg = RenderConfig(width=64, height=64, tile_h=8, tri_block=32)
    mesh = make_row_mesh(eight_devices, batch=2)
    gj, tj, light, look_from, look_at, up = _args(head_scene_data, camera)

    B = 2
    angles = np.linspace(0, 0.5, B, dtype=np.float32)
    lights = np.stack([[np.sin(a), 0, np.cos(a)] for a in angles]).astype(np.float32)
    froms = np.stack([[np.sin(a + 0.1), 0, np.cos(a + 0.1)] for a in angles]).astype(np.float32)

    out = render_batch_sharded(
        gj, tj, jnp.asarray(lights), jnp.asarray(froms), look_at, up,
        pipeline="phong", config=cfg, mesh=mesh, backend="pallas_interpret",
    )
    frames = np.asarray(out["frame"])
    assert frames.shape == (B, 64, 64, 3)
    assert np.asarray(out["overflow"]).shape == (B,)
    assert not np.asarray(out["overflow"]).any()

    fn = make_frame_fn("phong", cfg, backend="pallas_interpret")
    for b in range(B):
        single = fn(gj, tj, jnp.asarray(lights[b]), jnp.asarray(froms[b]), look_at, up)
        np.testing.assert_array_equal(frames[b], np.asarray(single["frame"]))


# ---------------------------------------------------------------------------
# Pipeline parallelism over the two passes: ("stage", "rows") mesh where
# stage 0 rasterizes the light view of frame t while stage 1 shades frame
# t-1 with the shadow map handed over via ppermute (render_sequence_pipelined).


@pytest.mark.parametrize("pipeline", [
    "shadow", pytest.param("occlusion", marks=pytest.mark.slow),
])
def test_pipelined_sequence_matches_single_device(head_scene_data, camera,
                                                  pipeline, eight_devices):
    """Every frame of the pipelined sequence must be bit-identical to the
    single-device render — the stage split and the ppermute handoff are
    pure data movement."""
    from tiny_renderer_tpu.parallel import make_pp_mesh, render_sequence_pipelined

    cfg = RenderConfig(width=96, height=96, tri_block=32)
    mesh = make_pp_mesh(eight_devices)
    gj, tj, light, look_from, look_at, up = _args(head_scene_data, camera)
    B = 3
    angles = np.linspace(0.0, 1.2, B, dtype=np.float32)
    lights = jnp.asarray(np.stack(
        [[np.sin(a), 0.0, np.cos(a)] for a in angles], dtype=np.float32))
    froms = jnp.asarray(np.stack(
        [[np.sin(a + 0.2), 0.0, np.cos(a + 0.2)] for a in angles],
        dtype=np.float32))

    out = render_sequence_pipelined(
        gj, tj, lights, froms, look_at, up, pipeline=pipeline, config=cfg,
        mesh=mesh, backend="jnp",
    )
    assert out["frame"].shape == (B, 96, 96, 3)
    assert not np.any(np.asarray(out["overflow"]))
    single = make_frame_fn(pipeline, cfg, backend="jnp")
    for i in range(B):
        ref = single(gj, tj, lights[i], froms[i], look_at, up)
        np.testing.assert_array_equal(
            np.asarray(out["frame"][i]), np.asarray(ref["frame"]),
            err_msg=f"frame {i}",
        )


@pytest.mark.slow  # kernel pp legs also run fast in the driver dryrun test
def test_pipelined_sequence_pallas_kernel(head_scene_data, camera, eight_devices):
    """The real Pallas raster kernel (interpret mode) + strip shade inside
    the pipelined scan's cond branches must stay bit-identical to the
    single-device kernel path."""
    from tiny_renderer_tpu.parallel import make_pp_mesh, render_sequence_pipelined

    cfg = RenderConfig(width=128, height=64, tri_block=32, tile_h=8)
    mesh = make_pp_mesh(eight_devices)
    gj, tj, light, look_from, look_at, up = _args(head_scene_data, camera)
    B = 2
    angles = np.linspace(0.0, 0.8, B, dtype=np.float32)
    lights = jnp.asarray(np.stack(
        [[np.sin(a), 0.0, np.cos(a)] for a in angles], dtype=np.float32))
    froms = jnp.asarray(np.stack(
        [[np.sin(a + 0.2), 0.0, np.cos(a + 0.2)] for a in angles],
        dtype=np.float32))

    out = render_sequence_pipelined(
        gj, tj, lights, froms, look_at, up, pipeline="shadow", config=cfg,
        mesh=mesh, backend="pallas_interpret",
    )
    single = make_frame_fn("shadow", cfg, backend="pallas_interpret")
    for i in range(B):
        ref = single(gj, tj, lights[i], froms[i], look_at, up)
        np.testing.assert_array_equal(
            np.asarray(out["frame"][i]), np.asarray(ref["frame"]),
            err_msg=f"frame {i}",
        )


def test_pipelined_rejects_invalid_configs(head_scene_data, camera, eight_devices):
    """Single-pass pipelines and the pass-1 strategies that contradict the
    stage split must be rejected loudly, and the mesh shape is validated."""
    import dataclasses

    from tiny_renderer_tpu.parallel import make_pp_mesh, render_sequence_pipelined

    cfg = RenderConfig(width=64, height=64, tri_block=32)
    mesh = make_pp_mesh(eight_devices)
    gj, tj, light, look_from, look_at, up = _args(head_scene_data, camera)
    lights = jnp.stack([light, light])
    froms = jnp.stack([look_from, look_from])
    args = (gj, tj, lights, froms, look_at, up)

    with pytest.raises(ValueError, match="single-pass"):
        render_sequence_pipelined(*args, pipeline="phong", config=cfg, mesh=mesh)
    with pytest.raises(ValueError, match="pass-1"):
        render_sequence_pipelined(
            *args, pipeline="shadow",
            config=dataclasses.replace(cfg, shard_triangles=True), mesh=mesh)
    with pytest.raises(ValueError, match="pass-1"):
        render_sequence_pipelined(
            *args, pipeline="shadow",
            config=dataclasses.replace(cfg, replicate_pass1=True), mesh=mesh)
    with pytest.raises(ValueError, match="stage"):
        render_sequence_pipelined(
            *args, pipeline="shadow", config=cfg,
            mesh=make_row_mesh(eight_devices, batch=1))


def test_pipelined_overflow_contract(camera, eight_devices):
    """A scene that trips the int32 exactness envelope must surface
    overflow=True on every frame of the pipelined sequence — the flag
    rides the same ppermute handoff as the shadow map."""
    from tiny_renderer_tpu.parallel import make_pp_mesh, render_sequence_pipelined

    cfg = RenderConfig(width=64, height=64, tri_block=32)
    mesh = make_pp_mesh(eight_devices)
    positions = np.array(
        [
            [-0.3, -0.3, 0.0], [0.3, -0.3, 0.0], [0.0, 0.3, 0.0],
            # vertex near the projection singularity (w ~ 0): coords ~ 2^18
            [-0.2, -0.2, 0.0], [0.2, -0.2, 0.0], [0.3, 0.2, 5.9999],
        ],
        np.float32,
    )
    idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    geom = {
        "positions": positions,
        "tex_coords": np.full((6, 2), 0.5, np.float32),
        "normals": np.tile(np.array([[0, 0, 1]], np.float32), (6, 1)),
        "pos_idx": idx, "tex_idx": idx, "normal_idx": idx,
    }
    tex = {k: np.zeros((16, 16, 3), np.uint8)
           for k in ("texture", "normal_map", "normal_map_tangent",
                     "specular_map")}
    gj, tj, light, look_from, look_at, up = _args((geom, tex), camera)
    fwd = jnp.asarray(np.array([0, 0, 1], np.float32))
    lights = jnp.stack([fwd, fwd])
    froms = jnp.stack([fwd, fwd])

    out = render_sequence_pipelined(
        gj, tj, lights, froms, look_at, up, pipeline="shadow", config=cfg,
        mesh=mesh, backend="jnp",
    )
    single = make_frame_fn("shadow", cfg, backend="jnp")(
        gj, tj, fwd, fwd, look_at, up)
    assert bool(np.asarray(single["overflow"]))
    assert np.all(np.asarray(out["overflow"]))


@pytest.mark.slow
def test_flagship_shape_pipelined_bit_equal(diablo_scene_data, camera, eight_devices):
    """The headline workload (diablo shadow 800x800) through the pipelined
    two-pass path: every frame of the sequence must be BIT-equal to the
    single-device render — exercises the ppermute shadow handoff, the
    stage-local binning windows, and strip y_offset arithmetic at real
    scale (the pp analog of test_flagship_shape_sharded_bit_equal)."""
    from tiny_renderer_tpu.parallel import make_pp_mesh, render_sequence_pipelined

    cfg = RenderConfig(width=800, height=800, tri_block=64)
    mesh = make_pp_mesh(eight_devices)
    gj, tj, light, look_from, look_at, up = _args(diablo_scene_data, camera)
    B = 2
    angles = np.linspace(0.0, 0.9, B, dtype=np.float32)
    lights = jnp.asarray(np.stack(
        [[np.sin(a), 0.0, np.cos(a)] for a in angles], dtype=np.float32))
    froms = jnp.asarray(np.stack(
        [[np.sin(a + 0.2), 0.0, np.cos(a + 0.2)] for a in angles],
        dtype=np.float32))

    out = render_sequence_pipelined(
        gj, tj, lights, froms, look_at, up, pipeline="shadow", config=cfg,
        mesh=mesh, backend="jnp",
    )
    single = make_frame_fn("shadow", cfg, backend="jnp")
    for i in range(B):
        ref = single(gj, tj, lights[i], froms[i], look_at, up)
        np.testing.assert_array_equal(
            np.asarray(out["frame"][i]), np.asarray(ref["frame"]),
            err_msg=f"frame {i}",
        )
    assert not np.any(np.asarray(out["overflow"]))

"""Capacity/stress: the renderer at 20-80x the reference's triangle count.

The reference tops out at 5,022 triangles; this exercises the dense
(T, ...) design where its actual limits live — binning incidence volume,
the CSR key-space guard, strip compaction over heavy coverage — using
midpoint-subdivided real meshes (assets.mesh_tools).  Subdivision
preserves the silhouette, so renders must stay consistent across
backends and sharding, and the overflow flag must stay False (the caps
are not silently truncating coverage).
"""

import numpy as np
import pytest

from tiny_renderer_tpu.assets.mesh_tools import subdivide_mesh
from tiny_renderer_tpu.config import RenderConfig
from tiny_renderer_tpu.pipelines.frame import make_frame_fn

from conftest import geom_dict, tex_dict


@pytest.fixture(scope="module")
def big_scene(head_model):
    mesh = subdivide_mesh(head_model.mesh, levels=2)  # 2492 -> 39,872 tris
    return geom_dict(mesh), tex_dict(head_model)


def test_subdivision_structure(head_model):
    m1 = subdivide_mesh(head_model.mesh, levels=1)
    assert m1.num_triangles == head_model.mesh.num_triangles * 4
    # Index streams stay in range and PTN-aligned.
    assert m1.pos_idx.shape == m1.tex_idx.shape == m1.normal_idx.shape
    assert m1.pos_idx.max() < m1.positions.shape[0]
    assert m1.tex_idx.max() < m1.tex_coords.shape[0]
    assert m1.normal_idx.max() < m1.normals.shape[0]
    # Corner vertices of each original triangle are preserved exactly.
    np.testing.assert_array_equal(
        m1.positions[m1.pos_idx[0::4, 0]],
        head_model.mesh.positions[head_model.mesh.pos_idx[:, 0]],
    )


def test_subdivided_render_matches_original_silhouette(head_model, camera):
    """Midpoint subdivision cannot move the surface: coverage and z of the
    subdivided render match the original almost everywhere (edge pixels
    may flip by the exact-integer coverage rules at the new shared
    edges)."""
    import jax
    import jax.numpy as jnp

    geom0 = geom_dict(head_model.mesh)
    geom1 = geom_dict(subdivide_mesh(head_model.mesh, levels=1))
    tex = tex_dict(head_model)
    cfg = RenderConfig(width=128, height=128)
    fn = make_frame_fn("phong", cfg, backend="jnp")
    args = lambda g: (
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, tex),
        *map(jnp.asarray, camera),
    )
    o0 = fn(*args(geom0))
    o1 = fn(*args(geom1))
    cov0 = np.asarray(o0["frame"]).any(axis=-1)
    cov1 = np.asarray(o1["frame"]).any(axis=-1)
    assert not bool(np.asarray(o1["overflow"]))
    # Silhouette identical up to a sliver of edge pixels.
    assert (cov0 != cov1).mean() < 0.01


@pytest.mark.parametrize("indirect", [True, False])
def test_csr_indirect_layout_at_any_size(diablo_model, camera, indirect):
    """csr_indirect picks the record layout and nothing else does: a
    20k-triangle scene with a 250k incidence cap keeps the compact
    (T, lanes) table + id list when the knob is on, and the gathered
    (cap, lanes) records when it is off — no device-memory budget
    switches layouts behind the caller's back."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from tiny_renderer_tpu.ops import mathlib as ml
    from tiny_renderer_tpu.ops.binning import bin_triangles, incidence_cap
    from tiny_renderer_tpu.ops.vertex import triangle_setup

    big = geom_dict(subdivide_mesh(diablo_model.mesh, levels=1))  # 20,088
    T = big["pos_idx"].shape[0]
    cfg = RenderConfig(width=128, height=128, csr_indirect=indirect,
                       max_incidences=250_000)
    light, look_from, look_at, up = map(jnp.asarray, camera)
    uniforms = ml.default_prepare(cfg, light, look_from, look_at, up, jnp)
    setup = triangle_setup(jax.tree.map(jnp.asarray, big), uniforms, cfg, xp=jnp)
    rec, tris, starts, ovf = bin_triangles(setup, cfg, ())
    cap = incidence_cap(T, cfg)
    assert not bool(ovf)
    if indirect:
        assert tris is not None and tris.shape == (cap,)
        assert rec.shape[0] == T  # compact per-triangle table
    else:
        assert tris is None
        assert rec.shape[0] == cap  # gathered rows
    assert starts.shape == (cfg.num_tiles + 1,)


@pytest.mark.slow  # 40k-triangle interpret-mode run (~25 s)
@pytest.mark.parametrize("backend", ["pallas_interpret"])
def test_stress_40k_triangles_backends_agree(big_scene, camera, backend):
    """39,872 triangles through the full pipeline: kernel backend agrees
    with jnp (tie-flip budget), no overflow, strip shade handles the
    coverage volume.  Caps: the default max_span clamps must not fire at
    this density (triangles shrink as they multiply)."""
    import jax
    import jax.numpy as jnp

    geom, tex = big_scene
    assert geom["pos_idx"].shape[0] == 39872
    cfg = RenderConfig(width=128, height=128, strip_batch=128, tile_h=8)
    args = (
        jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
        *map(jnp.asarray, camera),
    )
    ref = make_frame_fn("shadow", cfg, backend="jnp")(*args)
    out = make_frame_fn("shadow", cfg, backend=backend)(*args)
    assert not bool(np.asarray(ref["overflow"]))
    assert not bool(np.asarray(out["overflow"]))
    mismatch = (
        (np.asarray(out["frame"]) != np.asarray(ref["frame"]))
        .any(axis=-1).mean()
    )
    assert mismatch <= 0.005, f"stress mismatch {mismatch:.4%}"


@pytest.mark.slow  # 80k-tri interpret run (~1 min): the capacity config
# end-to-end
def test_stress_80k_agrees(diablo_model, camera):
    """The 80k-triangle capacity scene must agree with the jnp dense path
    within the tie-flip budget, with no overflow."""
    import jax
    import jax.numpy as jnp

    geom = geom_dict(subdivide_mesh(diablo_model.mesh, levels=2))
    tex = tex_dict(diablo_model)
    assert geom["pos_idx"].shape[0] == 80352
    cfg = RenderConfig(width=128, height=128, strip_batch=128, tile_h=8)
    args = (
        jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
        *map(jnp.asarray, camera),
    )
    ref = make_frame_fn("phong", cfg, backend="jnp")(*args)
    out = make_frame_fn("phong", cfg, backend="pallas_interpret")(*args)
    assert not bool(np.asarray(ref["overflow"]))
    assert not bool(np.asarray(out["overflow"]))
    mismatch = (
        (np.asarray(out["frame"]) != np.asarray(ref["frame"]))
        .any(axis=-1).mean()
    )
    assert mismatch <= 0.005, f"80k stress mismatch {mismatch:.4%}"


@pytest.mark.slow  # 40k-tri sharded run; shard_triangles' fast reps are
def test_stress_sharded_bit_identical(big_scene, camera):  # in test_parallel
    """The 40k-triangle scene through the row-sharded path (with
    shard_triangles, the axis built for geometry-heavy scenes) is
    bit-identical to single-device."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from tiny_renderer_tpu.parallel.sharding import (
        make_row_mesh,
        render_frame_sharded,
    )

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    geom, tex = big_scene
    cfg = RenderConfig(width=128, height=128, shard_triangles=True)
    args = (
        jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
        *map(jnp.asarray, camera),
    )
    mesh = make_row_mesh(devs[:8], batch=1)
    sharded = render_frame_sharded(
        *args, pipeline="phong", config=cfg, mesh=mesh
    )
    single = make_frame_fn(
        "phong", dataclasses.replace(cfg, shard_triangles=False),
        backend="jnp",
    )(*args)
    np.testing.assert_array_equal(
        np.asarray(sharded["frame"]), np.asarray(single["frame"])
    )

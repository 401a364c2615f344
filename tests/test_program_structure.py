"""Program-structure assertions: what the traced program MATERIALIZES.

The behavior tests prove outputs are right; these prove the perf
contracts hold at the program level: with needs_z=False
the camera pass's full-size z plane is not an output of ANY pallas_call
— on the single-device path and inside the sharded shard_map body — so
the kernel never writes it to device memory.  Counting pallas_call output avals in
the jaxpr is backend-honest: it inspects the traced program, not a
proxy flag.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tiny_renderer_tpu.config import RenderConfig
from tiny_renderer_tpu.pipelines.frame import render_frame

from conftest import geom_dict, tex_dict


def _walk_eqns(jaxpr):
    """Yield every eqn, recursing into params that hold jaxprs
    (pjit, shard_map, scan, cond, while, ...)."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            vs = v if isinstance(v, (list, tuple)) else (v,)
            for w in vs:
                if isinstance(w, jax.extend.core.Jaxpr):
                    yield from _walk_eqns(w)  # shard_map holds a bare Jaxpr
                else:
                    inner = getattr(w, "jaxpr", None)
                    if inner is not None:
                        yield from _walk_eqns(inner)


def _pallas_plane_outputs(pipeline, cfg, needs_z, scene, camera):
    geom, tex = scene
    args = (
        jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
        *map(jnp.asarray, camera),
    )

    def f(*a):
        return render_frame(*a, pipeline=pipeline, config=cfg,
                            backend="pallas_interpret", needs_z=needs_z)

    jaxpr = jax.make_jaxpr(f)(*args)
    plane = (cfg.padded_height, cfg.padded_width)
    shapes = []
    for eqn in _walk_eqns(jaxpr.jaxpr):
        if eqn.primitive.name == "pallas_call":
            shapes += [
                v.aval.shape for v in eqn.outvars
                if v.aval.shape[-2:] == plane
                and v.aval.dtype == jnp.float32
            ]
    return shapes


@pytest.fixture(scope="module")
def scene(head_model):
    return geom_dict(head_model.mesh), tex_dict(head_model)


@pytest.mark.parametrize("pipeline", ["shadow", "phong"])
def test_needs_z_false_elides_z_plane(pipeline, scene, camera):
    cfg = RenderConfig(width=64, height=64, strip_batch=32, tile_h=8)
    with_z = _pallas_plane_outputs(pipeline, cfg, True, scene, camera)
    without = _pallas_plane_outputs(pipeline, cfg, False, scene, camera)
    # Exactly one full-size f32 plane (the camera z target) disappears.
    assert len(with_z) - len(without) == 1, (with_z, without)


def test_sharded_needs_z_false_elides_z_plane(scene, camera):
    """Same contract inside the shard_map body: the sharded program with
    needs_z=False emits one fewer full-shard f32 plane per pallas_call
    set — the single-device write strategy is mirrored (PARITY §5)."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    from tiny_renderer_tpu.parallel.sharding import (
        make_row_mesh,
        render_frame_sharded,
    )

    geom, tex = scene
    cfg = RenderConfig(width=64, height=64, strip_batch=32, tile_h=8)
    mesh = make_row_mesh(devs[:8], batch=1)
    args = (
        jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
        *map(jnp.asarray, camera),
    )
    shard_plane = (cfg.height // 8, cfg.padded_width)

    def planes(needs_z):
        def f(*a):
            return render_frame_sharded(
                *a, pipeline="shadow", config=cfg, mesh=mesh,
                backend="pallas_interpret", needs_z=needs_z,
            )

        jaxpr = jax.make_jaxpr(f)(*args)
        out = []
        for eqn in _walk_eqns(jaxpr.jaxpr):
            if eqn.primitive.name == "pallas_call":
                out += [
                    v.aval.shape for v in eqn.outvars
                    if v.aval.shape[-2:] == shard_plane
                    and v.aval.dtype == jnp.float32
                ]
        return out

    with_z = planes(True)
    without = planes(False)
    assert len(with_z) - len(without) == 1, (with_z, without)

"""Per-stage device-time breakdown (SURVEY.md §5.1's tracing plan).

The reference has no per-stage instrumentation (only the FPS print,
src/app.rs:230-242); this renderer needs one because the whole frame is a
single fused XLA program — wall-clock alone can't attribute time.  This
module compiles CUMULATIVE PREFIXES of render_frame (vertex | +binning |
+raster | full) and reports the deltas as stage costs, with the
device->host frame fetch timed separately.

Protocol: each prefix is compiled and run once untimed, then run `iters`
times, each call timed to `jax.block_until_ready`; the stage's number is
the median.  Compile time never enters a timing.

Caveat recorded with the numbers: XLA fuses each prefix independently, so
deltas are attribution estimates, not exact schedules.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from ..ops import mathlib as ml
from ..ops.vertex import triangle_setup
from ..utils.timing import median_ms
from .frame import (
    PIPELINES,
    _planes_spec,
    _rasterize,
    render_frame,
)
from .shaders import kernel_varying_spec, VARYING_SPECS


def _checksum(*arrays):
    s = jnp.float32(0.0)
    for a in arrays:
        s += jnp.sum(a.astype(jnp.float32))
    return s


def _prefix_fn(pipeline, config, backend, stage):
    """A jittable function running render_frame up to `stage`
    ("vertex" | "bin" | "raster" | "full"), returning a tiny checksum.
    Mirrors render_frame's structure (frame.py:191-264)."""
    spec = PIPELINES[pipeline]

    def fn(geom, textures, light_direction, look_from, look_at, up):
        if stage == "full":
            # Burst posture (needs_z=False): the program being attributed
            # is the headline path.
            out = render_frame(
                geom, textures, light_direction, look_from, look_at, up,
                pipeline=pipeline, config=config, backend=backend,
                needs_z=False,
            )
            return _checksum(out["frame"])

        setups = []
        if spec.two_pass:
            u1 = ml.shadow_pass_1_prepare(config, light_direction, look_at, up, jnp)
            setups.append(
                (triangle_setup(geom, u1, config, matrix_key="shadow_matrix",
                                cull=False, needs=(), xp=jnp), ())
            )
            uniforms = ml.shadow_pass_2_prepare(
                config, light_direction, look_from, look_at, up, jnp
            )
        else:
            uniforms = ml.default_prepare(
                config, light_direction, look_from, look_at, up, jnp
            )
        # Mirror render_frame's spec selection exactly: the strip-compacted
        # shade (default on kernel backends) bins/rasterizes with NO
        # varying lanes (the strip_planes kspec when that knob is on) —
        # profiling the full varying-plane spec here would inflate the
        # bin/raster prefixes and understate the shade delta.
        compact = backend != "jnp" and config.compact_shade
        pspec = _planes_spec(pipeline, textures, config, backend) if compact else None
        if compact:
            kspec = pspec or ()
        elif backend != "jnp":
            kspec = kernel_varying_spec(pipeline, textures, tile=config.tex_tile)
        else:
            kspec = VARYING_SPECS[pipeline]
        setups.append(
            (triangle_setup(geom, uniforms, config, needs=spec.needs, xp=jnp), kspec)
        )

        if stage == "vertex":
            return _checksum(*[s["rx"] for s, _ in setups])

        if stage == "bin":
            if backend == "jnp":  # no binning stage on the dense path
                return _checksum(*[s["rx"] for s, _ in setups])
            from ..ops.binning import bin_triangles

            outs = []
            for s, sp in setups:
                records, tris, starts, _ = bin_triangles(s, config, sp)
                outs += [records[:, 0], starts]
                if tris is not None:
                    outs.append(tris)
            return _checksum(*outs)

        # stage == "raster": run both passes' rasters, skip shading, with
        # the headline path's emit flags (shadow pass z-only, camera pass
        # idx-only on the strip shade).
        outs = []
        for i, (s, sp) in enumerate(setups):
            shadow_pass = spec.two_pass and i == 0
            z, idx, varys, _ = _rasterize(
                s, config, backend, spec=sp,
                emit_idx=not shadow_pass,
                emit_z=shadow_pass or not compact,
            )
            outs.append(z if z is not None else idx)
            if varys is not None:
                outs.append(varys[0])
        return _checksum(*outs)

    return jax.jit(fn)


STAGES = ("vertex", "bin", "raster", "full")
STAGE_LABELS = {
    "vertex": "vertex setup",
    "bin": "+ binning",
    "raster": "+ raster",
    "full": "+ shade (full frame)",
}


def stage_breakdown(scene, iters: int = 12):
    """Measure per-stage device ms for a Scene's pipeline/config/backend.

    Returns (deltas, cumulative): dicts of stage -> ms.  deltas attribute
    each stage's cost as the difference of consecutive prefixes; 'fetch'
    is the frame device->host transfer.
    """
    geom, textures = scene._geom, scene._textures
    backend = scene._frame_fn.keywords["backend"]
    pipeline = scene._frame_fn.keywords["pipeline"]
    config = scene.config
    cam = [jnp.asarray(v) for v in (
        scene._light_direction, scene._look_from, scene._look_at, scene._up)]

    cumulative = {}
    for stage in STAGES:
        fn = _prefix_fn(pipeline, config, backend, stage)
        cumulative[stage], _ = median_ms(
            lambda: fn(geom, textures, *cam), max(1, iters))

    # Frame fetch (device->host blit) of an already-finished frame.
    scene.render()
    scene.block_until_ready()
    t0 = time.perf_counter()
    n_fetch = max(2, iters // 2)
    for _ in range(n_fetch):
        scene.get_frame_buffer()
    fetch_ms = (time.perf_counter() - t0) * 1e3 / n_fetch

    deltas = {}
    prev = 0.0
    for stage in STAGES:
        deltas[stage] = cumulative[stage] - prev
        prev = cumulative[stage]
    deltas["fetch"] = fetch_ms
    return deltas, cumulative


def print_stage_breakdown(scene, iters: int = 6, out=print):
    deltas, cumulative = stage_breakdown(scene, iters)
    out("per-stage device time (cumulative-prefix deltas):")
    for stage in STAGES:
        out(
            f"  {STAGE_LABELS[stage]:22s} {deltas[stage]:8.3f} ms"
            f"   (prefix total {cumulative[stage]:8.3f} ms)"
        )
    out(f"  {'frame fetch (blit)':22s} {deltas['fetch']:8.3f} ms")
    return deltas

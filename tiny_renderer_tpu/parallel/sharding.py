"""Multi-device scale-out: shard_map over screen-row shards (+ frame batch).

The reference is a single-process renderer with no distributed story
(SURVEY.md §5.8).  The scale-out maps the renderer's natural data
parallelism onto a jax.sharding.Mesh:

* "rows" axis — the screen's y axis is sharded; triangles (a few thousand,
  ~KBs) are replicated, so each device rasterizes and shades only its own
  row slab with zero communication.  The single cross-device dependency is
  the shadow map of two-pass pipelines: pass 1 depth is computed row-local
  and `jax.lax.all_gather`ed over the interconnect (NVLink between cards)
  before pass 2's arbitrary-position
  lookups (shader.rs:762-785 can sample anywhere).
* "batch" axis — independent frames (animation/orbit burst rendering) shard
  trivially: render_batch_sharded shards a batch of camera/light states over
  "batch" and rows over "rows" on a 2D mesh.
* triangle axis (config.shard_triangles) — the vertex stage optionally
  shards the TRIANGLE dimension across the "rows" devices (each transforms
  a contiguous T/n slice; the per-triangle setup is all_gather'ed before
  binning) — the TP analog for geometry-heavy scenes, where row sharding
  would replicate the whole vertex stage per device.

Everything compiles under one jit/shard_map.  make_row_mesh / make_pp_mesh
lay jax.devices() out in order; the four cards of one host are joined all
to all, so no order is worse than another.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import mathlib as ml
from ..ops.vertex import triangle_setup
from ..pipelines import shaders
from ..pipelines.frame import (
    PIPELINES,
    registry_generation,
    resolve_backend,
    _add_const_gather,
    _fragments_from_planes,
    _planes_spec,
    _rasterize,
    _shade_jnp_path,
    _shade_strips,
    _shadow_for_shade,
)
from ..pipelines.shaders import VARYING_SPECS, kernel_varying_spec


def make_row_mesh(devices=None, batch: int = 1):
    """Mesh over ("batch", "rows"). batch=1 gives a pure row mesh."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    import numpy as np

    arr = np.array(devices).reshape(batch, n // batch)
    return Mesh(arr, axis_names=("batch", "rows"))


def _tri_sharded_setup(geom, uniforms, config, n_rows, *, matrix_key="vpmv",
                       cull=True, needs=()):
    """Vertex stage sharded over the triangle axis (the TP analog).

    Row sharding replicates the whole vertex stage on every device; for
    geometry-heavy scenes that is the dominant replicated work.  Here each
    device transforms only its contiguous T/n slice of the triangles and
    the per-triangle setup is all_gather'ed over "rows" before binning
    (every triangle can land in any row window).  Communication is the
    (T, ~40 f32) setup — small next to the per-shard compute it removes
    at large T.

    The gathered array keeps the ORIGINAL triangle order (shard d owns
    originals [d*Tp, (d+1)*Tp); padding rows carry global ids >= T and
    are marked invalid), so the reference's polygon-order tie-break is
    untouched.  Returns the full setup dict with n*Tp-row arrays (inert
    padded tail) and the any-reduced coord_overflow scalar.
    """
    d = jax.lax.axis_index("rows")
    T = geom["pos_idx"].shape[0]
    Tp = -(-T // n_rows)

    def tri_slice(a):
        pad = [(0, n_rows * Tp - T)] + [(0, 0)] * (a.ndim - 1)
        return jax.lax.dynamic_slice_in_dim(
            jnp.pad(a, pad, mode="edge"), d * Tp, Tp
        )

    local = dict(geom)
    for k in list(local):
        if k in ("pos_idx", "tex_idx", "normal_idx", "pos_tri", "uv_tri",
                 "normal_tri") or k.startswith("attr:"):
            # Per-triangle arrays shard over the triangle axis; custom
            # "attr:" planes are (T, 3, k) and slice the same way.
            local[k] = tri_slice(local[k])
    setup = triangle_setup(
        local, uniforms, config, matrix_key=matrix_key, cull=cull,
        needs=needs, xp=jnp,
    )
    gid = d * Tp + jnp.arange(Tp, dtype=jnp.int32)
    setup["valid"] = setup["valid"] & (gid < T)
    ovf = jnp.any(jax.lax.all_gather(setup.pop("coord_overflow"), "rows"))
    setup = {
        k: jax.lax.all_gather(v, "rows").reshape((-1,) + v.shape[1:])
        for k, v in setup.items()
    }
    setup["coord_overflow"] = ovf
    return setup


def _assemble_shade(setup, idx, pipeline, uniforms, textures, config,
                    shadow_full, y0, rows_per_shard, compact, kspec,
                    varys=None):
    """Texture pack + shadow relayout + shade of one rasterized row slab —
    the tail every sharded path shares (identical to frame.render_frame's
    shade assembly, slab-local scatter targets, global pixel coords)."""
    spec = PIPELINES[pipeline]
    vspec = VARYING_SPECS[pipeline]
    if _needs_pack(textures, pipeline, config.tex_tile):
        textures = shaders.pack_textures(
            textures, _pipeline_maps()[pipeline], jnp, tile=config.tex_tile
        )
    if spec.two_pass:
        shadow_full = _shadow_for_shade(shadow_full, spec, config)
    if compact:
        return _shade_strips(
            setup, idx, pipeline, uniforms, textures, config,
            shadow_full if spec.two_pass else None, y_offset=y0,
            planes=varys, planes_spec=kspec,
        )
    if varys is None:
        frag = _shade_jnp_path(setup, idx, pipeline, config, y_offset=y0)
    else:
        frag = _fragments_from_planes(
            kspec, varys, rows_per_shard, config.width, y_offset=y0
        )
        _add_const_gather(frag, kspec, vspec, setup, idx)
    if spec.two_pass:
        frag["shadow_buffer"] = shadow_full
    colors = spec.shade(frag, uniforms, textures, config, jnp)
    covered = (idx >= 0)[..., None]
    return jnp.where(covered, colors, jnp.uint8(0))


def _camera_pass_and_shade(setup, uniforms, pipeline, textures, config,
                           backend, rows_per_shard, y0, shadow_full, needs_z):
    """Camera-pass raster + shade of one row slab given the ASSEMBLED full
    shadow map (None for single-pass pipelines) — the slab analog of
    frame.render_frame's camera stage, shared by the row-sharded and
    pipeline-parallel paths.  Returns (frame, z, overflow)."""
    spec = PIPELINES[pipeline]
    compact = backend != "jnp" and config.compact_shade
    if compact:
        kspec = _planes_spec(pipeline, textures, config, backend) or ()
    else:
        kspec = (
            kernel_varying_spec(pipeline, textures, tile=config.tex_tile)
            if backend != "jnp"
            else VARYING_SPECS[pipeline]
        )
    # Each device rasterizes only its own slab of rows_per_shard rows from
    # global row y0 (a whole tile row).
    z, idx, varys, ovf = _rasterize(
        setup, config, backend, spec=kspec, emit_z=needs_z,
        rows=rows_per_shard, y0=y0,
    )
    ovf = ovf | setup["coord_overflow"]
    frame = _assemble_shade(
        setup, idx, pipeline, uniforms, textures, config, shadow_full, y0,
        rows_per_shard, compact, kspec, varys=varys,
    )
    return frame, z, ovf


def _render_shard(geom, textures, light_direction, look_from, look_at, up,
                  *, pipeline, config, rows_per_shard, backend="jnp",
                  needs_z=True, n_rows=1):
    """Render this device's row slab.  Runs inside shard_map with axis "rows".

    needs_z=False (static) drops the camera pass's z output — on the kernel
    backends the z target is never written (depth stays in the kernel's
    registers), mirroring frame.render_frame's single-device strategy;
    the return tuple then omits z.
    """
    spec = PIPELINES[pipeline]
    W = config.width
    d = jax.lax.axis_index("rows")
    y0 = d * rows_per_shard

    if config.shard_triangles and n_rows > 1:
        make_setup = functools.partial(_tri_sharded_setup, n_rows=n_rows)
    else:
        def make_setup(geom, uniforms, config, **kw):
            return triangle_setup(geom, uniforms, config, xp=jnp, **kw)

    if spec.two_pass:
        u1 = ml.shadow_pass_1_prepare(config, light_direction, look_at, up, jnp)
        setup1 = make_setup(
            geom, u1, config, matrix_key="shadow_matrix", cull=False, needs=()
        )
        uniforms = ml.shadow_pass_2_prepare(
            config, light_direction, look_from, look_at, up, jnp
        )
        uniforms["shadow_matrix"] = u1["shadow_matrix"]
    else:
        uniforms = ml.default_prepare(config, light_direction, look_from, look_at, up, jnp)
        setup1 = None
        ovf1 = jnp.asarray(False)

    setup = make_setup(geom, uniforms, config, needs=spec.needs)
    # Same shade/raster strategy as the single-device path
    # (frame.render_frame): strip-compacted shading on the kernel backends —
    # each device compacts and shades only its own slab's covered strips.
    if spec.two_pass:
        if config.replicate_pass1:
            # Rasterize the light view at FULL height on every device: no
            # collective at all, n x redundant pass-1 compute.  The
            # full-height raster is exactly the single-device pass 1, so
            # the assembled map is bit-identical to the all_gather.
            shadow_full, _, _, ovf1 = _rasterize(
                setup1, config, backend, emit_idx=False
            )
            shadow_local = jax.lax.dynamic_slice_in_dim(
                shadow_full, y0, rows_per_shard
            )
        else:
            shadow_local, _, _, ovf1 = _rasterize(
                setup1, config, backend, emit_idx=False,
                rows=rows_per_shard, y0=y0,
            )
            # The only cross-device dependency: assemble the full shadow
            # map.
            shadow_full = jax.lax.all_gather(shadow_local, "rows").reshape(-1, W)
        ovf1 = ovf1 | setup1["coord_overflow"]
    else:
        shadow_local = jnp.full((rows_per_shard, W), ml.F32_MIN, jnp.float32)
        shadow_full = None
    frame, z, ovf2 = _camera_pass_and_shade(
        setup, uniforms, pipeline, textures, config, backend,
        rows_per_shard, y0, shadow_full, needs_z,
    )

    # Per-shard overflow (binning caps / coord exactness drops), shape (1,)
    # so shard_map can concatenate over "rows"; callers any()-reduce it.
    overflow = jnp.reshape(ovf1 | ovf2, (1,))
    if not needs_z:
        return frame, shadow_local, overflow
    return frame, z, shadow_local, overflow


def _pipeline_maps():
    from ..pipelines.frame import _PIPELINE_MAPS

    return _PIPELINE_MAPS


def _needs_pack(textures, pipeline, tile=0):
    from ..pipelines.frame import _pk_needed

    return _pk_needed(textures, pipeline, tile)


@functools.partial(
    jax.jit,
    static_argnames=("pipeline", "config", "mesh", "backend", "needs_z", "gen"),
)
def _render_frame_sharded_jit(
    geom, textures, light_direction, look_from, look_at, up, *, pipeline, config, mesh,
    backend="jnp", needs_z=True, gen=0,
):
    del gen  # static-key-only (pipeline registration generation)
    config = config.resolve(pipeline)
    n_rows = mesh.shape["rows"]
    if config.height % n_rows != 0:
        raise ValueError(f"height {config.height} not divisible by rows axis {n_rows}")
    rows_per = config.height // n_rows
    if backend != "jnp" and rows_per % config.tile_h != 0:
        raise ValueError(
            f"shard height {rows_per} not divisible by tile_h {config.tile_h}"
        )

    body = functools.partial(
        _render_shard, pipeline=pipeline, config=config, rows_per_shard=rows_per,
        backend=backend, needs_z=needs_z, n_rows=n_rows,
    )
    rep = P()
    row_plane = P("rows", None)
    out_specs = (P("rows", None, None),) + (
        (row_plane,) if needs_z else ()
    ) + (row_plane, P("rows"))
    outs = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(rep, rep, rep, rep, rep, rep),
        out_specs=out_specs,
        check_vma=False,
    )(geom, textures, light_direction, look_from, look_at, up)
    if needs_z:
        frame, z, shadow, ovf = outs
    else:
        (frame, shadow, ovf), z = outs, None
    # Same contract as render_frame: any shard hitting a binning cap or the
    # coord exactness envelope is surfaced, not silently truncated.
    return {"frame": frame, "z": z, "shadow": shadow, "overflow": jnp.any(ovf)}


def render_frame_sharded(
    geom, textures, light_direction, look_from, look_at, up, *, pipeline,
    config, mesh, backend="auto", needs_z=True,
):
    """Row-sharded single frame. Returns dict(frame, z, shadow) of full size.

    config.height must be divisible by the "rows" axis size (and, for the
    pallas backends, each shard's rows by tile_h).  needs_z=False skips the
    camera pass's z target entirely (returned "z" is None) — the kernel
    backends then never write it, matching the single-device path.
    """
    # The registration generation rides in the static jit key so a
    # re-registered pipeline name never hits stale executables
    # (frame.registry_generation).
    return _render_frame_sharded_jit(
        geom, textures, light_direction, look_from, look_at, up,
        pipeline=pipeline, config=config, mesh=mesh, backend=resolve_backend(backend),
        needs_z=needs_z, gen=registry_generation(pipeline),
    )


@functools.partial(
    jax.jit,
    static_argnames=("pipeline", "config", "mesh", "backend", "needs_z", "gen"),
)
def _render_batch_sharded_jit(
    geom, textures, light_directions, look_froms, look_at, up, *, pipeline, config, mesh,
    backend="jnp", needs_z=True, gen=0,
):
    del gen  # static-key-only (pipeline registration generation)
    config = config.resolve(pipeline)
    n_batch = mesh.shape["batch"]
    n_rows = mesh.shape["rows"]
    B = light_directions.shape[0]
    if B % n_batch != 0:
        raise ValueError(f"batch {B} not divisible by batch axis {n_batch}")
    if config.height % n_rows != 0:
        raise ValueError(f"height {config.height} not divisible by rows axis {n_rows}")
    rows_per = config.height // n_rows
    if backend != "jnp" and rows_per % config.tile_h != 0:
        raise ValueError(
            f"shard height {rows_per} not divisible by tile_h {config.tile_h}"
        )

    def body(geom, textures, lights, froms, look_at, up):
        shard = functools.partial(
            _render_shard, pipeline=pipeline, config=config, rows_per_shard=rows_per,
            backend=backend, needs_z=needs_z, n_rows=n_rows,
        )
        outs = jax.vmap(
            lambda l, f: shard(geom, textures, l, f, look_at, up)
        )(lights, froms)
        if needs_z:
            frame, z, _, ovf = outs
            return frame, z, ovf  # ovf: (B_local, 1), concatenated over "rows"
        frame, _, ovf = outs
        return frame, ovf

    rep = P()
    frame_spec = P("batch", "rows", None, None)
    z_spec = P("batch", "rows", None)
    out_specs = (frame_spec,) + ((z_spec,) if needs_z else ()) + (P("batch", "rows"),)
    outs = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(rep, rep, P("batch", None), P("batch", None), rep, rep),
        out_specs=out_specs,
        check_vma=False,
    )(geom, textures, light_directions, look_froms, look_at, up)
    if needs_z:
        frames, zs, ovfs = outs
    else:
        (frames, ovfs), zs = outs, None
    return {"frame": frames, "z": zs, "overflow": jnp.any(ovfs, axis=1)}


def render_batch_sharded(
    geom, textures, light_directions, look_froms, look_at, up, *, pipeline,
    config, mesh, backend="auto", needs_z=True,
):
    """Batch of frames on a 2D ("batch", "rows") mesh.

    light_directions/look_froms: (B, 3) sharded over "batch"; each frame's
    rows are sharded over "rows".  Returns frames (B, H, W, 3) plus a
    per-frame (B,) overflow flag (same contract as render_frame).
    needs_z=False (the burst/animation posture) skips the z targets.
    """
    return _render_batch_sharded_jit(
        geom, textures, light_directions, look_froms, look_at, up,
        pipeline=pipeline, config=config, mesh=mesh, backend=resolve_backend(backend),
        needs_z=needs_z, gen=registry_generation(pipeline),
    )


def make_pp_mesh(devices=None):
    """Mesh over ("stage", "rows") for two-pass pipeline parallelism
    (render_sequence_pipelined): stage 0 rasterizes the light pass of
    frame t while stage 1 shades frame t-1.  Needs an even device count;
    each stage group row-shards its own pass over "rows"."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % 2 != 0:
        raise ValueError(f"pipeline mesh needs an even device count, have {n}")
    import numpy as np

    arr = np.array(devices).reshape(2, n // 2)
    return Mesh(arr, axis_names=("stage", "rows"))


def render_sequence_pipelined(
    geom, textures, light_directions, look_froms, look_at, up, *, pipeline,
    config, mesh, backend="auto",
):
    """Two-pass PIPELINE parallelism over a ("stage", "rows") mesh.

    The reference renders its two passes back-to-back on one device
    (src/app.rs:230-242 drives the orbit; shader.rs:668-963 is the
    depth-pre-pass + shade).  Here the passes are split ACROSS the mesh's
    "stage" axis and software-pipelined over a frame sequence inside one
    lax.scan: at step t, stage 0 rasterizes the LIGHT view of frame t
    (row-sharded over its "rows" group) while stage 1 runs the camera
    pass + shade of frame t-1 with the shadow map handed over via
    jax.lax.ppermute at the end of step t-1.  Steady-state throughput is
    max(pass 1, pass 2) per step instead of their sum — the win over pure
    row sharding appears when intra-frame row scaling saturates (small
    slabs / many devices), the same regime PP targets in ML serving.

    Collectives are uniform across the mesh (the per-stage divergence
    lives in collective-free lax.cond branches): one all_gather over
    "rows" assembles the light map inside each stage group (stage 1's is
    discarded), one ppermute moves it stage 0 -> stage 1.  Frames are
    bit-identical to render_frame_sharded / the single-device path — the
    slab raster/shade code is shared (frame._rasterize,
    _camera_pass_and_shade) and the handoff is a pure permutation.

    Only two-pass pipelines make sense here (ValueError otherwise);
    config.shard_triangles and replicate_pass1 are pass-1 strategies that
    contradict the stage split and are rejected.  The burst posture is
    assumed (no z targets).  Returns {"frame": (B, H, W, 3),
    "overflow": (B,)}.
    """
    return _render_sequence_pipelined_jit(
        geom, textures, light_directions, look_froms, look_at, up,
        pipeline=pipeline, config=config, mesh=mesh, backend=resolve_backend(backend),
        gen=registry_generation(pipeline),
    )


@functools.partial(
    jax.jit, static_argnames=("pipeline", "config", "mesh", "backend", "gen")
)
def _render_sequence_pipelined_jit(
    geom, textures, light_directions, look_froms, look_at, up, *, pipeline,
    config, mesh, backend="jnp", gen=0,
):
    del gen  # static-key-only (pipeline registration generation)
    config = config.resolve(pipeline)
    spec = PIPELINES[pipeline]
    if not spec.two_pass:
        raise ValueError(
            f"pipeline {pipeline!r} is single-pass; pipeline parallelism "
            "splits the shadow pre-pass from the shade — use "
            "render_batch_sharded instead"
        )
    if config.shard_triangles or config.replicate_pass1:
        raise ValueError(
            "shard_triangles / replicate_pass1 are pass-1 strategies "
            "incompatible with the stage split"
        )
    if dict(mesh.shape).get("stage") != 2 or "rows" not in mesh.shape:
        raise ValueError(f'mesh must have axes ("stage"=2, "rows"); got {dict(mesh.shape)}')
    n_rows = mesh.shape["rows"]
    if config.height % n_rows != 0:
        raise ValueError(f"height {config.height} not divisible by rows axis {n_rows}")
    rows_per = config.height // n_rows
    if backend != "jnp" and rows_per % config.tile_h != 0:
        raise ValueError(
            f"shard height {rows_per} not divisible by tile_h {config.tile_h}"
        )
    B = light_directions.shape[0]
    H, W = config.height, config.width

    # Pack the loop-invariant texture plane ONCE before the scan (the
    # in-body _assemble_shade detects the packed key and skips a repack).
    if _needs_pack(textures, pipeline, config.tex_tile):
        textures = shaders.pack_textures(
            textures, _pipeline_maps()[pipeline], jnp, tile=config.tex_tile
        )

    # Shifted parameter streams: step t consumes frame t's LIGHT on
    # stage 0 and frame t-1's light+camera on stage 1 (B+1 steps total;
    # the fill/drain steps are skipped by the step-counter gates below).
    lights_t = jnp.concatenate([light_directions, light_directions[-1:]], 0)
    lights_p = jnp.concatenate([light_directions[:1], light_directions], 0)
    froms_p = jnp.concatenate([look_froms[:1], look_froms], 0)
    steps = jnp.arange(B + 1, dtype=jnp.int32)

    def body(geom, textures, lights_t, lights_p, froms_p, steps, look_at, up):
        stage = jax.lax.axis_index("stage")
        d = jax.lax.axis_index("rows")
        y0 = d * rows_per

        def step(carry, xs):
            shadow_prev, ovf_prev = carry
            l_t, l_p, f_p, t = xs

            # Stage 0: light-view slab of frame t.  Collective-free branch.
            def pass1(_):
                u1 = ml.shadow_pass_1_prepare(config, l_t, look_at, up, jnp)
                setup1 = triangle_setup(
                    geom, u1, config, matrix_key="shadow_matrix", cull=False,
                    needs=(), xp=jnp,
                )
                slab, _, _, o = _rasterize(
                    setup1, config, backend, emit_idx=False,
                    rows=rows_per, y0=y0,
                )
                return slab, jnp.reshape(
                    (o | setup1["coord_overflow"]).astype(jnp.int32), (1,)
                )

            def idle1(_):
                return (
                    jnp.full((rows_per, W), ml.F32_MIN, jnp.float32),
                    jnp.zeros((1,), jnp.int32),
                )

            # Step-counter gates skip the fill/drain waste: the last step
            # has no frame t to pre-rasterize, the first no frame t-1 to
            # shade.  Uniform within each "rows" group (t is global), so
            # the collectives below stay mesh-uniform.
            slab_t, ovf1_t = jax.lax.cond(
                (stage == 0) & (t < B), pass1, idle1, None
            )
            # Uniform collectives: every "rows" group assembles its stage's
            # full-height map (stage 1's gathered garbage is discarded).
            shadow_t = jax.lax.all_gather(slab_t, "rows").reshape(-1, W)
            ovf1_t = jnp.sum(jax.lax.all_gather(ovf1_t, "rows"), dtype=jnp.int32)
            ovf1_t = jnp.reshape(ovf1_t, (1,))

            # Stage 1: camera pass + shade of frame t-1 with the carried
            # map.  Collective-free branch (shared slab code).
            def pass2(_):
                u1p = ml.shadow_pass_1_prepare(config, l_p, look_at, up, jnp)
                uniforms = ml.shadow_pass_2_prepare(
                    config, l_p, f_p, look_at, up, jnp
                )
                uniforms["shadow_matrix"] = u1p["shadow_matrix"]
                setup = triangle_setup(
                    geom, uniforms, config, needs=spec.needs, xp=jnp
                )
                frame, _, o = _camera_pass_and_shade(
                    setup, uniforms, pipeline, textures, config, backend,
                    rows_per, y0, shadow_prev, needs_z=False,
                )
                return frame, jnp.reshape(o.astype(jnp.int32), (1,))

            def idle2(_):
                return (
                    jnp.zeros((rows_per, W, 3), jnp.uint8),
                    jnp.zeros((1,), jnp.int32),
                )

            frame_slab, ovf2 = jax.lax.cond(
                (stage == 1) & (t >= 1), pass2, idle2, None
            )

            # Handoff: frame t's light map (and its pass-1 overflow) moves
            # stage 0 -> stage 1 for the next step; stage 0's carry slots
            # receive ppermute's zero fill and are never read.
            shadow_next = jax.lax.ppermute(shadow_t, "stage", [(0, 1)])
            ovf1_next = jax.lax.ppermute(ovf1_t, "stage", [(0, 1)])
            # Frame t-1's overflow = its pass-1 flag (carried) | pass-2.
            out_ovf = ((ovf_prev + ovf2) > 0).astype(jnp.int32)
            return (shadow_next, ovf1_next), (frame_slab, out_ovf)

        carry0 = (
            jnp.zeros((H, W), jnp.float32),
            jnp.zeros((1,), jnp.int32),
        )
        xs = (lights_t, lights_p, froms_p, steps)
        _, (frames, ovfs) = jax.lax.scan(step, carry0, xs)
        return frames, ovfs  # (B+1, rows_per, W, 3), (B+1, 1)

    rep = P()
    outs = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(rep,) * 8,
        out_specs=(
            P(None, ("stage", "rows"), None, None),
            P(None, ("stage", "rows")),
        ),
        check_vma=False,
    )(geom, textures, lights_t, lights_p, froms_p, steps, look_at, up)
    frames_full, ovfs_full = outs  # (B+1, 2H, W, 3), (B+1, 2*n_rows)
    # Steps 1..B of the stage-1 half are frames 0..B-1; step 0 is the
    # pipeline-fill step and the first half is stage 0's zero slabs.
    frames = frames_full[1:, H:]
    overflow = jnp.any(ovfs_full[1:] > 0, axis=1)
    return {"frame": frames, "overflow": overflow}


# The sharded jits are also keyed on the pipeline NAME; each public
# wrapper above threads frame.registry_generation(pipeline) into the
# static jit key, so register_pipeline(overwrite=True)/
# unregister_pipeline invalidate their compiled executables without a
# global cache clear.

"""Screen-tile triangle binning for the Pallas raster kernel.

The reference bounds raster work per triangle with a bbox scan
(src/scene.rs:233-241); the data-parallel analog is tiling: the screen is cut into
(tile_h x tile_w) tiles and each triangle is binned into every tile its
screen-clamped bbox overlaps.  The Pallas kernel then only evaluates
(tile, triangle) pairs that can actually produce coverage — the blockwise
decomposition that bounds the O(pixels x triangles) product (SURVEY.md §5.7).

Strategy: incidence-key sort into a CSR list.  Each triangle contributes
up to max_span_y * max_span_x (tile, triangle) incidences; the packed keys
`tile_id * K + tri_id` of the full candidate grid are sorted in one
(T * span,) sort, per-tile ranges are recovered with searchsorted, and the
records are gathered ONCE into (tile, triangle)-sorted CSR order — each
raster-kernel program walks its tile's [starts[t], starts[t+1]) slice.
(config.binning_compact instead compacts the 2-3 real
incidences/triangle before a smaller sort.)  Per-tile list length is unbounded (dense
regions just own longer slices), which removed the per-tile-capacity
overflow class entirely; the only caps are:

* bbox span clamped to max_span_y x max_span_x tiles (default 16 x 8 =
  256 x 512 px) — triangles larger than that lose coverage beyond the cap;
* the global incidence cap (default 8x triangle count vs a typical 2-3x);
  on overflow the tail is dropped in generation (triangle-major) order.

Both deterministic, both far above the reference scenes, both reported via
`overflowed`.  The critical invariant holds: within each tile, triangle
indices ascend, preserving the reference's polygon-order tie-break
(shader.rs:169-180).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Packed per-triangle base record layout (f32 lanes) for the raster kernel.
#   0: a1   1: b1   2: c1   3: a2   4: b2   5: c2
#   6: sgn (sign of cz, +-1)   7: |cz|   8: 1/cz
#   9: z1  10: z2  11: z3  12: global triangle index (exact in f32, T < 2^24)
# Varying lanes (driven by a pipelines.shaders.VARYING_SPECS entry) follow:
# "interp" varyings contribute 3 lanes per component (v0, v1, v2); "const"
# varyings 1 lane per component; "zfrag" reuses base lanes 9-11.
BASE_LANES = 13


def _round_up(x, m):
    return -(-x // m) * m


def compact_scatter(mask, values, out_len, fill):
    """Front-compact values[mask] into an (out_len,) array, fill elsewhere.

    The cheap deterministic compaction idiom this codebase standardizes
    on (a flat cumsum and a scatter to monotone positions, instead of
    jnp.nonzero).  Entries beyond out_len (mask count overflow) are
    dropped deterministically in input order.  Used by the strip-shade
    covered-strip compaction; the binning incidence compaction uses the
    same scatter but derives positions from a T-sized per-triangle
    prefix.
    """
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mask, pos, out_len)
    return (
        jnp.full((out_len,), fill, values.dtype)
        .at[tgt]
        .set(values, mode="drop")
    )


def record_lanes(spec) -> int:
    n = BASE_LANES
    for name, comps, mode in spec or ():
        if mode == "interp":
            n += 3 * comps
        elif mode == "const":
            n += comps
        elif mode.startswith("texidx"):
            n += 6  # uv interp lanes; the kernel folds them into one plane
    return _round_up(max(n, 16), 8)


def pack_triangle_records(setup, spec=(), xp=jnp):
    """(T, record_lanes(spec)) f32 record per triangle."""
    from ..pipelines.shaders import _CONST_SOURCES, _INTERP_SOURCES

    czf = setup["cz"].astype(xp.float32)
    safe = xp.where(setup["cz"] == 0, xp.float32(1.0), czf)
    sgn = xp.where(czf < 0, xp.float32(-1.0), xp.float32(1.0))
    T = setup["a1"].shape[0]
    cols = [
        setup["a1"].astype(xp.float32),
        setup["b1"].astype(xp.float32),
        setup["c1"].astype(xp.float32),
        setup["a2"].astype(xp.float32),
        setup["b2"].astype(xp.float32),
        setup["c2"].astype(xp.float32),
        sgn,
        xp.abs(czf),
        xp.float32(1.0) / safe,
        setup["zv"][:, 0],
        setup["zv"][:, 1],
        setup["zv"][:, 2],
        xp.arange(T, dtype=xp.float32) if xp is jnp else xp.arange(T, dtype=np.float32),
    ]
    for name, comps, mode in spec or ():
        if mode == "interp":
            for c in range(comps):
                for v in range(3):
                    cols.append(_INTERP_SOURCES[name](setup, c, v))
        elif mode == "const":
            for c in range(comps):
                cols.append(_CONST_SOURCES[name](setup, c))
        elif mode.startswith("texidx"):
            for c in range(2):
                for v in range(3):
                    cols.append(_INTERP_SOURCES["uv"](setup, c, v))
    rec = xp.stack(cols, axis=-1)
    pad = record_lanes(spec) - rec.shape[-1]
    return xp.pad(rec, [(0, 0), (0, pad)])


def incidence_cap(T: int, config) -> int:
    """Static CSR capacity: generous vs the 2-3 incidences/triangle of the
    reference-shaped scenes at the default 16 x 64 tiles."""
    if config.max_incidences is not None:
        cap = config.max_incidences
    else:
        cap = max(8 * T, 4096)
    cap = min(cap, T * config.max_span_y * config.max_span_x)
    return _round_up(cap, 8)


def bin_triangles(setup, config, spec=(), row_tile_offset=0):
    """Bin triangles into screen tiles as a CSR incidence list.

    Per-tile triangle lists are variable-length slices of ONE flat record
    array (no per-tile capacity — dense regions can hold arbitrarily many
    triangles up to the global incidence cap), ascending by triangle index
    within each tile (the reference's polygon-order tie-break).

    row_tile_offset: first global tile-row this (row-sharded) bin covers;
    config then describes the LOCAL shard (config.tiles_y rows).  0 for the
    single-device full frame.

    Returns (records, tris, starts, overflowed):
      records: f32 triangle records.  config.csr_indirect=False: the
        (incidence_cap, record_lanes(spec)) gathered CSR array in
        (tile, triangle) order, tris is None.  csr_indirect=True: the
        compact (T, record_lanes(spec)) per-triangle table; tris is the
        (incidence_cap,) i32 sorted triangle-id list the kernel indirects
        through — this skips the cap-row record gather here (cap defaults
        to 8T).  Both layouts give bit-identical pixels.
      starts: (num_tiles + 1,) i32 — tile t owns slot range [starts[t],
        starts[t+1]) of the incidence list
      overflowed: () bool — a coverage cap was hit (span clamp, or total
        incidences beyond the cap: the tail of the generation order loses
        coverage)
    """
    th, tw = config.tile_h, config.tile_w
    n_tx = config.tiles_x
    num_tiles = config.num_tiles
    msy, msx = config.max_span_y, config.max_span_x

    T = setup["valid"].shape[0]
    # Key packing: key = tile_id * K + tri_id must fit in i32.
    K = 1 << int(T).bit_length()
    if num_tiles * K >= 2**31:
        raise ValueError(
            f"binning key overflow: {num_tiles} tiles x {T} triangles; "
            "use larger tiles or shard the screen"
        )
    cap = incidence_cap(T, config)

    n_ty = config.tiles_y
    valid = setup["valid"]
    tx0 = setup["x0"] // tw
    tx1 = setup["x1"] // tw
    ty0 = setup["y0"] // th - row_tile_offset
    ty1 = setup["y1"] // th - row_tile_offset
    # Row-shard window: keep triangles overlapping local tile rows [0, n_ty).
    valid = valid & (ty1 >= 0) & (ty0 <= n_ty - 1)
    ty0 = jnp.clip(ty0, 0, n_ty - 1)
    ty1 = jnp.clip(ty1, 0, n_ty - 1)
    span_x = tx1 - tx0
    span_y = ty1 - ty0
    span_clamped = jnp.any(valid & ((span_x > msx - 1) | (span_y > msy - 1)))

    dy = jnp.arange(msy, dtype=jnp.int32)
    dx = jnp.arange(msx, dtype=jnp.int32)
    # (T, msy, msx) candidate tiles.
    tile = (ty0[:, None, None] + dy[None, :, None]) * n_tx + (
        tx0[:, None, None] + dx[None, None, :]
    )
    ok = (
        valid[:, None, None]
        & (dy[None, :, None] <= span_y[:, None, None])
        & (dx[None, None, :] <= span_x[:, None, None])
    )
    tri_ids = jnp.arange(T, dtype=jnp.int32)
    key = jnp.where(ok, tile * K + tri_ids[:, None, None], jnp.int32(2**31 - 1))
    okf = ok.reshape(-1)
    total = jnp.sum(okf, dtype=jnp.int32)
    # Compact the 2-3 real incidences/triangle out of the (T, msy, msx)
    # candidate grid BEFORE sorting: the sort then runs on cap (~8T) keys
    # instead of the full candidate grid.  Scatter positions come from a
    # T-sized exclusive cumsum of per-triangle incidence counts plus each
    # slot's local rank, not a cumsum over the whole grid.  On cap
    # overflow the tail is dropped in generation order (triangle-major)
    # — deterministic, flagged via `overflowed`.
    if config.binning_compact:
        # Clamped spans: the candidate grid only generates dy < msy, dx < msx,
        # so counts/ranks must use min(span+1, max_span) — unclamped spans
        # would inflate the exclusive prefix for span-clamped triangles,
        # leaving sentinel gaps that push later triangles past the cap.
        sy = jnp.minimum(span_y + 1, msy)
        sx = jnp.minimum(span_x + 1, msx)
        counts = jnp.where(valid, sy * sx, 0)
        base = jnp.cumsum(counts) - counts  # exclusive prefix
        local = dy[None, :, None] * sx[:, None, None] + dx[None, None, :]
        tgt = jnp.where(
            ok, base[:, None, None] + local, jnp.int32(cap)
        ).reshape(-1)
        compacted = (
            jnp.full((cap,), 2**31 - 1, jnp.int32)
            .at[tgt]
            .set(key.reshape(-1), mode="drop")
        )
        keys_sorted = jnp.sort(compacted)  # (cap,)
    else:
        keys_sorted = jnp.sort(key.reshape(-1))  # full candidate grid (v3)

    # Per-tile ranges: starts[t] = first incidence of tile t, clamped to cap.
    boundaries = jnp.arange(num_tiles + 1, dtype=jnp.int32) * K
    starts = jnp.searchsorted(keys_sorted, boundaries, side="left").astype(jnp.int32)
    starts = jnp.minimum(starts, jnp.int32(cap))
    overflowed = (total > cap) | span_clamped

    csr_tris = (keys_sorted[:cap] & jnp.int32(K - 1)).astype(jnp.int32)
    csr_tris = jnp.minimum(csr_tris, T - 1)  # sentinel slots -> harmless row

    records = pack_triangle_records(setup, spec, jnp)
    if config.csr_indirect:
        return records, csr_tris, starts, overflowed
    return records[csr_tris], None, starts, overflowed

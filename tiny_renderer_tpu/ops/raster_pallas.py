"""Binned raster kernel for the GPU (Pallas, Triton route) — the fast path.

One program per screen tile, over grid (tiles_y, tiles_x).  Programs are
independent: each starts its tile fresh, walks the triangles binned to it
(ops/binning.py, the slice [starts[t], starts[t+1]) of the sorted CSR list)
and stores its tile once.  Inside a program:

* **Phase 1 — depth resolve**: per triangle, exact integer coverage tests
  (src/scene.rs:174-197 over integer raster coords; values < 2^24 held in
  f32) and a strict `z > best` update.  Triangles are visited in ascending
  global index order (binning sorts), so equal-z fragments keep the earliest
  triangle — exactly the serial reference's `z <= stored -> reject` rule
  (shader.rs:169-180).  Deterministic and bit-stable.  The tile's z and
  winning index stay in registers across the whole variable-length loop.
* **Phase 2 — varying interpolation** (only when a varying spec is given):
  per triangle, pixels it won get their varyings (uv, diffuse intensity,
  depth, Darboux pieces — see pipelines.shaders.VARYING_SPECS) interpolated
  with the reference's exact-division barycentrics.

The triangle table is either the compact (T, lanes) per-triangle record
array indirected through the (cap,) sorted triangle-id list
(config.csr_indirect), or the pre-gathered (cap, lanes) CSR array.  Both,
and the (num_tiles + 1,) offsets, are passed whole and read with scalar
loads; the flagship's records are a few hundred KB and stay in L2.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .binning import BASE_LANES
from .mathlib import F32_MIN

# Warps per program: 8 warps over a 16x64 tile give each thread 4 pixels.
NUM_WARPS = 8


def _plane_layout(spec):
    """[(mode, record_lane)] for each output plane of `spec`.

    mode "texidx:W:H" consumes 6 record lanes (uv per-vertex values) and
    produces one plane holding the flat texel index (exact integer in f32).
    """
    planes = []
    lane = BASE_LANES
    for name, comps, mode in spec or ():
        if mode.startswith("texidx"):
            planes.append((mode, lane))
            lane += 6
            continue
        for _ in range(comps):
            if mode == "interp":
                planes.append(("interp", lane))
                lane += 3
            elif mode == "const":
                planes.append(("const", lane))
                lane += 1
            else:  # zfrag — interpolates base z lanes 9..11
                planes.append(("zfrag", 9))
    return planes


def _div_rn(a, b, interpret):
    """IEEE round-to-nearest f32 division.  On the card Triton lowers `/` to
    the approximate div.full.f32; the varying planes must match
    compute_varyings' exact division, so ask for div.rn.f32 directly."""
    if interpret:
        return a / b
    b = jnp.broadcast_to(b, a.shape)
    [out] = plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;",
        args=[a, b],
        constraints="=r,r,r",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape, a.dtype)],
    )
    return out


def _raster_kernel(
    starts_ref, row_off_ref, *refs,
    tile_h, tile_w, tiles_x, spec, emit_idx, emit_z, indirect, interpret,
):
    planes = _plane_layout(spec)
    refs = list(refs)
    tris_ref = refs.pop(0) if indirect else None
    rec_ref = refs.pop(0)
    z_ref = refs.pop(0) if emit_z else None
    idx_ref = refs.pop(0) if emit_idx else None
    plane_refs = refs

    ty = pl.program_id(0)
    tx = pl.program_id(1)
    tile = ty * tiles_x + tx
    start = starts_ref[tile]
    end = starts_ref[tile + 1]
    row_off = row_off_ref[0]  # global tile-row offset of this (row-sharded) grid

    # Pixel coordinates of this tile (f32 holding exact integers).
    cols = jnp.arange(tile_w, dtype=jnp.int32)[None, :] + tx * tile_w
    rows = jnp.arange(tile_h, dtype=jnp.int32)[:, None] + (ty + row_off) * tile_h
    pxf = jnp.broadcast_to(cols, (tile_h, tile_w)).astype(jnp.float32)
    pyf = jnp.broadcast_to(rows, (tile_h, tile_w)).astype(jnp.float32)

    def rec(k, lane):
        if tris_ref is None:
            return rec_ref[k, lane]
        return rec_ref[tris_ref[k], lane]

    def edge_functions(k):
        cx = rec(k, 0) * pxf + rec(k, 1) * pyf + rec(k, 2)
        cy = rec(k, 3) * pxf + rec(k, 4) * pyf + rec(k, 5)
        return cx, cy

    # Phase 1 — depth resolve, z and idx carried in registers.
    def depth_body(k, carry):
        z_cur, idx_cur = carry
        cx, cy = edge_functions(k)
        sgn = rec(k, 6)
        absz = rec(k, 7)
        rcz = rec(k, 8)
        cxs = cx * sgn
        cys = cy * sgn
        zero = jnp.float32(0.0)
        inside = (cxs >= zero) & (cys >= zero) & (absz - cxs - cys >= zero)
        u = cx * rcz
        v = cy * rcz
        w = jnp.float32(1.0) - (cx + cy) * rcz
        zval = (w * rec(k, 9) + u * rec(k, 10)) + v * rec(k, 11)
        win = inside & (zval > z_cur)
        gidx = rec(k, 12).astype(jnp.int32)
        return jnp.where(win, zval, z_cur), jnp.where(win, gidx, idx_cur)

    z0 = jnp.full((tile_h, tile_w), F32_MIN, jnp.float32)
    i0 = jnp.full((tile_h, tile_w), -1, jnp.int32)
    z, idx = jax.lax.fori_loop(start, end, depth_body, (z0, i0))
    if z_ref is not None:
        z_ref[...] = z
    if idx_ref is not None:
        idx_ref[...] = idx
    if not planes:
        return

    # Phase 2 — varying planes of the pixels each triangle won.
    def vary_body(k, acc):
        mask = idx == rec(k, 12).astype(jnp.int32)
        cx, cy = edge_functions(k)
        sgn = rec(k, 6)
        absz = rec(k, 7)
        # Exact-division barycentrics (scene.rs:192-196): cx/cz computed as
        # (cx*sgn)/|cz| — the sign flip is exact, so the rounding matches the
        # reference's single division by cz bit-for-bit.
        u = _div_rn(cx * sgn, absz, interpret)
        v = _div_rn(cy * sgn, absz, interpret)
        w = jnp.float32(1.0) - _div_rn((cx + cy) * sgn, absz, interpret)
        out = []
        for (mode, lane), cur in zip(planes, acc):
            if mode == "const":
                val = jnp.full((tile_h, tile_w), rec(k, lane))
            elif mode.startswith("texidx"):
                # Fold uv interpolation + the reference's texel addressing
                # ((uv*dim) as u32 then clamp, util.rs:35-40 + our clamp
                # divergence) into one exact-integer-in-f32 index plane.
                parts = mode.split(":")
                wdim = jnp.float32(int(parts[1]))
                hdim = jnp.float32(int(parts[2]))
                # Optional 4th field: tile-swizzled plane layout
                # (config.tex_tile; see shaders._swizzle_index).
                swz = int(parts[3]) if len(parts) > 3 else 0
                uu = (rec(k, lane) * w + rec(k, lane + 1) * u) + rec(k, lane + 2) * v
                vv = (rec(k, lane + 3) * w + rec(k, lane + 4) * u) + rec(k, lane + 5) * v
                zero = jnp.float32(0.0)
                xw = uu * wdim
                yw = vv * hdim
                xw = jnp.where(jnp.isnan(xw), zero, xw)
                yw = jnp.where(jnp.isnan(yw), zero, yw)
                cxp = jnp.minimum(jnp.trunc(jnp.maximum(xw, zero)), wdim - 1.0)
                cyp = jnp.minimum(jnp.trunc(jnp.maximum(yw, zero)), hdim - 1.0)
                if swz:
                    # Tile-swizzled flat index; every op is exact in f32
                    # (coords < 2^20, and the tile is a power of two, so
                    # multiplying by its reciprocal is exact and trunc
                    # recovers the integer quotient).
                    fB = jnp.float32(swz)
                    inv = jnp.float32(1.0 / swz)
                    btx = jnp.trunc(cxp * inv)
                    bty = jnp.trunc(cyp * inv)
                    ix = cxp - btx * fB
                    iy = cyp - bty * fB
                    ntx = jnp.float32(int(parts[1]) // swz)
                    val = ((bty * ntx + btx) * fB + iy) * fB + ix
                else:
                    val = cyp * wdim + cxp
            else:  # interp / zfrag: (a0*w + a1*u) + a2*v
                val = (rec(k, lane) * w + rec(k, lane + 1) * u) + rec(k, lane + 2) * v
            out.append(jnp.where(mask, val, cur))
        return tuple(out)

    zeros = tuple(jnp.zeros((tile_h, tile_w), jnp.float32) for _ in planes)
    acc = jax.lax.fori_loop(start, end, vary_body, zeros)
    for r, val in zip(plane_refs, acc):
        r[...] = val


@functools.partial(
    jax.jit,
    static_argnames=(
        "tile_h", "tile_w", "tiles_y", "tiles_x", "spec", "emit_idx", "emit_z",
        "interpret",
    ),
)
def rasterize_pallas(
    records,
    starts,
    row_tile_offset=None,
    csr_tris=None,
    *,
    tile_h,
    tile_w,
    tiles_y,
    tiles_x,
    spec=(),
    emit_idx=True,
    emit_z=True,
    interpret=False,
):
    """Run the raster kernel.

    Args:
      records: f32 triangle records from bin_triangles.  Without csr_tris:
        the (incidence_cap, lanes) gathered array in (tile, triangle) CSR
        order.  With csr_tris (csr_indirect): the compact (T, lanes)
        per-triangle table, indirected through csr_tris inside the kernel.
      starts: (num_tiles + 1,) i32 CSR offsets.
      row_tile_offset: optional (1,) i32 global tile row of this grid's
        first row (the row-sharded path); 0 when None.
      csr_tris: optional (incidence_cap,) i32 sorted triangle ids.
      tile_h, tile_w: powers of two (Triton blocks).
      spec: pipelines.shaders.VARYING_SPECS entry (static).
      emit_idx: write the winning-triangle-index target.  Depth-only passes
        (the shadow map, shader.rs:694-709) need only max z.
      emit_z: write the depth target.  The strip-compacted shade consumes
        idx only.
      interpret: run the kernel body with the Pallas interpreter (CPU tests).

    Returns (z, idx, varyings) of spatial shape (tiles_y*tile_h,
    tiles_x*tile_w): winning depth (F32_MIN where uncovered; None if not
    emitted), winning triangle index (-1 where uncovered; None if not
    emitted), and the (num_planes, H, W) f32 interpolated varyings (None if
    spec is empty).
    """
    H = tiles_y * tile_h
    W = tiles_x * tile_w
    n_planes = len(_plane_layout(spec))
    assert emit_z or emit_idx or n_planes, "kernel must emit at least one target"
    for d in (tile_h, tile_w):
        assert d > 0 and d & (d - 1) == 0, "tiles must be powers of two"

    if row_tile_offset is None:
        row_tile_offset = jnp.zeros((1,), jnp.int32)
    inputs = [starts, row_tile_offset.astype(jnp.int32)]
    if csr_tris is not None:
        inputs.append(csr_tris)
    inputs.append(records)

    def whole(arr):
        return pl.BlockSpec(arr.shape, lambda ty, tx: (0,) * arr.ndim)

    tile_spec = pl.BlockSpec((tile_h, tile_w), lambda ty, tx: (ty, tx))
    out_shape = []
    if emit_z:
        out_shape.append(jax.ShapeDtypeStruct((H, W), jnp.float32))
    if emit_idx:
        out_shape.append(jax.ShapeDtypeStruct((H, W), jnp.int32))
    out_shape += [jax.ShapeDtypeStruct((H, W), jnp.float32)] * n_planes

    kernel = functools.partial(
        _raster_kernel,
        tile_h=tile_h,
        tile_w=tile_w,
        tiles_x=tiles_x,
        spec=spec,
        emit_idx=emit_idx,
        emit_z=emit_z,
        indirect=csr_tris is not None,
        interpret=interpret,
    )
    outs = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(tiles_y, tiles_x),
        in_specs=[whole(a) for a in inputs],
        out_specs=[tile_spec] * len(out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="raster_tile",
    )(*inputs)
    outs = list(outs)
    z = outs.pop(0) if emit_z else None
    idx = outs.pop(0) if emit_idx else None
    varys = jnp.stack(outs) if n_planes else None
    return z, idx, varys

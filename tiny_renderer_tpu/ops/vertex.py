"""Batched vertex stage: all triangles at once.

The reference runs a serial per-polygon vertex shader that mutates shared
`Buffer` varyings (reference: src/scene.rs:212-232, shader.rs:30-35), which
is what forces it single-threaded (SURVEY.md §2.2.8).  Here the whole vertex
stage is one batched computation over (T, ...) arrays:

* gather positions/uvs/normals per triangle,
* backface cull against the camera direction
  (should_cull_face, shader.rs:116-124),
* homogeneous transform + perspective divide + trunc-toward-zero raster
  coords (store_vertex_transformation_results, shader.rs:150-165),
* uv v-flip at vertex time (store_vertex_uvs, shader.rs:136-147),
* per-pipeline varyings: face/vertex light intensities, transformed
  positions/normals for the darboux tangent basis,
* integer edge-function coefficients for the raster stage.

Because raster x/y are i32, the barycentric cross product of the reference
(src/scene.rs:174-197) has exactly-representable integer intermediates
(|value| < 2^22 << 2^24), so the edge coefficients computed here make the
raster stage's coverage tests *exact*, not approximate.

xp-agnostic: used by both the JAX renderer and the NumPy oracle.
"""

from __future__ import annotations

from . import mathlib as ml

# Largest |raster coord| for which the int32 edge-coefficient arithmetic is
# exact (see docs/DESIGN.md): products <= 2^29, per-pixel evals <= 2^30.
EXACT_COORD_MAX = 1 << 14


def gather_triangles(geom, xp):
    """Per-triangle attribute gather: positions (T,3v,3), uvs (T,3v,2), normals.

    The index arrays are frame-invariant, so these gathers (~60k rows/frame
    for diablo shadow: pos for both passes + uv + normal) can be hoisted
    out of the frame entirely: if the geometry was pre-expanded with
    expand_geometry (Scene does this once at construction), the
    (T, 3, ...) arrays are used directly."""
    if "pos_tri" in geom:
        return {
            "pos": geom["pos_tri"],
            "uv_raw": geom["uv_tri"],
            "normal": geom["normal_tri"],
        }
    return {
        "pos": geom["positions"][geom["pos_idx"]],
        "uv_raw": geom["tex_coords"][geom["tex_idx"]],
        "normal": geom["normals"][geom["normal_idx"]],
    }


def expand_geometry(geom):
    """Geometry dict plus the pre-expanded per-triangle attribute arrays.

    One-time cost (three T*3-row gathers, ~0.5 MB for diablo) paid at scene
    construction instead of once per frame per pass."""
    out = dict(geom)
    out["pos_tri"] = geom["positions"][geom["pos_idx"]]
    out["uv_tri"] = geom["tex_coords"][geom["tex_idx"]]
    out["normal_tri"] = geom["normals"][geom["normal_idx"]]
    return out


def face_normals(pos, xp):
    """Untransformed face normal: (p1-p0) x (p2-p0) (shader.rs:117-118)."""
    return ml.cross3(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0], xp)


def triangle_setup(geom, uniforms, config, *, matrix_key="vpmv", cull=True, needs=(), xp=None):
    """Compute the full per-triangle raster + varying setup.

    Args:
      geom: dict of geometry arrays (positions/tex_coords/normals + index arrays).
      uniforms: output of one of the mathlib prepare functions.
      matrix_key: which uniform matrix transforms vertices — "vpmv" for camera
        passes, "shadow_matrix" for the shadow/occlusion depth pass
        (shader.rs:682-687 uses buffer.shadow_matrix).
      cull: apply backface culling (the shadow depth pass does not,
        shader.rs:679).
      needs: subset of {"face_intensity", "vertex_intensity", "darboux"}.

    Returns dict of (T, ...) arrays:
      valid: triangle produces fragments (not culled, not degenerate,
        non-empty clamped bbox)
      rx, ry: (T, 3) i32 raster coords;  zv: (T, 3) f32
      a1,b1,c1,a2,b2,c2,cz: (T,) i32 edge coefficients (cz == barycentric
        denominator; cz == 0 <=> the reference's degenerate |cross.z| < 1 test)
      x0,x1,y0,y1: (T,) i32 screen-clamped bbox (inclusive)
      uv: (T, 3, 2) f32 (v flipped);  plus requested varyings.
    """
    tris = gather_triangles(geom, xp)
    pos = tris["pos"]
    T = pos.shape[0]

    m = uniforms[matrix_key]
    tp = ml.mat4_transform_point(m, pos, xp)  # (T, 3, 3) screen-space
    rx = ml.rust_f32_to_i32(tp[..., 0], xp)
    ry = ml.rust_f32_to_i32(tp[..., 1], xp)
    zv = tp[..., 2]

    # Exactness envelope: the integer edge-coefficient products below are
    # exact in int32 only for |coords| <= 2^14 (products <= 2^29, per-pixel
    # edge evaluations <= 2^30; see docs/DESIGN.md).  Geometry projecting
    # with near-zero homogeneous w can produce raster coords up to ~2^31,
    # whose products would silently wrap — mark such triangles invalid and
    # surface the event as coord_overflow (the reference's f32 cross product
    # merely loses precision there; scene.rs:174-197).
    # Range compare, NOT abs: abs(INT32_MIN) wraps to INT32_MIN (negative)
    # and would pass the envelope for maximally-overflowing coords.
    in_exact = xp.all(
        (rx >= -EXACT_COORD_MAX) & (rx <= EXACT_COORD_MAX)
        & (ry >= -EXACT_COORD_MAX) & (ry <= EXACT_COORD_MAX),
        axis=1,
    )

    x1, x2, x3 = rx[:, 0], rx[:, 1], rx[:, 2]
    y1, y2, y3 = ry[:, 0], ry[:, 1], ry[:, 2]
    # Edge-function coefficients: cross.x = a1*px + b1*py + c1,
    # cross.y = a2*px + b2*py + c2, cross.z = cz (constant), matching
    # to_barycentric_coord (src/scene.rs:174-197) exactly over integers.
    a1 = y3 - y1
    b1 = -(x3 - x1)
    c1 = x3 * y1 - x1 * y3
    a2 = -(y2 - y1)
    b2 = x2 - x1
    c2 = x1 * y2 - x2 * y1
    cz = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)

    keep = xp.ones((T,), dtype=bool)
    if cull:
        fn = face_normals(pos, xp)
        keep = ml.dot3(uniforms["camera_direction"], fn) > xp.float32(0.0)
    # Degenerate: |cross.z| < 1 over integers <=> cz == 0 (scene.rs:188-191).
    keep = keep & (cz != 0)

    # Screen-clamped inclusive bbox (scene.rs:160-171, :236-239).
    xmin = xp.minimum(xp.minimum(x1, x2), x3)
    xmax = xp.maximum(xp.maximum(x1, x2), x3)
    ymin = xp.minimum(xp.minimum(y1, y2), y3)
    ymax = xp.maximum(xp.maximum(y1, y2), y3)
    x0 = xp.maximum(xmin, 0)
    x1c = xp.minimum(xmax, config.width - 1)
    y0 = xp.maximum(ymin, 0)
    y1c = xp.minimum(ymax, config.height - 1)
    keep = keep & (x0 <= x1c) & (y0 <= y1c)

    # Triangles that would rasterize on-screen but exceed the exactness
    # envelope: dropped (coverage loss) — callers surface this flag.
    coord_overflow = xp.any(keep & ~in_exact)
    keep = keep & in_exact

    uv_raw = tris["uv_raw"]
    uv = xp.stack([uv_raw[..., 0], xp.float32(1.0) - uv_raw[..., 1]], axis=-1)

    out = {
        "valid": keep,
        "rx": rx,
        "ry": ry,
        "zv": zv,
        "a1": a1,
        "b1": b1,
        "c1": c1,
        "a2": a2,
        "b2": b2,
        "c2": c2,
        "cz": cz,
        "x0": x0,
        "x1": x1c,
        "y0": y0,
        "y1": y1c,
        "uv": uv,
        "coord_overflow": coord_overflow,
    }

    # User vertex attributes (register_pipeline varying names "attr:*"):
    # per-corner (T, 3, k) float planes supplied alongside the geometry,
    # untouched by the matrix stack, interpolated like uv.  Passed through
    # here so every consumer — the packed fragment gather, the oracle, the
    # sharded paths — sees them as ordinary setup keys.
    for key, val in geom.items():
        if key.startswith("attr:"):
            a = xp.asarray(val, dtype=xp.float32)
            if a.ndim != 3 or a.shape[0] != T or a.shape[1] != 3:
                raise ValueError(
                    f"custom vertex attribute {key!r} must have shape "
                    f"(num_triangles={T}, 3, k); got {a.shape}"
                )
            out[key] = a

    if "face_intensity" in needs:
        # Flat shading: face normal through it_m, one diffuse coefficient
        # broadcast to the triangle (shader.rs:297-305).
        fn = face_normals(pos, xp)
        t_fn = ml.normalize3(ml.mat4_transform_vector(uniforms["it_m"], fn, xp), xp)
        diff = ml.dot3(uniforms["t_light_direction"], t_fn)
        out["intensity"] = xp.broadcast_to(diff[:, None], (T, 3))
    if "vertex_intensity" in needs:
        # Per-vertex Gouraud/Phong intensities (shader.rs:362-373).
        n = tris["normal"]
        t_n = ml.normalize3(ml.mat4_transform_vector(uniforms["it_m"], n, xp), xp)
        out["intensity"] = ml.dot3(uniforms["t_light_direction"], t_n)
    if "darboux" in needs:
        # Transformed positions (m) and normals (it_m) per vertex
        # (shader.rs:561-584) for the per-fragment Darboux basis.  The
        # reference recomputes the basis rows and uv deltas per fragment, but
        # they are per-triangle constants — precompute them here once.
        t_pos = ml.mat4_transform_point(uniforms["m"], pos, xp)
        n = tris["normal"]
        out["t_norm"] = ml.normalize3(
            ml.mat4_transform_vector(uniforms["it_m"], n, xp), xp
        )
        # vertex_t_positions * (-1,1,0) = p1 - p0; * (-1,0,1) = p2 - p0
        # (shader.rs:612-623), normalized.
        out["row0n"] = ml.normalize3(t_pos[:, 1] - t_pos[:, 0], xp)
        out["row1n"] = ml.normalize3(t_pos[:, 2] - t_pos[:, 0], xp)
        # uv deltas (shader.rs:632-643): (u1-u0, u2-u0) and (v1-v0, v2-v0).
        out["du"] = xp.stack(
            [uv[:, 1, 0] - uv[:, 0, 0], uv[:, 2, 0] - uv[:, 0, 0]], axis=-1
        )
        out["dv"] = xp.stack(
            [uv[:, 1, 1] - uv[:, 0, 1], uv[:, 2, 1] - uv[:, 0, 1]], axis=-1
        )
    return out

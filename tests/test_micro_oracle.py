"""Independent END-TO-END micro-frame oracle.

test_shader_fixtures anchors the fragment math independently, but the
vertex stage + prepare stack (ops/vertex.py, ops/mathlib.py) are shared
between the NumPy oracle and the device path — a transcription error there
is invisible to oracle parity.  This
file closes that hole: a scalar float64 transliteration of the FULL Rust
reference path — prepare (shader.rs:183-279), vertex shaders
(shader.rs:282-869), the serial bbox-scan raster of Scene::render
(scene.rs:151-268), and every fragment shader — that shares NO code with
tiny_renderer_tpu, run on tiny scenes (<=16 triangles, 32x32) across all 7
pipelines and asserted EXACTLY equal (u8 frames) to both the NumPy oracle
and the jnp device path.

Fixture robustness (the test's own validity check, in the spirit of
test_shader_fixtures.assert_margin): float64-vs-float32 noise must not be
able to flip any discrete decision, so the micro renderer tracks a margin
at every one — geometry-level decisions (raster trunc, cull) are hard
asserts the scenes are designed to satisfy; per-fragment decisions within
a margin of their boundary (texel pick, u8 cast, shadow compare, index
round, depth near-tie) mark that PIXEL fragile, and fragile pixels are
excluded from the exact-equality assertion with a cap on their fraction.
Everything outside the (tiny, quantified) fragile set must match EXACTLY.
"""

import math

import numpy as np
import pytest

# Scalar fragment-math helpers (already the independent transcription of
# the Rust fragment semantics — reused, still zero package code).
from test_shader_fixtures import (
    ref_color_blend,
    ref_decode_normal,
    ref_dot,
    ref_mat3_inverse,
    ref_mat3_vec,
    ref_normalize,
    ref_round,
    ref_tex_color,
    ref_u8_cast,
)

F32_MIN = -3.4028234663852886e38  # f32::MIN (scene.rs:131-132)

# ---------------------------------------------------------------------------
# Scalar float64 linear algebra (nalgebra semantics, shader.rs file:line cited)
# ---------------------------------------------------------------------------


def v_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def v_scale(a, s):
    return tuple(x * s for x in a)


def v_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def m4_mul(a, b):
    """4x4 * 4x4, plain left-to-right accumulation (nalgebra gemm)."""
    return [
        [sum(a[i][k] * b[k][j] for k in range(4)) for j in range(4)]
        for i in range(4)
    ]


def m4_point(m, p):
    """Point3::from_homogeneous(m * p_h): w = 1, divide by w' (shader.rs:157-158)."""
    o = [m[i][0] * p[0] + m[i][1] * p[1] + m[i][2] * p[2] + m[i][3] for i in range(4)]
    return (o[0] / o[3], o[1] / o[3], o[2] / o[3])


def m4_vector(m, v):
    """Vector3::from_homogeneous(m * v_h): w = 0 (shader.rs:226-228)."""
    return tuple(m[i][0] * v[0] + m[i][1] * v[1] + m[i][2] * v[2] for i in range(3))


def m4_transpose(m):
    return [[m[j][i] for j in range(4)] for i in range(4)]


def m4_inverse(m):
    """Gauss-Jordan float64 inverse (independent of mathlib's cofactors)."""
    n = 4
    a = [list(row) + [1.0 if i == j else 0.0 for j in range(n)]
         for i, row in enumerate(m)]
    for col in range(n):
        piv = max(range(col, n), key=lambda r: abs(a[r][col]))
        assert abs(a[piv][col]) > 1e-12, "singular matrix in micro oracle"
        a[col], a[piv] = a[piv], a[col]
        d = a[col][col]
        a[col] = [x / d for x in a[col]]
        for r in range(n):
            if r != col and a[r][col] != 0.0:
                f = a[r][col]
                a[r] = [x - f * y for x, y in zip(a[r], a[col])]
    return [row[n:] for row in a]


def rotation_between(a, b):
    """Rotation3::rotation_between(a, b) (shader.rs:921): Rodrigues."""
    na_, nb_ = ref_normalize(a), ref_normalize(b)
    c = v_cross(na_, nb_)
    nc = math.sqrt(ref_dot(c, c))
    d = ref_dot(na_, nb_)
    # Scenes keep the light well off both poles of +z.
    assert nc > 1e-3, "fragile: rotation_between near-aligned vectors"
    ax, ay, az = (c[0] / nc, c[1] / nc, c[2] / nc)
    ang = math.acos(max(-1.0, min(1.0, d)))
    s, ct = math.sin(ang), math.cos(ang)
    o = 1.0 - ct
    return [
        [ax * ax * o + ct, ax * ay * o - az * s, ax * az * o + ay * s],
        [ax * ay * o + az * s, ay * ay * o + ct, ay * az * o - ax * s],
        [ax * az * o - ay * s, ay * az * o + ax * s, az * az * o + ct],
    ]


# ---------------------------------------------------------------------------
# Margin self-checks: f32-vs-f64 noise must not flip a discrete decision.
#
# Two tiers:
# * GEOMETRY decisions (raster-coord trunc, backface cull) are per-triangle
#   and few — the scenes are DESIGNED to keep them away from boundaries, so
#   violating one is a hard failure (fix the scene).
# * PER-FRAGMENT decisions (texel pick, u8 cast, shadow compare, index
#   round, depth near-tie) happen thousands of times per frame; at any
#   margin some fragment will legitimately sit near a boundary.  Such a
#   fragment marks its PIXEL as fragile: the pixel is excluded from the
#   exact-equality comparison and counted — the test asserts the fragile
#   set stays a small fraction of coverage, so the equality is never
#   vacuous.  This is the end-to-end analog of test_shader_fixtures'
#   assert_margin, which hand-picks inputs away from boundaries.
# ---------------------------------------------------------------------------

TRUNC_MARGIN = 1e-3        # texel coords away from a texel boundary
TRUNC_MARGIN_HARD = 3e-4   # raster coords away from an int boundary: the
                           # f32 drift of the ~10-op vertex transform chain
                           # at |coord|<=32 is ~2.4e-5, so 3e-4 is >10x safe
                           # while rare enough for 72 draws/scene to pass
ROUND_MARGIN = 1e-3   # round() inputs away from half-integers
CULL_MARGIN = 1e-5    # cull dot away from 0
Z_MARGIN = 0.02       # depth-contender separation (z spans [0, 255])
SHADOW_MARGIN = 0.02  # shadow/occlusion depth-compare distance from threshold
CAST_MARGIN = 1e-3    # pre-cast color channel distance from u8 boundary


class _Fragile:
    """Collects pixels whose shading crossed within a margin of a discrete
    boundary.  `current` is set by the raster loop around each _shade call."""

    def __init__(self):
        self.pixels = set()
        self.current = None

    def mark(self):
        if self.current is not None:
            self.pixels.add(self.current)


FRAGILE = _Fragile()


def margin_trunc(x):
    frac = abs(x) - math.floor(abs(x))
    assert min(frac, 1.0 - frac) > TRUNC_MARGIN_HARD, f"fragile trunc: {x}"
    return int(x)  # Python int() == trunc toward zero == Rust `as i32`


def margin_round_u32(x):
    frac = x - math.floor(x)
    if abs(frac - 0.5) <= ROUND_MARGIN:
        FRAGILE.mark()
    r = ref_round(x)
    assert r >= 0.0, f"negative shadow index (u32 saturation) in micro scene: {x}"
    return int(r)


def margin_cast_u8(x):
    if 0.001 < x < 254.999:
        frac = x - math.floor(x)
        if min(frac, 1.0 - frac) <= CAST_MARGIN:
            FRAGILE.mark()
    return ref_u8_cast(x)


def margin_texel(uv, tex):
    h, w = tex.shape[:2]
    for val in (uv[0] * w, uv[1] * h):
        frac = val - math.floor(val)
        if min(frac, 1.0 - frac) <= TRUNC_MARGIN:
            FRAGILE.mark()
    return ref_tex_color(tex, uv[0], uv[1])


# ---------------------------------------------------------------------------
# Prepare stack (shader.rs:183-279), scalar float64
# ---------------------------------------------------------------------------


def mo_default_prepare(width, height, light, look_from, look_at, up):
    new_z = ref_normalize(v_sub(look_from, look_at))
    new_y = ref_normalize(v_sub(up, v_scale(new_z, ref_dot(new_z, up))))
    new_x = ref_normalize(v_cross(new_y, new_z))
    model = [
        [new_x[0], new_x[1], new_x[2], 0.0],
        [new_y[0], new_y[1], new_y[2], 0.0],
        [new_z[0], new_z[1], new_z[2], 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
    view = [
        [1.0, 0.0, 0.0, -look_from[0]],
        [0.0, 1.0, 0.0, -look_from[1]],
        [0.0, 0.0, 1.0, -look_from[2]],
        [0.0, 0.0, 0.0, 1.0],
    ]
    coef = -1.0 / 5.0
    projection = [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, coef, 1.0],
    ]
    w, h, d = float(width - 1), float(height - 1), 255.0
    viewport = [
        [w / 2.0, 0.0, 0.0, w / 2.0],
        [0.0, h / 2.0, 0.0, h / 2.0],
        [0.0, 0.0, d / 2.0, d / 2.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
    vpmv = m4_mul(m4_mul(m4_mul(viewport, projection), model), view)
    it_m = m4_inverse(m4_transpose(model))
    t_light = ref_normalize(m4_vector(model, light))
    return {
        "vpmv": vpmv,
        "m": model,
        "it_m": it_m,
        "camera_direction": new_z,
        "t_light": t_light,
    }


# ---------------------------------------------------------------------------
# The serial renderer (scene.rs:151-268) with per-pipeline shaders
# ---------------------------------------------------------------------------


def _vertex_common(geom, t, matrix, uniforms, cull):
    """Shared vertex work: positions gather, optional cull, transform+trunc,
    uv v-flip (shader.rs:127-165, :136-147)."""
    pos = [tuple(float(c) for c in geom["positions"][geom["pos_idx"][t][k]])
           for k in range(3)]
    fn = v_cross(v_sub(pos[1], pos[0]), v_sub(pos[2], pos[0]))
    if cull:
        d = ref_dot(uniforms["camera_direction"], fn)
        assert abs(d) > CULL_MARGIN, f"fragile cull dot {d} (triangle {t})"
        if d <= 0.0:
            return None
    rast, zv = [], []
    for k in range(3):
        tp = m4_point(matrix, pos[k])
        rast.append((margin_trunc(tp[0]), margin_trunc(tp[1])))
        zv.append(tp[2])
    uv = []
    for k in range(3):
        u, v = geom["tex_coords"][geom["tex_idx"][t][k]]
        uv.append((float(u), 1.0 - float(v)))
    normals = [tuple(float(c) for c in geom["normals"][geom["normal_idx"][t][k]])
               for k in range(3)]
    return {"pos": pos, "fn": fn, "rast": rast, "zv": zv, "uv": uv,
            "normals": normals}


def _bar_interp(vals, bar):
    return (vals[0] * bar[0] + vals[1] * bar[1]) + vals[2] * bar[2]


def _covered_fragments(v, W, H):
    """Bbox scan + to_barycentric_coord (scene.rs:160-171, :174-197, :236-247).

    float64 on integer raster coords <= 2^22: the cross product is EXACT, so
    coverage matches any faithful implementation bit-for-bit."""
    (x1, y1), (x2, y2), (x3, y3) = v["rast"]
    x_min, x_max = max(0, min(x1, x2, x3)), min(W - 1, max(x1, x2, x3))
    y_min, y_max = max(0, min(y1, y2, y3)), min(H - 1, max(y1, y2, y3))
    for i in range(x_min, x_max + 1):
        for j in range(y_min, y_max + 1):
            cross = v_cross(
                (float(x2 - x1), float(x3 - x1), float(x1 - i)),
                (float(y2 - y1), float(y3 - y1), float(y1 - j)),
            )
            if abs(cross[2]) < 1.0:
                continue  # degenerate -> (-1, 1, 1) -> skipped (scene.rs:188-191)
            bar = (
                1.0 - (cross[0] + cross[1]) / cross[2],
                cross[0] / cross[2],
                cross[1] / cross[2],
            )
            if bar[0] < 0.0 or bar[1] < 0.0 or bar[2] < 0.0:
                continue
            yield i, j, bar


def _shade(pipeline, uniforms, textures, v, bar, i, j, zfrag, shadow_buf, W):
    """Fragment shaders (shader.rs:318-333, :386-401, :439-459, :498-534,
    :597-654, :749-788, :872-947), scalar float64 with margin checks."""
    if pipeline in ("default", "phong", "normal_map", "specular", "darboux",
                    "shadow"):
        uv = (_bar_interp([u[0] for u in v["uv"]], bar),
              _bar_interp([u[1] for u in v["uv"]], bar))
        color = margin_texel(uv, textures["texture"])

    if pipeline == "default":
        t_fn = ref_normalize(m4_vector(uniforms["it_m"], v["fn"]))
        diff = ref_dot(uniforms["t_light"], t_fn)
        return _blend_margin(color, diff)
    if pipeline == "phong":
        diff = _bar_interp(v["intens"], bar)
        return _blend_margin(color, diff)
    if pipeline == "normal_map":
        n = ref_decode_normal(margin_texel(uv, textures["normal_map"]))
        t_n = ref_normalize(m4_vector(uniforms["it_m"], n))
        diff = ref_dot(uniforms["t_light"], t_n)
        return _blend_margin(color, diff)
    if pipeline == "specular":
        n = ref_decode_normal(margin_texel(uv, textures["normal_map"]))
        t_n = ref_normalize(m4_vector(uniforms["it_m"], n))
        tl = uniforms["t_light"]
        refl = ref_normalize(tuple(2.0 * c * ref_dot(tl, t_n) - l
                                   for c, l in zip(t_n, tl)))
        diff = ref_dot(tl, t_n)
        exp = float(margin_texel(uv, textures["specular_map"])[0])
        spec = 0.6 * max(refl[2], 0.0) ** exp
        out = []
        for ch in range(3):
            val = min((diff + spec) * color[ch], 255.0)
            out.append(margin_cast_u8(val))
        return tuple(out)
    if pipeline == "darboux":
        tn = ref_decode_normal(margin_texel(uv, textures["normal_map_tangent"]))
        local_z = tuple(_bar_interp([v["t_norm"][k][c] for k in range(3)], bar)
                        for c in range(3))
        basis = [list(v["row0n"]), list(v["row1n"]), list(ref_normalize(local_z))]
        inv = ref_mat3_inverse(basis)
        du = (v["uv"][1][0] - v["uv"][0][0], v["uv"][2][0] - v["uv"][0][0], 0.0)
        dv = (v["uv"][1][1] - v["uv"][0][1], v["uv"][2][1] - v["uv"][0][1], 0.0)
        lx = ref_normalize(ref_mat3_vec(inv, du))
        ly = ref_normalize(ref_mat3_vec(inv, dv))
        lz = ref_normalize(local_z)
        t_n = ref_normalize(tuple(
            lx[c] * tn[0] + ly[c] * tn[1] + lz[c] * tn[2] for c in range(3)
        ))
        diff = ref_dot(uniforms["t_light"], t_n)
        return _blend_margin(color, diff)
    if pipeline == "shadow":
        M = m4_mul(uniforms["shadow_matrix"], uniforms["i_vpmv"])
        sc = m4_point(M, (float(i), float(j), zfrag))
        sx, sy = margin_round_u32(sc[0]), margin_round_u32(sc[1])
        sval = shadow_buf[sy * W + sx]
        if abs(sc[2] + 1.0 - sval) <= SHADOW_MARGIN:
            FRAGILE.mark()
        coef = 0.3 if sc[2] + 1.0 < sval else 1.0
        diff = _bar_interp(v["intens"], bar)
        return _blend_margin(color, diff * coef)
    if pipeline == "occlusion":
        light_dir = m4_vector(uniforms["i_m"], uniforms["t_light"])
        world = m4_point(uniforms["i_vpmv"], (float(i), float(j), zfrag))
        M = m4_mul(uniforms["shadow_matrix"], uniforms["i_vpmv"])
        fsc = m4_point(M, (float(i), float(j), zfrag))
        fx, fy = margin_round_u32(fsc[0]), margin_round_u32(fsc[1])
        fval = shadow_buf[fy * W + fx]
        rot = rotation_between((0.0, 0.0, 1.0), light_dir)
        occ = 1.0
        for s in range(16):
            ang = (2.0 * math.pi / 16.0) * s
            gdir = (math.sin(ang), 0.0, math.cos(ang))
            sd = ref_mat3_vec(rot, gdir)
            sample = tuple(world[c] + sd[c] * 0.02 for c in range(3))
            ssc = m4_point(uniforms["shadow_matrix"], sample)
            sx, sy = margin_round_u32(ssc[0]), margin_round_u32(ssc[1])
            sval = shadow_buf[sy * W + sx]
            if abs(sval - 1.0 - fval) <= SHADOW_MARGIN:
                FRAGILE.mark()
            if sval - 1.0 > fval:
                strength = (sval - fval) / 20.0
                if abs(strength - 1.0) <= 1e-3:
                    FRAGILE.mark()
                occ -= (1.0 / 16.0) * min(strength, 1.0)
        return _blend_margin((255, 255, 255), occ)
    raise AssertionError(pipeline)


def _blend_margin(color, t):
    for ch in range(3):
        val = t * color[ch]
        if 0.001 < val < 254.999:
            frac = val - math.floor(val)
            if min(frac, 1.0 - frac) <= CAST_MARGIN:
                FRAGILE.mark()
    return ref_color_blend(color, (0, 0, 0), t)


def mo_render(pipeline, geom, textures, light, look_from, look_at, up, W, H):
    """Scene::render (scene.rs:151-268): all passes, serial triangle order.

    Deferred-winner resolution (max z, first triangle on ties) is
    output-equivalent to the reference's immediate overwrite (SURVEY §2.2.4);
    the depth-margin check below validates it per pixel (near-tied
    contenders that shade differently mark the pixel fragile).

    Returns (frame u8, z f32, fragile-pixel set)."""
    FRAGILE.pixels = set()
    FRAGILE.current = None
    T = len(geom["pos_idx"])
    shadow_buf = [F32_MIN] * (W * H)
    z_buf = [F32_MIN] * (W * H)
    frame = np.zeros((H, W, 3), np.uint8)

    two_pass = pipeline in ("shadow", "occlusion")
    if two_pass:
        # Pass 1 (shader.rs:671-709, :809-847): depth from the light, no
        # cull, every covered fragment max-updates the shadow buffer.
        u1 = mo_default_prepare(W, H, light, light, look_at, up)
        shadow_matrix = u1["vpmv"]
        for t in range(T):
            v = _vertex_common(geom, t, shadow_matrix, u1, cull=False)
            for i, j, bar in _covered_fragments(v, W, H):
                z = _bar_interp(v["zv"], bar)
                idx = j * W + i
                if z >= shadow_buf[idx]:
                    shadow_buf[idx] = z

    uniforms = mo_default_prepare(W, H, light, look_from, look_at, up)
    if two_pass:
        uniforms["shadow_matrix"] = shadow_matrix
        uniforms["i_vpmv"] = m4_inverse(uniforms["vpmv"])
        uniforms["i_m"] = m4_inverse(uniforms["m"])

    # Final pass: collect depth candidates per pixel, then resolve.
    candidates = {}  # (i, j) -> list of (z, t, v, bar)
    vres = {}
    for t in range(T):
        v = _vertex_common(geom, t, uniforms["vpmv"], uniforms, cull=True)
        if v is None:
            continue
        if pipeline in ("phong", "shadow"):
            v["intens"] = [
                ref_dot(uniforms["t_light"],
                        ref_normalize(m4_vector(uniforms["it_m"], n)))
                for n in v["normals"]
            ]
        if pipeline == "darboux":
            v["t_norm"] = [ref_normalize(m4_vector(uniforms["it_m"], n))
                           for n in v["normals"]]
            t_pos = [m4_point(uniforms["m"], p) for p in v["pos"]]
            v["row0n"] = ref_normalize(v_sub(t_pos[1], t_pos[0]))
            v["row1n"] = ref_normalize(v_sub(t_pos[2], t_pos[0]))
        vres[t] = v
        for i, j, bar in _covered_fragments(v, W, H):
            z = _bar_interp(v["zv"], bar)
            candidates.setdefault((i, j), []).append((z, t, bar))

    for (i, j), cands in candidates.items():
        # Reference rule: strictly-greater z wins, first triangle keeps ties
        # (shader.rs:169-180) == (max z, min t).
        win = max(cands, key=lambda c: (c[0], -c[1]))
        z, t, bar = win
        FRAGILE.current = (i, j)
        color = _shade(pipeline, uniforms, textures, vres[t], bar, i, j, z,
                       shadow_buf, W)
        # Depth-margin check: every other contender is either clearly below
        # the winner or shades to the identical color (shared-edge exact
        # ties within one coplanar quad) — otherwise an f32 1-ulp z flip
        # could change the pixel, so it is fragile.
        for (z2, t2, bar2) in cands:
            if t2 == t:
                continue
            if z - z2 < Z_MARGIN:
                c2 = _shade(pipeline, uniforms, textures, vres[t2], bar2,
                            i, j, z2, shadow_buf, W)
                if c2 != color:
                    FRAGILE.mark()
        FRAGILE.current = None
        frame[j, i] = color

    z_arr = np.full((H, W), np.float32(F32_MIN), np.float32)
    for (i, j), cands in candidates.items():
        z_arr[j, i] = np.float32(max(c[0] for c in cands))
    return frame, z_arr, set(FRAGILE.pixels)


# ---------------------------------------------------------------------------
# Tiny scenes (geometry contract of assets/obj.py, built inline)
# ---------------------------------------------------------------------------


def _textures():
    """8x8 deterministic maps with distinct texels (no package helpers)."""
    y, x = np.mgrid[0:8, 0:8]
    tex = np.stack([(29 * y + 13 * x + 31) % 256,
                    (17 * y + 41 * x + 101) % 256,
                    (53 * y + 7 * x + 11) % 256], axis=-1).astype(np.uint8)
    nrm = np.stack([40 + 20 * x, 40 + 20 * y, 180 + 5 * ((x + y) % 8)],
                   axis=-1).astype(np.uint8)
    tan = np.stack([90 + 15 * y, 200 - 18 * x, 160 + 10 * ((x * y) % 7)],
                   axis=-1).astype(np.uint8)
    spec = np.stack([1 + ((3 * x + 5 * y) % 7), 0 * x, 0 * x],
                    axis=-1).astype(np.uint8)
    return {"texture": tex, "normal_map": nrm, "normal_map_tangent": tan,
            "specular_map": spec}


def _quad(cx, cy, z, s, uv0=(0.0719, 0.0653), uv1=(0.9241, 0.9087)):
    """Two CCW triangles facing +z; uv window inside (0,1) avoiding texel
    boundaries of the 8x8 maps."""
    pos = [(cx - s, cy - s, z), (cx + s, cy - s, z),
           (cx + s, cy + s, z), (cx - s, cy + s, z)]
    (u0, v0), (u1, v1) = uv0, uv1
    uv = [(u0, v0), (u1, v0), (u1, v1), (u0, v1)]
    return pos, uv


def scene_quads():
    """Three overlapping quads at different depths (6 triangles): exercises
    depth resolution, shadowing of the back quad by the front ones, and all
    varying interpolations."""
    positions, tex_coords, pos_idx, tex_idx = [], [], [], []
    normal_idx = []
    # slight asymmetric offsets keep raster coords off integer boundaries
    for (cx, cy, z, s) in [(-0.0137, 0.0221, -0.402, 0.571),
                           (0.2143, 0.1709, 0.0531, 0.302),
                           (-0.1871, -0.2233, 0.3167, 0.193)]:
        pos, uv = _quad(cx, cy, z, s)
        b = len(positions)
        positions += pos
        tex_coords += uv
        pos_idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
        tex_idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
    # Slightly tilted normals (distinct per quad) for phong/shadow variety.
    normals = [(0.1, 0.2, 0.96), (-0.15, 0.05, 0.94), (0.05, -0.1, 0.97),
               (0.2, 0.1, 0.95)]
    for k in range(3):
        normal_idx += [[0, 1, 2], [0, 2, 3]]
    return {
        "positions": np.array(positions, np.float32),
        "tex_coords": np.array(tex_coords, np.float32),
        "normals": np.array([ref_normalize(n) for n in normals], np.float32),
        "pos_idx": np.array(pos_idx, np.int32),
        "tex_idx": np.array(tex_idx, np.int32),
        "normal_idx": np.array(normal_idx, np.int32),
    }


def _rot_xy(ax, ay):
    """Rx(ax) @ Ry(ay) rotation, rows as tuples."""
    cx, sx, cy, sy = math.cos(ax), math.sin(ax), math.cos(ay), math.sin(ay)
    rx = [(1, 0, 0), (0, cx, -sx), (0, sx, cx)]
    ry = [(cy, 0, sy), (0, 1, 0), (-sy, 0, cy)]
    return [tuple(sum(rx[i][k] * ry[k][j] for k in range(3)) for j in range(3))
            for i in range(3)]


def scene_steps():
    """Tilted, NON-TOUCHING quads overlapping in screen space (depth
    contention without shared edges — shared edges between differently
    shaded faces produce exact depth ties whose f32 resolution is
    route-dependent, i.e. the known tie-flip divergence; a micro scene
    demanding exact equality must avoid them).  Adds a back-facing
    triangle (cull path) and a partially offscreen quad (bbox clamping)."""
    positions, tex_coords, pos_idx, tex_idx, normal_idx = [], [], [], [], []
    normals = []
    quads = [
        # (center, half-size, rot_x, rot_y, uv window)
        ((-0.0239, 0.0317, -0.415), 0.553, 0.19, -0.12, (0.0713, 0.0641, 0.9203, 0.9096)),
        ((0.1811, 0.1287, 0.0467), 0.287, -0.27, 0.21, (0.1329, 0.3317, 0.6203, 0.8841)),
        ((-0.2217, -0.1439, 0.3343), 0.201, 0.11, 0.31, (0.4117, 0.0903, 0.8629, 0.5711)),
        ((-0.8873, 0.2141, 0.1531), 0.331, -0.08, -0.24, (0.0907, 0.1213, 0.7151, 0.7923)),
    ]
    for (c, s, ax, ay, (u0, v0, u1, v1)) in quads:
        R = _rot_xy(ax, ay)
        corners = [(-s, -s), (s, -s), (s, s), (-s, s)]
        b = len(positions)
        for (dx, dy) in corners:
            off = tuple(R[i][0] * dx + R[i][1] * dy for i in range(3))
            positions.append(tuple(c[i] + off[i] for i in range(3)))
        n = tuple(R[i][2] for i in range(3))  # rotated +z
        nb = len(normals)
        # Per-vertex normals tilted differently off the face normal so
        # phong/shadow interpolate non-constant intensities.
        for (tx, ty) in [(0.14, 0.06), (-0.09, 0.12), (0.07, -0.13), (-0.11, -0.08)]:
            normals.append(ref_normalize((n[0] + tx, n[1] + ty, n[2])))
        tex_coords += [(u0, v0), (u1, v0), (u1, v1), (u0, v1)]
        pos_idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
        tex_idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
        normal_idx += [[nb, nb + 1, nb + 2], [nb, nb + 2, nb + 3]]
    # Back-facing triangle (reversed winding): exercises the cull branch.
    b = len(positions)
    positions += [(0.31, -0.29, 0.211), (0.11, -0.31, 0.207), (0.22, -0.09, 0.223)]
    tex_coords += [(0.21, 0.17), (0.56, 0.23), (0.38, 0.61)]
    nb = len(normals)
    normals.append(ref_normalize((0.05, -0.03, -0.99)))
    pos_idx.append([b, b + 1, b + 2])
    tex_idx.append([b, b + 1, b + 2])
    normal_idx.append([nb, nb, nb])
    return {
        "positions": np.array(positions, np.float32),
        "tex_coords": np.array(tex_coords, np.float32),
        "normals": np.array(normals, np.float32),
        "pos_idx": np.array(pos_idx, np.int32),
        "tex_idx": np.array(tex_idx, np.int32),
        "normal_idx": np.array(normal_idx, np.int32),
    }


SCENES = {
    "quads": (scene_quads, (0.41, 0.0, 0.912), (0.29, 0.11, 0.95)),
    "steps": (scene_steps, (-0.37, 0.0, 0.929), (0.17, 0.23, 0.957)),
}
SIZE = 32
PIPELINES7 = ["default", "phong", "normal_map", "specular", "darboux",
              "shadow", "occlusion"]


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("pipeline", PIPELINES7)
def test_micro_oracle_end_to_end(scene_name, pipeline):
    """Full-path independence: micro oracle == NumPy oracle == jnp device
    path, exact u8 equality on every pixel outside the (tiny, counted)
    fragile set.  A transcription error in ops/vertex.py, ops/mathlib.py
    or pipelines/shaders.py fails here without going through shared code."""
    import jax
    import jax.numpy as jnp

    from tiny_renderer_tpu import RenderConfig
    from tiny_renderer_tpu.oracle import render_oracle
    from tiny_renderer_tpu.pipelines.frame import make_frame_fn

    make_scene, light, look_from = SCENES[scene_name]
    geom = make_scene()
    textures = _textures()
    look_at = (0.0, 0.0, 0.0)
    up = (0.0, 1.0, 0.0)

    frame_mo, z_mo, fragile = mo_render(
        pipeline, geom, textures, light, look_from, look_at, up, SIZE, SIZE
    )
    cov = z_mo > np.float32(F32_MIN)
    covered = int(cov.sum())
    # Fragility must stay a sliver of coverage or the equality is weak.
    # Occlusion gets a looser cap: its 16-sample probe makes ~50 boundary
    # draws per pixel (index rounds + threshold compares) vs ~5 elsewhere.
    cap = max(6, covered // (8 if pipeline == "occlusion" else 20))
    assert len(fragile) <= cap, (
        f"{pipeline}/{scene_name}: {len(fragile)} fragile of {covered} covered"
    )
    solid = np.ones((SIZE, SIZE), bool)
    for (i, j) in fragile:
        solid[j, i] = False

    cfg = RenderConfig(width=SIZE, height=SIZE, tri_block=16)
    lf = np.asarray(look_from, np.float32)
    li = np.asarray(light, np.float32)
    la = np.zeros(3, np.float32)
    u = np.asarray(up, np.float32)

    o = render_oracle(geom, textures, li, lf, la, u,
                      pipeline=pipeline, config=cfg)
    np.testing.assert_array_equal(
        frame_mo[solid], o["frame"][solid],
        err_msg=f"micro oracle != NumPy oracle ({pipeline}/{scene_name})",
    )

    fn = make_frame_fn(pipeline, cfg, backend="jnp")
    r = fn(jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, textures),
           jnp.asarray(li), jnp.asarray(lf), jnp.asarray(la), jnp.asarray(u))
    np.testing.assert_array_equal(
        frame_mo[solid], np.asarray(r["frame"])[solid],
        err_msg=f"micro oracle != jnp device path ({pipeline}/{scene_name})",
    )
    # Depth plane: same coverage, values to f32-accumulation tolerance.
    # (Coverage is decided by EXACT integer edge functions + margin-checked
    # trunc, so it needs no fragile waiver at all.)
    z_dev = np.asarray(r["z"])
    np.testing.assert_array_equal(cov, z_dev > np.float32(F32_MIN) / 2)
    np.testing.assert_allclose(z_mo[cov], z_dev[cov], rtol=1e-4, atol=5e-3)


def test_micro_scenes_have_coverage_and_occlusion():
    """Scene sanity: each scene covers pixels, has depth contention (the
    tie-rule actually exercised) and, for the two-pass pipelines, shadowed
    pixels — so the equalities above are not vacuous."""
    for name, (make_scene, light, look_from) in SCENES.items():
        geom = make_scene()
        frame, z, _ = mo_render("shadow", geom, _textures(), light, look_from,
                                (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), SIZE, SIZE)
        covered = (z > np.float32(F32_MIN)).sum()
        assert covered > 100, f"{name}: only {covered} covered pixels"
        # Shadowed pixels exist: re-render without pass 1's buffer influence
        # by comparing against phong (same diffuse term, no shadow coef).
        frame_p, _, _ = mo_render("phong", geom, _textures(), light, look_from,
                                  (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), SIZE, SIZE)
        assert (frame != frame_p).any(), f"{name}: no shadowed pixel"

"""The 7 shader pipelines as pure, vectorized fragment functions.

Each reference fragment shader (src/scene/shader.rs:282-963) is split into
two pure stages shared by every execution path:

1. **Varying interpolation** (`VARYING_SPECS` + `compute_varyings`): the
   barycentric interpolation (or per-triangle broadcast) of the quantities a
   fragment needs — uv, diffuse intensity, depth, the Darboux basis pieces.
   On the Pallas path these are produced *inside the raster kernel* (zero
   per-pixel gathers); on the jnp/oracle path `compute_varyings` computes
   them from gathered vertex attributes with the identical expressions.
2. **Shading** (`shade_*`): pure functions over the interpolated varyings +
   texture fetches, for any leading batch shape.

Immediate-mode shading in the reference is output-equivalent to this
deferred form because its fragment shaders have no side effects besides the
z/shadow writes the raster stage already resolved (SURVEY.md §2.2.4).

xp-agnostic: the same code runs under numpy (oracle) and jax.numpy (device).
"""

from __future__ import annotations

import numpy as np

from ..ops import mathlib as ml

BLACK = np.zeros(3, dtype=np.uint8)
WHITE = np.full(3, 255, dtype=np.uint8)

# ---------------------------------------------------------------------------
# Varying specifications
#
# Each pipeline's fragment stage consumes a fixed list of varyings:
#   (name, components, mode) with mode:
#     "interp" — barycentric interpolation of 3 per-vertex values
#     "const"  — per-triangle constant broadcast
#     "zfrag"  — bar . vertex_z_values (shader.rs:174), from the base record
# The raster kernel and compute_varyings both follow this spec.
# ---------------------------------------------------------------------------

VARYING_SPECS = {
    "default": (("uv", 2, "interp"), ("intensity", 1, "interp")),
    "phong": (("uv", 2, "interp"), ("intensity", 1, "interp")),
    "normal_map": (("uv", 2, "interp"),),
    "specular": (("uv", 2, "interp"),),
    "darboux": (
        ("uv", 2, "interp"),
        ("local_z", 3, "interp"),
        ("row0", 3, "const"),
        ("row1", 3, "const"),
        ("du", 2, "const"),
        ("dv", 2, "const"),
    ),
    "shadow": (("uv", 2, "interp"), ("intensity", 1, "interp"), ("zfrag", 1, "zfrag")),
    "occlusion": (("zfrag", 1, "zfrag"),),
}

# Per-vertex / per-triangle sources in the triangle_setup output for each
# varying: name -> (setup key, slicer).  For "interp", values[v][c] per
# vertex; for "const", values[c].
_INTERP_SOURCES = {
    "uv": lambda s, c, v: s["uv"][:, v, c],
    "intensity": lambda s, c, v: s["intensity"][:, v],
    "local_z": lambda s, c, v: s["t_norm"][:, v, c],
}
_CONST_SOURCES = {
    "row0": lambda s, c: s["row0n"][:, c],
    "row1": lambda s, c: s["row1n"][:, c],
    "du": lambda s, c: s["du"][:, c],
    "dv": lambda s, c: s["dv"][:, c],
}


def num_planes(spec) -> int:
    return sum(comps for (_, comps, _) in spec)


def kernel_varying_spec(pipeline, textures, tile: int = 0):
    """The spec actually used by the Pallas kernel for this pipeline.

    Two traffic optimizations over the reference spec (each full-screen f32
    plane costs real HBM bandwidth):
    * the interpolated uv's only consumer is texture sampling, so when the
      pipeline's maps share dimensions the kernel emits a single texel-index
      plane ("texidx:W:H") instead of two uv planes;
    * darboux's 10 per-triangle constants are cheaper as one small
      per-pixel gather (frame.py) than as 10 broadcast planes — dropped here.
    Falls back to the reference spec when texture dims are mixed.
    """
    spec = VARYING_SPECS[pipeline]
    names = _PIPELINE_MAPS_FOR_SPEC.get(pipeline, ())
    if not names:
        return spec
    dims = {textures[n].shape[:2] for n in names}
    if "normal_map_tangent" in names:
        dims.add(textures["normal_map"].shape[:2])
    if len(dims) != 1:
        return spec
    h, w = next(iter(dims))
    tile = _effective_tile(tile, h, w)
    out = []
    for name, comps, mode in spec:
        if name == "uv":
            # 4th field = tile-swizzled layout (config.tex_tile); the
            # kernel then emits indices into the matching packed plane.
            m = f"texidx:{w}:{h}:{tile}" if tile else f"texidx:{w}:{h}"
            out.append(("texidx", 1, m))
        elif mode == "const" and pipeline == "darboux":
            continue  # fetched via the per-triangle constant gather
        else:
            out.append((name, comps, mode))
    return tuple(out)


# Texture maps per pipeline (duplicated from frame.py to avoid an import
# cycle; frame.py asserts they match).
_PIPELINE_MAPS_FOR_SPEC = {
    "default": ("texture",),
    "phong": ("texture",),
    "normal_map": ("texture", "normal_map"),
    "specular": ("texture", "normal_map", "specular_map"),
    "darboux": ("texture", "normal_map_tangent"),
    "shadow": ("texture",),
    "occlusion": (),
}


def compute_varyings(frag, spec, xp):
    """Reference-path varying computation from per-fragment vertex attrs.

    frag carries gathered per-fragment triangle attributes ("uv" (...,3,2),
    "intensity" (...,3), "zv" (...,3), darboux constants) plus "bar".
    Interpolation order matches nalgebra's accumulation:
    (a0*b0 + a1*b1) + a2*b2.
    """
    bar = frag["bar"]
    b0, b1, b2 = bar[..., 0], bar[..., 1], bar[..., 2]
    out = {}
    for name, comps, mode in spec:
        if mode == "zfrag":
            zv = frag["zv"]
            out[name] = (zv[..., 0] * b0 + zv[..., 1] * b1) + zv[..., 2] * b2
        elif mode == "interp":
            if name == "uv":
                a = frag["uv"]  # (..., 3, 2)
                vals = [
                    (a[..., 0, c] * b0 + a[..., 1, c] * b1) + a[..., 2, c] * b2
                    for c in range(2)
                ]
                out[name] = xp.stack(vals, axis=-1)
            elif name == "intensity":
                a = frag["intensity"]
                out[name] = (a[..., 0] * b0 + a[..., 1] * b1) + a[..., 2] * b2
            elif name == "local_z":
                a = frag["t_norm"]  # (..., 3v, 3c)
                vals = [
                    (a[..., 0, c] * b0 + a[..., 1, c] * b1) + a[..., 2, c] * b2
                    for c in range(3)
                ]
                out[name] = xp.stack(vals, axis=-1)
            elif name.startswith("attr:"):
                # Custom per-vertex attribute (register_pipeline): generic
                # k-component interpolation in the same accumulation order.
                a = frag[name]  # (..., 3v, k)
                vals = [
                    (a[..., 0, c] * b0 + a[..., 1, c] * b1) + a[..., 2, c] * b2
                    for c in range(comps)
                ]
                out[name] = xp.stack(vals, axis=-1)
            else:
                raise KeyError(name)
        else:  # const
            key = {"row0": "row0n", "row1": "row1n", "du": "du", "dv": "dv"}[name]
            out[name] = frag[key]
    return out


# ---------------------------------------------------------------------------
# Texture samplers (src/scene/util.rs:34-83)
# ---------------------------------------------------------------------------


def _tex_coords(uv, w, h, xp):
    """(uv * dims) as u32, clamped into range.

    The reference does not clamp and would panic on out-of-range coordinates
    (util.rs:35-40); clamping is a documented divergence (SURVEY.md §2.2.5).
    """
    cx = ml.rust_f32_to_u32(uv[..., 0] * xp.float32(w), xp)
    cy = ml.rust_f32_to_u32(uv[..., 1] * xp.float32(h), xp)
    cx = xp.minimum(cx, xp.uint32(w - 1)).astype(xp.int32)
    cy = xp.minimum(cy, xp.uint32(h - 1)).astype(xp.int32)
    return cx, cy


def sample_color(textures, uv, xp):
    """get_color_at_uv (util.rs:34-41): nearest-neighbor RGB fetch."""
    tex = textures["texture"]
    cx, cy = _tex_coords(uv, tex.shape[1], tex.shape[0], xp)
    return tex[cy, cx]


def _decode_normal(rgb, xp):
    """byte/255 - 0.5 per channel, then normalize (util.rs:51-56)."""
    v = rgb.astype(xp.float32) / xp.float32(255.0) - xp.float32(0.5)
    return ml.normalize3(v, xp)


def sample_normal(textures, uv, xp):
    """get_normal_at_uv (util.rs:44-57)."""
    tex = textures["normal_map"]
    cx, cy = _tex_coords(uv, tex.shape[1], tex.shape[0], xp)
    return _decode_normal(tex[cy, cx], xp)


def sample_normal_tangent(textures, uv, xp):
    """get_normal_tangent_at_uv (util.rs:60-73).

    Reference quirk preserved: texel coordinates are computed from the
    *normal_map* dimensions but the fetch reads *normal_map_tangent*
    (util.rs:61-70).
    """
    nm = textures["normal_map"]
    tex = textures["normal_map_tangent"]
    cx, cy = _tex_coords(uv, nm.shape[1], nm.shape[0], xp)
    cx = xp.minimum(cx, tex.shape[1] - 1)
    cy = xp.minimum(cy, tex.shape[0] - 1)
    return _decode_normal(tex[cy, cx], xp)


def sample_specular(textures, uv, xp):
    """get_specular_value_at_uv (util.rs:76-83): RAW byte 0..255 — used
    directly as the specular exponent (shader.rs:521-525)."""
    tex = textures["specular_map"]
    cx, cy = _tex_coords(uv, tex.shape[1], tex.shape[0], xp)
    return tex[cy, cx, 0].astype(xp.float32)


_SAMPLERS = {
    "texture": sample_color,
    "normal_map": sample_normal,
    "normal_map_tangent": sample_normal_tangent,
    "specular_map": sample_specular,
}


# ---------------------------------------------------------------------------
# Word-packed texture fetch.  Packing each texel's RGB into one i32 word
# makes the fetch one 32-bit gather per texel instead of three byte
# gathers, with shifts/masks to unpack (bit-identical either way; its cost
# on the GPU is not measured yet).  Packing happens once per frame inside
# jit (pack_textures); samplers transparently use the packed plane when
# present, so the NumPy oracle (which never packs) keeps the plain u8 path.
# ---------------------------------------------------------------------------


def _pk_key(names, tile: int = 0) -> str:
    return "_pk:" + ",".join(names) + (f"@{tile}" if tile else "")


def _effective_tile(tile, h, w) -> int:
    """The tile actually applied: the requested one when it divides both
    texture dims (config validation already pinned it to a power of two),
    else 0 (plain row-major layout)."""
    if tile and h % tile == 0 and w % tile == 0:
        return int(tile)
    return 0


def _find_pk(textures, names):
    """Locate the packed plane for `names` -> (plane, tile) or (None, 0).

    pack_textures stores exactly one layout variant per name set (it
    removes the others), so the scan is unambiguous."""
    base = _pk_key(names)
    pk = textures.get(base)
    if pk is not None:
        return pk, 0
    prefix = base + "@"
    for k in textures:
        if k.startswith(prefix):
            return textures[k], int(k[len(prefix):])
    return None, 0


def _swizzle_index(cx, cy, w, tile, xp):
    """Row-major texel coords -> flat index in the tile-swizzled layout.

    Pure permutation of [0, h*w): texels of one tile x tile block are
    contiguous, so screen-adjacent fragments (which sample uv-adjacent
    texels) hit nearby gather rows.  Integer-exact in f32 (indices are
    < 2^24) AND in int32 — callers pass either."""
    tx, ix = cx // tile, cx % tile
    ty, iy = cy // tile, cy % tile
    return ((ty * (w // tile) + tx) * tile + iy) * tile + ix


def pack_textures(textures, names, xp, tile: int = 0):
    """Return a copy of `textures` with an (H, W, n) i32 packed plane for
    `names` (one word per map per texel), when all relevant dims match.

    With `tile` > 0 (config.tex_tile) the plane is stored in tile-swizzled
    flat order (same 2D shape; see _swizzle_index) and keyed _pk:...@tile;
    samplers detect the layout from the key, so a textures dict is
    self-describing and any stale other-layout variant is dropped here."""
    if not names:
        return textures
    texs = [textures[n] for n in names]
    dims = {t.shape[:2] for t in texs}
    if "normal_map_tangent" in names:
        dims.add(textures["normal_map"].shape[:2])
    if len(dims) != 1:
        return textures
    h, w = next(iter(dims))
    tile = _effective_tile(tile, h, w)
    words = []
    for t in texs:
        ti = t.astype(xp.int32)
        words.append(ti[..., 0] | (ti[..., 1] << 8) | (ti[..., 2] << 16))
    pk = xp.stack(words, axis=-1)
    if tile:
        pk = xp.reshape(
            xp.transpose(
                xp.reshape(pk, (h // tile, tile, w // tile, tile, -1)),
                (0, 2, 1, 3, 4),
            ),
            (h, w, -1),
        )
    out = {
        k: v
        for k, v in textures.items()
        if not (k == _pk_key(names) or k.startswith(_pk_key(names) + "@"))
    }
    out[_pk_key(names, tile)] = pk
    return out


def _unpack_rgb(word, xp):
    """(...,) i32 word -> (..., 3) u8."""
    r = (word & 0xFF).astype(xp.uint8)
    g = ((word >> 8) & 0xFF).astype(xp.uint8)
    b = ((word >> 16) & 0xFF).astype(xp.uint8)
    return xp.stack([r, g, b], axis=-1)


def sample_frag(textures, frag, names, xp):
    """Sample the pipeline's maps for a fragment batch.

    Uses the kernel-computed texel-index plane when present (one i32 gather,
    no per-pixel coordinate math), else the uv path via sample_maps.
    """
    texidx = frag.get("texidx")
    if texidx is None:
        return sample_maps(textures, frag["uv"], names, xp)
    # The kernel computed texidx for whichever layout the plane is stored
    # in (kernel_varying_spec and pack_textures share config.tex_tile), so
    # the flat gather below is layout-agnostic.
    pk, _ = _find_pk(textures, names)
    flat = pk.reshape(-1, len(names))
    g = flat[texidx.astype(xp.int32)]  # (..., n) i32 words
    out = {}
    for i, n in enumerate(names):
        raw = _unpack_rgb(g[..., i], xp)
        if n in ("normal_map", "normal_map_tangent"):
            out[n] = _decode_normal(raw, xp)
        elif n == "specular_map":
            out[n] = raw[..., 0].astype(xp.float32)
        else:
            out[n] = raw
    return out


def sample_maps(textures, uv, names, xp):
    """Fetch several maps at one uv with ONE gather: prefers the word-packed
    i32 plane from pack_textures, else a channel-concat u8 gather when all
    maps share dimensions, else falls back to the per-map samplers
    (preserving the tangent-map dimension quirk, util.rs:61-70).
    Returns {name: decoded sample} matching the individual samplers.
    """

    def decode(n, raw):
        if n in ("normal_map", "normal_map_tangent"):
            return _decode_normal(raw, xp)
        if n == "specular_map":
            return raw[..., 0].astype(xp.float32)
        return raw

    pk, tile = _find_pk(textures, names)
    if pk is not None:
        h, w = pk.shape[:2]
        cx, cy = _tex_coords(uv, w, h, xp)
        if tile:
            idx = _swizzle_index(cx, cy, w, tile, xp)
            g = pk.reshape(-1, pk.shape[-1])[idx]
        else:
            g = pk[cy, cx]  # (..., n) i32 words — one (native-width) gather
        return {
            n: decode(n, _unpack_rgb(g[..., i], xp)) for i, n in enumerate(names)
        }

    texs = [textures[n] for n in names]
    dims = {t.shape[:2] for t in texs}
    # The tangent map's texel coords come from the *normal_map* dims
    # (util.rs:61-70); the packed path is only valid if those match too.
    if "normal_map_tangent" in names:
        dims.add(textures["normal_map"].shape[:2])
    if len(names) == 1 or len(dims) != 1:
        return {n: _SAMPLERS[n](textures, uv, xp) for n in names}

    packed = xp.concatenate(texs, axis=-1)
    h, w = texs[0].shape[:2]
    cx, cy = _tex_coords(uv, w, h, xp)
    g = packed[cy, cx]  # (..., 3 * len(names))
    return {n: decode(n, g[..., 3 * i : 3 * i + 3]) for i, n in enumerate(names)}


def mat3_vec(m, v, xp):
    """Matrix3 * Vector3 with nalgebra accumulation order."""
    out = []
    for i in range(3):
        out.append(
            (m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]) + m[..., i, 2] * v[..., 2]
        )
    return xp.stack(out, axis=-1)


def _shadow_fetch(shadow_buffer, sx, sy, width, xp, tile: int = 0):
    """shadow_buffer[round(x) as u32 + round(y) as u32 * width].

    The reference's u32 cast saturates negatives to 0; the final index is
    unchecked and would panic out of range (shader.rs:774-778) — we clamp
    (documented divergence).  `tile` per shadow_flat_indices.
    """
    flat = shadow_flat_indices(sx, sy, shadow_buffer.shape, width, xp, tile)
    return shadow_buffer.reshape(-1)[flat]


# ---------------------------------------------------------------------------
# Pipelines.  Each shade function consumes the interpolated varyings of its
# VARYING_SPECS entry (plus "x"/"y" pixel coords and "shadow_buffer" for the
# two-pass pipelines).
# ---------------------------------------------------------------------------


def shade_default(frag, uniforms, textures, config, xp):
    """Flat shading (shader.rs:318-333): texture * face diffuse."""
    color = sample_frag(textures, frag, ("texture",), xp)["texture"]
    return ml.color_blend(color, xp.asarray(BLACK), frag["intensity"], xp)


def shade_phong(frag, uniforms, textures, config, xp):
    """Gouraud-interpolated intensity (shader.rs:386-401)."""
    color = sample_frag(textures, frag, ("texture",), xp)["texture"]
    return ml.color_blend(color, xp.asarray(BLACK), frag["intensity"], xp)


def shade_normal_map(frag, uniforms, textures, config, xp):
    """World-space normal map lookup (shader.rs:439-457)."""
    s = sample_frag(textures, frag, ("texture", "normal_map"), xp)
    color, n = s["texture"], s["normal_map"]
    t_n = ml.normalize3(ml.mat4_transform_vector(uniforms["it_m"], n, xp), xp)
    diff = ml.dot3(uniforms["t_light_direction"], t_n)
    return ml.color_blend(color, xp.asarray(BLACK), diff, xp)


def shade_specular(frag, uniforms, textures, config, xp):
    """Normal-map diffuse + Phong specular (shader.rs:498-534)."""
    s = sample_frag(textures, frag, ("texture", "normal_map", "specular_map"), xp)
    color = s["texture"].astype(xp.float32)
    n = s["normal_map"]
    t_n = ml.normalize3(ml.mat4_transform_vector(uniforms["it_m"], n, xp), xp)
    l = uniforms["t_light_direction"]
    d = ml.dot3(l, t_n)
    reflected = ml.normalize3(
        xp.float32(2.0) * (t_n * d[..., None]) - l, xp
    )
    # Camera-frame trick: only .z of the reflection matters since the camera
    # direction is (0,0,-1) in its own frame (shader.rs:520-525).
    spec_exp = s["specular_map"]
    spec = xp.float32(config.specular_scale) * xp.power(
        xp.maximum(reflected[..., 2], xp.float32(0.0)), spec_exp
    )
    coef = (d + spec)[..., None]
    corrected = xp.minimum(coef * color, xp.float32(255.0))
    return ml.rust_f32_to_u8(corrected, xp)


def shade_darboux(frag, uniforms, textures, config, xp):
    """Tangent-space (Darboux) normal mapping (shader.rs:597-654)."""
    s = sample_frag(textures, frag, ("texture", "normal_map_tangent"), xp)
    color, tn_sample = s["texture"], s["normal_map_tangent"]

    local_z = frag["local_z"]
    row2 = ml.normalize3(local_z, xp)
    basis = xp.stack([frag["row0"], frag["row1"], row2], axis=-2)
    i_basis = ml.mat3_inverse(basis, xp)

    du = frag["du"]
    dv = frag["dv"]
    zeros = xp.zeros_like(du[..., 0])
    local_x = mat3_vec(i_basis, xp.stack([du[..., 0], du[..., 1], zeros], axis=-1), xp)
    local_y = mat3_vec(i_basis, xp.stack([dv[..., 0], dv[..., 1], zeros], axis=-1), xp)

    col_x = ml.normalize3(local_x, xp)
    col_y = ml.normalize3(local_y, xp)
    col_z = ml.normalize3(local_z, xp)
    # transform matrix has columns (x, y, z); applied to the sampled normal.
    t_fragment_normal = ml.normalize3(
        col_x * tn_sample[..., 0:1] + col_y * tn_sample[..., 1:2] + col_z * tn_sample[..., 2:3],
        xp,
    )
    diff = ml.dot3(uniforms["t_light_direction"], t_fragment_normal)
    return ml.color_blend(color, xp.asarray(BLACK), diff, xp)


def shade_shadow(frag, uniforms, textures, config, xp):
    """Shadow pass 2 (shader.rs:749-788): phong + shadow-map depth compare."""
    x = frag["x"].astype(xp.float32)
    y = frag["y"].astype(xp.float32)
    z = frag["zfrag"]
    sm = ml.mat4_mul(uniforms["shadow_matrix"], uniforms["i_vpmv"])
    p = xp.stack([x, y, z], axis=-1)
    sc = ml.mat4_transform_point(sm, p, xp)
    shadow_val = _shadow_fetch(
        frag["shadow_buffer"], sc[..., 0], sc[..., 1], config.width, xp,
        tile=plane_tile_effective(config, frag["shadow_buffer"].shape),
    )
    shadow_coef = xp.where(
        sc[..., 2] + xp.float32(config.shadow_bias) < shadow_val,
        xp.float32(config.shadow_dim),
        xp.float32(1.0),
    )
    color = sample_frag(textures, frag, ("texture",), xp)["texture"]
    return ml.color_blend(
        color, xp.asarray(BLACK), frag["intensity"] * shadow_coef, xp
    )


def occlusion_sample_coords(xf, yf, zfrag, uniforms, config, xp):
    """Float shadow-space coords of the occlusion probe (shader.rs:882-933).

    Returns (sxs, sys): each (n+1, ...) float32 where rows 0..n-1 are the
    16 circular samples and row n is the fragment's own shadow coord.
    Single source of truth for the sample-position arithmetic shared by
    the XLA gather path, the Pallas stencil-fetch path, and the locality
    probe — identical per-sample math to n separate fetches.
    """
    p = xp.stack([xf, yf, zfrag], axis=-1)

    light = ml.mat4_transform_vector(uniforms["i_m"], uniforms["t_light_direction"], xp)
    world = ml.mat4_transform_point(uniforms["i_vpmv"], p, xp)
    sm = ml.mat4_mul(uniforms["shadow_matrix"], uniforms["i_vpmv"])
    fsc = ml.mat4_transform_point(sm, p, xp)

    rot = ml.rotation_between(
        xp.asarray(np.array([0.0, 0.0, 1.0], dtype=np.float32)), light, xp
    )

    n = config.occlusion_samples
    angle_coef = np.float32(2.0 * np.pi) / np.float32(n)
    step_size = xp.float32(config.occlusion_step)

    S = uniforms["shadow_matrix"]
    sxs, sys = [], []
    for i in range(n):
        ang = np.float32(angle_coef * np.float32(i))
        g = xp.asarray(np.array([np.sin(ang), 0.0, np.cos(ang)], dtype=np.float32))
        step_dir = mat3_vec(rot, g, xp)
        sample = world + step_dir * step_size
        ssc = ml.mat4_transform_point(S, sample, xp)
        sxs.append(ssc[..., 0])
        sys.append(ssc[..., 1])
    sxs.append(fsc[..., 0])
    sys.append(fsc[..., 1])
    return xp.stack(sxs), xp.stack(sys)


def shadow_flat_indices(sxs, sys, shadow_shape, width, xp, tile: int = 0):
    """Rounded, saturated, clamped FLAT shadow-buffer indices — exactly
    _shadow_fetch's index arithmetic (shader.rs:774-778 semantics), split
    out so the stencil-fetch path indexes identically.

    With `tile` > 0 the caller's buffer is stored tile-swizzled
    (swizzle_plane); the row-major flat index is decomposed AFTER the
    reference's saturate+clamp (the clamp is on the flat index, not per
    axis — an overflowing ix wraps into the next row exactly as the
    row-major layout reads it) and re-encoded for the swizzled layout, so
    the fetch returns bit-identical values."""
    ix = ml.rust_f32_to_u32(ml.rust_round(sxs, xp), xp)
    iy = ml.rust_f32_to_u32(ml.rust_round(sys, xp), xp)
    flat = ix + iy * xp.uint32(width)
    size = shadow_shape[0] * shadow_shape[1]
    flat = xp.minimum(flat, xp.uint32(size - 1)).astype(xp.int32)
    if tile:
        y2 = flat // xp.int32(width)
        x2 = flat - y2 * xp.int32(width)
        flat = _swizzle_index(x2, y2, width, tile, xp)
    return flat


def plane_tile_effective(config, shape) -> int:
    """The shadow-plane swizzle tile actually applied for this buffer:
    config.shadow_tile when it divides both dims and the buffer stride
    matches config.width (shadow_flat_indices' flat arithmetic assumes
    it), else 0.  Producer (frame/sharding swizzle the plane) and
    consumers (the shade fetches) must share this decision — both call
    here."""
    t = config.shadow_tile
    h, w = shape[0], shape[1]
    if t and h % t == 0 and w % t == 0 and w == config.width:
        return int(t)
    return 0


def swizzle_plane(plane, tile, xp):
    """Re-layout an (H, W) plane so each tile x tile block is contiguous
    in flat order — the plane-side counterpart of _swizzle_index (same
    (ty, tx, iy, ix) ordering as pack_textures' texture swizzle)."""
    h, w = plane.shape
    return xp.transpose(
        xp.reshape(plane, (h // tile, tile, w // tile, tile)), (0, 2, 1, 3)
    ).reshape(h, w)


def occlusion_update(svals, fval, config, xp):
    """The occlusion accumulation loop (shader.rs:934-941): svals (n, ...)
    sampled shadow values, fval the fragment's own shadow value."""
    n = config.occlusion_samples
    inv_n = xp.float32(1.0) / xp.float32(n)
    threshold = xp.float32(config.occlusion_threshold)
    depth_scale = xp.float32(config.occlusion_depth_scale)
    occ = xp.ones_like(fval)
    for i in range(n):
        sval = svals[i]
        occluded = (sval - threshold) > fval
        strength = xp.minimum((sval - fval) / depth_scale, xp.float32(1.0))
        occ = xp.where(occluded, occ - inv_n * strength, occ)
    return occ


def dedup_gather(table, flat_idx, cap_shift=3):
    """Exact duplicate-collapsing gather: table[flat_idx] with equal indices
    fetched once (jnp only).

    The occlusion probe's (n+1, batch) sample indices repeat heavily
    because the 17 samples sit at per-frame-constant offsets around
    per-fragment base points that cluster within consecutive strips.
    Equal indices fetch equal values, so collapsing them cannot change
    output: sort the indices with their
    positions, fetch each run's head once from the (static) cap of
    M >> cap_shift unique slots, broadcast along runs via a rank gather
    from the small fetched table, and scatter back through the sort
    permutation.  If a batch exceeds the unique cap the plain gather runs
    instead — bit-identical either way.
    """
    import jax
    import jax.numpy as jnp

    shape = flat_idx.shape
    I = flat_idx.reshape(-1).astype(jnp.int32)
    M = I.shape[0]
    cap = max(M >> cap_shift, 256)
    pos = jax.lax.iota(jnp.int32, M)
    Is, pos_s = jax.lax.sort_key_val(I, pos)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), Is[1:] != Is[:-1]]
    )
    rank = jnp.cumsum(first.astype(jnp.int32)) - 1
    overflow = rank[-1] >= cap

    def deduped(_):
        uniq = (
            jnp.zeros((cap,), jnp.int32)
            .at[jnp.where(first, rank, cap)]
            .set(Is, mode="drop")
        )
        fetched = table[uniq]  # the ONLY table-sized gather: cap rows
        vals_sorted = fetched[jnp.minimum(rank, cap - 1)]
        # Inverse permutation: every slot written exactly once.
        return jnp.zeros((M,), table.dtype).at[pos_s].set(vals_sorted)

    vals = jax.lax.cond(overflow, lambda _: table[I], deduped, None)
    return vals.reshape(shape)


def occlusion_coefficient(xf, yf, zfrag, shadow_buffer, uniforms, config, xp):
    """The occlusion core (shader.rs:882-941) for any batch of fragments:
    16-sample circular probe of the shadow buffer in the plane perpendicular
    to the light.  Returns the occlusion coefficient per fragment.

    All n+1 coords are computed elementwise, then fetched with ONE gather
    of (n+1, ...) indices — identical per-sample arithmetic to n separate
    fetches (shader.rs:922-933), fewer gather dispatches.  With
    config.occlusion_dedup (jnp path) duplicate indices are collapsed
    before the fetch (dedup_gather) — exact by construction.
    """
    n = config.occlusion_samples
    sxs, sys = occlusion_sample_coords(xf, yf, zfrag, uniforms, config, xp)
    flat = shadow_flat_indices(
        sxs, sys, shadow_buffer.shape, config.width, xp,
        tile=plane_tile_effective(config, shadow_buffer.shape),
    )
    if config.occlusion_dedup and xp is not np:
        vals = dedup_gather(shadow_buffer.reshape(-1), flat)
    else:
        vals = shadow_buffer.reshape(-1)[flat]  # (n+1, ...)
    return occlusion_update(vals[:n], vals[n], config, xp)


def shade_occlusion(frag, uniforms, textures, config, xp):
    """Occlusion pass 2 (shader.rs:872-947): grayscale white * coefficient."""
    occ = occlusion_coefficient(
        frag["x"].astype(xp.float32),
        frag["y"].astype(xp.float32),
        frag["zfrag"],
        frag["shadow_buffer"],
        uniforms,
        config,
        xp,
    )
    return ml.color_blend(xp.asarray(WHITE), xp.asarray(BLACK), occ, xp)

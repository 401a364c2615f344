"""Backend-agnostic (NumPy / jax.numpy) math mirroring the reference exactly.

Every function takes an ``xp`` namespace argument (numpy or jax.numpy) so the
CPU oracle and the device renderer share one implementation of the reference's
math, keeping their results aligned to elementwise-IEEE-f32 accuracy.

Reference semantics encoded here:

* Rust cast semantics (SURVEY.md §2.2.5): `f32 as i32`/`as u32`/`as u8` are
  truncate-toward-zero with saturation, NaN -> 0; `f32::round` is
  half-away-from-zero.
* the camera matrix stack of `default_prepare`
  (reference: src/scene/shader.rs:183-230): Gram-Schmidt camera basis,
  rotation "model" matrix, translation "view" matrix, perspective row
  coef=-1/5, viewport to [0,w-1]x[0,h-1]x[0,255].
* 4x4 / 3x3 inverses via cofactor expansion (nalgebra's
  `try_inverse` specialization for small matrices).
* `Rotation3::rotation_between` (used by the occlusion shader at
  shader.rs:921) via axis-angle Rodrigues.

All matrix products are written with explicit left-to-right add order to
match nalgebra's accumulation order.
"""

from __future__ import annotations

import numpy as np

F32_MIN = np.float32(-3.4028235e38)  # f32::MIN — the z/shadow clear value
                                      # (reference: src/scene.rs:131-132)


# ---------------------------------------------------------------------------
# Rust cast semantics
# ---------------------------------------------------------------------------

# Largest f32 value not exceeding the integer type's max: casting saturates
# one f32-ulp early for out-of-range values, which never occur in practice.
_I32_LO = np.float32(-2147483648.0)
_I32_HI = np.float32(2147483520.0)
_U32_HI = np.float32(4294967040.0)


def rust_f32_to_i32(x, xp):
    """`x as i32`: truncate toward zero, saturate, NaN -> 0."""
    x = xp.where(xp.isnan(x), xp.float32(0.0), x)
    x = xp.clip(x, _I32_LO, _I32_HI)
    return xp.trunc(x).astype(xp.int32)


def rust_f32_to_u32(x, xp):
    """`x as u32`: truncate toward zero, saturate at [0, u32::MAX], NaN -> 0.

    Returned as int64-capable uint32 semantics; we keep int32 when the caller
    guarantees a small range (texture/shadow indices are clamped right after).
    """
    x = xp.where(xp.isnan(x), xp.float32(0.0), x)
    x = xp.clip(x, xp.float32(0.0), _U32_HI)
    return xp.trunc(x).astype(xp.uint32)


def rust_f32_to_u8(x, xp):
    """`x as u8`: truncate toward zero, saturate at [0, 255], NaN -> 0."""
    x = xp.where(xp.isnan(x), xp.float32(0.0), x)
    x = xp.clip(x, xp.float32(0.0), xp.float32(255.0))
    return xp.trunc(x).astype(xp.uint8)


def rust_round(x, xp):
    """`f32::round`: round half away from zero (jnp.round is half-to-even)."""
    f = xp.floor(x)
    frac = x - f
    up = f + xp.float32(1.0)
    return xp.where(
        frac > xp.float32(0.5),
        up,
        xp.where(
            frac < xp.float32(0.5),
            f,
            xp.where(x >= xp.float32(0.0), up, f),
        ),
    )


# ---------------------------------------------------------------------------
# Vector helpers (shape (..., 3)), nalgebra accumulation order
# ---------------------------------------------------------------------------


def dot3(a, b):
    """nalgebra Vector3 dot: ((x1*x2 + y1*y2) + z1*z2)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross3(a, b, xp):
    return xp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def norm3(a, xp):
    return xp.sqrt(dot3(a, a))


def normalize3(a, xp):
    return a / norm3(a, xp)[..., None]


# ---------------------------------------------------------------------------
# 4x4 matrices.  Stored (4, 4) row-major; explicit accumulation order.
# ---------------------------------------------------------------------------


def mat4_mul(a, b):
    """a @ b with nalgebra's left-to-right row-column accumulation."""
    return (
        a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
    ) + (a[..., :, 2:3] * b[..., 2:3, :] + a[..., :, 3:4] * b[..., 3:4, :])


def mat4_transform_point(m, p, xp):
    """Point3::from_homogeneous(m * p.to_homogeneous()): w=1, divide by w'.

    p: (..., 3).  Returns (..., 3).  Reference: src/scene/shader.rs:157-158.
    """
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    out = []
    for i in range(4):
        out.append(((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3])
    w = out[3]
    return xp.stack([out[0] / w, out[1] / w, out[2] / w], axis=-1)


def mat4_transform_vector(m, v, xp):
    """Vector3::from_homogeneous(m * v.to_homogeneous()): w=0, no divide."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    out = []
    for i in range(3):
        out.append((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z)
    return xp.stack(out, axis=-1)


def mat4_inverse(m, xp):
    """Cofactor-expansion 4x4 inverse (nalgebra try_inverse / MESA algorithm)."""
    a = [[m[i, j] for j in range(4)] for i in range(4)]
    (m00, m01, m02, m03) = a[0]
    (m10, m11, m12, m13) = a[1]
    (m20, m21, m22, m23) = a[2]
    (m30, m31, m32, m33) = a[3]

    s0 = m00 * m11 - m10 * m01
    s1 = m00 * m12 - m10 * m02
    s2 = m00 * m13 - m10 * m03
    s3 = m01 * m12 - m11 * m02
    s4 = m01 * m13 - m11 * m03
    s5 = m02 * m13 - m12 * m03

    c5 = m22 * m33 - m32 * m23
    c4 = m21 * m33 - m31 * m23
    c3 = m21 * m32 - m31 * m22
    c2 = m20 * m33 - m30 * m23
    c1 = m20 * m32 - m30 * m22
    c0 = m20 * m31 - m30 * m21

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    invdet = xp.float32(1.0) / det

    out = xp.stack(
        [
            xp.stack(
                [
                    (m11 * c5 - m12 * c4 + m13 * c3) * invdet,
                    (-m01 * c5 + m02 * c4 - m03 * c3) * invdet,
                    (m31 * s5 - m32 * s4 + m33 * s3) * invdet,
                    (-m21 * s5 + m22 * s4 - m23 * s3) * invdet,
                ]
            ),
            xp.stack(
                [
                    (-m10 * c5 + m12 * c2 - m13 * c1) * invdet,
                    (m00 * c5 - m02 * c2 + m03 * c1) * invdet,
                    (-m30 * s5 + m32 * s2 - m33 * s1) * invdet,
                    (m20 * s5 - m22 * s2 + m23 * s1) * invdet,
                ]
            ),
            xp.stack(
                [
                    (m10 * c4 - m11 * c2 + m13 * c0) * invdet,
                    (-m00 * c4 + m01 * c2 - m03 * c0) * invdet,
                    (m30 * s4 - m31 * s2 + m33 * s0) * invdet,
                    (-m20 * s4 + m21 * s2 - m23 * s0) * invdet,
                ]
            ),
            xp.stack(
                [
                    (-m10 * c3 + m11 * c1 - m12 * c0) * invdet,
                    (m00 * c3 - m01 * c1 + m02 * c0) * invdet,
                    (-m30 * s3 + m31 * s1 - m32 * s0) * invdet,
                    (m20 * s3 - m21 * s1 + m22 * s0) * invdet,
                ]
            ),
        ]
    )
    return out


def mat3_inverse(m, xp):
    """Cofactor 3x3 inverse; det==0 input would panic in the reference
    (shader.rs:631 unwrap) — here it produces inf/nan which the caller's
    downstream normalize turns into NaN color, cast to 0 (black)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    invdet = xp.float32(1.0) / det

    row0 = xp.stack([c00, m02 * m21 - m01 * m22, m01 * m12 - m02 * m11], axis=-1)
    row1 = xp.stack([c01, m00 * m22 - m02 * m20, m02 * m10 - m00 * m12], axis=-1)
    row2 = xp.stack([c02, m01 * m20 - m00 * m21, m00 * m11 - m01 * m10], axis=-1)
    return xp.stack([row0, row1, row2], axis=-2) * invdet[..., None, None]


# ---------------------------------------------------------------------------
# The reference's frame-constant preparers (src/scene/shader.rs:183-279)
# ---------------------------------------------------------------------------


def camera_matrices(width, height, depth, projection_coef, look_from, look_at, up, xp):
    """The matrix stack of `default_prepare` (shader.rs:183-230).

    Returns dict with vpmv, m (model matrix), it_m, camera_direction.
    width/height/depth/projection_coef are Python floats (static).
    """
    f32 = xp.float32
    new_z = normalize3(look_from - look_at, xp)
    new_y = normalize3(up - (dot3(new_z, up) * new_z), xp)
    new_x = normalize3(cross3(new_y, new_z, xp), xp)

    zero = xp.zeros((), xp.float32)
    one = xp.ones((), xp.float32)

    def row(v, w):
        return xp.stack([v[0], v[1], v[2], w])

    model = xp.stack(
        [
            row(new_x, zero),
            row(new_y, zero),
            row(new_z, zero),
            xp.stack([zero, zero, zero, one]),
        ]
    )
    view = xp.stack(
        [
            xp.stack([one, zero, zero, -look_from[0]]),
            xp.stack([zero, one, zero, -look_from[1]]),
            xp.stack([zero, zero, one, -look_from[2]]),
            xp.stack([zero, zero, zero, one]),
        ]
    )
    coef = f32(projection_coef)
    projection = xp.asarray(
        np.array(
            [
                [1.0, 0.0, 0.0, 0.0],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, 1.0, 0.0],
                [0.0, 0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )
    )
    # projection[3, 2] = coef without host round-trips: build additively.
    e32 = xp.zeros((4, 4), xp.float32)
    if xp is np:
        e32 = e32.copy()
        e32[3, 2] = coef
    else:
        e32 = e32.at[3, 2].set(coef)
    projection = projection + e32

    w = np.float32(width - 1)
    h = np.float32(height - 1)
    d = np.float32(depth)
    viewport = xp.asarray(
        np.array(
            [
                [w / np.float32(2.0), 0.0, 0.0, w / np.float32(2.0)],
                [0.0, h / np.float32(2.0), 0.0, h / np.float32(2.0)],
                [0.0, 0.0, d / np.float32(2.0), d / np.float32(2.0)],
                [0.0, 0.0, 0.0, 1.0],
            ],
            dtype=np.float32,
        )
    )

    # nalgebra evaluates viewport * projection * model * view left-to-right.
    vpmv = mat4_mul(mat4_mul(mat4_mul(viewport, projection), model), view)
    it_m = mat4_inverse(xp.swapaxes(model, -1, -2), xp)
    return {
        "vpmv": vpmv,
        "m": model,
        "it_m": it_m,
        "camera_direction": new_z,
    }


def default_prepare(config, light_direction, look_from, look_at, up, xp):
    """Full `default_prepare` (shader.rs:183-230): matrices + transformed light."""
    u = camera_matrices(
        config.width,
        config.height,
        config.depth,
        config.projection_coef,
        look_from,
        look_at,
        up,
        xp,
    )
    u["t_light_direction"] = normalize3(
        mat4_transform_vector(u["m"], light_direction, xp), xp
    )
    return u


def shadow_pass_1_prepare(config, light_direction, look_at, up, xp):
    """shadow_pass_prepare_1 (shader.rs:234-255): camera placed at the light
    direction point; the resulting vpmv is the shadow matrix."""
    u = default_prepare(config, light_direction, light_direction, look_at, up, xp)
    u["shadow_matrix"] = u["vpmv"]
    return u


def shadow_pass_2_prepare(config, light_direction, look_from, look_at, up, xp):
    """shadow_pass_prepare_2 (shader.rs:259-279): default + i_vpmv, i_m."""
    u = default_prepare(config, light_direction, look_from, look_at, up, xp)
    u["i_vpmv"] = mat4_inverse(u["vpmv"], xp)
    u["i_m"] = mat4_inverse(u["m"], xp)
    return u


# ---------------------------------------------------------------------------
# Rotation3::rotation_between (occlusion sampling, shader.rs:921)
# ---------------------------------------------------------------------------


def rotation_between(a, b, xp):
    """Rotation matrix taking direction a to direction b (nalgebra semantics).

    nalgebra: normalize both, axis = cross, angle = acos(dot); identity when
    aligned.  For exactly opposite vectors nalgebra returns None and the
    reference panics (shader.rs:921 unwrap); we instead return a 180-degree
    rotation about the x-axis (documented divergence — no crash inside jit).
    """
    na_ = normalize3(a, xp)
    nb_ = normalize3(b, xp)
    c = cross3(na_, nb_, xp)
    norm_c = norm3(c, xp)
    d = dot3(na_, nb_)
    eps = xp.float32(1.19209290e-7)  # f32::EPSILON, nalgebra's default_epsilon

    safe_norm = xp.where(norm_c > eps, norm_c, xp.float32(1.0))
    axis = c / safe_norm[..., None]
    # acos of a clamped dot; nalgebra does not clamp (NaN for |dot|>1 via
    # rounding) but that NaN would poison the whole frame — divergence noted.
    angle = xp.arccos(xp.clip(d, xp.float32(-1.0), xp.float32(1.0)))

    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    s = xp.sin(angle)
    cth = xp.cos(angle)
    one_m = xp.float32(1.0) - cth
    rot = xp.stack(
        [
            xp.stack([ax * ax * one_m + cth, ax * ay * one_m - az * s, ax * az * one_m + ay * s], axis=-1),
            xp.stack([ax * ay * one_m + az * s, ay * ay * one_m + cth, ay * az * one_m - ax * s], axis=-1),
            xp.stack([ax * az * one_m - ay * s, ay * az * one_m + ax * s, az * az * one_m + cth], axis=-1),
        ],
        axis=-2,
    )
    eye = xp.eye(3, dtype=xp.float32)
    flip_x = xp.asarray(np.diag(np.array([1.0, -1.0, -1.0], dtype=np.float32)))
    aligned = xp.where(d >= xp.float32(0.0), eye, flip_x)
    return xp.where(norm_c > eps, rot, aligned)


# ---------------------------------------------------------------------------
# Color blend (src/scene/util.rs:7-13)
# ---------------------------------------------------------------------------


def color_blend(color_1, color_2, t, xp):
    """Per-channel t*c1 + (1-t)*c2 with Rust saturating `as u8` cast.

    color_1/color_2: (..., 3) u8; t: (...) f32, deliberately unclamped — a
    negative light intensity makes the result black via cast saturation.
    """
    c1 = color_1.astype(xp.float32)
    c2 = color_2.astype(xp.float32)
    t = t[..., None]
    return rust_f32_to_u8(t * c1 + (xp.float32(1.0) - t) * c2, xp)

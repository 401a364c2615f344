"""Procedural test/demo meshes.

The reference ships exactly two OBJ assets (diablo, african_head —
SURVEY.md §2.9) and supports any asset directory with the same file set.
These generators produce meshes with the identical geometry contract
(positions / tex_coords / normals + PTN triangle indices, unit-sphere scale
to suit the fixed orbit camera at radius 1 and projection distance 5) for
tests, demos and benchmarking without external assets.
"""

from __future__ import annotations

import numpy as np

from ..assets.obj import ObjMesh


def _mesh(positions, tex_coords, normals, pos_idx, tex_idx, normal_idx) -> ObjMesh:
    return ObjMesh(
        positions=np.asarray(positions, np.float32).reshape(-1, 3),
        tex_coords=np.asarray(tex_coords, np.float32).reshape(-1, 2),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        pos_idx=np.asarray(pos_idx, np.int32).reshape(-1, 3),
        tex_idx=np.asarray(tex_idx, np.int32).reshape(-1, 3),
        normal_idx=np.asarray(normal_idx, np.int32).reshape(-1, 3),
    )


def make_plane(size: float = 0.8) -> ObjMesh:
    """Two CCW triangles in the z=0 plane facing +z."""
    s = size / 2
    positions = [[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]]
    tex_coords = [[0, 0], [1, 0], [1, 1], [0, 1]]
    normals = [[0, 0, 1]]
    pos_idx = [[0, 1, 2], [0, 2, 3]]
    tex_idx = pos_idx
    normal_idx = [[0, 0, 0], [0, 0, 0]]
    return _mesh(positions, tex_coords, normals, pos_idx, tex_idx, normal_idx)


def make_cube(size: float = 0.6) -> ObjMesh:
    """Axis-aligned cube with per-face normals and uv per face."""
    s = size / 2
    faces = [
        # (normal, four corners CCW as seen from outside)
        ([0, 0, 1], [[-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]]),
        ([0, 0, -1], [[s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]]),
        ([1, 0, 0], [[s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]]),
        ([-1, 0, 0], [[-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]]),
        ([0, 1, 0], [[-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]]),
        ([0, -1, 0], [[-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]]),
    ]
    positions, normals, pos_idx, normal_idx = [], [], [], []
    tex_coords = [[0, 0], [1, 0], [1, 1], [0, 1]]
    tex_idx = []
    for normal, corners in faces:
        base = len(positions)
        positions.extend(corners)
        normals.append(normal)
        ni = len(normals) - 1
        pos_idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        normal_idx += [[ni] * 3, [ni] * 3]
        tex_idx += [[0, 1, 2], [0, 2, 3]]
    return _mesh(positions, tex_coords, normals, pos_idx, tex_idx, normal_idx)


def make_uv_sphere(radius: float = 0.45, stacks: int = 16, slices: int = 32) -> ObjMesh:
    """Latitude/longitude sphere with smooth normals and equirect uvs."""
    positions, normals, tex_coords = [], [], []
    for i in range(stacks + 1):
        theta = np.pi * i / stacks
        for j in range(slices + 1):
            phi = 2 * np.pi * j / slices
            n = [
                np.sin(theta) * np.cos(phi),
                np.cos(theta),
                np.sin(theta) * np.sin(phi),
            ]
            normals.append(n)
            positions.append([radius * c for c in n])
            tex_coords.append([j / slices, 1.0 - i / stacks])
    idx = []
    cols = slices + 1
    for i in range(stacks):
        for j in range(slices):
            a = i * cols + j
            b = a + cols
            if i != 0:
                idx.append([a, a + 1, b])
            if i != stacks - 1:
                idx.append([a + 1, b + 1, b])
    idx = np.asarray(idx, np.int32)
    return _mesh(positions, tex_coords, normals, idx, idx, idx)


def checker_texture(size: int = 256, cells: int = 8,
                    c0=(40, 40, 200), c1=(230, 230, 230)) -> np.ndarray:
    """(size, size, 3) u8 checkerboard for demo texturing."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cell = size // cells
    mask = ((xx // cell) + (yy // cell)) % 2 == 0
    out = np.where(mask[..., None], np.array(c0, np.uint8), np.array(c1, np.uint8))
    return out.astype(np.uint8)


def flat_normal_texture(size: int = 256) -> np.ndarray:
    """Normal map encoding the +z normal (value 0.5 -> byte 127/128ish)."""
    out = np.empty((size, size, 3), np.uint8)
    out[..., 0] = 128
    out[..., 1] = 128
    out[..., 2] = 255
    return out


def _blob(center, radii, stacks, slices, rng, uv_band):
    """One closed, radially displaced ellipsoid with OBJ-style PTN streams.

    Positions and normals share seam and pole vertices (so normals are
    smooth across the seam, as in an exported OBJ); tex coords keep the
    full (stacks+1) x (slices+1) grid inside the v-range `uv_band`.
    2 * slices * (stacks - 1) triangles, wound like make_uv_sphere.
    """
    # Smooth displacement: a few seeded plane waves over the direction,
    # a function of the 3D point so the shared seam vertices agree.
    waves = rng.normal(size=(4, 3))
    waves /= np.linalg.norm(waves, axis=1, keepdims=True)
    freq = rng.uniform(2.0, 6.0, size=4)
    phase = rng.uniform(0.0, 2 * np.pi, size=4)
    amp = rng.uniform(0.03, 0.07)

    theta = np.pi * np.arange(1, stacks) / stacks
    phi = 2 * np.pi * np.arange(slices) / slices
    ring = np.stack(
        [
            np.sin(theta)[:, None] * np.cos(phi)[None, :],
            np.broadcast_to(np.cos(theta)[:, None], (stacks - 1, slices)),
            np.sin(theta)[:, None] * np.sin(phi)[None, :],
        ],
        axis=-1,
    ).reshape(-1, 3)
    dirs = np.concatenate([[[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], ring])
    bump = 1.0 + amp * np.sin(dirs @ waves.T * freq + phase).sum(axis=1) / 2
    positions = np.asarray(center) + dirs * np.asarray(radii) * bump[:, None]

    def pid(i, j):
        if i == 0:
            return 0
        if i == stacks:
            return 1
        return 2 + (i - 1) * slices + j % slices

    cols = slices + 1
    p_idx, t_idx = [], []
    for i in range(stacks):
        for j in range(slices):
            a, b = i * cols + j, (i + 1) * cols + j
            if i != 0:
                t_idx.append([a, a + 1, b])
                p_idx.append([pid(i, j), pid(i, j + 1), pid(i + 1, j)])
            if i != stacks - 1:
                t_idx.append([a + 1, b + 1, b])
                p_idx.append([pid(i, j + 1), pid(i + 1, j + 1), pid(i + 1, j)])
    p_idx = np.asarray(p_idx, np.int64)

    # Area-weighted vertex normals over the shared position vertices.
    tri = positions[p_idx]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normals = np.zeros_like(positions)
    for c in range(3):
        np.add.at(normals, p_idx[:, c], fn)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)

    v0, v1 = uv_band
    uu, vv = np.meshgrid(np.arange(cols) / slices, np.arange(stacks + 1) / stacks)
    tex = np.stack([uu, v1 - (v1 - v0) * vv], axis=-1).reshape(-1, 2)
    return positions, tex, normals, p_idx, np.asarray(t_idx, np.int64)


# Blob layouts (center, radii, stacks, slices).  Each blob contributes
# 2 * slices * (stacks - 1) triangles; the sums are the reference assets'
# counts: 5,022 (diablo) and 2,492 (african_head).
_SCENE_BLOBS = {
    "diablo": (
        ((0.0, -0.10, 0.0), (0.34, 0.58, 0.28), 32, 36),   # body
        ((0.0, 0.60, 0.08), (0.20, 0.22, 0.20), 32, 15),   # head
        ((-0.40, 0.00, 0.14), (0.14, 0.44, 0.15), 32, 15),  # arms
        ((0.40, 0.00, 0.14), (0.14, 0.44, 0.15), 32, 15),
    ),
    "african_head": (
        ((0.0, 0.05, 0.0), (0.50, 0.62, 0.50), 15, 49),   # skull
        ((0.0, -0.05, 0.45), (0.12, 0.20, 0.16), 15, 20),  # nose
        ((0.0, -0.62, -0.08), (0.24, 0.30, 0.24), 15, 20),  # neck
    ),
}


def _smooth_field(rng, shape, n_waves=6):
    """(H, W) f32 sum of seeded plane waves in [-1, 1]."""
    h, w = shape
    yy, xx = np.meshgrid(
        np.linspace(0, 1, h, dtype=np.float32),
        np.linspace(0, 1, w, dtype=np.float32),
        indexing="ij",
    )
    out = np.zeros(shape, np.float32)
    for _ in range(n_waves):
        kx, ky = rng.uniform(-24, 24, size=2).astype(np.float32)
        ph = np.float32(rng.uniform(0, 2 * np.pi))
        out += np.sin(kx * xx + ky * yy + ph)
    return out / np.float32(n_waves)


def _to_u8(x):
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def seeded_maps(seed=0, size: int = 1024) -> dict:
    """The four (size, size, 3) u8 maps of an asset, generated from `seed`
    (an int or a sequence of ints, as np.random.default_rng takes it):
    a colored diffuse texture, an object-space normal map, a tangent-space
    normal map near +z, and a grayscale specular map."""
    rng = np.random.default_rng(seed)
    shape = (size, size)
    f = [_smooth_field(rng, shape) for _ in range(3)]
    grain = rng.integers(-10, 11, size=(size, size, 3)).astype(np.float32)
    base = np.asarray([120.0, 90.0, 70.0], np.float32)
    spread = np.asarray([90.0, 70.0, 60.0], np.float32)
    texture = _to_u8(base + spread * np.stack(f, -1) + grain)

    def encode(n):
        n = n / np.linalg.norm(n, axis=-1, keepdims=True)
        return _to_u8((n + 1.0) * 127.5)

    obj_n = np.stack([_smooth_field(rng, shape) for _ in range(3)], -1)
    obj_n[..., 2] += 0.25  # keep away from the zero vector
    tan_n = np.stack(
        [0.35 * _smooth_field(rng, shape), 0.35 * _smooth_field(rng, shape),
         np.ones(shape, np.float32)], -1,
    )
    spec = _to_u8(20.0 + 18.0 * _smooth_field(rng, shape))
    return {
        "texture": texture,
        "normal_map": encode(obj_n),
        "normal_map_tangent": encode(tan_n),
        "specular_map": np.repeat(spec[..., None], 3, axis=-1),
    }


SEEDED_SCENES = tuple(_SCENE_BLOBS)


def seeded_mesh(name: str, seed: int = 0) -> ObjMesh:
    """Mesh of the reference asset shape `name` ("diablo": 5,022 triangles;
    "african_head": 2,492), generated from `seed`.

    A few displaced ellipsoids that overlap, so the scene occludes itself
    (depth complexity above 1) and casts shadows on itself, at unit-sphere
    scale for the fixed orbit camera.  Vertices are rounded to 6 decimals,
    as an exported OBJ stores them.  The same (name, seed) gives
    byte-identical arrays.
    """
    if name not in _SCENE_BLOBS:
        raise ValueError(
            f"unknown seeded scene {name!r}; expected one of {SEEDED_SCENES}"
        )
    rng = np.random.default_rng([seed, SEEDED_SCENES.index(name)])
    blobs = _SCENE_BLOBS[name]
    parts = ([], [], [], [], [])
    n_pos = n_tex = 0
    for k, (center, radii, stacks, slices) in enumerate(blobs):
        jitter = rng.uniform(-0.02, 0.02, size=3)
        band = (k / len(blobs), (k + 1) / len(blobs))
        pos, tex, nrm, p_idx, t_idx = _blob(
            np.asarray(center) + jitter, radii, stacks, slices, rng, band
        )
        for acc, arr in zip(parts, (pos, tex, nrm, p_idx + n_pos, t_idx + n_tex)):
            acc.append(arr)
        n_pos += pos.shape[0]
        n_tex += tex.shape[0]
    positions, tex, normals, p_idx, t_idx = (np.concatenate(a) for a in parts)
    return _mesh(
        np.round(positions, 6), np.round(tex, 6), np.round(normals, 6),
        p_idx, t_idx, p_idx,
    )


def seeded_model(name: str, seed: int = 0):
    """Model (mesh + four 1024x1024 maps) of the reference asset shape
    `name`, generated from `seed` — see seeded_mesh and seeded_maps."""
    from ..assets.model import Model

    maps = seeded_maps([seed, SEEDED_SCENES.index(name), 1])
    return Model(mesh=seeded_mesh(name, seed), **maps)


def to_geom(mesh: ObjMesh) -> dict:
    """Geometry dict in the frame-function input format."""
    return {
        "positions": mesh.positions,
        "tex_coords": mesh.tex_coords,
        "normals": mesh.normals,
        "pos_idx": mesh.pos_idx,
        "tex_idx": mesh.tex_idx,
        "normal_idx": mesh.normal_idx,
    }


def make_textures(size: int = 256) -> dict:
    """Full texture set (diffuse/normal/tangent-normal/specular) for demos."""
    return {
        "texture": checker_texture(size),
        "normal_map": flat_normal_texture(size),
        "normal_map_tangent": flat_normal_texture(size),
        "specular_map": np.full((size, size, 3), 8, np.uint8),
    }

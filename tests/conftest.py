"""Test configuration: CPU backend with a virtual 8-device mesh.

Sharding is validated on a host-platform device mesh
(xla_force_host_platform_device_count=8); the GPU kernel itself is covered
by chip_smoke.py on the card and by the `gpu`-marked tests, which skip
off the card.  The reference-shape scenes are generated from a seed
(models.procedural.seeded_model).
"""

import os
import tempfile

# CLI tests exercise app.main(), which enables the persistent compilation
# cache by default — point it at a throwaway dir, never the checkout's
# cache or one the user configured (the suite must not pollute it with
# tiny CPU-test entries).
os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(
    prefix="trt_xla_cache_"
)

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    # The fast suite runs on the CPU; `JAX_PLATFORMS=cuda pytest -m gpu`
    # runs the card-only checks on a GPU host.
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

def geom_dict(mesh):
    return {
        "positions": mesh.positions,
        "tex_coords": mesh.tex_coords,
        "normals": mesh.normals,
        "pos_idx": mesh.pos_idx,
        "tex_idx": mesh.tex_idx,
        "normal_idx": mesh.normal_idx,
    }


def tex_dict(model):
    return {
        "texture": model.texture,
        "normal_map": model.normal_map,
        "normal_map_tangent": model.normal_map_tangent,
        "specular_map": model.specular_map,
    }


@pytest.fixture(scope="session")
def head_model():
    """The african_head-shaped seeded scene (2,492 triangles)."""
    from tiny_renderer_tpu.models.procedural import seeded_model

    return seeded_model("african_head", 0)


@pytest.fixture(scope="session")
def diablo_model():
    """The diablo-shaped seeded scene (5,022 triangles)."""
    from tiny_renderer_tpu.models.procedural import seeded_model

    return seeded_model("diablo", 0)


def format_obj(mesh):
    """OBJ text of `mesh` (v / vt / vn records and 1-based PTN faces).

    Floats are written as the shortest decimal of their exact value, so
    parse_obj (and the native loader) read back the identical f32 arrays.
    """

    def rows(tag, arr):
        return [
            tag + " " + " ".join(repr(float(x)) for x in row) for row in arr
        ]

    faces = np.stack([mesh.pos_idx, mesh.tex_idx, mesh.normal_idx], -1) + 1
    lines = (
        rows("v", mesh.positions)
        + rows("vt", mesh.tex_coords)
        + rows("vn", mesh.normals)
        + ["f " + " ".join("/".join(map(str, c)) for c in f) for f in faces]
    )
    return "\n".join(lines) + "\n"


def encode_tga_rle(img):
    """(H, W, 3) RGB u8 -> 24 bpp run-length TGA (type 10), bottom-left
    origin like the reference's assets.  Runs of equal pixels become RLE
    packets of at most 128 pixels; packets never cross a scanline."""
    import struct

    h, w, _ = img.shape
    rows = np.ascontiguousarray(img[::-1, :, ::-1])  # bottom row first, BGR
    px = rows.reshape(h * w, 3)
    change = np.ones(h * w, bool)
    change[1:] = np.any(px[1:] != px[:-1], axis=1)
    change[::w] = True  # a run starts at every scanline
    starts = np.flatnonzero(change)
    lengths = np.diff(np.append(starts, h * w))
    # Split runs longer than 128 pixels into 128-pixel packets.
    n_pk = -(-lengths // 128)
    first = np.repeat(starts, n_pk)
    k = np.arange(n_pk.sum()) - np.repeat(np.cumsum(n_pk) - n_pk, n_pk)
    pk_len = np.minimum(np.repeat(lengths, n_pk) - 128 * k, 128)
    packets = np.empty((first.size, 4), np.uint8)
    packets[:, 0] = 0x80 | (pk_len - 1)
    packets[:, 1:] = px[first + 128 * k]
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h, 24, 0)
    return header + packets.tobytes()


def write_asset_dir(path, name, seed=0):
    """Write seeded_model(name, seed) as an asset directory in the
    reference's layout (model.obj + the four maps as RLE TGA), loadable by
    assets.load_model.  Returns `path`."""
    from tiny_renderer_tpu.models.procedural import seeded_model

    model = seeded_model(name, seed)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.obj"), "w") as f:
        f.write(format_obj(model.mesh))
    for key in ("texture", "normal_map", "normal_map_tangent", "specular_map"):
        with open(os.path.join(path, f"{key}.tga"), "wb") as f:
            f.write(encode_tga_rle(getattr(model, key)))
    return path


@pytest.fixture(scope="session")
def asset_root(tmp_path_factory):
    """A directory holding both seeded scenes in the reference's asset
    layout (model.obj + four RLE TGA maps), for the loaders and the CLI."""
    from tiny_renderer_tpu.models.procedural import SEEDED_SCENES

    root = tmp_path_factory.mktemp("assets")
    for name in SEEDED_SCENES:
        write_asset_dir(str(root / name), name, 0)
    return str(root)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked `gpu` check the compiled kernel and skip unless JAX
    runs on a GPU; chip_smoke.py runs their equivalents on the card."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU form")


@pytest.fixture(scope="session")
def head_scene_data(head_model):
    return geom_dict(head_model.mesh), tex_dict(head_model)


@pytest.fixture(scope="session")
def diablo_scene_data(diablo_model):
    return geom_dict(diablo_model.mesh), tex_dict(diablo_model)


@pytest.fixture(scope="session")
def camera():
    light = np.array([0.35, 0.0, 0.94], np.float32)
    look_from = np.array([0.25, 0.0, 0.97], np.float32)
    look_at = np.zeros(3, np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    return light, look_from, look_at, up


# Orbit-sweep poses (camera_deg, light_deg) for angle-parametrized parity:
# includes oblique/grazing light (grazing light exercises shadow-index
# saturation and off-axis occlusion probes).  The reference orbits both on
# the full unit XZ circle (src/app.rs:200-207), so any angle is in-spec.
ORBIT_POSES = (
    (0.0, 70.0),
    (25.0, -60.0),
    (80.0, 15.0),
    (160.0, 85.0),
    (245.0, -80.0),
)


def pose_camera(cam_deg, light_deg):
    """(light, look_from, look_at, up) from orbit angles in degrees
    (src/app.rs:200-207 parameterization)."""
    ca = np.deg2rad(np.float32(cam_deg))
    la = np.deg2rad(np.float32(light_deg))
    light = np.array([np.sin(la), 0.0, np.cos(la)], np.float32)
    look_from = np.array([np.sin(ca), 0.0, np.cos(ca)], np.float32)
    return light, look_from, np.zeros(3, np.float32), np.array([0.0, 1.0, 0.0], np.float32)

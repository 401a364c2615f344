"""Asset layer: TGA decode (vs PIL + native C++), OBJ parse (vs known counts).

The reference's asset facts (SURVEY.md §2.9): diablo 5022 tris,
african_head 2492 tris, all maps 1024x1024 RLE TGA.  The seeded scenes
(models.procedural) keep those shapes; the `asset_root` fixture writes
them to disk as OBJ + RLE TGA, and these tests read them back through the
NumPy and native loaders.
"""

import os

import numpy as np
import pytest

from tiny_renderer_tpu.assets.obj import parse_obj
from tiny_renderer_tpu.assets.tga import read_tga
from tiny_renderer_tpu.assets import native

MAPS = ("texture", "normal_map", "normal_map_tangent", "specular_map")
ALL_TGAS = [(model, name) for model in ("diablo", "african_head") for name in MAPS]


@pytest.mark.parametrize("model,name", ALL_TGAS)
def test_tga_matches_pil(asset_root, model, name):
    PIL = pytest.importorskip("PIL.Image")
    path = os.path.join(asset_root, model, name + ".tga")
    ours = read_tga(path)
    theirs = np.asarray(PIL.open(path).convert("RGB"))
    assert ours.shape == theirs.shape == (1024, 1024, 3)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("model,name", ALL_TGAS)
def test_native_loader_matches_numpy(asset_root, model, name):
    if not native.native_available():
        pytest.skip("native loader not built")
    path = os.path.join(asset_root, model, name + ".tga")
    nat = native.read_tga_native(path)
    np.testing.assert_array_equal(nat, read_tga(path))


@pytest.mark.parametrize("asset", ["diablo", "african_head"])
def test_native_obj_matches_numpy(asset_root, asset):
    if not native.native_available():
        pytest.skip("native loader not built")
    from tiny_renderer_tpu.assets.obj import read_obj

    p = os.path.join(asset_root, asset, "model.obj")
    m_py = read_obj(p)
    m_c = native.read_obj_native(p)
    assert m_c is not None
    for field in ("positions", "tex_coords", "normals", "pos_idx", "tex_idx", "normal_idx"):
        np.testing.assert_array_equal(getattr(m_c, field), getattr(m_py, field), err_msg=field)


def test_obj_counts_diablo(asset_root, diablo_model):
    from tiny_renderer_tpu import load_model

    mesh = load_model(os.path.join(asset_root, "diablo"), verbose=False).mesh
    assert mesh.num_vertices == 2519
    assert mesh.num_triangles == 5022
    assert mesh.tex_coords.shape[0] == 2805
    assert mesh.normals.shape[0] == 2519
    for field in ("positions", "tex_coords", "normals", "pos_idx", "tex_idx", "normal_idx"):
        np.testing.assert_array_equal(
            getattr(mesh, field), getattr(diablo_model.mesh, field), err_msg=field
        )


def test_obj_counts_head(asset_root, head_model):
    from tiny_renderer_tpu import load_model

    model = load_model(os.path.join(asset_root, "african_head"), verbose=False)
    assert model.mesh.num_vertices == 1252
    assert model.mesh.num_triangles == 2492
    for key in MAPS:
        img = getattr(model, key)
        assert img.shape == (1024, 1024, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, getattr(head_model, key), err_msg=key)


def test_seeded_scenes_are_deterministic():
    """Same (name, seed) -> byte-identical arrays; another seed differs."""
    from tiny_renderer_tpu.models import seeded_model

    a, b = seeded_model("african_head", 3), seeded_model("african_head", 3)
    c = seeded_model("african_head", 4)
    for field in ("positions", "tex_coords", "normals", "pos_idx"):
        assert getattr(a.mesh, field).tobytes() == getattr(b.mesh, field).tobytes()
    for key in MAPS:
        assert getattr(a, key).tobytes() == getattr(b, key).tobytes()
    assert not np.array_equal(a.mesh.positions, c.mesh.positions)
    assert not np.array_equal(a.texture, c.texture)


def test_obj_parser_small():
    text = """
# comment
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 0.0 1.0 0.0
vt 0.1 0.2
vt 0.3 0.4
vt 0.5 0.6
vn 0.0 0.0 1.0
f 1/1/1 2/2/1 3/3/1
"""
    mesh = parse_obj(text)
    assert mesh.num_triangles == 1
    np.testing.assert_array_equal(mesh.pos_idx, [[0, 1, 2]])
    np.testing.assert_array_equal(mesh.tex_idx, [[0, 1, 2]])
    np.testing.assert_array_equal(mesh.normal_idx, [[0, 0, 0]])
    np.testing.assert_allclose(mesh.tex_coords[1], [0.3, 0.4])


def test_obj_parser_rejects_non_ptn():
    # The reference panics on non-PTN polygons (src/scene.rs:218).
    with pytest.raises(ValueError, match="PTN"):
        parse_obj("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")


def test_obj_quad_uses_first_three_corners():
    # Reference reads only indices[0..3] of each polygon (src/scene.rs:224-226).
    text = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vn 0 0 1
f 1/1/1 2/1/1 3/1/1 4/1/1
"""
    mesh = parse_obj(text)
    assert mesh.num_triangles == 1
    np.testing.assert_array_equal(mesh.pos_idx, [[0, 1, 2]])


def test_load_model_missing_files(tmp_path):
    from tiny_renderer_tpu import load_model

    with pytest.raises(FileNotFoundError, match="missing required files"):
        load_model(str(tmp_path))

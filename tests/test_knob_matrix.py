"""Cross-product bit-identity of the pinned perf knobs.

Every RenderConfig perf knob is documented bit-identity-pinned (config.py)
and tested individually; this matrix pins COMPOSITIONS, where gating
interplay lives (e.g. strip_planes must compose with csr_indirect and the
texture swizzles, csr_indirect changes the record layout under every
other knob, and the tile shape re-partitions the kernel grid).  All combos
must render the exact same frame: raster resolve is lexicographic and
shading expressions are shared, so any knob changing a pixel is a bug,
not noise.
"""

import dataclasses

import numpy as np
import pytest

from tiny_renderer_tpu.config import RenderConfig
from tiny_renderer_tpu.pipelines.frame import render_frame

from conftest import geom_dict, tex_dict

BASE = RenderConfig(width=64, height=64, strip_batch=32, tile_h=8)

# (name, knob overrides) — rendered with needs_z=False (the burst
# posture).  Fast set: every knob appears at least once (via a single or
# inside all-on); the remaining compositions exercise the same gates and
# run in -m slow.
_SLOW = {"planes", "sl32", "sl4", "t16", "swz16", "swz16+planes",
         "swz8+fullplane", "sswz16+swz16", "sswz16"}
COMBOS = [
    ("nocsr", dict(csr_indirect=False)),
    ("planes", dict(strip_planes=True)),
    ("fullplane", dict(compact_shade=False)),
    ("sl32", dict(strip_len=32)),
    ("sl4", dict(strip_len=4)),
    ("t16", dict(tile_h=16)),
    ("t32x64", dict(tile_h=32, tile_w=64)),
    ("swz16", dict(tex_tile=16)),
    ("swz16+planes", dict(tex_tile=16, strip_planes=True)),
    ("swz8+fullplane", dict(tex_tile=8, compact_shade=False)),
    ("sswz16", dict(shadow_tile=16)),
    ("sswz8", dict(shadow_tile=8)),
    ("sswz16+swz16", dict(shadow_tile=16, tex_tile=16)),
    ("all-on", dict(strip_planes=True, csr_indirect=False,
                    binning_compact=True, tile_h=16, tex_tile=16,
                    shadow_tile=16)),
]
COMBOS = [
    pytest.param(n, k, id=n,
                 marks=pytest.mark.slow if n in _SLOW else ())
    for n, k in COMBOS
]


@pytest.fixture(scope="module")
def scene(head_model):
    return geom_dict(head_model.mesh), tex_dict(head_model)


@pytest.fixture(scope="module")
def baseline(scene, camera):
    geom, tex = scene
    out = render_frame(
        geom, tex, *camera, pipeline="shadow", config=BASE,
        backend="pallas_interpret", needs_z=False,
    )
    return np.asarray(out["frame"])


@pytest.mark.parametrize("name,knobs", COMBOS)
def test_knob_combo_bit_identical(scene, camera, baseline, name, knobs):
    geom, tex = scene
    cfg = dataclasses.replace(BASE, **knobs)
    out = render_frame(
        geom, tex, *camera, pipeline="shadow", config=cfg,
        backend="pallas_interpret", needs_z=False,
    )
    np.testing.assert_array_equal(np.asarray(out["frame"]), baseline)

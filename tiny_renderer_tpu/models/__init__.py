from .procedural import (
    SEEDED_SCENES,
    make_cube,
    make_plane,
    make_uv_sphere,
    seeded_model,
    to_geom,
)

__all__ = [
    "SEEDED_SCENES",
    "make_cube",
    "make_plane",
    "make_uv_sphere",
    "seeded_model",
    "to_geom",
]

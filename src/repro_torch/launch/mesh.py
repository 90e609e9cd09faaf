"""Device meshes of the port (port of ``repro/launch/mesh.py`` and of
``worker_index`` in ``repro/train/step.py``).

A mesh is a shape and named axes: ``DxM`` gives ``("data", "model")``,
``PxDxM`` gives ``("pod", "data", "model")``.  The data axes (``pod``,
``data``) index the data-parallel workers; a worker's joint rank over
them is row-major, so the LAST data axis carries the low bits — the
order ``lax.all_gather`` over a tuple of axes and
``repro.dist.aggregate.gtopk_round_plan`` use.  Building a mesh touches
no device: which process or which slot of this process runs a worker is
the wire's business (``dist/wire.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

DATA_AXES = ("pod", "data")


class Mesh(NamedTuple):
    """``shape`` per axis, ``axis_names`` in mesh order."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    shape, axes = tuple(int(x) for x in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if any(x < 1 for x in shape):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    if "model" not in axes or not set(axes) <= set(DATA_AXES + ("model",)):
        raise ValueError(f"mesh axes must be a subset of {DATA_AXES} plus "
                         f"'model', got {axes}")
    return Mesh(shape, axes)


def parse_mesh(spec) -> Mesh:
    """``"DxM"`` / ``"PxDxM"`` (or a tuple of 2 or 3 sizes, or a Mesh)."""
    if isinstance(spec, Mesh):
        return spec
    dims = (tuple(int(x) for x in spec.split("x")) if isinstance(spec, str)
            else tuple(int(x) for x in spec))
    if len(dims) not in (2, 3):
        raise ValueError(f"mesh must be DxM or PxDxM, got {spec!r}")
    return make_mesh(dims, ("pod", "data", "model")[-len(dims):])


def data_axes_of(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def model_axis_size(mesh: Mesh) -> int:
    return mesh.sizes["model"]


def data_world_size(mesh: Mesh) -> int:
    return math.prod(mesh.sizes[a] for a in data_axes_of(mesh))


def worker_index(mesh: Mesh, coords: dict) -> int:
    """Row-major joint rank of the worker at ``coords`` (data axis name
    -> position): ``idx = idx·size(a) + coords[a]`` over the data axes in
    mesh order, as the reference's ``worker_index``."""
    idx = 0
    for a in data_axes_of(mesh):
        idx = idx * mesh.sizes[a] + int(coords[a])
    return idx


def worker_coords(mesh: Mesh, rank: int) -> dict:
    """Inverse of :func:`worker_index`."""
    coords = {}
    for a in reversed(data_axes_of(mesh)):
        rank, coords[a] = divmod(rank, mesh.sizes[a])
    return coords

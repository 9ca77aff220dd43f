"""A mesh of ranks: the port's counterpart of the JAX package's
``parallel/mesh.py``.

The reference lays its devices on a 2-D grid, ``(data, model)`` by
default, the second axis taking the smaller factor of the device count
(``_factor``); the sharded temporal planner names the axes ``("data",
"seq")``, so 4 ranks are data 2 x seq 2 and 2 ranks data 2 x seq 1.
Here the devices are ranks: rank r sits at the grid position of its
index in row-major order, so the ranks of one ``seq`` line are
consecutive, and each line of each axis is a :class:`Group` with a
process group of its own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from .distributed import Group, World


def _factor(n: int) -> Tuple[int, int]:
    """Split n into the most square (a, b) with a * b == n, a <= b."""
    best = (1, n)
    for a in range(1, math.isqrt(n) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


@dataclass
class Mesh:
    """This rank's view of the mesh: axis sizes in order, its coordinate
    on each axis, the :class:`Group` of its line along each axis, and
    ``all``, the group of every rank in the mesh."""
    world: World
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Group] = field(repr=False)
    all: Group = field(repr=False)


def make_mesh(world: World, axis_names: Sequence[str] = ("data", "seq"),
              shape: Optional[Mapping[str, int]] = None
              ) -> Optional[Mesh]:
    """The mesh over the world's ranks.  With two axis names the second
    takes the smaller factor of the world size (the reference's
    ``make_mesh``); with one, every rank lies on it.  ``shape`` ({name:
    size}, ordered) fixes the axes instead, over the first prod(sizes)
    ranks; a rank beyond them gets None.  Every rank of the world must
    call this together (each line's process group is made collectively)."""
    if shape is None:
        if len(axis_names) == 1:
            shape = {axis_names[0]: world.size}
        elif len(axis_names) == 2:
            small, large = _factor(world.size)
            shape = {axis_names[0]: large, axis_names[1]: small}
        else:
            raise ValueError(f"make_mesh takes one or two axis names, got "
                             f"{tuple(axis_names)}")
    shape = dict(shape)
    n = math.prod(shape.values())
    if n > world.size:
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has "
                         f"{world.size}")
    grid = np.arange(n).reshape(tuple(shape.values()))
    inside = world.rank < n

    def group(ranks) -> Optional[Group]:
        # new_group is collective over the world: every rank makes every
        # line's group in the same order, members or not
        pg = (dist.new_group(list(ranks))
              if world.backend and 1 < len(ranks) < world.size else None)
        return Group(ranks, world.rank, pg) if world.rank in ranks else None

    groups = {}
    for axis, name in enumerate(shape):
        lines = np.moveaxis(grid, axis, -1).reshape(-1, shape[name])
        for line in lines.tolist():
            g = group(line)
            if g is not None:
                groups[name] = g
    everyone = group(list(range(n)))
    if not inside:
        return None
    pos = np.unravel_index(world.rank, grid.shape)
    coords = {name: int(p) for name, p in zip(shape, pos)}
    return Mesh(world, shape, coords, groups, everyone)

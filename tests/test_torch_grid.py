"""The port's process grid (parallel/distributed.py ``Grid``) against the
reference's device mesh, on the CPU and without starting a process.

- For every mesh of the stage, seq, expert and tensor axes up to eight
  processes: each process's coordinates round-trip, and its view of
  each axis is the processes that differ from it only there, in the order
  of their index on it. Against the reference's
  ``build_mesh(...).devices`` (eight CPU devices): process ``g`` sits
  where the reference puts device ``g`` on the stage and seq axes, and on
  every axis wherever tensor or expert is of size 1. Where both are above
  1 the one divergence on record holds: the port puts ``tensor``
  innermost, the reference ``expert`` (ROADMAP, Deliberate divergences).
- Each axis's views partition the processes; the label and the words of
  a grid are what the reports and the messages print; a process's cut
  (``RankGroup.shard_of``) is ``Shard.of`` at its tensor and expert
  coordinates; a grid of another size than the processes is refused
  before any group is joined.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.parallel import distributed as pdist
from production_stack_tpu_torch.parallel.mesh import MeshConfig
from production_stack_tpu_torch.parallel.shardings import Shard

AXES = pdist.GRID_AXES  # stage, seq, expert, tensor
# every mesh of the four axes up to eight processes
MESHES = [dict(zip(AXES, sizes))
          for sizes in itertools.product(range(1, 9), repeat=4)
          if np.prod(sizes) <= 8]
IDS = ["x".join(f"{a}{n}" for a, n in m.items() if n > 1) or "one"
       for m in MESHES]


def _reference_ids(mesh: dict) -> np.ndarray:
    """The reference's device ids over its axes ("stage", "seq",
    "tensor", "expert"), its data axis of size 1 dropped."""
    n = int(np.prod(list(mesh.values())))
    jm = jmesh.build_mesh(jmesh.MeshConfig(data=1, **mesh),
                          devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert jm.axis_names == ("data", "stage", "seq", "tensor", "expert")
    return ids[0]


def _ref_coords(ids: np.ndarray) -> dict:
    """Device id -> its index on each of the reference's axes."""
    names = ("stage", "seq", "tensor", "expert")
    return {int(ids[idx]): dict(zip(names, idx))
            for idx in np.ndindex(ids.shape)}


def test_every_mesh_up_to_eight_processes_is_listed():
    assert len(MESHES) == len(set(map(tuple, (m.values() for m in MESHES))))
    assert {int(np.prod(list(m.values()))) for m in MESHES} == set(
        range(1, 9))
    # ordered factorizations of 1..8 into four sizes
    assert len(MESHES) == 1 + 4 + 4 + 10 + 4 + 16 + 4 + 20


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_coordinates_round_trip(mesh):
    grid = pdist.Grid(**mesh)
    seen = set()
    for g in range(grid.size):
        c = grid.coords(g)
        assert grid.process(**c) == g
        assert all(0 <= c[a] < mesh[a] for a in AXES)
        seen.add(tuple(c.values()))
    assert len(seen) == grid.size
    # tensor innermost, then expert, seq and stage
    assert [grid.coords(g)["tensor"] for g in range(grid.size)] == [
        g % mesh["tensor"] for g in range(grid.size)]
    with pytest.raises(ValueError):
        grid.coords(grid.size)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_places_follow_the_reference_device_order(mesh):
    """Process g sits where the reference puts device g on every axis
    when tensor or expert is of size 1. Where both are above 1 the stage
    and seq coordinates still agree, and the tensor and expert ones are
    the reference's with the two axes' nesting swapped: the port's tensor
    index varies fastest, the reference's expert index (the divergence
    on record)."""
    grid = pdist.Grid(**mesh)
    ref = _ref_coords(_reference_ids(mesh))
    T, X = mesh["tensor"], mesh["expert"]
    for g in range(grid.size):
        mine, theirs = grid.coords(g), ref[g]
        assert (mine["stage"], mine["seq"]) == (theirs["stage"],
                                                theirs["seq"])
        if T == 1 or X == 1:
            assert mine == {a: theirs[a] for a in AXES}
        else:
            inner = g % (T * X)
            assert (theirs["tensor"], theirs["expert"]) == divmod(inner, X)
            assert (mine["expert"], mine["tensor"]) == divmod(inner, T)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_views_are_the_reference_axes(mesh):
    """A process's view of an axis is the processes whose coordinates
    differ from its own only on that axis, by their index there: the
    reference's devices along that mesh axis through the process's
    coordinates."""
    grid = pdist.Grid(**mesh)
    ids = _reference_ids(mesh)
    names = ("stage", "seq", "tensor", "expert")
    port_at = {tuple(grid.coords(g)[a] for a in names): g
               for g in range(grid.size)}
    for g in range(grid.size):
        c = grid.coords(g)
        for axis in AXES:
            view = grid.members(g, axis)
            assert view[c[axis]] == g
            along = [port_at[tuple(i if a == axis else c[a]
                                   for a in names)]
                     for i in range(mesh[axis])]
            assert list(view) == along
            # the reference's devices along the axis, at the same
            # coordinates, hold the same places
            idx = [slice(None) if a == axis else c[a] for a in names]
            ref_along = ids[tuple(idx)].reshape(-1)
            assert len(ref_along) == len(view) == mesh[axis]


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_each_axis_views_partition_the_processes(mesh):
    grid = pdist.Grid(**mesh)
    for axis in AXES:
        groups = grid.groups(axis)
        assert len(groups) == grid.size // mesh[axis]
        assert sorted(g for m in groups for g in m) == list(
            range(grid.size))
        assert [m[0] for m in groups] == sorted(m[0] for m in groups)
        for m in groups:
            assert all(grid.members(g, axis) == m for g in m)


@pytest.mark.parametrize("mesh,label,words", [
    (dict(), "tensor", "tensor parallelism"),
    (dict(tensor=2), "tensor", "tensor parallelism"),
    (dict(seq=2), "seq", "sequence parallelism"),
    (dict(expert=2), "expert", "expert parallelism"),
    (dict(seq=2, tensor=2), "seq,tensor", "sequence and tensor parallelism"),
    (dict(stage=2, tensor=2), "stage,tensor",
     "pipeline and tensor parallelism"),
    (dict(expert=2, tensor=2), "expert,tensor",
     "expert and tensor parallelism"),
    (dict(seq=2, expert=2), "seq,expert", "sequence and expert parallelism"),
    (dict(stage=2, expert=2), "stage,expert",
     "pipeline and expert parallelism"),
    (dict(stage=2, seq=2), "stage,seq", "sequence and pipeline parallelism"),
    (dict(seq=2, expert=2, tensor=2), "seq,expert,tensor",
     "sequence, expert and tensor parallelism"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_label_and_words(mesh, label, words):
    grid = pdist.Grid(**mesh)
    assert (grid.label, grid.parallelism) == (label, words)
    assert grid.axes == tuple(a for a in AXES if mesh.get(a, 1) > 1)
    assert pdist.Grid.of(MeshConfig(tensor=-1, **{
        a: n for a, n in mesh.items() if a != "tensor"}),
        mesh.get("tensor", 1)) == grid


@pytest.mark.parametrize("mesh", [dict(expert=2), dict(expert=2, tensor=2),
                                  dict(seq=2, expert=2, tensor=2),
                                  dict(stage=2, expert=2),
                                  dict(stage=2, seq=2)],
                         ids=lambda m: "x".join(f"{a}{n}"
                                                for a, n in m.items()))
def test_each_process_cuts_at_its_tensor_and_expert_coordinates(mesh):
    cfg = ModelConfig.from_pretrained("tiny-mixtral")
    grid = pdist.Grid(**mesh)
    for g in range(grid.size):
        ranks = pdist.RankGroup(g, grid.size, torch.device("cpu"),
                                ("cpu",) * grid.size, "gloo", None,
                                grid.label, grid=grid)
        c = grid.coords(g)
        shard = ranks.shard_of(cfg)
        if grid.tensor == grid.expert == 1:
            assert shard == Shard(g, grid.size, {}, frozenset())
        else:
            assert shard == Shard.of(cfg, c["tensor"], grid.tensor,
                                     (c["expert"], grid.expert)
                                     if grid.expert > 1 else (0, 1))
        assert {a: ranks.coord(a) for a in AXES} == c


def test_a_grid_of_another_size_is_refused_before_any_group():
    with pytest.raises(ValueError, match="3 processes make no seq x "
                       "expert grid"):
        pdist.init_rank(0, 3, 0, ["cpu"] * 3, "gloo",
                        grid=pdist.Grid(seq=2, expert=2))
    with pytest.raises(ValueError, match="grid axis seq of size 0"):
        pdist.Grid(seq=0)
    assert not torch.distributed.is_initialized()

"""The engine's parallel sizes, as the reference's ``MeshConfig``
(production_stack_tpu/parallel/mesh.py).

The reference builds one named JAX mesh ("data", "stage", "seq",
"tensor", "expert") over the chips of a slice. Here the ``tensor`` axis is
a set of processes, one a rank, each driving one card (or the CPU); the
``seq`` axis is such a set too, each rank holding the whole model and a
whole copy of the KV pool, joined only by the ring prefill's exchange
(parallel/ring_attention.py); and the ``stage`` axis is one process's
list of devices, one a pipeline stage (``stage_devices``;
engine/pp_runner.py), which may repeat a card. Each of the three can be
above 1; two at once where tensor is one of them (the seq x tensor and
the stage x tensor grids of processes, parallel/distributed.py), not seq
and stage together; data and expert parallelism are later slices. -1 on
an axis means "every device the others leave", as in the reference.
"""

from __future__ import annotations

import dataclasses
import math

AXIS_DATA = "data"
AXIS_STAGE = "stage"
AXIS_SEQ = "seq"
AXIS_TENSOR = "tensor"
AXIS_EXPERT = "expert"

MESH_AXES = (AXIS_DATA, AXIS_STAGE, AXIS_SEQ, AXIS_TENSOR, AXIS_EXPERT)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallel sizes; -1 on one axis takes every remaining device."""

    data: int = 1
    stage: int = 1
    seq: int = 1
    tensor: int = -1
    expert: int = 1

    def resolved(self, n_devices: int) -> "MeshConfig":
        """The reference's resolution: the -1 axis (at most one) takes
        ``n_devices`` over the product of the fixed axes, and the sizes
        must use every device."""
        sizes = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {unknown}")
        if unknown:
            known = math.prod(v for v in sizes.values() if v != -1)
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {known}"
                )
            sizes[unknown[0]] = n_devices // known
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} does not use all {n_devices} devices"
            )
        return MeshConfig(**sizes)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as a JAX mesh's ``shape``."""
        return {a: getattr(self, a) for a in MESH_AXES}


def tensor_size(mesh: MeshConfig, device) -> int:
    """The tensor-parallel degree an engine on ``device`` runs at. A fixed
    size is taken as given. -1 resolves as ``MeshConfig.resolved`` does
    over the devices a rank can have: the visible cards on ``cuda`` over
    the pipeline stages, seq ranks and expert ranks (the cards left to
    each; at least 1, so that a machine without one fails where the
    device is asked for, and stages may share a card), one process on the
    CPU. The tensor, stage, seq and expert axes are ported: a data axis
    above 1 raises."""
    if mesh.data != 1:
        raise ValueError(f"mesh axis {AXIS_DATA!r} = {mesh.data}: data "
                         "parallelism is not ported (the tensor, "
                         "pipeline, sequence and expert axes are)")
    if mesh.stage < 1:
        raise ValueError(f"pipeline-parallel size {mesh.stage} < 1")
    if mesh.seq < 1:
        raise ValueError(f"sequence-parallel size {mesh.seq} < 1")
    expert_size(mesh)
    if mesh.tensor != -1:
        if mesh.tensor < 1:
            raise ValueError(f"tensor-parallel size {mesh.tensor} < 1")
        return mesh.tensor
    n = 1
    if str(device).startswith("cuda"):
        import torch

        n = max(torch.cuda.device_count()
                // (mesh.stage * mesh.seq * mesh.expert), 1)
    return MeshConfig(tensor=-1).resolved(n).tensor


def expert_size(mesh: MeshConfig) -> int:
    """The expert-parallel degree: the mesh's ``expert`` axis, taken as
    given (the reference's CLI has no flag for it, so only a caller's
    ``EngineConfig.mesh`` sets it, and it is never -1 here)."""
    if mesh.expert < 1:
        raise ValueError(f"expert-parallel size {mesh.expert}: give the "
                         "expert axis a size of 1 or more")
    return mesh.expert


def stage_devices(device, n_stages: int, devices=None) -> list[str]:
    """Each pipeline stage's device: ``devices`` where the caller names
    them, else ``cuda:s`` for stage s on a card and the CPU for every
    stage otherwise. Raises unless there is one a stage and every one
    exists on this machine; a stage never moves to another card or to
    the CPU."""
    import torch

    if devices is None:
        devices = ([f"cuda:{s}" for s in range(n_stages)]
                   if torch.device(device).type == "cuda"
                   else ["cpu"] * n_stages)
    devices = [str(d) for d in devices]
    if len(devices) != n_stages:
        raise ValueError(f"{n_stages} pipeline stages need {n_stages} "
                         f"devices, got {devices}")
    n = torch.cuda.device_count()
    for s, d in enumerate(devices):
        dev = torch.device(d)
        if dev.type == "cpu":
            continue
        if dev.type != "cuda":
            raise ValueError(f"stage {s}: unsupported device {d!r}")
        if (0 if dev.index is None else dev.index) >= n:
            raise RuntimeError(
                f"pipeline parallelism over {n_stages} stages puts stage "
                f"{s} on {d}, but this machine has {n} CUDA card(s)")
    return devices

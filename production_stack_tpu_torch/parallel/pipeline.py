"""Pipeline parallelism's microbatch schedule over stage devices.

The port's counterpart of production_stack_tpu/parallel/pipeline.py. The
reference runs the schedule as a ``shard_map`` over its mesh's ``stage``
axis and rotates activations with ``ppermute``; here stage s's layers sit
on ``devices[s]`` and an activation moves to the next stage's device with
``.to``. The layers are cut into S stages (the stacked layer axis split
as ``split_layers_into_stages`` splits it), a batch into M microbatches,
and the classic schedule runs S + M - 1 ticks: at tick t stage s runs
microbatch t - s. The bubble shrinks as M grows.

``pipelined_forward`` is the generic building block; the serving engine's
per-stage KV pools are engine/pp_runner.py's.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def _tree_map(fn: Callable, tree):
    """``fn`` over the tensors of a nested dict."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _n_layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return int(tree.shape[0])


def _stage_body(layer_fn: Callable, params_stage, x: torch.Tensor
                ) -> torch.Tensor:
    """This stage's stacked layers (L_stage, ...) over ``x``, in order."""
    for i in range(_n_layers(params_stage)):
        x = layer_fn(_tree_map(lambda a: a[i], params_stage), x)
    return x


def pipelined_forward(
    layer_fn: Callable,  # (layer_params, activations (mb, ...)) -> activations
    stage_params,  # nested dict, leaves (S, L_per_stage, ...)
    x: torch.Tensor,  # (M, mb, ...) microbatched input
    devices: Sequence,  # stage s runs on devices[s]
) -> torch.Tensor:
    """Pipeline-parallel forward. Returns the last stage's (M, mb, ...)
    outputs, on its device."""
    S = len(devices)
    M = x.shape[0]
    local = [_tree_map(lambda a, s=s: a[s].to(devices[s]), stage_params)
             for s in range(S)]
    arrived: list = [None] * S  # each stage's input for this tick
    outputs: list = [None] * M
    for t in range(S + M - 1):
        sent = [None] * S
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            h = x[m].to(devices[0]) if s == 0 else arrived[s]
            h = _stage_body(layer_fn, local[s], h)
            if s == S - 1:
                outputs[m] = h
            else:
                sent[s + 1] = h.to(devices[s + 1])
        arrived = sent
    return torch.stack(outputs)


def split_layers_into_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) for the stages."""
    def _split(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages} "
                             "stages")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])

    return _tree_map(_split, stacked_params)

"""Expert parallelism in the port at the op and shard level, against the
JAX package's rules and MoE block and against the port on one device, on
the CPU.

- Rules: ``rules_for_model(cfg, tp, ep)`` equals the reference's at
  ``MeshConfig(tensor=tp, expert=ep)`` for (tensor, expert) = (1, 2), (2,
  2), (1, 4), (1, 3) (tiny-mixtral's X = 4 does not divide 3: replicated)
  and for a dense model, whose experts axis always falls back. Each
  rank's ``Shard`` holds of every leaf the slice the reference's
  ``NamedSharding`` puts on the device at its (tensor, expert)
  coordinate, but for the router, which every expert rank holds whole (a
  deliberate divergence: the reference splits its X columns).
- Weights: expert rank e's seeded, ``shard_params``, checkpoint and
  ``params_from_jax`` stacks are bit for bit the cut of expert 1's, int8
  scales included.
- The MoE block on ranks as threads (``_grid``: N expert ranks of T
  tensor ranks, each view summing in rank order): at expert 2, expert 4
  (one expert a rank) and expert 2 x tp 2, float32, W8A8 and W8A16,
  against the JAX ``_moe_mlp`` within ``ATOL`` and bit for bit against
  the port at expert 1 at the same tensor size; a batch that overflows
  capacity drops the same slots across the expert ranks as on one
  device. The combine's bytes are ``2 (N - 1) / N T E 4`` a call, and 0
  where the experts are replicated (expert 3).
- ``forward_tokens`` with dense attention and ``logits_from_hidden``, the
  counterpart of the reference's ``forward_dense`` test (tests/
  test_moe.py): tensor 2 x expert 2 against the JAX forward on one
  device, and bit for bit against the port at tp 2.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import quant as jq
from production_stack_tpu.engine.weights import init_or_load as jax_init
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel import mesh as jmesh
from production_stack_tpu.parallel import shardings as jshard
from production_stack_tpu_torch.engine import quant as tq
from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.weights import (
    init_random,
    load_safetensors,
    params_from_jax,
    shard_params,
)
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.ops.attention import dense_causal_attention
from production_stack_tpu_torch.parallel import shardings as tshard
from production_stack_tpu_torch.parallel.mesh import (
    MeshConfig,
    expert_size,
    tensor_size,
)

torch.set_num_threads(1)

ATOL = 2e-5  # the port's MoE block against the JAX one (test_torch_moe.py)


def _tiny(preset="tiny-mixtral", **kw) -> ModelConfig:
    return dataclasses.replace(ModelConfig.from_pretrained(preset), **kw)


def _jtiny(preset="tiny-mixtral", **kw):
    return dataclasses.replace(jcfg.ModelConfig.from_pretrained(preset), **kw)


def _jmesh(tp: int, ep: int):
    return jmesh.build_mesh(jmesh.MeshConfig(data=1, tensor=tp, expert=ep),
                            devices=jax.devices()[:tp * ep])


# -- the mesh -------------------------------------------------------------------

def test_expert_axis_no_longer_refused():
    assert tensor_size(MeshConfig(expert=2), "cpu") == 1
    assert tensor_size(MeshConfig(tensor=2, expert=2), "cpu") == 2
    assert expert_size(MeshConfig(expert=4)) == 4
    with pytest.raises(ValueError, match="data"):
        tensor_size(MeshConfig(data=2, expert=2), "cpu")
    with pytest.raises(ValueError, match="expert"):
        tensor_size(MeshConfig(expert=0), "cpu")


# -- rules and shards -------------------------------------------------------------

GRIDS = [(1, 2), (2, 2), (1, 4), (1, 3)]


@pytest.mark.parametrize("preset", ["tiny-mixtral", "tiny-llama"])
@pytest.mark.parametrize("tp,ep", GRIDS)
def test_rules_are_the_reference(preset, tp, ep):
    want = jshard.rules_for_model(_jtiny(preset), _jmesh(tp, ep)).rules
    got = tshard.rules_for_model(_tiny(preset), tp, ep).rules
    assert dict(got) == dict(want)
    experts = preset == "tiny-mixtral" and 4 % ep == 0
    assert (got[tshard.EXPERTS] == "expert") == experts


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) and not tq.is_quantized(v):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("preset", ["tiny-mixtral", "tiny-llama"])
@pytest.mark.parametrize("tp,ep", GRIDS)
def test_each_rank_holds_the_reference_slice(preset, tp, ep):
    """Every leaf's slice on the device at mesh coordinate (tensor t,
    expert e) under the reference's rules is the port's ``Shard.of(cfg,
    t, tp, (e, ep))`` cut, the router excepted (whole on every rank)."""
    jc, tc = _jtiny(preset), _tiny(preset)
    mesh = _jmesh(tp, ep)
    rules = jshard.rules_for_model(jc, mesh)
    specs = dict(_leaves(jllama.param_specs(jc)))
    shapes = dict(_leaves(tllama.param_shapes(tc)))
    held = dict(_leaves(tshard.held_specs(tllama.param_specs(tc))))
    devices = mesh.devices  # (data, stage, seq, tensor, expert)
    n_router = 0
    for name, axes in specs.items():
        shape = shapes[name]
        placed = jax.sharding.NamedSharding(
            mesh, rules.spec(axes)).devices_indices_map(shape)
        for t in range(tp):
            for e in range(ep):
                shard = tshard.Shard.of(tc, t, tp, (e, ep))
                got = np.arange(int(np.prod(shape))).reshape(shape)
                want = got[placed[devices[0, 0, 0, t, e]]]
                got = shard.cut(got, held[name])
                if name.endswith("router") and rules.rules[
                        tshard.EXPERTS] is not None:
                    n_router += 1
                    assert got.shape == shape  # whole on every rank
                    assert want.shape[-1] == shape[-1] // ep
                else:
                    np.testing.assert_array_equal(got, want, err_msg=name)
    assert n_router == (tp * ep if preset == "tiny-mixtral" and 4 % ep == 0
                        else 0)


def _assert_cut(full, got, cfg, t, tp, e, ep):
    sh = tshard.Shard.of(cfg, t, tp, (e, ep))
    specs = dict(_leaves(tshard.held_specs(tllama.param_specs(cfg))))
    got = dict(_leaves(got))
    for name, leaf in _leaves(full):
        want = sh.cut_leaf(leaf, specs[name])
        if tq.is_quantized(leaf):
            for part in ("q", "s"):
                assert torch.equal(got[name][part], want[part]), (name, part)
        else:
            assert torch.equal(got[name], want), name


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("tp,ep", [(1, 2), (2, 2), (1, 4)])
def test_seeded_and_cut_shards_are_the_cut_of_expert1(quant, tp, ep):
    cfg = _tiny(quant=quant)
    full = init_random(cfg, seed=3)
    for g in range(tp * ep):
        t, e = g % tp, g // tp
        mine = init_random(cfg, 3, "cpu", t, tp, expert=(e, ep))
        _assert_cut(full, mine, cfg, t, tp, e, ep)
        _assert_cut(full, shard_params(full, cfg, t, tp, (e, ep)), cfg, t,
                    tp, e, ep)
        w = mine["layers"]["w_down"]
        assert (w["q"] if quant else w).shape[1] == 4 // ep
        assert mine["layers"]["router"].shape[-1] == 4


def test_checkpoint_and_jax_int8_shards_are_the_cut(tmp_path):
    from test_torch_checkpoint import write_checkpoint

    cfg = _tiny(quant="int8",
                weights_path=write_checkpoint(tmp_path, "tiny-mixtral"))
    full = load_safetensors(cfg)
    for e in range(2):
        _assert_cut(full, load_safetensors(cfg, "cpu", 0, 1,
                                           expert=(e, 2)), cfg, 0, 1, e, 2)
    jc = _jtiny(quant="int8")
    tree = jax.tree.map(np.asarray, jax.device_get(jq.quantize_params(
        jc, jax_init(_jtiny(), _jmesh(1, 1), seed=0))))
    cfg = _tiny(quant="int8")
    full = params_from_jax(tree, cfg)
    for g in range(4):
        t, e = g % 2, g // 2
        _assert_cut(full, params_from_jax(tree, cfg, "cpu", t, 2,
                                          expert=(e, 2)), cfg, t, 2, e, 2)


# -- ranks as threads ---------------------------------------------------------------

class _Exchange:
    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def all(self, rank: int, x: torch.Tensor) -> list:
        self.slots[rank] = x.clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _View:
    """One axis of a RankGroup over threads: sums in rank order, the
    vocab shards side by side, ``moe_combine`` counting its bytes as the
    RankGroup does (2 (n - 1) / n of the payload)."""

    def __init__(self, ex: _Exchange, rank: int, size: int, shard):
        self.ex, self.rank, self.size, self.shard = ex, rank, size, shard
        self.wire = {}

    def _sum(self, x):
        parts = self.ex.all(self.rank, x)
        out = parts[0].clone()
        for y in parts[1:]:
            out = out + y
        return out

    def all_reduce(self, x):
        return self._sum(x.float()).to(x.dtype)

    def all_reduce_int32(self, x):
        assert x.dtype == torch.int32
        return self._sum(x)

    def all_reduce_max(self, x):
        parts = self.ex.all(self.rank, x)
        out = parts[0].clone()
        for y in parts[1:]:
            out = torch.maximum(out, y)
        return out

    def all_gather_last(self, x):
        return torch.cat(self.ex.all(self.rank, x), dim=-1)

    def moe_combine(self, x):
        assert x.dtype == torch.float32
        n = self.size
        self.wire["moe_combine"] = (self.wire.get("moe_combine", 0.0)
                                    + x.nbytes * 2.0 * (n - 1) / n)
        return self._sum(x)


def _grid(cfg, tp: int, ep: int, fn) -> list:
    """``fn(t, e, tensor_view, expert_view)`` on ``ep * tp`` threads,
    thread g expert rank g // tp and tensor rank g % tp (the tensor view
    None at tp 1); the results by g."""
    tex = [_Exchange(tp) for _ in range(ep)]
    eex = [_Exchange(ep) for _ in range(tp)]
    out, errors = [None] * (tp * ep), []

    def run(g):
        t, e = g % tp, g // tp
        shard = tshard.Shard.of(cfg, t, tp, (e, ep))
        tv = _View(tex[e], t, tp, shard) if tp > 1 else None
        try:
            out[g] = fn(t, e, tv, _View(eex[t], e, ep, shard))
        except BaseException as err:  # noqa: BLE001 (re-raised below)
            errors.append(err)
            for ex in tex + eex:
                ex.barrier.abort()

    threads = [threading.Thread(target=run, args=(g,))
               for g in range(tp * ep)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    if errors:
        raise errors[0]
    return out


# -- the MoE block ------------------------------------------------------------------

def _layer0(mode: str, router_bias: float = 0.0, **kw):
    """Layer 0 of a seeded tiny-mixtral on both sides, quantized by the
    JAX package for int8: (JAX layer, the port's config and layer)."""
    jc, tc = _jtiny(**kw), _tiny(**kw)
    params = jllama.init_params(jc, jax.random.key(0))
    if router_bias:
        # input feature 0 pushes every token toward expert 0
        params["layers"]["router"] = params["layers"]["router"].at[
            :, 0, 0].add(router_bias)
    if mode != "float32":
        params = jq.quantize_params(jc, params)
    np_params = jax.tree.map(np.asarray, params)
    tp_params = params_from_jax(np_params, tc)
    jl = jax.tree.map(lambda a: jnp.asarray(a[0]), np_params["layers"])
    tl = {k: tllama._layer(v, 0) for k, v in tp_params["layers"].items()}
    return jc, jl, tc, tl


def _ranks_block(tc, tl, x, tp, ep):
    """The port's block at (tp, ep) on threads: each rank's output and its
    expert view's combine bytes."""
    specs = {n: s[1:] for n, s in tshard.held_specs(
        tllama.param_specs(tc))["layers"].items()}

    def one(t, e, tv, ev):
        lp = {n: ev.shard.cut_leaf(w, specs[n]) for n, w in tl.items()}
        y = tllama._moe_mlp(tc, lp, torch.from_numpy(x), len(x), tv,
                            expert=ev)
        return y, ev.wire.get("moe_combine", 0.0)

    return _grid(tc, tp, ep, one)


ROWS = {"float32": 40, "w8a8": 40, "w8a16": 600}


@pytest.mark.parametrize("mode", list(ROWS))
@pytest.mark.parametrize("tp,ep", [(1, 2), (1, 4), (2, 2)])
def test_moe_block_matches_the_reference_and_expert1(mode, tp, ep):
    jc, jl, tc, tl = _layer0(mode)
    x = np.random.default_rng(ep * 10 + tp).standard_normal(
        (ROWS[mode], tc.hidden_size)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jllama._moe_mlp(jc, jl, a))(
        jnp.asarray(x)))
    one = _ranks_block(tc, tl, x, tp, 1)[0][0]
    got = _ranks_block(tc, tl, x, tp, ep)
    T, E = x.shape
    for y, wire in got:
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=ATOL)
        assert torch.equal(y, one)
        assert wire == T * E * 4 * 2.0 * (ep - 1) / ep


@pytest.mark.parametrize("mode", ["float32", "w8a8"])
@pytest.mark.parametrize("tp,ep", [(1, 2), (2, 2), (1, 4)])
def test_dropped_slots_are_one_devices(mode, tp, ep):
    """X = 8 and a router that sends most tokens to expert 0, past its
    capacity: every expert rank keeps and drops the slots one device
    does, so the outputs are one device's bit for bit; the reference's
    ``ref_tokens`` (64) sets the capacity above the 48 rows run."""
    jc, jl, tc, tl = _layer0(mode, router_bias=20.0, num_experts=8)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, tc.hidden_size)).astype(np.float32)
    x[:, 0] = np.abs(x[:, 0]) + 1.0
    logits = (torch.from_numpy(x) @ tl["router"]).float()
    _, idx = tllama.top_k_lower_first(logits, tc.num_experts_per_tok)
    cap = max(int(2.0 * 64 * 2 / 8), 2)
    assert int((idx == 0).sum()) > cap  # slots really are dropped
    want = np.asarray(jax.jit(lambda a: jllama._moe_mlp(jc, jl, a))(
        jnp.asarray(x)))
    one = _ranks_block(tc, tl, x, tp, 1)[0][0]
    for y, _ in _ranks_block(tc, tl, x, tp, ep):
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=ATOL)
        assert torch.equal(y, one)


def test_replicated_experts_run_no_combine():
    """Expert 3 over tiny-mixtral's 4 experts: the rules replicate them,
    every rank holds all four and runs the block as one device, with no
    combine."""
    _, _, tc, tl = _layer0("float32")
    x = np.random.default_rng(3).standard_normal(
        (24, tc.hidden_size)).astype(np.float32)
    one = tllama._moe_mlp(tc, tl, torch.from_numpy(x), len(x))
    for y, wire in _ranks_block(tc, tl, x, 1, 3):
        assert torch.equal(y, one)
        assert wire == 0.0


# -- the forward (tests/test_moe.py's sharded forward_dense) ---------------------

def test_forward_dense_at_tp2_expert2():
    jc, tc = _jtiny(), _tiny()
    mesh = _jmesh(1, 1)
    tree = jax.tree.map(np.asarray, jax.device_get(jax_init(jc, mesh,
                                                            seed=0)))
    tokens = np.asarray([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    want = np.asarray(jax.jit(jllama.forward_dense, static_argnums=0)(
        jc, jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens)))

    def fwd(t, e, tv, ev, ep):
        params = params_from_jax(tree, tc, "cpu", t, 2, expert=(e, ep))
        tok = torch.from_numpy(tokens)
        pos = torch.arange(8)[None]

        def attend(q, k, v, kv, layer):
            return dense_causal_attention(q, k, v), kv

        hidden, _ = tllama.forward_tokens(tc, params, tok, pos, attend,
                                          group=tv, expert=ev)
        return tllama.logits_from_hidden(tc, params, hidden, group=tv)

    one = _grid(tc, 2, 1, lambda t, e, tv, ev: fwd(t, e, tv, ev, 1))[0]
    got = _grid(tc, 2, 2, lambda t, e, tv, ev: fwd(t, e, tv, ev, 2))
    for y in got:
        np.testing.assert_allclose(y.numpy(), want, rtol=2e-4, atol=2e-4)
        assert torch.equal(y, one)

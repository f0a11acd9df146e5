"""The port's int8 quantization (``engine/quant.py``) against the JAX
package's, on the CPU.

- ``quantize_array``: q bit for bit and s equal, on every weight of both
  contract tables, the embedding and the LM head. The reference quantizes
  inside a jitted program, where XLA multiplies by the float32 reciprocal
  of 127 rather than dividing; the port does the same.
- ``quant_matmul`` / ``expert_matmul`` against ``quant_einsum`` (jitted,
  as the reference serves it) for every equation the model uses, the
  batched MoE forms included, on both sides of the W8A8 / W8A16 threshold
  and with ``tokens_hint``: float32, rtol = atol = 1e-5.
- ``PSTPU_QUANT_A16_THRESHOLD`` parses as the reference's does;
  ``embed_lookup`` and the tied head; ``maybe_quantize`` (off by default,
  idempotent, refusing "fp4"); ``quantize_params``' structure and values;
  random init of an int8 model is the quantization of the bf16 one.
- Engines: tiny-llama and tiny-mixtral with ``quant="int8"``, the port
  against the JAX engine on the ragged and the bucketed path, from the
  same float32 weights, each quantizing them itself. Greedy tokens are
  identical up to an argmax near-tie (top-2 gap under 1e-4). Logprobs are
  held within ``INT8_LP_BAND``, not 1e-4: an activation whose value
  divided by its scale lies within float noise of a rounding boundary
  rounds one way in one framework and the other way in the other, which
  moves that token's products by one int8 step (about 1e-2 of a logit on
  these models) and the rest of its sequence with them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, drain
from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import quant as jq
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.weights import init_or_load as jax_init
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.parallel.mesh import MeshConfig, build_mesh
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import quant as tq
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.weights import (
    init_random,
    params_from_jax,
)

torch.set_num_threads(2)

TOL = 1e-5
INT8_LP_BAND = 0.05


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _tq(w: dict) -> dict:
    return {"q": _t(w["q"]), "s": _t(w["s"])}


def _jax_params(preset: str) -> dict:
    cfg = jcfg.ModelConfig.from_pretrained(preset)
    return jax.tree.map(np.asarray, jllama.init_params(cfg, jax.random.key(0)))


LEAVES = ([("tiny-llama", "layers", n, a) for n, a in jq._LAYER_CONTRACT.items()]
          + [("tiny-mixtral", "layers", n, a)
             for n, a in jq._MOE_CONTRACT.items()]
          + [("tiny-llama", None, "embed", (1,)),
             ("tiny-llama", None, "lm_head", (0,))])


@pytest.mark.parametrize("preset,group,name,axes", LEAVES,
                         ids=[f"{p}-{n}" for p, _, n, _ in LEAVES])
def test_quantize_array_bit_exact(preset, group, name, axes):
    params = _jax_params(preset)
    w = (params[group] if group else params)[name]
    want = jq.quantize_array(jnp.asarray(w), axes)
    got = tq.quantize_array(_t(w), axes)
    assert got["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    # the stacked weight quantized a slice at a time is the same
    if group:
        st = tq.quantize_stack(_t(w), axes)
        assert torch.equal(st["q"], got["q"]) and torch.equal(st["s"], got["s"])


def test_quantize_array_rounds_half_to_even():
    # 2.5 and 3.5 of a scale of 1: jnp.round and torch.round both give 2, 4
    w = np.array([[127.0, 2.5, 3.5, -2.5]], np.float32).T
    got = tq.quantize_array(_t(w), (0,))["q"].numpy()[:, 0]
    want = np.asarray(jq.quantize_array(jnp.asarray(w), (0,))["q"])[:, 0]
    np.testing.assert_array_equal(got, want)


# (equation, x shape, w shape, contracted axes of w, port's n_contract)
FORMS = [
    ("...te,ehd->...thd", (2, 5, 64), (64, 4, 16), (0,), 1),
    ("...thd,hde->...te", (2, 5, 4, 16), (4, 16, 64), (0, 1), 2),
    ("...te,ef->...tf", (2, 5, 64), (64, 96), (0,), 1),
    ("...tf,fe->...te", (3, 96), (96, 64), (0,), 1),
    ("...te,ev->...tv", (4, 1, 64), (64, 200), (0,), 1),
]


def _jit_einsum(eq, x, w, out_dtype=None, tokens_hint=None):
    """The reference's quant_einsum as its engine runs it: jitted."""
    fn = jax.jit(functools.partial(jq.quant_einsum, eq, out_dtype=out_dtype,
                                   tokens_hint=tokens_hint))
    return np.asarray(fn(jnp.asarray(x), jax.tree.map(jnp.asarray, w)))


@pytest.mark.parametrize("route", ["w8a8", "w8a16"])
@pytest.mark.parametrize("eq,xs,ws,axes,nc", FORMS, ids=[f[0] for f in FORMS])
def test_quant_matmul_matches_quant_einsum(eq, xs, ws, axes, nc, route):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) * 0.1).astype(np.float32)
    qw = jax.tree.map(np.asarray, jq.quantize_array(jnp.asarray(w), axes))
    rows = int(np.prod(xs[:len(xs) - nc]))
    # the token count decides the route: the rows here, or a hint
    hint = rows if route == "w8a8" else 4096
    out_dtype = jnp.float32 if eq.endswith("tv") else None
    want = _jit_einsum(eq, x, qw, out_dtype, tokens_hint=hint)
    got = tq.quant_matmul(_t(x), _tq(qw), nc, out_dtype=torch.float32,
                          tokens=hint)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # a plain weight is a plain product
    plain = tq.quant_matmul(_t(x), _t(w), nc)
    np.testing.assert_allclose(plain.numpy(), np.einsum(
        eq.replace("...", ""), x.reshape(-1, *xs[len(xs) - nc:]),
        w).reshape(plain.shape), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("route", ["w8a8", "w8a16"])
@pytest.mark.parametrize("eq", ["xce,xef->xcf", "xcf,xfe->xce"])
def test_expert_matmul_matches_batched_quant_einsum(eq, route):
    """The MoE forms: the port quantizes each row once before dispatch and
    hands expert_matmul int8 rows with their scales (W8A8), or model-dtype
    rows (W8A16); the reference quantizes the dispatched (X, C, K) rows."""
    rng = np.random.default_rng(1)
    X, C, K, N = 4, 6, 32, 24
    x = rng.standard_normal((X, C, K)).astype(np.float32)
    x[1, 4:] = 0  # empty capacity rows
    w = (rng.standard_normal((X, K, N)) * 0.1).astype(np.float32)
    qw = jax.tree.map(np.asarray, jq.quantize_array(jnp.asarray(w), (1,)))
    assert qw["s"].shape == (X, 1, N)
    hint = 7 if route == "w8a8" else 600
    want = _jit_einsum(eq, x, qw, tokens_hint=hint)
    if route == "w8a8":
        xq, sx = tq.quantize_rows(_t(x).flatten(0, 1))
        got = tq.expert_matmul(xq.view(X, C, K), _tq(qw), torch.float32,
                               sx=sx.view(X, C))
    else:
        got = tq.expert_matmul(_t(x), _tq(qw), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_w8a16_tiles_equal_one_dequantized_product(monkeypatch):
    """A W8A16 product dequantizes its weight a column tile at a time; the
    tiles give the whole dequantized product's result."""
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((600, 64)).astype(np.float32))
    w = tq.quantize_array(_t(rng.standard_normal((64, 100)).astype(
        np.float32)), (0,))
    whole = tq.quant_matmul(x, w)
    monkeypatch.setattr(tq, "DEQUANT_TILE_ELEMS", 64 * 24)
    tiled = tq.quant_matmul(x, w)
    assert torch.equal(whole, tiled)
    np.testing.assert_allclose(whole.numpy(), (x @ tq.dequantize_array(
        w)).numpy(), rtol=TOL, atol=TOL)


def test_w8a8_runs_the_int8_product(monkeypatch):
    """Below the threshold the product is torch._int_mm's, on a CPU tensor
    too: no float fallback."""
    calls = []
    orig = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm",
                        lambda a, b: calls.append(a.shape) or orig(a, b))
    rng = np.random.default_rng(3)
    w = tq.quantize_array(_t(rng.standard_normal((64, 48)).astype(
        np.float32)), (0,))
    tq.quant_matmul(_t(rng.standard_normal((5, 64)).astype(np.float32)), w)
    assert calls == [(5, 64)]
    tq.quant_matmul(_t(rng.standard_normal((5, 64)).astype(np.float32)), w,
                    tokens=512)
    assert calls == [(5, 64)]


@pytest.mark.parametrize("raw,want", [(None, 512), ("1024", 1024),
                                      ("2e3", 2000), ("0", 0), ("-7", 0),
                                      ("lots", 512)])
def test_a16_threshold_parsing(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("PSTPU_QUANT_A16_THRESHOLD", raising=False)
    else:
        monkeypatch.setenv("PSTPU_QUANT_A16_THRESHOLD", raw)
    assert tq._a16_threshold() == jq._a16_threshold() == want
    assert tq.a16(10 ** 6) is (want > 0)
    assert not tq.a16(max(want - 1, 0))


def test_threshold_zero_forces_w8a8(monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((600, 64)).astype(np.float32)
    w = jax.tree.map(np.asarray, jq.quantize_array(
        jnp.asarray(rng.standard_normal((64, 32)).astype(np.float32)), (0,)))
    monkeypatch.setenv("PSTPU_QUANT_A16_THRESHOLD", "0")
    want = _jit_einsum("...te,ef->...tf", x, w)
    got = tq.quant_matmul(_t(x), _tq(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_embed_lookup_and_tied_head():
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    toks = np.array([[3, 7, 49], [0, 3, 12]], np.int32)
    qe = jax.tree.map(np.asarray, jq.quantize_array(jnp.asarray(emb), (1,)))
    for table, ours in ((emb, _t(emb)), (qe, _tq(qe))):
        want = np.asarray(jq.embed_lookup(
            jax.tree.map(jnp.asarray, table), jnp.asarray(toks), jnp.float32))
        got = tq.embed_lookup(ours, _t(toks), torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        jh = jq.head_from_embed(jax.tree.map(jnp.asarray, table))
        th = tq.head_from_embed(ours)
        if tq.is_quantized(th):
            np.testing.assert_array_equal(th["q"].numpy(), np.asarray(jh["q"]))
            np.testing.assert_array_equal(th["s"].numpy(), np.asarray(jh["s"]))
            assert th["s"].shape == (1, 50)
        else:
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_maybe_quantize_gate():
    cfg = tcfg.ModelConfig.from_pretrained("tiny-llama")
    params = init_random(cfg)
    assert tq.maybe_quantize(cfg, params) is params  # off by default
    qcfg = dataclasses.replace(cfg, quant="int8")
    qp = tq.maybe_quantize(qcfg, params)
    assert tq.params_quantized(qp) and not tq.params_quantized(params)
    assert tq.maybe_quantize(qcfg, qp) is qp  # idempotent
    with pytest.raises(ValueError, match="fp4"):
        tq.maybe_quantize(dataclasses.replace(cfg, quant="fp4"), params)


@pytest.mark.parametrize("preset", ["tiny-mixtral", "tiny-gemma"])
def test_quantize_params_matches_reference(preset):
    """Structure as the reference's test pins it, and every leaf equal."""
    jc = jcfg.ModelConfig.from_pretrained(preset)
    tc = tcfg.ModelConfig.from_pretrained(preset)
    np_params = _jax_params(preset)
    want = jax.tree.map(np.asarray, jq.quantize_params(
        jc, jax.tree.map(jnp.asarray, np_params)))
    got = tq.quantize_params(tc, params_from_jax(np_params, tc))
    lay = got["layers"]
    assert tq.is_quantized(lay["wq"]) and tq.is_quantized(lay["w_gate"])
    assert not tq.is_quantized(lay["attn_norm"])
    assert tq.is_quantized(got["embed"])
    if preset == "tiny-mixtral":
        assert not tq.is_quantized(lay["router"])  # the router stays
        X, F = tc.num_experts, tc.intermediate_size
        assert lay["w_gate"]["s"].shape == (tc.num_layers, X, 1, F)
    else:
        assert "lm_head" not in got  # tied
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    for path, leaf in flat_want:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("preset", ["tiny-llama", "tiny-mixtral"])
def test_int8_random_init_is_quantized_bf16_init(preset):
    """Random init of an int8 model makes the same values as the plain
    model of the same seed, quantized: the int8 engine serves the
    quantization of the bf16 engine's model."""
    cfg = dataclasses.replace(tcfg.ModelConfig.from_pretrained(preset),
                              dtype="bfloat16")
    plain = init_random(cfg, seed=5)
    qcfg = dataclasses.replace(cfg, quant="int8")
    direct = init_random(qcfg, seed=5)
    want = tq.quantize_params(qcfg, plain)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict) and not tq.is_quantized(v):
                yield from leaves(v, prefix + k + ".")
            else:
                yield prefix + k, v

    got = dict(leaves(direct))
    for name, leaf in leaves(want):
        if tq.is_quantized(leaf):
            assert torch.equal(got[name]["q"], leaf["q"]), name
            assert torch.equal(got[name]["s"], leaf["s"]), name
        else:
            assert torch.equal(got[name], leaf), name


# -- engines -----------------------------------------------------------------

PROMPTS = [5, 17, 40, 9, 23]


@pytest.fixture(scope="module")
def jax_weights():
    mesh = build_mesh(MeshConfig(data=1, tensor=1))
    out = {}
    for preset in ("tiny-llama", "tiny-mixtral"):
        params = jax_init(jcfg.ModelConfig.from_pretrained(preset), mesh,
                          seed=0)
        out[preset] = (params, jax.tree.map(np.asarray,
                                            jax.device_get(params)))
    return mesh, out


def _int8_engines(jax_weights, preset, impl, T):
    mesh, by_preset = jax_weights
    params, np_params = by_preset[preset]
    sched = dict(max_num_seqs=4, max_num_batched_tokens=T,
                 prefill_buckets=(16, 32, 64))
    cache = dict(block_size=4, num_blocks=256)
    jm = jcfg.ModelConfig.from_pretrained(preset, quant="int8")
    tm = tcfg.ModelConfig.from_pretrained(preset, quant="int8")
    jeng = JaxEngine(jcfg.EngineConfig(
        model=jm, cache=jcfg.CacheConfig(**cache),
        scheduler=jcfg.SchedulerConfig(**sched),
        mesh=MeshConfig(data=1, tensor=1), attention_impl=impl),
        mesh=mesh, params=params, num_blocks=256)
    teng = LLMEngine(tcfg.EngineConfig(
        model=tm, cache=tcfg.CacheConfig(**cache),
        scheduler=tcfg.SchedulerConfig(**sched), attention_impl=impl),
        params=params_from_jax(np_params, tm, "cpu"), device="cpu")
    return jeng, teng


def assert_int8_same(want, got):
    """Tokens as ``assert_same`` holds them; logprobs within the int8
    band (module docstring)."""
    none = {rid: [] for rid in want[0]}
    assert_same((want[0], none, want[2]), (got[0], none, got[2]), gaps={
        rid: [top[0][1] - top[1][1] for _, top in entries]
        for rid, entries in want[1].items()})
    for rid in want[1]:
        for (a, _), (b, _) in zip(want[1][rid], got[1][rid]):
            assert abs(a - b) <= INT8_LP_BAND, (rid, a, b)


@pytest.mark.parametrize("preset,impl,T", [
    ("tiny-llama", "ragged", 32),      # every product W8A8
    ("tiny-llama", "ragged", 512),     # ragged steps W8A16, decode W8A8
    ("tiny-llama", "bucketed", 64),
    ("tiny-mixtral", "ragged", 32),
    ("tiny-mixtral", "ragged", 512),
    ("tiny-mixtral", "bucketed", 64),
])
def test_int8_engine_matches_reference(jax_weights, preset, impl, T):
    jeng, teng = _int8_engines(jax_weights, preset, impl, T)
    assert tq.params_quantized(teng.runner.params)
    rng = np.random.default_rng(1)
    reqs = [(f"r{i}", rng.integers(0, 259, n).tolist(),
             SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True,
                            logprobs=2)) for i, n in enumerate(PROMPTS)]
    want = drain(jeng, reqs)
    got = drain(teng, reqs)
    assert_int8_same(want, got)
    assert sum(map(len, got[0].values())) == 12 * len(PROMPTS)


def test_profile_ranges_name_the_int8_work():
    """With ``PROFILE_RANGES`` on (``chip_smoke.py`` phase 8 turns it on
    for its profile windows) the activation quantization, the int8 GEMM
    and the dequantization run inside profiler ranges of those names;
    off, they record none."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(6)
    w = tq.quantize_array(_t(rng.standard_normal((64, 48)).astype(
        np.float32)), (0,))
    x = _t(rng.standard_normal((5, 64)).astype(np.float32))
    names = {}
    for on in (False, True):
        tq.PROFILE_RANGES = on
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                tq.quant_matmul(x, w)
                tq.quant_matmul(x, w, tokens=512)
        finally:
            tq.PROFILE_RANGES = False
        names[on] = {e.name for e in prof.events()}
    wanted = {"quant.activations", "quant.int8_gemm", "quant.dequantize"}
    assert wanted <= names[True] and not wanted & names[False]

"""The PyTorch port's plain ops against the JAX package's, on the CPU.

The same numpy-seeded inputs go through the JAX function and its port;
float32 throughout, so the two agree within 1e-5 (they differ only in the
order their libraries sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.kv_cache import (
    PrefixCachingBlockAllocator as JaxAllocator,
)
from production_stack_tpu.engine.kv_cache import _chain_hash as jax_chain_hash
from production_stack_tpu.engine.kv_cache import slot_mapping_for as jax_slots
from production_stack_tpu.ops import norms as jnorms
from production_stack_tpu.ops import paged_attention as jpa
from production_stack_tpu.ops import rope as jrope
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine.kv_cache import (
    PrefixCachingBlockAllocator,
    _chain_hash,
    slot_mapping_for,
)
from production_stack_tpu_torch.ops import kv_write as k1
from production_stack_tpu_torch.ops import norms, rope
from production_stack_tpu_torch.ops import paged_attention as tpa
from production_stack_tpu_torch.ops import paged_decode_attention as k3
from production_stack_tpu_torch.ops import ragged_paged_attention as k2

torch.set_num_threads(2)

ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    close(norms.rms_norm(t(x), t(w), 1e-5, offset),
          jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset))


@pytest.mark.parametrize("theta,scaling", [(10000.0, 1.0), (500000.0, 8.0)])
def test_apply_rope(theta, scaling):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(-1, 300, (2, 7)).astype(np.int32)
    close(rope.apply_rope(t(x), t(pos), theta, scaling),
          jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, scaling))


@pytest.mark.parametrize("kh,d", [(1, 16), (2, 32), (8, 16)])
def test_combine_split_kv(kh, d):
    """The one-card slab is the reference's at tp=1: K heads, then V."""
    rng = np.random.default_rng(2)
    k = rng.standard_normal((5, kh, d)).astype(np.float32)
    v = rng.standard_normal((5, kh, d)).astype(np.float32)
    fused = tpa.combine_kv(t(k), t(v))
    np.testing.assert_array_equal(fused.numpy(),
                                  np.asarray(jpa.combine_kv(k, v, 1)))
    k2_, v2_ = tpa.split_kv(fused)
    np.testing.assert_array_equal(k2_.numpy(), k)
    np.testing.assert_array_equal(v2_.numpy(), v)


def test_write_kv_drops_padding():
    """K1's plain version (``kv_write`` on CPU tensors) is the reference's
    ``write_kv``: slot -1 drops the token."""
    rng = np.random.default_rng(3)
    L, N, bs, KH, D, T = 2, 8, 4, 2, 16, 10
    cache = rng.standard_normal((L, N, bs, 2 * KH, D)).astype(np.float32)
    k = rng.standard_normal((T, KH, D)).astype(np.float32)
    v = rng.standard_normal((T, KH, D)).astype(np.float32)
    slots = np.full(T, -1, np.int32)
    slots[:7] = rng.permutation(N * bs)[:7]
    want = jpa.write_kv(jnp.asarray(cache), jnp.int32(1), jnp.asarray(k),
                        jnp.asarray(v), jnp.asarray(slots))
    got = k1.kv_write(t(cache.copy()), tpa.combine_kv(t(k), t(v)), t(slots), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _paged_case(rng, lens, H=4, KH=2, D=16, bs=4, M=8, N=32):
    kv = rng.standard_normal((N, bs, 2 * KH, D)).astype(np.float32)
    tables = rng.integers(0, N, (len(lens), M)).astype(np.int32)
    return kv, tables


def test_paged_attention():
    """K3's plain version against the reference ``paged_attention`` at one
    query a sequence (position ctx - 1). The reference leaves finite
    garbage on a row of context 0; the port outputs 0 there."""
    rng = np.random.default_rng(4)
    lens = np.array([9, 16, 0, 3], np.int32)
    kv, tables = _paged_case(rng, lens)
    q = rng.standard_normal((len(lens), 4, 16)).astype(np.float32)
    qpos = (lens - 1)[:, None].astype(np.int32)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q[:, None]), jnp.asarray(kv), jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(qpos)))[:, 0]
    got = k3.paged_decode_attention(t(q), t(kv[None]), t(tables), t(lens),
                                    0).numpy()
    live = lens > 0
    close(got[live], want[live])
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("soft_cap", [0.0, 5.0])
def test_ragged_paged_attention_reference(soft_cap):
    """K2's plain version against the reference ``ragged_paged_attention``
    on the rows of a span; the reference leaves finite garbage on tail
    padding, the port exact zeros."""
    rng = np.random.default_rng(5)
    q_lens, ctx = [5, 0, 1, 7], [9, 0, 13, 7]
    kv, tables = _paged_case(rng, ctx)
    T = sum(q_lens) + 3  # tail padding
    q = rng.standard_normal((T, 4, 16)).astype(np.float32)
    seq_ids = np.concatenate([np.full(n, s) for s, n in enumerate(q_lens)]
                             + [np.zeros(3)]).astype(np.int32)
    qpos = np.concatenate([np.arange(c - n, c) for n, c in zip(q_lens, ctx)]
                          + [np.full(3, -1)]).astype(np.int32)
    ctx = np.asarray(ctx, np.int32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    want = np.asarray(jpa.ragged_paged_attention(
        *map(jnp.asarray, (q, kv, tables, ctx, seq_ids, qpos)),
        soft_cap=soft_cap))
    got = k2.ragged_paged_attention(t(q), t(kv[None]), t(tables), t(cu),
                                    t(ctx), 0, soft_cap=soft_cap).numpy()
    span = qpos >= 0
    close(got[span], want[span])
    assert (got[~span] == 0).all()


def test_chain_hash_and_slots_bit_identical():
    """Block identities and slot mappings match the JAX engine's, so both
    engines address and prefix-match a prompt's blocks the same way."""
    prev = 0x9E3779B97F4A7C15
    for chunk in [(1, 2, 3, 4), (5, 6, 7, 8), tuple(range(16))]:
        assert _chain_hash(prev, chunk) == jax_chain_hash(prev, chunk)
        prev = _chain_hash(prev, chunk)
    np.testing.assert_array_equal(slot_mapping_for([5, 9, 2], 3, 7, 4),
                                  jax_slots([5, 9, 2], 3, 7, 4))


def test_allocator_matches_reference():
    mine = PrefixCachingBlockAllocator(num_blocks=8, block_size=4)
    ref = JaxAllocator(num_blocks=8, block_size=4)
    toks = list(range(17))
    for a in (mine, ref):
        blocks, _ = a.allocate_sequence(toks)
        a.commit_full_blocks(toks, blocks)
        a.free_blocks(blocks)
    assert mine.allocate_sequence(toks) == ref.allocate_sequence(toks)
    assert mine.num_free_blocks == ref.num_free_blocks
    assert mine.allocate_sequence(list(range(100, 140))) is None
    assert ref.allocate_sequence(list(range(100, 140))) is None


def test_presets_match_reference():
    """Every preset carries the reference's values, field for field, and
    no reference preset is left out (Whisper's three included)."""
    assert set(tcfg.MODEL_PRESETS) == set(jcfg.MODEL_PRESETS)
    assert {"tiny-mixtral", "mixtral-8x7b", "tiny-whisper",
            "whisper-large-v3-class"} <= set(tcfg.MODEL_PRESETS)
    assert set(tcfg.ModelConfig.__dataclass_fields__) == set(
        jcfg.ModelConfig.__dataclass_fields__)
    for name, mine in tcfg.MODEL_PRESETS.items():
        ref = jcfg.MODEL_PRESETS[name]
        for f in tcfg.ModelConfig.__dataclass_fields__:
            assert getattr(mine, f) == getattr(ref, f), (name, f)
    assert tcfg.SchedulerConfig().max_num_seqs == jcfg.SchedulerConfig().max_num_seqs
    assert (tcfg.SchedulerConfig().max_num_batched_tokens
            == jcfg.SchedulerConfig().max_num_batched_tokens)
    assert tcfg.CacheConfig().block_size == jcfg.CacheConfig().block_size


@pytest.mark.parametrize("option", [{"encoder_layers": 2},
                                    {"num_mel_bins": 80},
                                    {"sot_id": 1}])
def test_unported_options_raise(option):
    """Whisper's options are honoured on a Whisper preset, as the
    reference's ``from_pretrained`` honours them; an option ModelConfig
    does not have raises, and is never ignored."""
    mine = tcfg.ModelConfig.from_pretrained("tiny-whisper", **option)
    ref = jcfg.ModelConfig.from_pretrained("tiny-whisper", **option)
    for f in tcfg.ModelConfig.__dataclass_fields__:
        assert getattr(mine, f) == getattr(ref, f), f
    (name, value), = option.items()
    assert getattr(mine, name) == value
    assert tcfg.EngineConfig.for_model("tiny-whisper", **option).model == mine
    unknown = {name + "_x": value}
    with pytest.raises(ValueError, match="has no option"):
        tcfg.ModelConfig.from_pretrained("tiny-whisper", **unknown)
    with pytest.raises(ValueError, match="has no option"):
        tcfg.EngineConfig.for_model("tiny-llama", **unknown)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        tcfg.resolve_device("cuda")


@pytest.mark.parametrize("impl", ["auto", "ragged", "bucketed"])
def test_attention_impl_resolution(impl):
    """"auto" resolves to the ragged path, on the CPU too (where the
    reference's "auto" picks bucketed); "ragged" and "bucketed" (K4) are
    taken as asked for, and anything else is refused."""
    from production_stack_tpu_torch.engine.model_runner import ModelRunner

    cfg = tcfg.EngineConfig.for_model("tiny-llama", attention_impl=impl,
                                      cache=tcfg.CacheConfig(num_blocks=8))
    want = "ragged" if impl == "auto" else impl
    assert ModelRunner(cfg, device="cpu").attention_impl == want
    cfg.attention_impl = "paged"
    with pytest.raises(ValueError, match="auto|ragged|bucketed"):
        ModelRunner(cfg, device="cpu")

"""The port's KV-transfer wire format against the JAX package's, on the CPU.

``engine/kv_transfer.py`` keeps the reference's frames byte for byte, so a
JAX engine and a port engine can feed each other:

- ``frame``, ``END_FRAME``, ``default_group`` and ``layer_groups`` equal the
  JAX module's;
- the port's consumer reads the frames the JAX producer writes, and the JAX
  consumer reads the port's, in float32 and as bf16 words (the port moves
  bfloat16 as raw 2-byte words; the JAX side as ``ml_dtypes.bfloat16``),
  over synthetic pools and over two tiny-llama engines' real exports;
- a flipped byte raises ``FrameDigestError`` at its group's first layer,
  with the groups before it landed, and a resume from ``start_layer``
  gathers no earlier group.
"""

import asyncio
import io

import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import engine_configs, jax_engine, port_engine, tiny_weights
from production_stack_tpu.engine import kv_transfer as jkt
from production_stack_tpu.engine.sampling import SamplingParams as JaxSP
from production_stack_tpu_torch.engine import kv_transfer as tkt
from production_stack_tpu_torch.engine.sampling import SamplingParams

torch.set_num_threads(2)

L, N, BS, KH2, D = 6, 12, 4, 4, 8
BLOCKS = [7, 2, 9, 4]  # non-contiguous, out of order


@pytest.mark.parametrize("n", [0, 1, 17, 4096])
def test_frame_is_byte_equal(n):
    payload = bytes(np.random.default_rng(n).integers(0, 256, n, np.uint8))
    assert tkt.frame(payload) == jkt.frame(payload)
    assert tkt.frame(memoryview(payload)) == jkt.frame(payload)
    assert tkt.END_FRAME == jkt.END_FRAME
    assert tkt.FRAME_HEADER.format == jkt.FRAME_HEADER.format
    assert tkt.FRAME_CRC.format == jkt.FRAME_CRC.format


@pytest.mark.parametrize("layers,group,start", [
    (1, 1, 0), (2, 1, 1), (5, 2, 0), (5, 2, 4), (32, 16, 16), (32, 5, 10),
    (7, 7, 0)])
def test_layer_groups_equal(layers, group, start):
    assert tkt.default_group(layers) == jkt.default_group(layers)
    assert (list(tkt.layer_groups(layers, group, start))
            == list(jkt.layer_groups(layers, group, start)))


def _pool_np(dtype: str, seed: int = 0) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((L, N, BS, KH2, D))
    return x.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)


def _torch_of(a: np.ndarray) -> torch.Tensor:
    """The numpy pool as a torch tensor of the same bits."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


class _TorchPool:
    """A stand-in engine over a torch pool (``runner.export_blocks_range``
    and ``import_kv_range``, as the port's engine and runner have them)."""

    def __init__(self, kv: torch.Tensor):
        self.kv = kv
        self.runner = self
        self.gathers = []

    def export_blocks_range(self, blocks, lo, n):
        self.gathers.append((lo, n))
        return self.kv[lo:lo + n].index_select(1, torch.tensor(blocks))

    def import_kv_range(self, blocks, lo, data):
        self.kv[lo:lo + data.shape[0]].index_copy_(1, torch.tensor(blocks),
                                                    data)


class _NumpyPool:
    """The same over a numpy pool, for the JAX functions."""

    def __init__(self, kv: np.ndarray):
        self.kv = kv
        self.runner = self

    def export_blocks_range(self, blocks, lo, n):
        return self.kv[lo:lo + n][:, blocks]

    def import_kv_range(self, blocks, lo, data):
        self.kv[lo:lo + data.shape[0], blocks] = data


class _Content:
    """aiohttp's ``StreamReader.readexactly`` over bytes."""

    def __init__(self, data: bytes):
        self.buf = io.BytesIO(data)

    async def readexactly(self, n):
        out = self.buf.read(n)
        if len(out) < n:
            raise asyncio.IncompleteReadError(out, n)
        return out


def _jax_frames(pool, blocks, group, start=0) -> bytes:
    async def run(fn):
        return fn(pool)

    async def go():
        return b"".join([f async for f in jkt.produce_frames(
            run, blocks, L, group, start_layer=start)])

    return asyncio.run(go())


def _jax_consume(pool, data: bytes, local, shape, dtype, group, start=0):
    async def run(fn):
        return fn(pool)

    return asyncio.run(jkt.consume_frames(
        _Content(data), run, local, shape, dtype, group, start_layer=start))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_jax_frames_into_port(dtype, group):
    src = _pool_np(dtype)
    data = _jax_frames(_NumpyPool(src), BLOCKS, group)
    dst = _TorchPool(torch.zeros((L, N, BS, KH2, D),
                                 dtype=tkt.wire_dtype(dtype)))
    local = [0, 11, 5, 3]
    shape = (L, len(BLOCKS), BS, KH2, D)
    landed = tkt.consume_frames(io.BytesIO(data), lambda fn: fn(dst), local,
                                shape, dtype, group)
    assert landed == L
    want = _torch_of(src)[:, BLOCKS]
    assert np.array_equal(_bits(dst.kv[:, local]), _bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 3, 6])
def test_port_frames_into_jax(dtype, group):
    src = _TorchPool(_torch_of(_pool_np(dtype, seed=1)))
    data = b"".join(tkt.produce_frames(lambda fn: fn(src), BLOCKS, L, group,
                                       window=2))
    assert data == _jax_frames(_NumpyPool(_pool_np(dtype, seed=1)), BLOCKS,
                               group)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    dst = _NumpyPool(np.zeros((L, N, BS, KH2, D), np_dtype))
    local = [1, 2, 3, 4]
    landed = _jax_consume(dst, data, local, (L, 4, BS, KH2, D), dtype, group)
    assert landed == L
    got = dst.kv[:, local]
    assert np.array_equal(got.view(np.int16) if dtype == "bfloat16" else got,
                          _bits(src.kv[:, BLOCKS]))


@pytest.mark.parametrize("bad_group", [0, 1, 2])
def test_flipped_byte_raises_at_its_group(bad_group):
    """Frames of groups of 2 layers; one byte of group ``bad_group``'s
    payload flipped: FrameDigestError at that group's first layer, every
    earlier group landed (``on_group``)."""
    src = _TorchPool(_torch_of(_pool_np("float32", seed=2)))
    frames = list(tkt.produce_frames(lambda fn: fn(src), BLOCKS, L, 2))
    bad = bytearray(frames[bad_group])
    bad[tkt.FRAME_HEADER.size + 5] ^= 0x40
    frames[bad_group] = bytes(bad)
    data = b"".join(frames)
    dst = _TorchPool(torch.zeros((L, N, BS, KH2, D)))
    spans = []
    with pytest.raises(tkt.FrameDigestError) as e:
        tkt.consume_frames(io.BytesIO(data), lambda fn: fn(dst), BLOCKS,
                           (L, 4, BS, KH2, D), "float32", 2,
                           on_group=lambda lo, n: spans.append((lo, n)))
    assert e.value.layer == 2 * bad_group
    assert spans == [(2 * g, 2) for g in range(bad_group)]
    # the JAX consumer raises at the same layer
    jdst = _NumpyPool(np.zeros((L, N, BS, KH2, D), np.float32))
    with pytest.raises(jkt.FrameDigestError) as je:
        _jax_consume(jdst, data, BLOCKS, (L, 4, BS, KH2, D), "float32", 2)
    assert je.value.layer == e.value.layer


def test_resume_gathers_no_earlier_group():
    src = _TorchPool(_torch_of(_pool_np("float32", seed=3)))
    frames = list(tkt.produce_frames(lambda fn: fn(src), BLOCKS, L, 2,
                                     start_layer=4))
    assert src.gathers == [(4, 2)]
    assert len(frames) == 2 and frames[-1] == tkt.END_FRAME
    dst = _TorchPool(torch.zeros((L, N, BS, KH2, D)))
    landed = tkt.consume_frames(io.BytesIO(b"".join(frames)),
                                lambda fn: fn(dst), BLOCKS,
                                (L, 4, BS, KH2, D), "float32", 2,
                                start_layer=4)
    assert landed == 2
    assert torch.equal(dst.kv[4:, BLOCKS], src.kv[4:, BLOCKS])
    assert not dst.kv[:4].any()
    with pytest.raises(ValueError, match="short KV stream"):
        tkt.consume_frames(io.BytesIO(frames[0] + tkt.END_FRAME),
                           lambda fn: fn(dst), BLOCKS, (L, 4, BS, KH2, D),
                           "float32", 2)


def test_bf16_words_round_trip():
    t = torch.randn(3, 5, dtype=torch.float32).to(torch.bfloat16)
    raw = bytearray(tkt.tensor_bytes(t))
    assert len(raw) == 2 * t.numel() == tkt.nbytes_of(t.shape, "bfloat16")
    back = tkt.tensor_from_bytes(raw, "bfloat16", t.shape)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    with pytest.raises(ValueError):
        tkt.wire_dtype("int4")


def test_engine_exports_cross_the_wire():
    """Two tiny-llama engines (float32, same weights) prefill the same
    prompt; the JAX engine's blocks, framed by the JAX producer, land in
    the port engine's fresh blocks bit for bit, and the port engine's,
    framed by the port producer, land in the JAX engine's."""
    weights = tiny_weights()
    jconf, tconf = engine_configs("ragged", max_num_seqs=4,
                                  max_num_batched_tokens=32)
    jeng, teng = jax_engine(weights, jconf), port_engine(weights, tconf)
    prompt = list(range(3, 40))
    jeng.generate([prompt], JaxSP(temperature=0.0, max_tokens=1))
    teng.generate([prompt], SamplingParams(temperature=0.0, max_tokens=1))
    jblocks, _ = jeng.scheduler.allocator.match_prefix(prompt)
    tblocks, _ = teng.scheduler.allocator.match_prefix(prompt)
    assert len(jblocks) == len(tblocks) == len(prompt) // 4
    layers = jconf.model.num_layers
    shape = (layers, len(jblocks), 4, 2 * jconf.model.num_kv_heads,
             jconf.model.head_dim)

    async def jrun(fn):
        return fn(jeng)

    async def frames():
        return b"".join([f async for f in jkt.produce_frames(
            jrun, jblocks, layers, 1)])

    data = asyncio.run(frames())
    local = teng.scheduler.allocator.take_free_blocks(len(jblocks))
    tkt.consume_frames(io.BytesIO(data), lambda fn: fn(teng), local, shape,
                       "float32", 1)
    assert np.array_equal(teng.export_kv(local).numpy(),
                          jeng.export_kv(jblocks))
    # and the port engine's blocks into the JAX engine
    data = b"".join(tkt.produce_frames(lambda fn: fn(teng), tblocks, layers))
    jlocal = jeng.scheduler.allocator.take_free_blocks(len(tblocks))
    _jax_consume(jeng, data, jlocal, shape, "float32",
                 tkt.default_group(layers))
    assert np.array_equal(jeng.export_kv(jlocal),
                          teng.export_kv(tblocks).numpy())

"""K4's launch geometry, on the CPU.

``launch_geometry`` (ops/paged_prefill_attention.py) is the arithmetic of
the launch ``csrc/paged_prefill_attention.cu`` makes: a chunk's queries for
one KV head are S * G rows, a CTA owns ``rows`` consecutive rows of them,
and the bf16 kernel stages ``positions`` context positions a step. For
every preset of ``MODEL_PRESETS`` the paged engine serves (Whisper's run
no paged kernel), in bf16 and in float32, and at every prefill bucket, the CTAs must cover every row of the bucket exactly once
and each must fit Hopper's 227 KB of shared memory a CTA. The tiles the
Python side may ask for must be the ones the CUDA source builds.
"""

import re
from pathlib import Path

import pytest
import torch

from production_stack_tpu_torch.engine.config import (
    MODEL_PRESETS,
    SchedulerConfig,
)
from production_stack_tpu_torch.ops import _build
from production_stack_tpu_torch.ops import paged_prefill_attention as k4

CSRC = Path(_build.CSRC)
# the presets whose attention runs the paged kernels
PAGED_PRESETS = sorted(n for n, c in MODEL_PRESETS.items()
                       if c.architecture != "whisper")
# every default bucket, and sizes no tile divides
BUCKETS = SchedulerConfig().prefill_buckets + (1, 40, 127)


def _check_cover(geo, S, G, KH, P):
    spans = geo["row_spans"]
    assert geo["grid"] == (len(spans), KH, P)
    covered = []
    for first, n in spans:
        assert 0 < n <= geo["rows"]
        covered.extend(range(first, first + n))
    assert covered == list(range(S * G))  # every row once, in order
    assert geo["smem_bytes"] <= k4.SMEM_LIMIT
    assert geo["threads"] % 32 == 0 and geo["threads"] <= 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("preset", PAGED_PRESETS)
def test_default_tile_covers_every_row_and_fits(preset, dtype):
    cfg = MODEL_PRESETS[preset]
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KH
    for S in BUCKETS:
        geo = k4.launch_geometry(4, S, H, KH, D, dtype)
        _check_cover(geo, S, G, KH, 4)
        if dtype == torch.bfloat16:
            assert (geo["rows"], geo["positions"]) == k4.DEFAULT_TILE[D]
            assert geo["threads"] == 2 * geo["rows"]  # a warp per 16 rows
        else:
            assert geo["rows"] == k4.WALK_TOKENS * G
            assert geo["positions"] == k4.WALK_POSITIONS


@pytest.mark.parametrize("D", _build.HEAD_DIMS)
def test_every_built_tile_covers_and_fits(D):
    assert k4.DEFAULT_TILE[D] in k4.TILES[D]
    for tile in k4.TILES[D]:
        for G in (1, 2, 3, 4, 7, 8):
            geo = k4.launch_geometry(2, 40, 2 * G, 2, D, torch.bfloat16,
                                     tile)
            _check_cover(geo, 40, G, 2, 2)
            # bf16 sQ plus two stages of K and V, rows padded by 16 bytes
            rows, positions = tile
            assert geo["smem_bytes"] == (rows + 4 * positions) * (D + 8) * 2


@pytest.mark.parametrize("tile,dtype", [
    ((64, 48), torch.bfloat16),   # positions not built
    ((32, 64), torch.bfloat16),   # rows not built
    ((8, 64), torch.float32),     # the walk stages 32 positions
    ((0, 32), torch.float32),
    ((512, 32), torch.float32),   # past the shared memory of a CTA
])
def test_geometry_refuses_unbuilt_or_oversized_tiles(tile, dtype):
    with pytest.raises(ValueError):
        k4.launch_geometry(1, 128, 8, 2, 128, dtype, tile)


def test_python_tiles_match_the_cuda_source():
    """TILES, PAD and WALK_POSITIONS are read by the CUDA source too: the
    tiles ``with_tile`` builds (beside the row-tile walk that K4 and K2
    share), mma::kPad and kTileK."""
    src = (CSRC / "mma_attention.cuh").read_text()
    body = src[src.index("inline int with_tile"):]
    body = body[:body.index("return kUnsupported")]
    common, d128 = body.split("if constexpr (D == 128)")
    pat = r"rows == (\d+) && positions == (\d+)"
    everywhere = {(int(r), int(n)) for r, n in re.findall(pat, common)}
    only_128 = {(int(r), int(n)) for r, n in re.findall(pat, d128)}
    for D in _build.HEAD_DIMS:
        want = everywhere | (only_128 if D == 128 else set())
        assert set(k4.TILES[D]) == want, D
    mma_h = (CSRC / "mma_attention.cuh").read_text()
    assert re.search(rf"constexpr int kPad = {k4.PAD};", mma_h)
    common_h = (CSRC / "paged_attention_common.cuh").read_text()
    assert re.search(rf"constexpr int kTileK = {k4.WALK_POSITIONS};",
                     common_h)


def test_rows_cross_token_boundaries():
    """At G = 3 a 64-row CTA holds 21 tokens and a third: no row idles, and
    the next CTA starts inside that token."""
    geo = k4.launch_geometry(1, 40, 6, 2, 128, torch.bfloat16, (64, 32))
    assert geo["row_spans"][:2] == [(0, 64), (64, 56)]
    assert divmod(64, 3) == (21, 1)

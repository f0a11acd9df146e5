#!/usr/bin/env python3
"""Time the port's attention kernels (K2, K3, K4) of one checkout on the
card, at the shapes ``chip_smoke.py`` measures, for comparing two commits
in one run on one card.

    python3 scripts/attention_ab.py --root DIR [--label NAME]

``DIR`` is the root of a checkout of this repository, this one or another
(an older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists); its ``production_stack_tpu_torch`` is imported and
its kernels are built and timed. The inputs come from this script's own
``chip_smoke.py`` helpers and a fixed seed, so two checkouts see the same
data. It takes either version of the wrappers' arguments: a work map
(``ragged_work_map``) or a query tile map (``stream_tiles``) for K2, a
split plan or none for K3. Times are device time (``chip_smoke.time_ms``:
a CUDA graph of many launches between one pair of events). Prints one
JSON line: the card, the label and each shape's time in ms. Run the two
checkouts in turns (A, B, B, A) in one command to see the spread.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, type=pathlib.Path)
    ap.add_argument("--label", default=None)
    a = ap.parse_args()
    root = a.root.resolve()
    if not (root / "production_stack_tpu_torch" / "__init__.py").exists():
        print(f"attention_ab.py: no production_stack_tpu_torch under {root}",
              file=sys.stderr)
        return 2
    smoke = _smoke()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("attention_ab.py: needs a CUDA card", file=sys.stderr)
        return 1
    from production_stack_tpu_torch.ops import _build
    from production_stack_tpu_torch.ops import paged_decode_attention as k3
    from production_stack_tpu_torch.ops import paged_prefill_attention as k4
    from production_stack_tpu_torch.ops import ragged_paged_attention as k2

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build_all()
    H, KH, D, bs, layer, T, S, M = 32, 8, 128, 16, 1, 2048, 64, 512
    bf16 = torch.bfloat16
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    times = {}

    def k2_time(label, spans):
        pool, dev, _ = smoke.make_stream(rng, spans, T, S, M, bs, 2 * KH, D,
                                         bf16, torch, layer=layer)
        q = torch.randn((T, H, D), dtype=bf16, device="cuda")
        args = (q, pool, dev["tables"], dev["cu"], dev["ctx"], layer)
        if hasattr(k2, "ragged_work_map"):
            tiles = k2.ragged_work_map(dev["cu"].cpu().numpy(),
                                       dev["ctx"].cpu().numpy(), T, H, KH, D,
                                       bf16, "cuda")
        else:
            tiles = k2.stream_tiles(dev["cu"], T)
        times[label] = smoke.time_ms(torch, lambda: k2.ragged_paged_attention(
            *args, tiles=tiles), 10)

    def k3_time(label, lens):
        spans = [(b, 1, c) for b, c in enumerate(lens) if c > 0]
        pool, dev, _ = smoke.make_stream(rng, spans, len(lens), len(lens), M,
                                         bs, 2 * KH, D, bf16, torch,
                                         layer=layer)
        q = torch.randn((len(lens), H, D), dtype=bf16, device="cuda")
        args = (q, pool, dev["tables"], dev["ctx"], layer)
        kw = ({"plan": k3.split_plan(max(lens), len(spans), KH)}
              if hasattr(k3, "split_plan") else {})
        times[label] = smoke.time_ms(torch, lambda: k3.paged_decode_attention(
            *args, **kw), 20)

    mixed = [(0, 512, 512), (3, 700, 1200), (7, 300, 300), (9, 1, 1)]
    mixed += [(s, 1, int(rng.integers(1, 2048)))
              for s in range(10, S) if s % 5]
    k2_time("K2 mixed stream", sorted(mixed))
    k2_time("K2 4 x 512 prefill-only", [(s, 512, 512) for s in range(4)])
    k3_time("K3 B=64, ctx up to 2k", [0 if b % 9 == 0 else
                                      int(rng.integers(1, 2049))
                                      for b in range(S)])
    k3_time("K3 B=64, ctx 130-170", [int(rng.integers(130, 171))
                                     for _ in range(S)])
    k3_time("K3 B=4, ctx 8192", [8192, 8192, 8000, 8192])
    chunks, P_S = [(0, 512), (700, 512), (0, 300), None], 512
    pool, dev = smoke.make_prefill_batch(rng, chunks, P_S, M, bs, 2 * KH, D,
                                         bf16, torch, layer=layer)
    q = torch.randn((len(chunks), P_S, H, D), dtype=bf16, device="cuda")
    kargs = (q, pool, dev["tables"], dev["q_starts"], dev["ctx"], layer)
    times["K4 mixed batch"] = smoke.time_ms(
        torch, lambda: k4.paged_prefill_attention(*kargs), 50)
    print(json.dumps({"card": card, "label": a.label or str(root),
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Measure, on the card, the library calls the port's int8 path rests on,
at mixtral-8x7b's shapes: cuBLAS's int8 GEMM (``torch._int_mm``) with the
weight row-major and column-major beside a bf16 GEMM of the same shape;
the row counts the int8 GEMM accepts against each layout; and the
PyTorch ways to dequantize an int8 weight into bf16.

    python3 scripts/int8_gemm_probe.py

Times are device time (``chip_smoke.time_ms``: a CUDA graph of many
launches between one pair of events). Prints one JSON line with the card's
name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent

# (K, N) of Mixtral's expert up/gate, expert down and LM head products
SHAPES = ((4096, 14336), (14336, 4096), (4096, 32000))
ROWS = (32, 64, 256, 2048)
ROW_RULE = (1, 8, 16, 17, 24, 32, 40, 48, 64, 72, 96)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int8_gemm_probe.py: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    gemm = []
    for K, N in SHAPES:
        w_rm = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev,
                             generator=g)
        w_cm = w_rm.t().contiguous().t()
        wb = torch.randn(K, N, dtype=torch.bfloat16, device=dev, generator=g)
        for M in ROWS:
            x = torch.randint(-127, 128, (M, K), dtype=torch.int8,
                              device=dev, generator=g)
            xb = torch.randn(M, K, dtype=torch.bfloat16, device=dev,
                             generator=g)
            want = x.double() @ w_rm.double()
            rec = {"K": K, "N": N, "M": M}
            for name, w in (("row_major", w_rm), ("col_major", w_cm)):
                if not torch.equal(torch._int_mm(x, w).double(), want):
                    raise AssertionError(f"int8 GEMM {name} wrong at "
                                         f"{(M, K, N)}")
                rec[f"int8_{name}_ms"] = smoke.time_ms(
                    torch, lambda x=x, w=w: torch._int_mm(x, w), 50)
            rec["bf16_ms"] = smoke.time_ms(torch, lambda: xb @ wb, 50)
            gemm.append(rec)
    accepted = {"row_major": [], "col_major": []}
    w = torch.randint(-127, 128, (64, 40), dtype=torch.int8, device=dev,
                      generator=g)
    for M in ROW_RULE:
        x = torch.randint(-127, 128, (M, 64), dtype=torch.int8, device=dev,
                          generator=g)
        for name, layout in (("row_major", w), ("col_major",
                                               w.t().contiguous().t())):
            try:
                torch._int_mm(x, layout)
                torch.cuda.synchronize()
                accepted[name].append(M)
            except RuntimeError:
                pass
    q = torch.randint(-127, 128, (14336, 4096), dtype=torch.int8,
                      device=dev, generator=g).t()  # (4096, 14336), col-major
    s = torch.rand(1, 14336, device=dev, generator=g)
    out = torch.empty_like(q, dtype=torch.bfloat16)
    dequant = {
        "mul_into_bf16_ms": smoke.time_ms(
            torch, lambda: torch.mul(q, s, out=out), 50),
        "mul_then_cast_ms": smoke.time_ms(
            torch, lambda: (q * s).to(torch.bfloat16), 50),
        "int8_to_bf16_copy_ms": smoke.time_ms(
            torch, lambda: out.copy_(q), 50),
        "elements": q.numel(),
    }
    print(json.dumps({"card": card, "int8_gemm": gemm,
                      "rows_accepted": accepted, "dequant": dequant}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

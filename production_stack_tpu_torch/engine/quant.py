"""int8 quantization of the serving forward pass.

A copy of production_stack_tpu/engine/quant.py's arithmetic on torch
tensors:

- **weights**: per-output-channel symmetric int8, the scale taken over
  the contracted axes when the parameters are made or loaded
  (``quantize_params``). The scale keeps those axes as size-1 dims, so
  it broadcasts straight onto the product's output, the MoE expert stacks
  included. A quantized weight is a plain dict ``{"q": int8, "s":
  float32}``.
- **activations**: dynamic per-token symmetric int8 (absmax over the
  contracted axes), below ``_a16_threshold()`` tokens (W8A8): int8 x int8
  -> int32, rescaled in float32 by the activation scale times the weight
  scale. At or above it (W8A16) the activations stay in the model dtype
  and the weights are dequantized (q * s in float32, rounded once into the
  model dtype) a tile at a time.

The W8A8 product is ``torch._int_mm``: cuBLAS's int8 GEMM on the card,
the counterpart of XLA's int8 dot, which the reference computes outside
any Pallas kernel. On the card it needs more than 16 rows and both other
dims multiples of 8: rows are padded up, and any other shape raises; it
never falls back to W8A16. Norms, biases, the MoE router and the LoRA
bank stay in the model dtype.

Which route a product takes is decided by the token count the reference's
same call sees (``tokens``), not by the rows this eager engine happens to
run: see ``models/llama.py`` ``forward_hidden``.

**Row-parallel products** (tensor parallelism: the contracted axes of x
and w are this rank's cut of them, ``group`` the ranks' RankGroup) sum
what the reference's GSPMD sums. On the W8A8 route each row's activation
scale is the max over the ranks of each rank's absmax (an all-reduce
max of one float32 a row), so every rank quantizes its slice of the row
as one device quantizes the whole row; the int32 partials are summed
over the ranks in int32, exactly, before the one rescale. On the W8A16
route and for a plain weight the partial is accumulated in float32 and
summed in float32 before the one rounding (``row_parallel_matmul``).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
from typing import Any, Optional, Tuple

import torch

_EPS = 1e-8
# The reference divides by 127.0 inside jitted programs, where XLA turns a
# division by a constant into a product with its float32 reciprocal: the
# port multiplies by the same reciprocal, so scales and int8 values come
# out bit for bit
_INV127 = 1.0 / 127.0

# the elements of the weight tile a W8A16 product dequantizes at a time
# (128 MB in bf16: one Mixtral expert's matrix, 58.7 M elements, fits in
# one; a whole (X, E, F) stack would be 0.9 GB)
DEQUANT_TILE_ELEMS = 1 << 26

# profiler ranges round the int8 work (``profile_range``), off unless a
# profile asks for them: a range costs a few microseconds of host time
PROFILE_RANGES = False

# torch._int_mm on CUDA (H100): K and N multiples of 8; at least 17 rows
# against a column-major weight, a multiple of 32 against a row-major one
_INT_MM_MIN_ROWS = 17
_INT_MM_ROW_MAJOR_ROWS = 32
_INT_MM_ALIGN = 8


def _a16_threshold() -> int:
    """Token count at or above which a quantized product runs W8A16.
    ``PSTPU_QUANT_A16_THRESHOLD`` overrides the default 512, parsed as the
    reference parses it; values <= 0 disable W8A16."""
    raw = os.environ.get("PSTPU_QUANT_A16_THRESHOLD", "512")
    try:
        val = int(float(raw))
    except ValueError:
        logging.getLogger(__name__).warning(
            "unparseable PSTPU_QUANT_A16_THRESHOLD=%r; using 512", raw)
        return 512
    return max(val, 0)


def profile_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while
    ``PROFILE_RANGES`` is set, else a no-op context: the device time of
    the kernels launched inside reads as that range's in a trace."""
    if PROFILE_RANGES:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def quantize_array(w: torch.Tensor, contract_axes: Tuple[int, ...]) -> dict:
    """Symmetric int8 over ``contract_axes`` (the product's contracted
    dims), with the scale keeping them as size-1 dims. Rounds half to
    even, as ``jnp.round`` does. q is laid out by ``empty_q``."""
    wf = w.float()
    s = wf.abs().amax(dim=tuple(contract_axes), keepdim=True)
    s = torch.clamp(s, min=_EPS) * _INV127
    q = empty_q(w.shape, contract_axes, w.device)
    q.copy_(torch.clamp(torch.round(wf / s), -127, 127))
    return {"q": q, "s": s}


def empty_q(shape, contract_axes: Tuple[int, ...], device) -> torch.Tensor:
    """An int8 tensor of ``shape`` whose contracted axes vary fastest in
    memory: each product's (K, N) view of it is column-major, the layout
    in which cuBLAS's int8 GEMM runs 4-8x faster than row-major (H100).
    The embedding (V, E), contracted over E, stays row-major."""
    order = ([i for i in range(len(shape)) if i not in contract_axes]
             + list(contract_axes))
    store = torch.empty([shape[i] for i in order], dtype=torch.int8,
                        device=device)
    return store.permute([order.index(i) for i in range(len(shape))])


def scale_axes(w: dict) -> Tuple[int, ...]:
    """The contracted axes of a quantized weight (torch or numpy): where
    its scale keeps a size-1 dim and q does not."""
    return tuple(i for i, (ns, nq) in enumerate(zip(w["s"].shape,
                                                    w["q"].shape))
                 if ns == 1 and nq != 1)


def dequantize_array(w: dict) -> torch.Tensor:
    return w["q"].float() * w["s"]


def a16(tokens: int) -> bool:
    """Whether a quantized product over ``tokens`` rows runs W8A16."""
    thresh = _a16_threshold()
    return bool(thresh) and tokens >= thresh


def quantize_rows(x: torch.Tensor, group=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token int8 of ``x (M, K)``: (xq (M, K) int8, sx (M,) float32),
    the reference's activation arithmetic (absmax / 127, floored at
    ``_EPS``). With a ``group`` whose ranks each hold a slice of K, the
    absmax is the max over the ranks (module docstring): the tensor
    group, never the expert ranks, which each hold whole rows of their
    own experts' slots."""
    with profile_range("quant.activations"):
        xf = x.float()
        amax = torch.linalg.vector_norm(xf, ord=float("inf"), dim=-1)
        if group is not None:
            amax = group.all_reduce_max(amax)
        sx = amax.mul_(_INV127).clamp_(min=_EPS)
        xq = torch.div(xf, sx[:, None]).round_().clamp_(-127, 127).to(
            torch.int8)
    return xq, sx


def int8_mm(xq: torch.Tensor, wq: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (M, N) by ``torch._int_mm``,
    into ``out`` when given. On the card K and N must be multiples of 8,
    else this raises, and cuBLAS refuses some row counts (H100): fewer
    than 17 against any weight, and any but a multiple of 32 against a
    row-major one. M is padded to what the weight's layout takes (the
    port lays weights out column-major, ``empty_q``)."""
    M, K = xq.shape
    N = wq.shape[1]
    with profile_range("quant.int8_gemm"):
        if xq.is_cuda:
            if K % _INT_MM_ALIGN or N % _INT_MM_ALIGN:
                raise ValueError(
                    f"int8 product ({M}, {K}) x ({K}, {N}): cuBLAS's int8 "
                    f"GEMM needs K and N multiples of {_INT_MM_ALIGN}")
            if wq.stride(0) == 1:  # column-major
                padded = max(M, _INT_MM_MIN_ROWS)
            else:
                padded = -(-M // _INT_MM_ROW_MAJOR_ROWS) * _INT_MM_ROW_MAJOR_ROWS
            if padded != M:
                xq = torch.cat([xq, xq.new_zeros(padded - M, K)])
                acc = torch._int_mm(xq, wq)[:M]
                return acc if out is None else out.copy_(acc)
        xq = xq.contiguous()
        if out is None:
            return torch._int_mm(xq, wq)
        return torch._int_mm(xq, wq, out=out)


def rescale(acc: torch.Tensor, sx: torch.Tensor, s: torch.Tensor,
            out_dtype) -> torch.Tensor:
    """The int32 product back to ``out_dtype``: acc * sx * s in float32,
    in the reference's order, rounded once. ``sx`` has acc's leading
    dims (one scale a row), ``s`` broadcasts from the right."""
    scaled = torch.mul(acc, sx[..., None])  # int32 x float32 -> float32
    return torch.mul(scaled, s, out=torch.empty_like(scaled,
                                                      dtype=out_dtype))


def _w8a8(x2: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor,
          out_dtype, x8=None, group=None) -> torch.Tensor:
    """x2 (M, K) in the model dtype, q2 (K, N) int8, s2 (1, N) float32;
    ``x8`` is x2's ``quantize_rows`` when the caller has it already. With
    a ``group``, K is cut over its ranks (module docstring)."""
    xq, sx = quantize_rows(x2, group) if x8 is None else x8
    acc = int8_mm(xq, q2)
    if group is not None:
        acc = group.all_reduce_int32(acc)
    return rescale(acc, sx, s2, out_dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-d, or batched 3-d) accumulated and returned in
    float32 whatever the inputs' dtype: a row-parallel partial, summed
    over the ranks before its one rounding."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        fn = torch.mm if a.dim() == 2 else torch.bmm
        return fn(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _w8a16(x2: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor,
           out_dtype, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x2 (M, K) @ dequantized (K, N), a column tile at a time, into
    ``out`` when given: each tile is q * s in float32, rounded once into
    the activations' dtype. A float32 ``out_dtype`` under activations of
    another dtype is a row-parallel partial, accumulated and kept in
    float32."""
    K, N = q2.shape
    step = max(DEQUANT_TILE_ELEMS // K, _INT_MM_ALIGN)
    if out is None:
        out = torch.empty(x2.shape[0], N, dtype=out_dtype, device=x2.device)
    for j in range(0, N, step):
        wd = dequantize_tile(q2[:, j:j + step], s2[:, j:j + step], x2.dtype)
        dst = out[:, j:j + step]
        if dst.dtype == torch.float32 and x2.dtype != torch.float32:
            dst.copy_(matmul_f32(x2, wd))
        elif dst.is_contiguous() and dst.dtype == x2.dtype:
            torch.mm(x2, wd, out=dst)
        else:
            dst.copy_(x2 @ wd)
    return out


def dequantize_tile(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """q * s computed in float32 (int8 times float32 promotes to it) and
    rounded once into ``dtype``, in one pass: the product is stored
    straight into a ``dtype`` tensor laid out as q is."""
    with profile_range("quant.dequantize"):
        return torch.mul(q, s, out=torch.empty_like(q, dtype=dtype))


def _weight_2d(w: Any, n_contract: int):
    """A weight of shape (*contracted, *out) as (K, N) (and its scale as
    (1, N) when quantized)."""
    if not is_quantized(w):
        return w.reshape(-1, *w.shape[n_contract:]).flatten(1), None
    q = w["q"]
    K = 1
    for d in q.shape[:n_contract]:
        K *= d
    return q.reshape(K, -1), w["s"].reshape(1, -1)


def shared_rows(x: torch.Tensor, w: Any, n_contract: int = 1,
                tokens: Optional[int] = None):
    """``x``'s int8 rows for the W8A8 products that share ``x`` as input
    (q, k and v; gate and up), quantized once: ``quant_matmul``'s ``x8``.
    None where ``w`` is plain or the products run W8A16."""
    if not w8a8(x, w, n_contract, tokens):
        return None
    return quantize_rows(_rows(x, n_contract))


def _rows(x: torch.Tensor, n_contract: int) -> torch.Tensor:
    """``x (..., *c)`` as (M, K)."""
    return x.reshape(-1, *x.shape[x.dim() - n_contract:]).flatten(1)


def w8a8(x: torch.Tensor, w: Any, n_contract: int = 1,
         tokens: Optional[int] = None) -> bool:
    """Whether ``quant_matmul(x, w, n_contract, tokens=tokens)`` runs the
    int8 product."""
    if not is_quantized(w):
        return False
    rows = 1
    for d in x.shape[:x.dim() - n_contract]:
        rows *= d
    return not a16(rows if tokens is None else tokens)


def quant_matmul(x: torch.Tensor, w: Any, n_contract: int = 1,
                 out_dtype=None, tokens: Optional[int] = None,
                 x8=None) -> torch.Tensor:
    """``x (..., *c) @ w (*c, *out) -> (..., *out)``, contracting the last
    ``n_contract`` dims of ``x`` with the first of ``w``: the counterpart
    of the reference's ``quant_einsum`` on every unbatched form the model
    uses ("...te,ehd->...thd", "...thd,hde->...te", "...te,ef->...tf",
    "...tf,fe->...te", "...te,ev->...tv"). A plain ``w`` is a plain
    product. A quantized ``w`` runs W8A8 below ``_a16_threshold()``
    tokens and W8A16 at or above it, where ``tokens`` is the row count
    the reference's call sees (default: the rows of ``x``); ``x8`` is
    ``shared_rows(x, ...)`` where several products share ``x``. W8A16
    rounds into ``x``'s dtype before ``out_dtype``, as the reference's
    dequantized einsum does."""
    out_dtype = out_dtype if out_dtype is not None else x.dtype
    lead = x.shape[:x.dim() - n_contract]
    x2 = _rows(x, n_contract)
    w2, s2 = _weight_2d(w, n_contract)
    out_shape = (w["q"] if s2 is not None else w).shape[n_contract:]
    if s2 is None:
        y = (x2 @ w2).to(out_dtype)
    elif w8a8(x, w, n_contract, tokens):
        y = _w8a8(x2, w2, s2, out_dtype, x8)
    else:
        y = _w8a16(x2, w2, s2, x2.dtype).to(out_dtype)
    return y.reshape(*lead, *out_shape)


def row_parallel_matmul(x: torch.Tensor, w: Any, n_contract: int,
                        tokens: Optional[int], group,
                        delta: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``quant_matmul(x, w, n_contract, tokens=tokens)`` plus a LoRA
    ``delta``, in ``x``'s dtype, where the contracted axes of ``x`` and
    ``w`` are cut over ``group``'s ranks and ``delta`` is this rank's
    share: the sum over the ranks (module docstring). A float32 partial
    carries the delta in its one all-reduce; the W8A8 route's exact int32
    sum cannot carry a float, so there the delta is summed on its own, as
    the reference's separate einsum is."""
    lead = x.shape[:x.dim() - n_contract]
    x2 = _rows(x, n_contract)
    w2, s2 = _weight_2d(w, n_contract)
    out_shape = (w["q"] if s2 is not None else w).shape[n_contract:]
    if s2 is not None and w8a8(x, w, n_contract, tokens):
        y = _w8a8(x2, w2, s2, x.dtype, group=group).reshape(*lead, *out_shape)
        return y if delta is None else y + group.all_reduce(delta)
    part = (matmul_f32(x2, w2) if s2 is None
            else _w8a16(x2, w2, s2, torch.float32))
    part = part.reshape(*lead, *out_shape)
    if delta is not None:
        part = part + delta
    return group.all_reduce(part).to(x.dtype)


def _expert_sum(group, part: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """``part (X, C, N)`` (float32 or int32; X this rank's experts, all
    of them or an expert rank's share) summed over ``group``'s ranks,
    sending only ``rows`` (indices into the X C rows): the others are
    zero on every rank (unoccupied capacity rows, whose dispatched input
    is zero), so the sum is the whole one's. ``group`` is the tensor
    group, whose ranks hold the same experts."""
    reduce = (group.all_reduce_int32 if part.dtype == torch.int32
              else group.all_reduce)
    flat = part.flatten(0, 1)
    out = torch.zeros_like(flat)
    if rows.numel():  # every rank keeps the same slots, or none
        out[rows] = reduce(flat[rows])
    return out.view(part.shape)


def expert_matmul(xb: torch.Tensor, w: Any, out_dtype, *,
                  sx: Optional[torch.Tensor] = None,
                  group=None, rows: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The batched MoE forms "xce,xef->xcf" and "xcf,xfe->xce": ``xb (X,
    C, K)`` against the expert stack ``w (X, K, N)``, one expert at a
    time, X being the experts this rank holds (an expert rank's share
    under expert parallelism). A plain stack is a batched product. A quantized stack runs
    W8A16 when ``xb`` is in the model dtype (one expert's tiles
    dequantized at a time), and W8A8 when ``xb`` is int8 with its per-row
    scales ``sx (X, C)`` (the rows were quantized once, before dispatch:
    a copied row has its token's absmax). With a ``group``, K is cut over
    its ranks and the products are summed over them before the rounding
    to ``out_dtype``: in int32 on the W8A8 route (``sx`` must then be the
    max over the ranks already), in float32 otherwise. A ``group`` comes
    with ``rows``, the rows of ``xb`` that are not zero: only they are
    sent (``_expert_sum``)."""
    X, C = xb.shape[:2]
    if not is_quantized(w):
        if group is None:
            return torch.bmm(xb, w).to(out_dtype)
        return _expert_sum(group, matmul_f32(xb, w), rows).to(out_dtype)
    q, s = w["q"], w["s"]  # (X, K, N), (X, 1, N)
    if sx is None:
        part = torch.float32 if group is not None else out_dtype
        out = torch.empty(X, C, q.shape[-1], dtype=part, device=xb.device)
        for e in range(X):
            _w8a16(xb[e], q[e], s[e], part, out=out[e])
        return (out if group is None
                else _expert_sum(group, out, rows).to(out_dtype))
    # every expert's int32 product, then one rescale over the stack
    acc = torch.empty(X, C, q.shape[-1], dtype=torch.int32, device=xb.device)
    for e in range(X):
        int8_mm(xb[e], q[e], out=acc[e])
    if group is not None:
        acc = _expert_sum(group, acc, rows)
    return rescale(acc, sx, s, out_dtype)


def embed_lookup(embed: Any, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Token-embedding gather accepting a quantized table: the rows
    dequantize after the gather (one scale a row)."""
    idx = tokens.long()
    if not is_quantized(embed):
        return embed[idx].to(dtype)
    return (embed["q"][idx].float() * embed["s"][idx]).to(dtype)


def head_from_embed(embed: Any) -> Any:
    """The tied-embedding LM head (embed.T), keeping its quantization."""
    if not is_quantized(embed):
        return embed.t()
    return {"q": embed["q"].t(), "s": embed["s"].t()}


# contracted axes per weight, in the stacked (L, ...) layer layout
_LAYER_CONTRACT = {
    "wq": (1,),      # (L, E, H, D)  contract E
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),    # (L, H, D, E)  contract H, D
    "w_gate": (1,),  # (L, E, F)     contract E
    "w_up": (1,),
    "w_down": (1,),  # (L, F, E)     contract F
}
_MOE_CONTRACT = {
    "w_gate": (2,),  # (L, X, E, F)  contract E
    "w_up": (2,),
    "w_down": (2,),  # (L, X, F, E)  contract F
}
# the embedding (V, E) and the LM head (E, V), outside the layer stack
TOP_CONTRACT = {"embed": (1,), "lm_head": (0,)}


def contract_axes(cfg) -> dict:
    """Layer weight -> its contracted axes under ``cfg``'s architecture."""
    contract = dict(_LAYER_CONTRACT)
    if cfg.architecture == "mixtral" and cfg.num_experts > 0:
        contract.update(_MOE_CONTRACT)
    return contract


def params_quantized(params: dict) -> bool:
    return is_quantized(params.get("layers", {}).get("wq"))


def maybe_quantize(cfg, params: dict) -> dict:
    """Apply ``cfg.quant`` to a parameter dict: a no-op when off or when
    the dict is quantized already; any mode but "int8" raises."""
    if getattr(cfg, "quant", None) in (None, "", "none"):
        return params
    if cfg.quant != "int8":
        raise ValueError(f"unsupported quantization mode: {cfg.quant!r}")
    if params_quantized(params):
        return params
    return quantize_params(cfg, params)


def quantize_params(cfg, params: dict) -> dict:
    """Quantize the matmul weights of a parameter dict. Norms, QKV biases
    and the MoE router stay in the model dtype. Each stacked weight is
    quantized one layer at a time, so the float32 temporaries stay one
    layer's size."""
    layers = dict(params["layers"])
    for name, axes in contract_axes(cfg).items():
        if name in layers:
            layers[name] = quantize_stack(layers[name], axes)
    out = dict(params)
    out["layers"] = layers
    for name, axes in TOP_CONTRACT.items():
        if name in params:  # a tied model has no lm_head
            out[name] = quantize_array(params[name], axes)
    return out


def quantize_stack(w: torch.Tensor, axes: Tuple[int, ...]) -> dict:
    """``quantize_array(w, axes)`` for a stacked weight, one slice of its
    leading uncontracted dims (a layer; a layer's expert) at a time, into
    preallocated int8 and scale stacks: the float32 temporaries stay one
    slice's size."""
    out = empty_quantized(w.shape, axes, w.device)
    for idx in itertools.product(*(range(d) for d in w.shape[:min(axes)])):
        put_quantized(out, idx, w[idx], axes)
    return out


def empty_quantized(shape, axes: Tuple[int, ...], device) -> dict:
    """The int8 (``empty_q``) and float32 scale tensors of a quantized
    weight of ``shape``, contracted over ``axes``, to be filled by
    ``put_quantized``."""
    s_shape = tuple(1 if i in axes else d for i, d in enumerate(shape))
    return {"q": empty_q(shape, axes, device),
            "s": torch.empty(s_shape, dtype=torch.float32, device=device)}


def put_quantized(w: dict, idx: tuple, t: torch.Tensor,
                  axes: Tuple[int, ...], cut=None) -> None:
    """Quantize ``t``, the slice ``idx`` (leading indices) of a weight
    contracted over ``axes``, into ``w``; ``cut`` keeps a rank's part of
    the quantized slice (parallel/shardings.py ``Shard.cut_leaf``)."""
    one = quantize_array(t, tuple(a - len(idx) for a in axes))
    if cut is not None:
        one = cut(one)
    w["q"][idx] = one["q"]
    w["s"][idx] = one["s"]

"""Multi-LoRA adapter loading: the engine side of the reference's
LoraAdapter operator, which downloads adapters and POSTs
/v1/load_lora_adapter and /v1/unload_lora_adapter to each engine pod.

Ports production_stack_tpu/engine/lora.py. Adapters load UNMERGED into a
device bank (slot 0 = base model) and every token selects its adapter, so
one step freely mixes base and any adapters (models/llama.py
``_lora_delta``); under tensor parallelism each rank holds its share of
every adapter (``adapter_share``). The reference runs a tiny generation
after the first load, to compile its LoRA programs before traffic
arrives; this engine runs eager PyTorch and has no program to compile,
so loading stops at writing the bank.

Adapter format: an HF PEFT directory, ``adapter_config.json`` and
``adapter_model.safetensors`` with ``...layers.N.<module>.lora_A.weight``
(r, in) and ``lora_B.weight`` (out, r) tensors. The machines this package
targets need not have the ``safetensors`` package, so the file is read
here (``read_safetensors``).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from production_stack_tpu_torch.engine.config import ModelConfig

# PEFT target module -> the stacked parameter it adapts
_TARGETS = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}

_KEY_RE = re.compile(r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\.lora_(A|B)\.weight")

_SAFETENSORS_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2"}


class SafetensorsFile:
    """One ``.safetensors`` file, read a tensor at a time.

    The format: an 8-byte little-endian header length, a JSON header
    mapping each name to its dtype, shape and byte range, then the raw
    little-endian tensors. F32 and F16 keep their dtype; BF16 (which numpy
    lacks) comes back as float32, its 16 bits shifted into the top of a
    float32, which is exact. The data is memory-mapped, so ``get`` reads
    only the tensor it is asked for."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            n = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.header = header
        self._data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)

    def keys(self) -> list[str]:
        return list(self.header)

    def get(self, name: str) -> np.ndarray:
        meta = self.header[name]
        kind = _SAFETENSORS_DTYPES.get(meta["dtype"])
        if kind is None:
            raise ValueError(f"{self.path}: tensor {name!r} has dtype "
                             f"{meta['dtype']}; only F32, F16 and BF16 load")
        lo, hi = meta["data_offsets"]
        arr = np.frombuffer(self._data[lo:hi], dtype=kind)
        if meta["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr.reshape(meta["shape"]).copy()


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array
    (``SafetensorsFile``), read one at a time."""
    f = SafetensorsFile(path)
    return {name: f.get(name) for name in f.keys()}


def write_safetensors(path: str, tensors: dict[str, np.ndarray]) -> None:
    """Write float32 and float16 arrays in the format ``read_safetensors``
    reads (tensors in name order, packed back to back), for tools and
    tests that make adapters on a machine without the package."""
    names = sorted(tensors)
    kinds = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16"}
    header, offset = {}, 0
    for name in names:
        arr = tensors[name]
        if arr.dtype not in kinds:
            raise ValueError(f"{name}: dtype {arr.dtype}; write float32 or "
                             "float16")
        header[name] = {"dtype": kinds[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in names:
            f.write(np.ascontiguousarray(
                tensors[name], tensors[name].dtype.newbyteorder("<")).tobytes())


def target_shapes(cfg: ModelConfig) -> dict:
    """Each adaptable parameter -> (input width, output shape)."""
    H, KH, D, E, F = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.hidden_size, cfg.intermediate_size)
    return {"wq": (E, (H, D)), "wk": (E, (KH, D)), "wv": (E, (KH, D)),
            "wo": (H * D, (E,)), "w_gate": (E, (F,)), "w_up": (E, (F,)),
            "w_down": (F, (E,))}


def adapter_share(bank: dict, shard, cfg: ModelConfig) -> dict:
    """A tensor-parallel rank's share of ``load_adapter_raw``'s bank, as
    contiguous copies (parallel/shardings.py ``Shard.cut_lora``): A cut
    along its input where the target's input is sharded (``wo``,
    ``w_down``), B along its output where the target's output is (``wq``,
    ``wk``, ``wv``, ``w_gate``, ``w_up``). A row-parallel target's delta
    ``(x_r @ A_r) @ B`` is then this rank's share of ``(x @ A) @ B``."""
    ins = {"wo": (cfg.num_heads, cfg.head_dim)}
    out = {}
    for target, (A, B) in bank.items():
        a, b = shard.cut_lora(target, A, B,
                              ins.get(target, (A.shape[1],)))
        out[target] = (np.ascontiguousarray(a), np.ascontiguousarray(b))
    return out


def layer_share(share: dict, layers: range) -> dict:
    """A pipeline stage's cut of an adapter share (``load_adapter_raw``'s
    or ``adapter_share``'s stacked pairs): its layers ``layers``."""
    return {target: (A[layers.start:layers.stop], B[layers.start:layers.stop])
            for target, (A, B) in share.items()}


def bank_bytes(cfg: ModelConfig, max_loras: int, max_rank: int,
               itemsize: int) -> int:
    """Device memory of a full bank: every target, every slot."""
    per = sum(i + int(np.prod(o)) for i, o in target_shapes(cfg).values())
    return cfg.num_layers * max_loras * max_rank * per * itemsize


def load_adapter_raw(name: str, path: str, cfg: ModelConfig,
                     max_rank: int) -> dict:
    """Load a PEFT adapter as raw (A, B) pairs in this package's
    orientations, stacked per layer and rank-padded for the bank:
    target -> (A (L, in, Rmax), B (L, Rmax, *out)), float32, with
    ``lora_alpha / r`` folded into B."""
    cfg_path = os.path.join(path, "adapter_config.json")
    scaling = 1.0
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            acfg = json.load(f)
        r = acfg.get("r", 8)
        scaling = acfg.get("lora_alpha", r) / max(r, 1)

    out_shapes = {k: o for k, (_, o) in target_shapes(cfg).items()}
    pairs: dict[tuple[int, str], dict[str, np.ndarray]] = {}
    tensors = read_safetensors(os.path.join(path, "adapter_model.safetensors"))
    for key, arr in tensors.items():
        m = _KEY_RE.search(key)
        if not m:
            continue
        layer, module, ab = int(m.group(1)), m.group(2), m.group(3)
        if module not in _TARGETS:
            continue
        pairs.setdefault((layer, module), {})[ab] = arr

    per_target: dict[str, dict[int, tuple[np.ndarray, np.ndarray]]] = {}
    for (layer, module), ab in pairs.items():
        if "A" not in ab or "B" not in ab:
            continue
        A = ab["A"].astype(np.float32).T  # (in, r)
        r = A.shape[1]
        if r > max_rank:
            raise ValueError(
                f"adapter rank {r} exceeds max_lora_rank {max_rank}"
            )
        B = ab["B"].astype(np.float32).T * scaling  # (r, out_flat)
        per_target.setdefault(_TARGETS[module], {})[layer] = (A, B)

    if not per_target:
        raise ValueError(f"adapter at {path!r} has no supported LoRA targets")

    bank: dict = {}
    for our_key, by_layer in per_target.items():
        in_dim = next(iter(by_layer.values()))[0].shape[0]
        out = out_shapes[our_key]
        A_st = np.zeros((cfg.num_layers, in_dim, max_rank), np.float32)
        B_st = np.zeros((cfg.num_layers, max_rank, *out), np.float32)
        for layer, (A, B) in by_layer.items():
            r = A.shape[1]
            A_st[layer, :, :r] = A
            B_st[layer, :r] = B.reshape(r, *out)
        bank[our_key] = (A_st, B_st)
    return bank


class LoraManager:
    """Multi-LoRA bank: adapters occupy slots 1..max_loras-1 of the device
    bank (slot 0 = zeros = base model); any mix of adapters and base
    requests serves in one step."""

    def __init__(self, engine):
        self.engine = engine
        self.max_loras = engine.config.max_loras
        self.max_rank = engine.config.max_lora_rank
        self.slots: dict[str, int] = {}  # adapter name -> slot

    def list_adapters(self) -> list[str]:
        return sorted(self.slots)

    def slot_of(self, name: str) -> int:
        return self.slots.get(name, 0)

    def load(self, name: str, path: str) -> None:
        if name in self.slots:
            return
        used = set(self.slots.values())
        free = [i for i in range(1, self.max_loras) if i not in used]
        if not free:
            raise RuntimeError(
                f"all {self.max_loras - 1} adapter slots in use; unload one"
            )
        bank = load_adapter_raw(name, path, self.engine.config.model,
                                self.max_rank)
        slot = free[0]
        self.engine.runner.register_lora(slot, bank)
        self.slots[name] = slot

    def unload(self, name: str) -> bool:
        slot = self.slots.pop(name, None)
        if slot is None:
            return False
        self.engine.runner.unregister_lora(slot)
        return True

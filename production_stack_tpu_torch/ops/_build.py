"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``. Libraries go to ``production_stack_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name that carries a hash of the sources and
flags, so an edited source is never served from a stale build. Nothing is
compiled when this module is imported: ``load`` builds on first use, and
``build_all`` starts one ``nvcc`` per source, all at once.

Only the sources under ``csrc/`` are compiled. A build that fails raises;
there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("kv_write", "ragged_paged_attention", "paged_decode_attention",
           "paged_prefill_attention")
# head dims the attention kernels are instantiated for (with_head_dim in
# csrc/paged_attention_common.cuh): every head dim of MODEL_PRESETS
HEAD_DIMS = (32, 48, 64, 96, 128, 256)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_launchers: dict[str, "ctypes._CFuncPtr"] = {}
_lock = threading.Lock()


class LaunchCounter:
    """Launches of one kernel since the last reset. A wrapper adds one
    where it launches its kernel and nowhere else, so a run can show that
    its main path went through the kernel. A wrapper called while a CUDA
    graph is captured launches nothing: the graph cache
    (engine/step_graphs.py) takes back what the capture added
    (``launch_counts``, ``restore_counts``) and adds it at every replay."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        COUNTERS.append(self)


# every kernel's counter, in the order the wrappers were imported
COUNTERS: list[LaunchCounter] = []


def launch_counts() -> dict[LaunchCounter, int]:
    return {c: c.n for c in COUNTERS}


def restore_counts(counts: dict[LaunchCounter, int]) -> dict:
    """Set each counter back to ``counts``; returns what each had gained
    since (the counters that gained nothing are left out)."""
    gained = {c: c.n - n for c, n in counts.items() if c.n != n}
    for c, n in counts.items():
        c.n = n
    return gained


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin): the "
            "CUDA kernels cannot be built"
        )
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen]:
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = BUILD_DIR / f"{name}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=f, stderr=subprocess.STDOUT,
        )
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen) -> None:
    rc = proc.wait()
    log = BUILD_DIR / f"{name}.log"
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {rc}):\n{log.read_text()}"
        )
    os.replace(tmp, out)


def build_all(names=SOURCES) -> float:
    """Compile every named source that has no current build, one nvcc per
    source, all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [(n, *_start(n)) for n in names if not _lib_path(n).exists()]
        errors = []
        for name, out, tmp, proc in jobs:
            try:
                _finish(name, out, tmp, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all((name,))
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(path))
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return _libs[name]


def launcher(name: str, argtypes: list) -> "ctypes._CFuncPtr":
    """``<name>_launch`` of ``csrc/<name>.cu``, its argument types set once
    when first asked for. Pointers are ``c_void_p``: a bare Python int
    would be cut to 32 bits."""
    fn = _launchers.get(name)
    if fn is None:
        fn = getattr(load(name), f"{name}_launch")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _launchers[name] = fn
    return fn


def check(name: str, rc: int, what: str) -> None:
    """Raise when a launcher returned a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        msg = load(name).kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}): {msg}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(
            f"kernels take float32 or bfloat16 tensors, got {t.dtype}"
        )
    return DTYPE_CODES[name]


def require_head_dim(what: str, head_dim: int) -> None:
    """Refuse a head dim the attention kernels have no instantiation for,
    before anything is launched."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(
            f"{what}: head_dim {head_dim} has no kernel instantiation "
            f"(built for {HEAD_DIMS}, csrc/paged_attention_common.cuh)"
        )


def require_cuda(what: str, *tensors) -> None:
    """Every tensor lies on one CUDA device and is contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def require_int32(what: str, *tensors) -> None:
    import torch

    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: index tensors must be int32, got {t.dtype}")


def require_aligned(what: str, *tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensor data must be 16-byte aligned")

"""The port stands alone: it imports neither JAX nor the JAX package.

A fresh interpreter imports the server module (the package's widest entry
point); the test's own process cannot check this, because this suite's
conftest imports JAX for every test. A static scan of every file in the
package checks the same for modules the server does not load. Note that
``production_stack_tpu_torch`` starts with ``production_stack_tpu``: the
checks compare whole dotted names. The modules of the surface the router
reads (metrics, perf accounting, lifecycle, canary goldens) also load
neither ``prometheus_client`` nor ``aiohttp``, which the card's machine
lacks. The model-side modules (quantization, the weights loader, the
model with its MoE block) load neither JAX nor the ``safetensors``
package, which the card's machine also lacks. The KV plane (the transfer
frames, the host and remote tiers, the remote KV server, and the engine
and server that drive them) loads none of JAX, ``aiohttp``, ``requests``
or ``prometheus_client``. The dense scoring path (the attention op, the
runner and the engine that pad and run it) loads neither JAX nor the JAX
package's attention module it ports. The Whisper path (the model, the audio
front end, the runner and its stdlib server) loads none of JAX, the JAX
package, ``aiohttp``, ``prometheus_client`` or ``safetensors``. The
resilience, overload and tenant planes (``tenancy.py``,
``engine/overload.py``, ``testing/faults.py``, whose reference modules load
without JAX and, for the faults, with ``aiohttp``) load none of JAX, the
JAX package or ``aiohttp``: ``production_stack_tpu_torch.testing`` is the
port's own, ``production_stack_tpu.testing`` is forbidden. Ring attention
(``parallel/ring_attention.py``) loads neither JAX nor the JAX package's
ring attention module it ports. The stage x tensor grid's modules (the
relay, the stage runner, the mirrored calls, the entry points) load
neither JAX nor the JAX package.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "production_stack_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "production_stack_tpu")


def forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matches_whole_names_only():
    assert forbidden("production_stack_tpu")
    assert forbidden("production_stack_tpu.engine.config")
    assert forbidden("jax.numpy")
    assert not forbidden("production_stack_tpu_torch")
    assert not forbidden("production_stack_tpu_torch.engine")
    assert not forbidden("jaxtyping")


def test_server_import_loads_no_jax():
    code = (
        "import json, sys\n"
        "import production_stack_tpu_torch.engine.server\n"
        "import production_stack_tpu_torch.ops._build\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "production_stack_tpu_torch.engine.server" in mods
    assert [m for m in mods if forbidden(m)] == []


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_static_imports(path):
    bad = [m for m in _imports(path) if forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


SURFACE = ("production_stack_tpu_torch.engine.metrics",
           "production_stack_tpu_torch.engine.perf_accounting",
           "production_stack_tpu_torch.engine.lifecycle",
           "production_stack_tpu_torch.canary_golden",
           "production_stack_tpu_torch.engine.server")
LIBRARIES = ("prometheus_client", "aiohttp")


def test_surface_modules_load_no_jax_nor_http_libraries():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SURFACE!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(SURFACE) <= set(mods)
    bad = [m for m in mods if forbidden(m) or any(
        m == lib or m.startswith(lib + ".") for lib in LIBRARIES)]
    assert bad == []


@pytest.mark.parametrize("module", SURFACE)
def test_surface_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    bad = [m for m in _imports(path) if forbidden(m) or any(
        m == lib or m.startswith(lib + ".") for lib in LIBRARIES)]
    assert bad == [], f"{path.name} imports {bad}"


def test_chip_smoke_defines_each_name_once():
    """A later definition would shadow an earlier phase's helper of the
    same name: chip_smoke.py defines each top-level name once."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert sorted({n for n in names if names.count(n) > 1}) == []


MODEL_SIDE = ("production_stack_tpu_torch.engine.quant",
              "production_stack_tpu_torch.engine.weights",
              "production_stack_tpu_torch.engine.lora",
              "production_stack_tpu_torch.models.llama",
              "production_stack_tpu_torch.models.registry")


def test_model_side_modules_load_no_jax_nor_safetensors():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODEL_SIDE!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(MODEL_SIDE) <= set(mods)
    assert [m for m in mods if forbidden(m) or m == "safetensors"
            or m.startswith("safetensors.")] == []


@pytest.mark.parametrize("module", MODEL_SIDE)
def test_model_side_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    bad = [m for m in _imports(path) if forbidden(m)
           or m.split(".")[0] == "safetensors"]
    assert bad == [], f"{path.name} imports {bad}"


KV_PLANE = ("production_stack_tpu_torch.engine.kv_transfer",
            "production_stack_tpu_torch.engine.kv_offload",
            "production_stack_tpu_torch.kv_server",
            "production_stack_tpu_torch.engine.engine",
            "production_stack_tpu_torch.engine.server")
KV_LIBRARIES = ("aiohttp", "requests", "prometheus_client")


def _kv_bad(name: str) -> bool:
    return forbidden(name) or any(name == lib or name.startswith(lib + ".")
                                  for lib in KV_LIBRARIES)


def test_kv_plane_loads_no_jax_nor_http_libraries():
    code = (
        "import importlib, json, sys\n"
        f"for m in {KV_PLANE!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(KV_PLANE) <= set(mods)
    assert [m for m in mods if _kv_bad(m)] == []


@pytest.mark.parametrize("module", KV_PLANE)
def test_kv_plane_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    bad = [m for m in _imports(path) if _kv_bad(m)]
    assert bad == [], f"{path.name} imports {bad}"


def test_kv_bad_matches_whole_names_only():
    assert _kv_bad("requests") and _kv_bad("requests.adapters")
    assert _kv_bad("aiohttp.web") and _kv_bad("production_stack_tpu.kv_server")
    assert not _kv_bad("requests_toolbelt_like") and not _kv_bad(
        "production_stack_tpu_torch.kv_server")


SCORING = ("production_stack_tpu_torch.ops.attention",
           "production_stack_tpu_torch.engine.model_runner",
           "production_stack_tpu_torch.engine.engine")


def test_scoring_path_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SCORING!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(SCORING) <= set(mods)
    assert [m for m in mods if forbidden(m)] == []


@pytest.mark.parametrize("module", SCORING)
def test_scoring_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    bad = [m for m in _imports(path) if forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


WHISPER = ("production_stack_tpu_torch.models.whisper",
           "production_stack_tpu_torch.engine.audio",
           "production_stack_tpu_torch.engine.whisper_runner",
           "production_stack_tpu_torch.engine.whisper_server")


def _whisper_bad(name: str) -> bool:
    return forbidden(name) or any(
        name == lib or name.startswith(lib + ".")
        for lib in LIBRARIES + ("safetensors",))


def test_whisper_path_loads_no_jax_nor_http_libraries():
    code = (
        "import importlib, json, sys\n"
        f"for m in {WHISPER!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(WHISPER) <= set(mods)
    assert [m for m in mods if _whisper_bad(m)] == []


@pytest.mark.parametrize("module", WHISPER)
def test_whisper_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    bad = [m for m in _imports(path) if _whisper_bad(m)]
    assert bad == [], f"{path.name} imports {bad}"


RESILIENCE = ("production_stack_tpu_torch.tenancy",
              "production_stack_tpu_torch.engine.overload",
              "production_stack_tpu_torch.testing",
              "production_stack_tpu_torch.testing.faults")


def _resilience_bad(name: str) -> bool:
    return forbidden(name) or name == "aiohttp" or name.startswith(
        "aiohttp.")


def test_resilience_prefix_trap():
    assert _resilience_bad("production_stack_tpu.testing")
    assert _resilience_bad("production_stack_tpu.testing.faults")
    assert _resilience_bad("production_stack_tpu.tenancy")
    assert _resilience_bad("aiohttp.web")
    assert not _resilience_bad("production_stack_tpu_torch.testing")
    assert not _resilience_bad("production_stack_tpu_torch.testing.faults")
    assert not _resilience_bad("production_stack_tpu_torch.tenancy")


def test_resilience_modules_load_no_jax_nor_aiohttp():
    code = (
        "import importlib, json, sys\n"
        f"for m in {RESILIENCE!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(RESILIENCE) <= set(mods)
    assert [m for m in mods if _resilience_bad(m)] == []


@pytest.mark.parametrize("module", RESILIENCE[:2] + RESILIENCE[3:])
def test_resilience_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    bad = [m for m in _imports(path) if _resilience_bad(m)]
    assert bad == [], f"{path.name} imports {bad}"


TENSOR_PARALLEL = ("production_stack_tpu_torch.parallel",
                   "production_stack_tpu_torch.parallel.mesh",
                   "production_stack_tpu_torch.parallel.shardings",
                   "production_stack_tpu_torch.parallel.distributed",
                   "production_stack_tpu_torch.engine.multihost")


def test_tensor_parallel_prefix_trap():
    """The reference's modules of the same names are forbidden, the
    port's are not."""
    for name in TENSOR_PARALLEL:
        assert not forbidden(name)
        assert forbidden(name.replace("production_stack_tpu_torch",
                                      "production_stack_tpu"))


def test_tensor_parallel_modules_load_no_jax():
    """The rank plumbing (and a follower's entry point) loads neither JAX
    nor the JAX package's parallel or multihost modules."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {TENSOR_PARALLEL!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(TENSOR_PARALLEL) <= set(mods)
    assert [m for m in mods if forbidden(m)] == []


@pytest.mark.parametrize("module", TENSOR_PARALLEL)
def test_tensor_parallel_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    if path.with_suffix("").is_dir():
        path = path.with_suffix("") / "__init__.py"
    bad = [m for m in _imports(path) if forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


PIPELINE = ("production_stack_tpu_torch.parallel.pipeline",
            "production_stack_tpu_torch.engine.pp_runner")


def test_pipeline_prefix_trap():
    """The reference's modules of the same names are forbidden, the
    port's are not."""
    for name in PIPELINE:
        assert not forbidden(name)
        assert forbidden(name.replace("production_stack_tpu_torch",
                                      "production_stack_tpu"))


def test_pipeline_modules_load_no_jax():
    """The microbatch schedule and the staged runner load neither JAX nor
    the JAX package's pipeline or staged-runner modules."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {PIPELINE!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(PIPELINE) <= set(mods)
    assert [m for m in mods if forbidden(m)] == []


@pytest.mark.parametrize("module", PIPELINE)
def test_pipeline_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    bad = [m for m in _imports(path) if forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


RING = ("production_stack_tpu_torch.parallel.ring_attention",)


def test_ring_prefix_trap():
    """The reference's module of the same name is forbidden, the port's
    is not."""
    for name in RING:
        assert not forbidden(name)
        assert forbidden(name.replace("production_stack_tpu_torch",
                                      "production_stack_tpu"))


def test_ring_modules_load_no_jax():
    """Ring attention loads neither JAX nor the JAX package's ring
    attention module it ports."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {RING!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(RING) <= set(mods)
    assert [m for m in mods if forbidden(m)] == []


@pytest.mark.parametrize("module", RING)
def test_ring_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    bad = [m for m in _imports(path) if forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


MULTIHOST = ("production_stack_tpu_torch.engine.multihost",
             "production_stack_tpu_torch.parallel.distributed",
             "production_stack_tpu_torch.engine.engine",
             "production_stack_tpu_torch.engine.server",
             "production_stack_tpu_torch.testing.multihost_harness")


def test_multihost_prefix_trap():
    """The reference's modules of the same names (its channel, its
    topology, its harness) are forbidden, the port's are not."""
    for name in MULTIHOST:
        assert not forbidden(name)
        assert forbidden(name.replace("production_stack_tpu_torch",
                                      "production_stack_tpu"))


def test_multihost_modules_load_no_jax():
    """The multi-host control plane (the channel, the topology and the
    rendezvous, the engine and server that lead or follow, the harness)
    loads neither JAX nor the JAX package, whose channel module loads
    without JAX and is still not imported."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {MULTIHOST!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(MULTIHOST) <= set(mods)
    assert [m for m in mods if forbidden(m)] == []


@pytest.mark.parametrize("module", MULTIHOST)
def test_multihost_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    bad = [m for m in _imports(path) if forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


PP_TP = ("production_stack_tpu_torch.parallel.distributed",
         "production_stack_tpu_torch.parallel.mesh",
         "production_stack_tpu_torch.engine.pp_runner",
         "production_stack_tpu_torch.engine.multihost",
         "production_stack_tpu_torch.engine.model_runner",
         "production_stack_tpu_torch.engine.lora",
         "production_stack_tpu_torch.engine.perf_accounting",
         "production_stack_tpu_torch.engine.engine",
         "production_stack_tpu_torch.engine.server")


def test_pp_tp_prefix_trap():
    """The reference's modules of the same names (its staged runner, its
    mesh, its channel) are forbidden, the port's are not."""
    for name in PP_TP:
        assert not forbidden(name)
        assert forbidden(name.replace("production_stack_tpu_torch",
                                      "production_stack_tpu"))


def test_pp_tp_modules_load_no_jax():
    """The stage x tensor grid (the relay and the grid's views, the stage
    runner, the mirrored calls and KV parts, the entry points) loads
    neither JAX nor the JAX package."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {PP_TP!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(PP_TP) <= set(mods)
    assert [m for m in mods if forbidden(m)] == []


@pytest.mark.parametrize("module", PP_TP)
def test_pp_tp_static_imports(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    bad = [m for m in _imports(path) if forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"

"""Helpers of the port's multi-host tests (``test_torch_multihost*``):
free ports, the ``PSTPU_*`` environment of one process of a group, the
harness's processes started on their own, and a trap that fails a
process in which a pickling collective or a plain ``pickle.loads`` runs.

``trapped_harness`` is what each harness process runs (``python -c``):
it replaces ``torch.distributed``'s object collectives and
``pickle.loads``/``pickle.load`` with functions that record the call and
raise, runs the harness, and prints ``TRAP <json>``, the calls recorded,
on its way out.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OBJECT_COLLECTIVES = ("broadcast_object_list", "scatter_object_list",
                      "gather_object", "all_gather_object",
                      "send_object_list", "recv_object_list")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def group_env(process_id: int, coord: int, control: int, n: int = 2,
              secret: str = "test-secret") -> dict:
    """This environment with one process's ``PSTPU_*`` settings (no
    secret where ``secret`` is None)."""
    env = dict(os.environ)
    env.pop("PSTPU_CONTROL_SECRET", None)
    env.update({
        "PYTHONPATH": str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
        "PSTPU_COORDINATOR": f"127.0.0.1:{coord}",
        "PSTPU_NUM_PROCESSES": str(n),
        "PSTPU_PROCESS_ID": str(process_id),
        "PSTPU_CONTROL_PORT": str(control),
    })
    if secret is not None:
        env["PSTPU_CONTROL_SECRET"] = secret
    return env


def trapped_harness() -> None:
    """A harness process (its flags in ``sys.argv[1:]``) under the trap
    (module docstring)."""
    import pickle

    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d

    calls = []

    def trap(name):
        def trapped(*a, **kw):
            calls.append(name)
            raise AssertionError(f"{name} ran in a multi-host process")
        return trapped

    for name in OBJECT_COLLECTIVES:
        for mod in (dist, c10d):
            if hasattr(mod, name):
                setattr(mod, name, trap(f"torch.distributed.{name}"))
    pickle.loads = trap("pickle.loads")
    pickle.load = trap("pickle.load")
    from production_stack_tpu_torch.testing import multihost_harness

    try:
        multihost_harness.main(sys.argv[1:])
    finally:
        print("TRAP " + json.dumps(calls), flush=True)


def start_harness(process_id: int, coord: int, control: int, args=(),
                  secret: str = "test-secret", n: int = 2,
                  device: str = "cpu") -> subprocess.Popen:
    """One harness process of ``n`` on ``device`` under the trap, its
    output piped."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import _torch_multihost; _torch_multihost.trapped_harness()")
    return subprocess.Popen(
        [sys.executable, "-c", code, "--device", device, *args], cwd=ROOT,
        env=group_env(process_id, coord, control, n, secret=secret),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def line(out: str, prefix: str):
    """The JSON after ``prefix`` on its line of ``out``."""
    for ln in out.splitlines():
        if ln.startswith(prefix + " "):
            return json.loads(ln[len(prefix) + 1:])
    raise AssertionError(f"no {prefix} line in:\n{out[-3000:]}")


def run_pair(args=(), timeout: float = 90, n: int = 2,
             device: str = "cpu") -> tuple:
    """The harness as a leader and ``n - 1`` followers started on their
    own, each on ``device``: (the leader's return code and output, the
    first follower's); a further follower that fails raises."""
    coord, control = free_port(), free_port()
    procs = [start_harness(i, coord, control, args, n=n, device=device)
             for i in range(n - 1, -1, -1)][::-1]
    outs = []
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout if i == 0 else 30)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out in outs[2:]:
        assert rc == 0 and "FOLLOWER DONE" in out, out[-3000:]
    return outs[0], outs[1]

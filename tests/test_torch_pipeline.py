"""Pipeline parallelism's microbatch schedule: the port's
``pipelined_forward`` against the JAX package's on the same numpy inputs,
the port's counterpart of ``tests/test_pipeline.py``. Four stages must
equal the sequential run of all layers, and one stage degenerates to it;
both equal the JAX schedule within float32 noise (rtol = atol = 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.jax_compat import set_mesh
from production_stack_tpu.parallel import pipeline as jpipe
from production_stack_tpu.parallel.mesh import MeshConfig, build_mesh
from production_stack_tpu_torch.parallel import pipeline as tpipe

TOL = dict(rtol=2e-5, atol=2e-5)


def jax_layer(lp, h):
    return h + jnp.tanh(h @ lp["w"] + lp["b"])


def torch_layer(lp, h):
    return h + torch.tanh(h @ lp["w"] + lp["b"])


def _inputs(seed, L, E, M, mb, bias=True):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, E, E)) * 0.1).astype(np.float32)
    b = ((rng.standard_normal((L, E)) * 0.1) if bias
         else np.zeros((L, E))).astype(np.float32)
    x = rng.standard_normal((M, mb, E)).astype(np.float32)
    return {"w": w, "b": b}, x


@pytest.mark.parametrize("S,seed,L,E,M,mb,bias,tensor", [
    (4, 0, 8, 16, 6, 4, True, 2),
    (1, 1, 4, 8, 2, 3, False, 1)], ids=["4-stages", "1-stage"])
def test_pipelined_matches_sequential_and_jax(S, seed, L, E, M, mb, bias,
                                              tensor):
    params, x = _inputs(seed, L, E, M, mb, bias)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    got = tpipe.pipelined_forward(
        torch_layer, tpipe.split_layers_into_stages(tparams, S),
        torch.from_numpy(x), ["cpu"] * S)
    h = torch.from_numpy(x)
    for i in range(L):
        h = torch_layer({k: v[i] for k, v in tparams.items()}, h)
    np.testing.assert_allclose(got.numpy(), h.numpy(), **TOL)

    mesh = build_mesh(MeshConfig(data=1, stage=S, tensor=tensor))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    with set_mesh(mesh):
        want = jax.jit(lambda p, xx: jpipe.pipelined_forward(
            jax_layer, p, xx, mesh, "stage"))(
                jpipe.split_layers_into_stages(jparams, S), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_uneven_split_is_refused():
    with pytest.raises(ValueError, match="6 layers not divisible by 4"):
        tpipe.split_layers_into_stages({"w": torch.zeros(6, 2)}, 4)

"""buctd_tpu_torch transcendental throughput (K6) on the CPU: the plain chain
of each variant against tools/bench_exp2.py::_kernel, built here as a
``pallas_call`` in interpret mode at a small (8, 128) tile and chained OUTER
times as the tool's ``make`` does.  tools/bench_exp2.py is imported by path
and not edited.

Tolerance: rtol 1e-6.  The full chain contracts (d/dy op(0.03 y) is about
0.03 near y = 1.03), so each element ends within a few f32 ulps of the other
side whatever the exp routine's last bit, and whatever the input: 1, 2 and 3
steps on inputs over [-100, 100] are checked as well, where the input and the
step count still show.  The CUDA kernel is held against the
plain version on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.
"""

import functools
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from buctd_tpu_torch.ops import exp_throughput as ex
from test_torch_port_config import REPO


def _bench_exp2():
    spec = importlib.util.spec_from_file_location("bench_exp2", REPO / "tools" / "bench_exp2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_call(bench, variant, inner):
    """The tool's kernel at an (8, 128) tile in interpret mode, ``inner``
    steps a call (the tool's module global, read when the kernel is traced)."""
    from jax.experimental import pallas as pl

    bench.INNER = inner
    return pl.pallas_call(functools.partial(bench._kernel, bench.VARIANTS[variant]),
                          out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                          interpret=True)


@pytest.mark.parametrize("variant", list(ex.VARIANTS))
def test_plain_chain_matches_pallas_kernel(variant):
    bench = _bench_exp2()
    assert bench.INNER == ex.INNER and list(bench.VARIANTS) == list(ex.VARIANTS)
    call = _pallas_call(bench, variant, bench.INNER)
    x = np.random.RandomState(0).uniform(0.5, 1.5, (8, 128)).astype(np.float32)
    want, got = jnp.asarray(x), torch.from_numpy(x)
    before = ex.exp_chain.launches
    for _ in range(bench.OUTER):
        want = call(want)
        got = ex.exp_chain(got, variant)
    assert ex.exp_chain.launches == before                   # CPU calls do not count
    assert got.dtype == torch.float32 and 1.0 < float(got.min()) <= float(got.max()) < 1.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("inner", [1, 2, 3])
@pytest.mark.parametrize("variant", list(ex.VARIANTS))
def test_short_chain_matches_pallas_kernel(variant, inner):
    """1-3 steps on inputs over [-100, 100], where the result still depends on
    the input and on the step count (the full chain forgets both)."""
    call = _pallas_call(_bench_exp2(), variant, inner)
    x = np.random.RandomState(inner).uniform(-100, 100, (8, 128)).astype(np.float32)
    got = ex.exp_chain(torch.from_numpy(x), variant, inner).numpy()
    np.testing.assert_allclose(got, np.asarray(call(jnp.asarray(x))), rtol=1e-6, atol=0)
    assert not np.allclose(got, ex.exp_chain_plain(torch.from_numpy(x), variant,
                                                   inner + 1).numpy(), rtol=1e-3)


def test_refusals():
    x = torch.ones(4, 4)
    with pytest.raises(ValueError):
        ex.exp_chain(x, "exp10")
    with pytest.raises(TypeError):
        ex.exp_chain(x.double(), "exp")

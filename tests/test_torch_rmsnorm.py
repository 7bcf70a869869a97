"""The port's RMSNorm wrapper and its plain version against the JAX package,
on the CPU.

The shapes of ``tests/test_kernels.py::TestRMSNorm`` go through the JAX
``ops.rmsnorm`` (the Pallas kernel in interpret mode), the JAX
``ref.rmsnorm_ref``, and the port's ``ops.rmsnorm``, kernel wrapper and
``rmsnorm_ref`` on CPU tensors (which take the plain version), from the
same seeded numpy inputs.  Tolerances: ``TOL`` of ``tests/test_kernels.py``
(float32 2e-5, bfloat16 2e-2).  The kernel itself runs only on a card
(``tests/test_torch_kernels_card.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as rn

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(shape, dtype, seed, shift=0.0):
    jd, td = DTYPES[dtype]
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) + shift
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 128), (3, 512), (2, 5, 256), (300, 1024)])
def test_matches_jax(shape, dtype, w_dtype):
    jx, tx = _pair(shape, dtype, 0)
    jw, tw = _pair(shape[-1:], w_dtype, 1, shift=1.0)
    want = _f32(jref.rmsnorm_ref(jx, jw))
    jkern = _f32(jops.rmsnorm(jx, jw, row_block=64))
    np.testing.assert_allclose(jkern, want, **TOL[dtype])
    before = rn.rmsnorm.launches
    outs = (tops.rmsnorm(tx, tw, row_block=64), rn.rmsnorm(tx, tw), tref.rmsnorm_ref(tx, tw))
    assert rn.rmsnorm.launches == before           # CPU tensors never launch
    for got in outs:
        assert got.dtype == tx.dtype and tuple(got.shape) == shape
        np.testing.assert_allclose(_f32(got), want, **TOL[dtype])
        np.testing.assert_allclose(_f32(got), jkern, **TOL[dtype])


@pytest.mark.parametrize("eps", [1e-6, 1e-2])
def test_eps_matches_jax(eps):
    jx, tx = _pair((4, 64), "float32", 2)
    jw, tw = _pair((64,), "float32", 3, shift=1.0)
    np.testing.assert_allclose(_f32(tops.rmsnorm(tx, tw, eps=eps)),
                               _f32(jops.rmsnorm(jx, jw, eps=eps)), **TOL["float32"])


def test_row_block_changes_no_value():
    _j, tx = _pair((300, 256), "float32", 4)
    _jw, tw = _pair((256,), "float32", 5, shift=1.0)
    assert torch.equal(tops.rmsnorm(tx, tw, row_block=7), tops.rmsnorm(tx, tw, row_block=256))


@pytest.mark.parametrize("bad", ["w_shape", "scalar", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    x, w = torch.zeros(4, 8), torch.ones(8)
    if bad == "w_shape":
        w = torch.ones(7)
    elif bad == "scalar":
        x = torch.zeros(())
    else:
        w = torch.ones(8, device="meta")
    with pytest.raises(ValueError):
        rn.rmsnorm(x, w)

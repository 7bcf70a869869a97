"""The fused AdamW kernel's wrapper and plain version against the JAX
package's ``fused_adamw`` (its Pallas kernel in interpret mode), as
``TestFusedAdamW`` in ``tests/test_kernels.py`` holds that kernel to its
oracle.  On the CPU the port's wrapper runs the plain version
(``kernels/ref.py::adamw_ref``); on the card the kernel is held against the
same plain version by ``chip_smoke.py`` and ``test_torch_kernels_card.py``.

Tolerances (``test_kernels.TOL``): new p float32 rtol 2e-5 / atol 2e-5,
bfloat16 rtol 2e-2 / atol 2e-2 (compared in float32); m and v rtol 1e-5 /
atol 1e-6.  The sweep over n and step uses the reference's own sweep
tolerance, rtol 3e-5 / atol 3e-6.  Both sides compute in float32 in the
same order; only ulps differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.testing import given, hst, settings  # hypothesis-optional
from repro_torch.kernels import fused_adamw as fa
from repro_torch.kernels.ref import adamw_ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, seeds=(0, 1, 2, 3), scale_mv=0.01):
    r = [np.random.RandomState(s) for s in seeds]
    p = r[0].randn(n).astype(np.float32)
    g = r[1].randn(n).astype(np.float32)
    m = (r[2].randn(n) * scale_mv).astype(np.float32)
    v = np.abs(r[3].randn(n) * scale_mv).astype(np.float32)
    return p, g, m, v


def _port(p, g, m, v, dtype, **kw):
    sc = fa.scalar_row(kw["lr"], kw["b1"], kw["b2"],
                       torch.tensor(kw["step"], dtype=torch.int32),
                       kw.get("grad_scale", 1.0))
    t = lambda a, dt=torch.float32: torch.from_numpy(a).to(dt)
    out = fa.fused_adamw(t(p, TDT[dtype]), t(g, TDT[dtype]), t(m), t(v), sc,
                         eps=kw["eps"], wd=kw["wd"])
    return [o.float().numpy() for o in out]


def _jax(p, g, m, v, dtype, block, **kw):
    out = ops.fused_adamw(jnp.asarray(p, JDT[dtype]), jnp.asarray(g, JDT[dtype]),
                          jnp.asarray(m), jnp.asarray(v), block=block,
                          lr=jnp.float32(kw["lr"]), b1=kw["b1"], b2=kw["b2"],
                          eps=kw["eps"], wd=kw["wd"], step=jnp.int32(kw["step"]),
                          grad_scale=kw.get("grad_scale", 1.0))
    return [np.asarray(o, np.float32) for o in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1000, 4096, 70001])
def test_plain_version_matches_jax_kernel(n, dtype):
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, step=7, grad_scale=0.5)
    p, g, m, v = _inputs(n)
    po, mo, vo = _port(p, g, m, v, dtype, **kw)
    pj, mj, vj = _jax(p, g, m, v, dtype, 4096, **kw)
    np.testing.assert_allclose(po, pj, **TOL[dtype])
    np.testing.assert_allclose(mo, mj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vo, vj, rtol=1e-5, atol=1e-6)


@given(n=hst.integers(1, 3000), step=hst.integers(1, 100))
@settings(max_examples=10, deadline=None)
def test_property_sweep(n, step):
    p, g, _, _ = _inputs(n, seeds=(n % 17, n % 13, 0, 0))
    zeros = np.zeros(n, np.float32)
    kw = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, wd=0.0, step=step)
    po, _, _ = _port(p, g, zeros, zeros, "float32", **kw)
    pj, _, _ = _jax(p, g, zeros, zeros, "float32", 1024, **kw)
    np.testing.assert_allclose(po, pj, rtol=3e-5, atol=3e-6)


def test_scalar_row_matches_reference_wrapper():
    """lr, b1, b2, c1 = 1/(1-b1^t), c2, gscale in float32 from the int32 step,
    as ``src/repro/kernels/fused_adamw.py`` builds its scalar row."""
    step = jnp.int32(7)
    c1 = 1.0 / (1.0 - 0.9 ** step.astype(jnp.float32))
    c2 = 1.0 / (1.0 - 0.95 ** step.astype(jnp.float32))
    want = np.asarray(jnp.stack([jnp.float32(1e-3), jnp.float32(0.9),
                                 jnp.float32(0.95), c1, c2, jnp.float32(0.5),
                                 jnp.float32(0), jnp.float32(0)]))
    got = fa.scalar_row(torch.tensor(1e-3), 0.9, 0.95,
                        torch.tensor(7, dtype=torch.int32), torch.tensor(0.5))
    assert got.dtype == torch.float32 and got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)


def test_cpu_tensors_take_the_plain_version():
    p, g, m, v = (torch.from_numpy(a) for a in _inputs(513))
    sc = fa.scalar_row(1e-3, 0.9, 0.95, torch.tensor(3, dtype=torch.int32), 0.7)
    before = fa.fused_adamw.launches
    got = fa.fused_adamw(p, g, m, v, sc, eps=1e-8, wd=0.1)
    want = adamw_ref(p, g, m, v, sc, eps=1e-8, wd=0.1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fa.fused_adamw.launches == before           # no kernel on the CPU
    assert got[0] is not p and torch.equal(p, torch.from_numpy(_inputs(513)[0]))


@pytest.mark.parametrize("bad", ["dtype_mismatch", "int_param", "two_d", "length",
                                 "scalar_row"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p, g, m, v = (torch.from_numpy(a) for a in _inputs(64))
    sc = fa.scalar_row(1e-3, 0.9, 0.95, torch.tensor(1, dtype=torch.int32))
    if bad == "dtype_mismatch":
        g = g.to(torch.bfloat16)
    elif bad == "int_param":
        p, g = p.to(torch.int32), g.to(torch.int32)
    elif bad == "two_d":
        p, g, m, v = (x.reshape(8, 8) for x in (p, g, m, v))
    elif bad == "length":
        v = v[:63]
    else:
        sc = sc[:6]
    with pytest.raises((TypeError, ValueError)):
        fa.fused_adamw(p, g, m, v, sc, eps=1e-8, wd=0.1)



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_wrapper_matches_jax_ops(dtype):
    """``repro_torch.kernels.ops.fused_adamw`` takes the reference ops'
    keyword arguments (scalars and the step, not a scalar row)."""
    from repro_torch.kernels import ops as tops
    p, g, m, v = _inputs(4099)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1, grad_scale=0.5)
    want = ops.fused_adamw(jnp.asarray(p, JDT[dtype]), jnp.asarray(g, JDT[dtype]),
                           jnp.asarray(m), jnp.asarray(v), lr=jnp.float32(1e-3),
                           step=jnp.int32(7), block=4096, **kw)
    got = tops.fused_adamw(torch.from_numpy(p).to(TDT[dtype]), torch.from_numpy(g).to(TDT[dtype]),
                           torch.from_numpy(m), torch.from_numpy(v), lr=1e-3, step=7,
                           block=4096, **kw)
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0], np.float32),
                               **TOL[dtype])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_ops_exposes_the_reference_names():
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    names = ("flash_attention", "fused_adamw", "rmsnorm", "split_pipeline")
    assert all(callable(getattr(jops, n)) and callable(getattr(tops, n)) for n in names)

"""Result dtypes and values of the annotated numpy ops on non-float inputs:
every op of ROADMAP C1-C4 (``mod``, ``square``, ``sum``, ``prod``, ``abs``,
``floor``, ``power``, ``sign``) x bool, uint8, int16, int32 and float32 x
every port executor (on the CPU; ``cuda`` runs the kernel's plain version
there), against the JAX package's ``eager`` executor on the same numpy
inputs.

The JAX rules held: bool ``mod``/``power``/``square`` promote to int32;
``abs``/``floor`` of bool stay bool; ``sign`` of bool raises TypeError;
integer ``mod`` by zero gives 0 (float ``mod`` by zero gives nan);
``sum``/``prod`` of uint8 give uint32 (wrapping modulo 2**32), of bool and
small signed ints int32.  Integer values must be equal; float32 within
rtol 2e-5 (nan positions equal).  ``power`` draws exponents 0..3 and small
bases, where both packages are exact (ROADMAP: ``jnp.power`` on integers is
not exact modular arithmetic elsewhere).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import annotated_numpy as janp
from repro.core import mozart as jmozart
from repro_torch.core import annotated_numpy as tanp
from repro_torch.core import mozart as tmozart

JAX_CFG = dict(handoff=False, plan_cache=False, autotune=False)
#: the port side of a comparison runs as the JAX side does: no plan cache
#: and no tuner, so the counters compare like with like.
PORT_CFG = dict(plan_cache=False, autotune=False)


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    """Each test starts with an empty port plan cache, as tests/conftest.py
    empties the JAX package's: no test replays a plan another left."""
    from repro_torch.core import plan_cache
    plan_cache.clear()
    yield
EXECUTORS = ["eager", "pipelined", "fused", "scan", "cuda"]
OPS = ["mod", "square", "sum", "prod", "abs", "floor", "power", "sign"]
DTYPES = {"bool": np.bool_, "uint8": np.uint8, "int16": np.int16,
          "int32": np.int32, "float32": np.float32}
N, BATCH = 37, 8                   # four whole chunks and a ragged tail


def _inputs(op, dname):
    r = np.random.RandomState(zlib.crc32(f"{op}-{dname}".encode()))
    dt = DTYPES[dname]
    if dt is np.bool_:
        return r.rand(N) > 0.5, r.rand(N) > 0.5
    if op == "power":
        base = r.randint(0, 6, N) if dt is np.uint8 else r.randint(-5, 6, N)
        if dt is np.float32:
            return (r.rand(N) * 3).astype(dt), r.randint(0, 4, N).astype(dt)
        return base.astype(dt), r.randint(0, 4, N).astype(dt)
    if op == "prod" and dt is np.float32:
        return (0.9 + 0.2 * r.rand(N)).astype(dt), None
    if dt is np.float32:
        x, y = r.randn(N).astype(dt) * 4, r.randn(N).astype(dt) * 3
        y[::7] = 0.0                   # float mod by zero: nan
        return x, y
    lo = 0 if dt is np.uint8 else -9
    hi = 250 if dt is np.uint8 and op in ("sum", "prod") else 10
    x, y = r.randint(lo, hi, N).astype(dt), r.randint(lo, 10, N).astype(dt)
    y[::5] = 0                         # integer mod by zero: 0
    return x, y


def _args(op, x, y):
    return (x, y) if op in ("mod", "power") else (x,)


_JAX: dict = {}


def _jax(op, dname):
    key = (op, dname)
    if key not in _JAX:
        x, y = _inputs(op, dname)
        try:
            with jmozart.session(executor="eager", **JAX_CFG):
                out = getattr(janp, op)(*[jnp.asarray(a) for a in _args(op, x, y)])
                _JAX[key] = np.asarray(out)
        except TypeError as e:
            _JAX[key] = e
    return _JAX[key]


def _port(op, dname, executor):
    x, y = _inputs(op, dname)
    with tmozart.session(executor=executor, device="cpu", **PORT_CFG, batch_elements=BATCH) as ctx:
        out = getattr(tanp, op)(*[torch.from_numpy(np.array(a)) for a in _args(op, x, y)])
        got = out.value
    return got, ctx


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("op", OPS)
def test_op_dtype_and_values_equal_jax(op, dname, executor):
    want = _jax(op, dname)
    if isinstance(want, TypeError):
        with pytest.raises(TypeError):
            _port(op, dname, executor)
        return
    got, _ctx = _port(op, dname, executor)
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    if want.dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_sign_of_bool_raises_like_jnp():
    with pytest.raises(TypeError):
        jnp.sign(jnp.asarray([True, False]))
    with tmozart.session(executor="fused", device="cpu"):
        with pytest.raises(TypeError, match="bool"):
            tanp.sign(torch.tensor([True, False]))


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.uint8])
def test_integer_mod_by_zero_gives_zero(executor, dtype):
    """C2: ``[7,-7,7,-7,5,0] mod [3,3,-3,-3,0,0]`` is ``[1,2,-2,-1,0,0]``
    (uint8 takes the non-negative half)."""
    x, y = [7, -7, 7, -7, 5, 0], [3, 3, -3, -3, 0, 0]
    want = [1, 2, -2, -1, 0, 0]
    if dtype == torch.uint8:
        x, y, want = [7, 7, 5, 0], [3, 3, 0, 0], [1, 1, 0, 0]
    jwant = np.asarray(jnp.mod(jnp.asarray(x, str(dtype).replace("torch.", "")),
                               jnp.asarray(y, str(dtype).replace("torch.", ""))))
    assert jwant.tolist() == want
    with tmozart.session(executor=executor, device="cpu", batch_elements=4):
        got = tanp.mod(torch.tensor(x, dtype=dtype), torch.tensor(y, dtype=dtype)).value
    assert got.dtype == dtype and got.tolist() == want


def test_float_mod_by_zero_keeps_nan():
    with tmozart.session(executor="cuda", device="cpu") as ctx:
        got = tanp.mod(torch.tensor([7.0, -7.0]), torch.tensor([0.0, 3.0])).value
    assert torch.isnan(got[0]) and float(got[1]) == 2.0
    assert ctx.stats["cuda_stages"] == 1          # float mod stays on the kernel


def test_bool_mod_stays_off_the_kernel():
    """C1: the int32 stage runs on ``fused`` and is counted as a fallback,
    where it once lowered to the kernel and stored NaN as True."""
    x = torch.tensor([True, False, True, False])
    y = torch.tensor([True, True, False, False])
    with tmozart.session(executor="cuda", device="cpu") as ctx:
        got = tanp.mod(x, y).value
    assert got.dtype == torch.int32 and got.tolist() == [0, 0, 0, 0]
    assert ctx.stats.get("cuda_stages", 0) == 0
    assert ctx.stats["cuda_fallback_stages"] == 1


def test_lowering_refuses_mod_of_bool_operands():
    from repro_torch.core import cuda_exec
    b = cuda_exec._Builder(0)
    x = ("in", 0)
    b.is_bool[x], b.is_vec[x] = True, True
    with pytest.raises(cuda_exec.LoweringError, match="MOD"):
        b.emit("MOD", (x, x))


def test_unsigned_reductions_wrap_like_jax():
    """C3: uint8 sums and products accumulate in uint32 and wrap modulo
    2**32, across chunk merges too."""
    x = np.full(40, 251, np.uint8)
    jsum = np.asarray(jnp.sum(jnp.asarray(x)))
    jprod = np.asarray(jnp.prod(jnp.asarray(x)))
    for executor in ("eager", "fused"):
        with tmozart.session(executor=executor, device="cpu", batch_elements=7):
            s = tanp.sum(torch.from_numpy(x.copy()))
            p = tanp.prod(torch.from_numpy(x.copy()))
            assert s.value.dtype == p.value.dtype == torch.uint32
            assert int(s.value) == int(jsum) and int(p.value) == int(jprod)

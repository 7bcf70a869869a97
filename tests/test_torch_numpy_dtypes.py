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
    """C1: a bool ``mod`` never reaches a float ``MOD`` of bools (which once
    stored NaN as True).  Since the kernel takes integers (ROADMAP B1) the
    stage runs on it as the reference's ``pallas`` does: both operands
    ``CAST`` to int32, then an integer ``MOD`` whose zero divisor gives 0."""
    from repro_torch.core import cuda_exec
    from repro_torch.kernels import program as P
    x = torch.tensor([True, False, True, False])
    y = torch.tensor([True, True, False, False])
    with tmozart.session(executor="cuda", device="cpu") as ctx:
        out = tanp.mod(x, y)
        stage = ctx.last_plan()[0]
        concrete = {k: ctx.graph.resolve(si.value) for k, si in stage.inputs.items()}
        program = cuda_exec.prepare_launch(stage, concrete, ctx)[0]
        got = out.value
    assert got.dtype == torch.int32 and got.tolist() == [0, 0, 0, 0]
    assert ctx.stats["cuda_stages"] == 1
    assert ctx.stats.get("cuda_fallback_stages", 0) == 0
    names = [P.OPCODES[op][0] for op, *_ in program.code]
    assert names[:2] == ["CAST", "CAST"] and program.instr_types[0] == (P.BOOL, P.I32)
    assert program.instr_types[names.index("MOD")] == (P.I32, P.I32)


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


# -- C9: 64-bit inputs narrowed as the reference narrows them ------------------

#: op -> dtypes it runs on in both packages (torch has no CPU ``add`` for
#: uint32, so uint64 inputs take the ops it has).
C9_OPS = {"add": ("int64", "float64", "complex128"),
          "multiply": ("int64", "uint64", "float64", "complex128"),
          "sum": ("int64", "uint64", "float64", "complex128"),
          "mod": ("int64", "float64"), "maximum": ("int64", "float64")}
C9_NARROW = {"int64": "int32", "uint64": "uint32", "float64": "float32",
             "complex128": "complex64"}


def _c9_inputs(dname):
    """Values past 32 bits: int64 beyond 2**31 (they wrap), uint64 beyond
    2**32, float64 that round to float32, complex128 of both parts."""
    r = np.random.RandomState(zlib.crc32(dname.encode()))
    if dname == "int64":
        x = r.randint(-(1 << 40), 1 << 40, N, dtype=np.int64)
        y = r.randint(-9, 10, N).astype(np.int64) + (1 << 33)
        return x, y
    if dname == "uint64":
        return (r.randint(0, 1 << 62, N, dtype=np.int64).astype(np.uint64) * np.uint64(3),
                r.randint(0, 10, N).astype(np.uint64) + np.uint64(1 << 35))
    x, y = r.randn(N) * 4, r.randn(N) * 3 + 0.1
    if dname == "complex128":
        return x + 1j * r.randn(N), y - 2j * r.randn(N)
    return x, y


def _c9_call(anp, op, x, y):
    if op == "sum":
        return anp.sum(x)
    if op == "add":
        return anp.add(x, 1)
    return getattr(anp, op)(x, y)


def _to_torch(a):
    if a.dtype == np.uint64:
        return torch.from_numpy(a.view(np.int64).copy()).view(torch.uint64)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("op,dname", [(op, d) for op, ds in C9_OPS.items() for d in ds])
def test_64bit_inputs_are_narrowed_as_jax_narrows_them(op, dname, executor):
    """C9: dtypes equal, integers equal (int64 and uint64 wrap modulo
    2**32), floats within float32's rtol 2e-5 of the reference's."""
    x, y = _c9_inputs(dname)
    with jmozart.session(executor="eager", **JAX_CFG):
        want = np.asarray(_c9_call(janp, op, jnp.asarray(x), jnp.asarray(y)).value)
    with tmozart.session(executor=executor, device="cpu", **PORT_CFG,
                         batch_elements=BATCH) as ctx:
        got = _c9_call(tanp, op, _to_torch(x), _to_torch(y)).value
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    assert want.dtype.name in (C9_NARROW[dname], "uint32")     # uint32: the sum's dtype
    if got.dtype in (torch.uint32, torch.uint16):
        got = got.to(torch.int64)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5 if op != "sum" else 1e-4,
                                   atol=1e-5)
    if executor == "cuda" and dname != "complex128":
        assert ctx.stats["cuda_stages"] == 1 and ctx.stats.get("cuda_fallback_stages", 0) == 0


@pytest.mark.parametrize("executor", EXECUTORS)
def test_python_int_outside_int32_raises_overflow_like_jax(executor):
    x = np.arange(6, dtype=np.int32)
    with pytest.raises(OverflowError):
        with jmozart.session(executor="eager", **JAX_CFG):
            janp.add(jnp.asarray(x), 2**40).value
    with pytest.raises(OverflowError):
        with tmozart.session(executor=executor, device="cpu", **PORT_CFG):
            tanp.add(torch.from_numpy(x), 2**40).value
    with tmozart.session(executor=executor, device="cpu", **PORT_CFG):
        assert tanp.add(torch.from_numpy(x), 2**31 - 1).value.dtype == torch.int32


def _hash_chain(anp):
    def run(ids, scale):
        b = anp.mod(anp.add(anp.multiply(ids, 40503), 12345), 1024)
        return b, anp.sum(b), anp.max(anp.multiply(scale, 0.5))
    return run


def _plan_shape(ctx):
    return [[n.fn.name for n in s.nodes] for s in ctx.last_plan()]


@pytest.mark.parametrize("executor", ["fused", "cuda"])
def test_pipeline_on_64bit_inputs_plans_and_counts_as_jax(executor):
    """``mozart.pipeline`` on int64 and float64 arguments: the same 32-bit
    results, plan shape and counters as the reference's pipeline; a call
    on int32/float32 arguments of the same shape is warm on both (one plan:
    the narrowed dtypes are the plan's)."""
    r = np.random.RandomState(3)
    ids = r.randint(0, 1 << 40, 4000, dtype=np.int64)
    scale = r.randn(4000)
    jp = jmozart.pipeline(_hash_chain(janp), executor={"cuda": "pallas"}.get(executor, executor))
    tp = tmozart.pipeline(_hash_chain(tanp), executor=executor, device="cpu")
    keys = ("planner_calls", "plan_cache_hits", "plan_cache_misses", "stages", "evaluations",
            "registered")
    for a, b in ((ids, scale), (ids.astype(np.int32), scale.astype(np.float32)),
                 (ids, scale)):
        want = [np.asarray(v) for v in jp(jnp.asarray(a), jnp.asarray(b))]
        got = tp(torch.from_numpy(a), torch.from_numpy(b))
        for g, w in zip(got, want):
            assert str(g.dtype).replace("torch.", "") == w.dtype.name
            if w.dtype == np.float32:
                np.testing.assert_allclose(g.numpy(), w, rtol=2e-5)
            else:
                np.testing.assert_array_equal(g.numpy(), w)
        assert {k: tp.last_call_stats.get(k, 0) for k in keys} == \
            {k: jp.last_call_stats.get(k, 0) for k in keys}
        assert _plan_shape(tp.ctx) == _plan_shape(jp.ctx)
    assert tp.last_call_stats.get("planner_calls", 0) == 0
    if executor == "cuda":
        assert tp.last_call_stats["cuda_stages"] == jp.last_call_stats["pallas_stages"]
        assert tp.last_call_stats.get("cuda_fallback_stages", 0) == 0


def test_a_64bit_tensor_read_by_many_calls_is_one_stage_input():
    """A float64 tensor passed to several annotated calls is narrowed once
    per session, so Black-Scholes from float64 inputs plans and lowers as
    from float32 (5 split inputs, a plan cache hit) and gives the same
    float32 outputs bit for bit."""
    from repro_torch import workloads as tw
    data = tw.black_scholes_data(257, device="cpu")
    with tmozart.session(executor="cuda", device="cpu") as ctx32:
        want = [o.value for o in tw.black_scholes(**data)]
    with tmozart.session(executor="cuda", device="cpu") as ctx64:
        outs = tw.black_scholes(**{k: v.double() for k, v in data.items()})
        stage = ctx64.last_plan()[0]
        got = [o.value for o in outs]
    assert ctx64.stats["plan_cache_hits"] == 1 and ctx64.stats["cuda_stages"] == 1
    assert sum(1 for si in stage.inputs.values() if si.split_type.splittable) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)

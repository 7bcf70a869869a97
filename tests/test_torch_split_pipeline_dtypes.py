"""The split-pipeline kernel at every dtype the Pallas kernel takes (ROADMAP
B1): the port's ``cuda`` executor (the kernel's plain version on the CPU)
against the JAX package's ``pallas`` executor (its kernel in interpret
mode) on the same numpy inputs.

For bool, int8/16/32, uint8/16/32, float16 and bfloat16, stages of unary
and binary ops, Python-scalar operands, ``where``, ``mod`` (divisor 0
included), comparisons and reductions: ``cuda_stages`` equals
``pallas_stages`` and no stage falls back.  Integers and bools must be
equal; float16 within 2e-3 and bfloat16 within 2e-2 (rtol, and atol of
that fraction of max|ref|): the port rounds every instruction's result to
the half dtype, as torch's eager ops do, where the reference's kernel
computes a chain in float32 once a (float32) scalar joins it.

Two cases follow the reference's ``eager`` executor instead of its
``pallas`` one, which differs from it there (ROADMAP C, observations): the
kernel's scalars are strong int32, so an 8/16-bit chain that overflows
before a ``mod`` is reduced unwrapped; and a bool ``max`` masks the ragged
tail with ``-inf`` cast to bool, which is True.
"""

import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import annotated_numpy as janp
from repro.core import mozart as jmozart
from repro_torch.core import annotated_numpy as tanp
from repro_torch.core import cuda_exec
from repro_torch.core import mozart as tmozart
from repro_torch.kernels import program as P

JAX_CFG = dict(handoff=False, plan_cache=False, autotune=False)
#: the port side runs as the JAX side does: no plan cache and no tuner.
PORT_CFG = dict(plan_cache=False, autotune=False)
N = 2500                              # two whole 1024-blocks and a ragged tail

DTYPES = ["bool", "int8", "int16", "int32", "uint8", "uint16", "uint32", "float16",
          "bfloat16"]
TOL = {"float16": 2e-3, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    """Each test starts with an empty port plan cache, as tests/conftest.py
    empties the JAX package's: no test replays a plan another left."""
    from repro_torch.core import plan_cache
    plan_cache.clear()
    yield


def _np_dtype(dname):
    return ml_dtypes.bfloat16 if dname == "bfloat16" else np.dtype(dname)


def _data(dname, case):
    """Two inputs of ``dname``: random, ``y`` with zeros (integer ``mod``)
    and, for ``reduce``, factors near 1 (a product that stays exact or
    finite)."""
    r = np.random.RandomState(zlib.crc32(f"{dname}-{case}".encode()))
    if dname == "bool":
        return r.rand(N) > 0.5, r.rand(N) > 0.3
    if dname in TOL:
        x = (r.randn(N) * 3).astype(np.float32)
        y = (r.randn(N) * 2).astype(np.float32)
        if case == "reduce":
            y = (1 + 2e-3 * r.randn(N)).astype(np.float32)
        return x.astype(_np_dtype(dname)), y.astype(_np_dtype(dname))
    info = np.iinfo(dname)
    lo, hi = max(info.min, -100), min(info.max, 100)
    x, y = r.randint(lo, hi + 1, N), r.randint(max(lo, -9), 10, N)
    y[::7] = 0
    if case == "reduce":
        y = np.where(r.rand(N) > 0.5, 1, 3 if lo == 0 else -1)
    if case == "wrap":
        x = r.randint(info.min, min(info.max, 1 << 20) + 1, N)
    return x.astype(dname), y.astype(dname)


def _floats(anp, x, y):
    return {
        "unary": lambda: (anp.exp(anp.multiply(x, 0.25)), anp.sqrt(anp.abs(x)), anp.tanh(y),
                          anp.floor(x), anp.sign(y), anp.negative(x), anp.log1p(anp.abs(y))),
        "binary": lambda: (anp.add(x, y), anp.subtract(x, y), anp.multiply(x, y),
                           anp.divide(x, anp.add(anp.abs(y), 1.0)), anp.maximum(x, y),
                           anp.minimum(x, y), anp.atan2(x, y)),
        "scalar": lambda: (anp.multiply(x, 0.5), anp.add(2.0, y), anp.subtract(1.0, x),
                           anp.maximum(x, 0.0), anp.power(anp.abs(x), 2)),
        "where": lambda: (anp.where(anp.greater(x, y), x, y), anp.where(x, y, 0.5)),
        "mod": lambda: (anp.mod(x, y), anp.mod(x, 1.5), anp.mod(x, 0.0)),
        "compare": lambda: (anp.greater(x, y), anp.less(x, 0.5), anp.equal(anp.floor(x), x),
                            anp.logical_and(anp.greater(x, 0.0), anp.less(y, x)),
                            anp.logical_or(anp.isnan(anp.log(x)), anp.greater(y, 1.0))),
        "reduce": lambda: (anp.sum(x), anp.max(x), anp.min(x), anp.prod(y),
                           anp.sum(anp.multiply(x, y))),
    }


def _ints(anp, x, y, unsigned):
    small = anp.mod(y, 4)
    return {
        "unary": lambda: (anp.negative(x), anp.abs(x), anp.square(y), anp.sign(x),
                          anp.floor(x)),
        "binary": lambda: (anp.add(x, y), anp.subtract(x, y), anp.multiply(x, y),
                           anp.maximum(x, y), anp.minimum(x, y), anp.divide(x, y),
                           anp.power(anp.mod(x, 6), small)),
        "scalar": lambda: (anp.add(x, 3), anp.multiply(2, x), anp.subtract(x, 1),
                           anp.maximum(x, 5), anp.minimum(7, y), anp.multiply(x, 0.5)),
        "where": lambda: (anp.where(anp.greater(x, y), x, y), anp.where(y, x, 7)),
        "mod": lambda: (anp.mod(x, y), anp.mod(x, 7), anp.mod(x, 0)),
        "compare": lambda: (anp.greater(x, y), anp.less(x, 5), anp.equal(x, y),
                            anp.logical_and(anp.greater(x, 0), anp.less(y, x)),
                            anp.logical_not(anp.greater(y, x))),
        "reduce": lambda: (anp.sum(x), anp.prod(y), anp.sum(anp.add(x, y))),
        "extrema": lambda: (anp.max(x), anp.min(anp.add(x, y))),
        "wrap": lambda: (anp.add(anp.multiply(x, 3), 1), anp.mod(anp.add(anp.multiply(x, 3), 1), 7)),
    }


def _bools(anp, x, y):
    return {
        "unary": lambda: (anp.logical_not(x), anp.abs(x), anp.floor(y), anp.square(x)),
        "binary": lambda: (anp.add(x, y), anp.multiply(x, y), anp.maximum(x, y),
                           anp.minimum(x, y), anp.power(x, y)),
        "scalar": lambda: (anp.logical_and(x, True), anp.add(x, 1), anp.multiply(x, 2.5)),
        "where": lambda: (anp.where(x, y, False), anp.where(x, 2, 3)),
        "mod": lambda: (anp.mod(x, y),),
        "compare": lambda: (anp.greater(x, y), anp.equal(x, y), anp.logical_or(x, y),
                            anp.logical_and(anp.logical_not(x), y)),
        "reduce": lambda: (anp.sum(x), anp.max(anp.logical_and(x, anp.logical_not(x))),
                           anp.min(y), anp.prod(y), anp.max(x)),
    }


def chain(anp, dname, case, x, y):
    if dname == "bool":
        cases = _bools(anp, x, y)
    elif dname in TOL:
        cases = _floats(anp, x, y)
    else:
        cases = _ints(anp, x, y, dname.startswith("uint"))
    return cases[case]()


CASES = ["unary", "binary", "scalar", "where", "mod", "compare", "reduce"]
INTS = ["int8", "int16", "int32", "uint8", "uint16", "uint32"]
#: (dtype, case) -> outputs where the reference's ``pallas`` executor differs
#: from its ``eager`` one; the port follows ``eager`` there.
PALLAS_QUIRKS = {("bool", "reduce"): (1,)}
PALLAS_QUIRKS.update({(d, "wrap"): (1,) for d in ("int8", "int16", "uint8", "uint16")})
#: integer ``max``/``min``: the reference's kernel casts its ``-inf``/``inf``
#: identity to the integer dtype and fails, so the stage demotes off
#: ``pallas`` (to ``scan``); the port's kernel runs it.
PALLAS_DEMOTES = {(d, "extrema") for d in INTS}


def _run_jax(dname, case, executor):
    x, y = _data(dname, case)
    with jmozart.session(executor=executor, **JAX_CFG) as ctx:
        outs = chain(janp, dname, case, jnp.asarray(x), jnp.asarray(y))
        vals = [np.asarray(o.value) for o in outs]
    return vals, ctx.stats


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype in (np.uint16, np.uint32):
        return torch.from_numpy(a.astype(np.int64)).to(getattr(torch, a.dtype.name))
    return torch.from_numpy(a.copy())


def _numpy(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    if t.dtype in (torch.uint16, torch.uint32):
        return t.to(torch.int64).numpy().astype(str(t.dtype).replace("torch.", ""))
    return t.numpy()


def _run_port(dname, case, executor="cuda"):
    x, y = _data(dname, case)
    with tmozart.session(executor=executor, device="cpu", **PORT_CFG) as ctx:
        outs = chain(tanp, dname, case, _torch(x), _torch(y))
        vals = [_numpy(o.value) for o in outs]
    return vals, ctx.stats


def _close(got, want, dname, what):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.issubdtype(want.dtype, np.floating) and want.dtype != ml_dtypes.bfloat16:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    g, w = got.astype(np.float64), want.astype(np.float64)
    tol = TOL.get(dname, 2e-5)         # float32 results of integers: 2e-5
    finite = np.abs(w[np.isfinite(w)])
    atol = tol * float(finite.max()) if finite.size else 0.0
    np.testing.assert_allclose(g, w, rtol=tol, atol=atol, equal_nan=True, err_msg=what)


def _params():
    out = []
    for dname in DTYPES:
        for case in CASES + (["wrap", "extrema"] if dname in INTS else []):
            out.append((dname, case))
    return out


@pytest.mark.parametrize("dname,case", _params())
def test_stage_runs_on_the_kernel_and_matches_jax_pallas(dname, case):
    want, jst = _run_jax(dname, case, "pallas")
    got, pst = _run_port(dname, case)
    if (dname, case) in PALLAS_DEMOTES:
        assert jst.get("pallas_stages", 0) == 0 and jst["exec_demotions"] >= 1
        assert pst["cuda_stages"] == 1
    else:
        assert jst["pallas_stages"] >= 1
        assert pst["cuda_stages"] == jst["pallas_stages"]
    assert pst.get("cuda_fallback_stages", 0) == 0
    quirks = PALLAS_QUIRKS.get((dname, case), ())
    eager = _run_jax(dname, case, "eager")[0] if quirks else None
    for i, (g, w) in enumerate(zip(got, want)):
        if i in quirks:
            assert not np.array_equal(w, eager[i]), "the reference's quirk is gone"
            w = eager[i]
        _close(g, w, dname, f"{dname} {case} output {i}")


@pytest.mark.parametrize("dname", ["int16", "uint8", "float16", "bfloat16", "int32"])
def test_fused_executor_agrees_with_the_kernel_path(dname):
    """The port's ``fused`` executor (torch's own ops) on the same chain:
    the kernel's typed program computes what the library computes (uint16
    and uint32 are left out: torch has no CPU arithmetic for them)."""
    for case in ("binary", "mod", "where", "compare"):
        kern, _ = _run_port(dname, case, "cuda")
        fused, st = _run_port(dname, case, "fused")
        for i, (g, w) in enumerate(zip(kern, fused)):
            _close(g, w, dname, f"{dname} {case} output {i}")


def test_int32_mod_by_zero_lowers_to_zero():
    """The lowering traces ``mod`` at the stage's dtypes: the integer branch
    of the library function (its zero guard) becomes the program, where a
    trace that took the float branch would lower a bare ``MOD`` and give
    nan, stored as an integer."""
    x = torch.tensor([7, -7, 7, -7, 5, 0], dtype=torch.int32)
    y = torch.tensor([3, 3, -3, -3, 0, 0], dtype=torch.int32)
    with tmozart.session(executor="cuda", device="cpu", **PORT_CFG) as ctx:
        out = tanp.mod(x, y)
        stage = ctx.last_plan()[0]
        concrete = {k: ctx.graph.resolve(si.value) for k, si in stage.inputs.items()}
        program = cuda_exec.prepare_launch(stage, concrete, ctx)[0]
        got = out.value
    assert ctx.stats["cuda_stages"] == 1 and ctx.stats.get("cuda_fallback_stages", 0) == 0
    assert got.dtype == torch.int32 and got.tolist() == [1, 2, -2, -1, 0, 0]
    names = [P.OPCODES[op][0] for op, *_ in program.code]
    assert "MOD" in names and "WHERE" in names            # the guard is in the program
    assert all(t[0] == P.I32 for t, n in zip(program.instr_types, names) if n == "MOD")
    assert program.in_dtypes == (P.I32, P.I32) and program.out_dtypes == (P.I32,)


def test_float32_program_is_not_replayed_on_int32_inputs_of_the_same_shape():
    """A plan cache entry pins its program per input dtypes: the float32
    program pinned for a shape is never launched on int32 inputs."""
    from repro_torch.core import plan_cache
    from repro_torch.kernels import split_pipeline as sp
    launches = []
    real = sp._launch

    def spy(program, split_inputs, *a, **k):
        launches.append((program.in_dtypes, tuple(x.dtype for x in split_inputs)))
        return real(program, split_inputs, *a, **k)

    sp._launch, cuda_exec.sp._launch = spy, spy
    try:
        got = []
        for dtype in (torch.float32, torch.int32, torch.float32, torch.int32):
            x = torch.arange(-50, 50).to(dtype)
            with tmozart.session(executor="cuda", device="cpu") as ctx:
                got.append(tanp.mod(tanp.add(x, 7), 9).value)
            assert ctx.stats["cuda_stages"] == 1
    finally:
        sp._launch = cuda_exec.sp._launch = real
    for program_dtypes, input_dtypes in launches:
        assert program_dtypes == tuple(P.CODE[d] for d in input_dtypes)
    assert got[1].dtype == torch.int32 and got[0].dtype == torch.float32
    assert torch.equal(got[1], torch.remainder(torch.arange(-50, 50) + 7, 9).to(torch.int32))
    assert torch.equal(got[0], got[2]) and torch.equal(got[1], got[3])
    assert len(plan_cache.entries()) >= 1


def test_program_key_names_the_input_dtypes():
    """``lower_stage`` pins per input dtypes (``input_signature``)."""
    x = torch.arange(10, dtype=torch.int16)
    with tmozart.session(executor="cuda", device="cpu", **PORT_CFG) as ctx:
        out = tanp.add(x, 2.5)
        stage = ctx.last_plan()[0]
        concrete = {k: ctx.graph.resolve(si.value) for k, si in stage.inputs.items()}
        sig = cuda_exec.input_signature(stage, concrete)
        del out
    assert torch.int16 in sig and "float" in sig


def test_complex64_stays_on_fused_and_is_counted():
    """Complex has no kernel dtype (nor a Mosaic type): the stage runs on
    ``fused`` and counts in ``cuda_fallback_stages``; the reference's
    ``pallas`` fails on it and demotes."""
    x = (np.arange(12) + 1j * np.arange(12)[::-1]).astype(np.complex64)
    with tmozart.session(executor="cuda", device="cpu", **PORT_CFG) as ctx:
        got = tanp.multiply(tanp.add(torch.from_numpy(x), 1.0), 2.0).value
    assert ctx.stats["cuda_fallback_stages"] == 1 and ctx.stats.get("cuda_stages", 0) == 0
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), (x + 1.0) * 2.0, rtol=1e-6)
    with jmozart.session(executor="pallas", **JAX_CFG) as jctx:
        want = np.asarray(janp.multiply(janp.add(jnp.asarray(x), 1.0), 2.0).value)
    assert jctx.stats.get("pallas_stages", 0) == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_a_sampled_run_lowers_at_the_stage_shapes():
    """``auto`` and the tuner time a stage on a slice of its inputs; the
    lowering traces at the stage's shapes (its nodes' avals), not the
    slice's, so the sample runs on the kernel and the program it pins
    serves the whole stage."""
    from repro_torch import workloads as tw
    from repro_torch.core.stage_exec import get_executor
    data = tw.black_scholes_data(4096, device="cpu")
    with tmozart.session(executor="cuda", device="cpu", **PORT_CFG) as ctx:
        outs = tw.black_scholes(**data)
        stage = ctx.last_plan()[0]
        concrete = {k: ctx.graph.resolve(si.value) for k, si in stage.inputs.items()}
        get_executor("cuda").sampled_time(stage, concrete, ctx, 1024, 4096, 1024)
        assert ctx.stats["cuda_stages"] == 2
        assert ctx.stats.get("cuda_fallback_stages", 0) == 0
        assert cuda_exec.prepare_launch(stage, concrete, ctx) is not None
        del outs

"""The ``cuda`` executor's lowering and the split-pipeline kernel's plain
version (``kernels/ref.py``), against the JAX package.

On the CPU the executor runs the plain version, which evaluates the same
lowered program opcode by opcode, so every opcode is held here against the
JAX op it stands for; the JAX side runs its Pallas kernel in interpret mode,
as its own tests do.

Tolerances: float32 rtol 2e-5, atol 2e-5 * max|ref| (same per-element op
order; only libm ulps in exp/log/erf/sin differ).  Sums over n elements
rtol 1e-4 (summation order differs); products rtol 1e-3.  NaN positions
must agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import annotated_numpy as janp
from repro.core import mozart as jmozart
from repro.kernels import ops as jops
from repro_torch.core import annotated_numpy as tanp
from repro_torch.core import cuda_exec
from repro_torch.core import mozart as tmozart
from repro_torch.core import splittable, Along
from repro_torch.kernels import program as prog
from repro_torch.kernels.ref import split_pipeline_ref
from repro_torch.kernels.split_pipeline import split_pipeline

JAX_CFG = dict(rewrite=False, handoff=False, plan_cache=False, autotune=False)
UNARY = sorted(tanp._UNARY)
BINARY = sorted(tanp._BINARY)


def close(got, want, rtol=2e-5):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.bool_:
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, want)
        return
    finite = np.abs(want[np.isfinite(want)]) if want.ndim else np.abs(want)
    atol = 2e-5 * float(np.max(finite)) if np.size(finite) else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


def run_port(fn, args, executor="cuda", batch=None):
    """One op (or chain) through a CPU session; returns values and stats."""
    targs = {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v
             for k, v in args.items()}
    with tmozart.session(executor=executor, device="cpu",
                         batch_elements=batch) as ctx:
        out = fn(**targs)
        outs = out if isinstance(out, tuple) else (out,)
        vals = [o.value for o in outs]
    return [v.numpy() if isinstance(v, torch.Tensor) else v for v in vals], ctx


def _probe():
    return {k: v for k, v in janp.__probe_examples__().items()
            if k in tanp._UNARY or k in tanp._BINARY or k == "where"}


def _np_args(kw):
    return {k: np.asarray(v) if hasattr(v, "shape") else v for k, v in kw.items()}


@pytest.mark.parametrize("op", UNARY + BINARY + ["where"])
def test_every_op_lowers_and_matches_jax(op):
    """Each elementwise op alone in a stage goes to the kernel (plain version
    here) and agrees with the JAX op on the probe inputs."""
    args = _np_args(_probe()[op])
    got, ctx = run_port(getattr(tanp, op), args)
    assert ctx.stats["cuda_stages"] == 1 and ctx.stats["cuda_fallback_stages"] == 0
    want = np.asarray(getattr(janp, op)(**{k: jnp.asarray(v) for k, v in args.items()}))
    close(got[0], want)


SPECIAL = np.array([-2.5, -1.0, -0.0, 0.0, 0.5, 3.0, np.nan, np.inf, -np.inf],
                   np.float32)


@pytest.mark.parametrize("op", ["sign", "isnan", "abs", "floor", "logical_not",
                             "negative", "square", "exp"])
def test_unary_special_values(op):
    got, _ = run_port(getattr(tanp, op), dict(x=SPECIAL))
    close(got[0], np.asarray(getattr(janp, op)(jnp.asarray(SPECIAL))))


@pytest.mark.parametrize("op", ["maximum", "minimum", "mod", "greater", "less",
                                "equal", "logical_and", "logical_or", "atan2",
                                "add", "multiply", "divide"])
def test_binary_special_values(op):
    y = np.roll(SPECIAL, 3)
    y[y == 0] = -1.5                    # keep mod/divide by zero out of scope
    got, _ = run_port(getattr(tanp, op), dict(x=SPECIAL, y=y))
    close(got[0], np.asarray(getattr(janp, op)(jnp.asarray(SPECIAL), jnp.asarray(y))))


@pytest.mark.parametrize("op", BINARY)
@pytest.mark.parametrize("scalar_first", [False, True])
def test_binary_with_python_scalar(op, scalar_first):
    """A Python scalar operand is a broadcast input passed at run time; the
    result keeps JAX's weak-typed dtype."""
    x = np.linspace(0.1, 0.9, 33, dtype=np.float32)
    args = dict(x=0.5, y=x) if scalar_first else dict(x=x, y=0.5)
    got, ctx = run_port(getattr(tanp, op), args)
    assert ctx.stats["cuda_stages"] == 1
    jargs = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
             for k, v in args.items()}
    close(got[0], np.asarray(getattr(janp, op)(**jargs)))


def test_where_with_scalar_branches_and_float_condition():
    x = np.array([0.0, 1.5, -2.0, np.nan], np.float32)
    got, _ = run_port(tanp.where, dict(c=x, x=1.0, y=x))
    close(got[0], np.asarray(janp.where(jnp.asarray(x), 1.0, jnp.asarray(x))))


def _chain(anp):
    # tests/test_kernels.py::TestSplitPipeline.test_chain_vs_ref as ops
    def run(a, b, c):
        t = anp.add(anp.exp(anp.multiply(a, 0.1)), b)
        u = anp.maximum(t, c)
        return u, anp.sum(u)
    return run


@pytest.mark.parametrize("n", [1, 1000, 1500, 4097])
def test_plain_version_matches_jax_kernel_chain(n):
    rs = np.random.RandomState(n)
    x, y = rs.randn(n).astype(np.float32), rs.randn(n).astype(np.float32)
    got, ctx = run_port(_chain(tanp), dict(a=x, b=y, c=0.5))
    assert ctx.stats["cuda_stages"] == 1

    def chain(blocks, bcasts):
        a, b = blocks
        (c,) = bcasts
        u = jnp.maximum(jnp.exp(a * 0.1) + b, c)
        return [u, u]

    want = jops.split_pipeline(chain, [jnp.asarray(x), jnp.asarray(y)],
                               [jnp.float32(0.5)],
                               [("concat", ""), ("reduce", "add")],
                               [jnp.float32, jnp.float32], block_elems=1024)
    close(got[0], np.asarray(want[0]))
    close(got[1], np.asarray(want[1]), rtol=1e-4)


@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
def test_reduce_ops_with_ragged_tail(op):
    n = 1500                            # a partial last tile
    x = (np.random.RandomState(0).rand(n) + 0.5).astype(np.float32)
    red = {"add": tanp.sum, "max": tanp.max, "min": tanp.min, "mul": tanp.prod}[op]
    got, ctx = run_port(red, dict(x=x))
    assert ctx.stats["cuda_stages"] == 1
    want = jops.split_pipeline(lambda b, c: [b[0]], [jnp.asarray(x)], [],
                               [("reduce", op)], [jnp.float32], block_elems=1024)[0]
    rtol = 1e-3 if op == "mul" else 1e-4
    assert np.isclose(float(got[0]), float(want), rtol=rtol)
    oracle = {"add": np.sum, "max": np.max, "min": np.min, "mul": np.prod}[op]
    assert np.isclose(float(got[0]), oracle(x.astype(np.float64)), rtol=rtol)


def _jax_stats(fn, args, executor):
    with jmozart.session(executor=executor, **JAX_CFG) as ctx:
        out = fn(**{k: jnp.asarray(v) for k, v in args.items()})
        vals = [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]
    return vals, ctx


def test_reduction_consumed_in_its_stage_falls_back_counted():
    def chain(anp):
        def run(x):
            return anp.exp(anp.sum(x))     # exp joins the sum's stage
        return run

    x = np.linspace(0.0, 0.01, 100, dtype=np.float32)
    got, ctx = run_port(chain(tanp), dict(x=x))
    assert ctx.stats["cuda_fallback_stages"] == 1
    assert ctx.stats["cuda_stages"] == 0
    want, jctx = _jax_stats(chain(janp), dict(x=x), "pallas")
    assert jctx.stats["pallas_stages"] == 0
    close(got[0], want[0], rtol=1e-4)


def test_unsupported_dtype_and_untraceable_body_fall_back_counted():
    @splittable(x=Along(0), ret=Along(0), elementwise=True)
    def branchy(x):
        if x.shape[0] > 5:               # branch on a traced value: fx refuses
            return x * 2.0
        return x

    xi = np.arange(10, dtype=np.int32)
    got, ctx = run_port(tanp.square, dict(x=xi))
    assert ctx.stats["cuda_fallback_stages"] == 1
    np.testing.assert_array_equal(got[0], xi * xi)
    got, ctx = run_port(branchy, dict(x=np.ones(10, np.float32)))
    assert ctx.stats["cuda_fallback_stages"] == 1
    np.testing.assert_array_equal(got[0], np.full(10, 2.0, np.float32))


def test_bool_add_is_logical_or():
    """torch (like jnp) adds bools as logical or; the lowering must not sum
    1.0 + 1.0 and then feed 2.0 into arithmetic."""
    x = np.array([0.2, 0.7, 0.9, 0.1], np.float32)

    def chain(anp):
        def run(x):
            b = anp.add(anp.greater(x, 0.5), anp.greater(x, 0.8))
            return anp.multiply(b, x)
        return run

    got, ctx = run_port(chain(tanp), dict(x=x))
    assert ctx.stats["cuda_stages"] == 1
    want, _ = _jax_stats(chain(janp), dict(x=x), "eager")
    close(got[0], want[0])


def _lowered(fn, data):
    with tmozart.session(executor="cuda", device="cpu") as ctx:
        out = fn(**data)
        stage = ctx.last_plan()[0]
        concrete = {k: ctx.graph.resolve(si.value) for k, si in stage.inputs.items()}
        launch = cuda_exec.prepare_launch(stage, concrete, ctx)
        del out
    return launch


def test_black_scholes_program_reuses_slots():
    from repro_torch import workloads as tw
    program, split_inputs, bcasts, kinds = _lowered(
        tw.black_scholes, tw.black_scholes_data(64, device="cpu"))
    assert len(program.code) == 32 and program.n_split == 5
    assert program.n_slots <= 8                 # liveness, not one per op
    assert program.n_bcast == len(bcasts) == 4 and kinds == [("concat", "")] * 2


def test_wrapper_takes_plain_version_only_on_cpu():
    from repro_torch import workloads as tw
    launch = _lowered(tw.haversine, tw.haversine_data(100, device="cpu"))
    before = split_pipeline.launches
    got = split_pipeline(*launch)
    want = split_pipeline_ref(*launch)
    assert split_pipeline.launches == before       # the CPU never launches
    close(got[0].numpy(), want[0].numpy())
    program, split_inputs, bcasts, kinds = launch
    with pytest.raises(ValueError):
        split_pipeline(program, [x.to("meta") for x in split_inputs], bcasts, kinds)
    with pytest.raises(TypeError):
        split_pipeline(program, [x.double() for x in split_inputs], bcasts, kinds)


def test_program_operand_encoding_round_trips():
    for kind in (prog.KIND_INPUT, prog.KIND_SCALAR, prog.KIND_SLOT):
        for i in (0, 1, prog.MAX_INDEX):
            assert prog.decode(prog.operand(kind, i)) == (kind, i)
    with pytest.raises(ValueError):
        prog.operand(prog.KIND_SLOT, prog.MAX_INDEX + 1)


def test_user_function_with_tensor_methods_and_annotated_calls_lowers():
    """Tensor methods and annotated ops inside a user's elementwise function
    (the latter step aside under the fx trace) both become opcodes."""
    @splittable(x=Along(0), y=Along(0), ret=Along(0), elementwise=True)
    def blend(x, y):
        return tanp.exp(x).mul(0.25).add(y.abs()) - 1.0

    x = np.linspace(-1.0, 1.0, 50, dtype=np.float32)
    y = np.linspace(2.0, -2.0, 50, dtype=np.float32)
    got, ctx = run_port(blend, dict(x=x, y=y))
    assert ctx.stats["cuda_stages"] == 1 and ctx.stats["cuda_fallback_stages"] == 0
    close(got[0], np.exp(x) * 0.25 + np.abs(y) - 1.0)

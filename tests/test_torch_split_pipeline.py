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
    with tmozart.session(executor=executor, device="cpu", **PORT_CFG,
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
    """complex64 has no kernel dtype (nor a Mosaic type); a body calling a
    torch op that has no opcode cannot become a program."""
    @splittable(x=Along(0), ret=Along(0), elementwise=True)
    def branchy(x):
        return torch.clamp(x, 0.0, 5.0) * 2.0      # clamp: no opcode

    xc = (np.arange(10) + 1j).astype(np.complex64)
    got, ctx = run_port(tanp.square, dict(x=xc))
    assert ctx.stats["cuda_fallback_stages"] == 1
    np.testing.assert_allclose(got[0], xc * xc, rtol=1e-6)
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


# -- forwarding marks, and the kernel's geometry and load-path rules ----------


def _workload_program(name):
    from repro_torch import workloads as tw
    fn, data = {"black_scholes": (tw.black_scholes, tw.black_scholes_data(64, device="cpu")),
                "haversine": (tw.haversine, tw.haversine_data(64, device="cpu")),
                "quickstart": (tw.quickstart, tw.quickstart_data(100, device="cpu"))}[name]
    return _lowered(fn, data)


@pytest.mark.parametrize("name,marked,total", [("black_scholes", 20, 32),
                                                ("haversine", 12, 16),
                                                ("quickstart", 4, 4)])
def test_forwarding_marks_the_workloads(name, marked, total):
    """Results read only by the next instruction (and the last result, read
    only by outputs) stay in registers; the rest keep a slot."""
    program = _workload_program(name)[0]
    assert len(program.code) == total and program.forwarded == marked
    assert prog.forward(program) == program                 # idempotent
    assert prog.forward(prog.unmarked(program)) == program
    assert program.stored_slots == {"black_scholes": 4, "haversine": 3,
                                    "quickstart": 0}[name]


def _ssa_program(code, outputs, n_split=2):
    return prog.assemble([(prog.OP[op], srcs) for op, srcs in code],
                         [(s, False) for s in outputs], n_split=n_split, n_bcast=1, imms=())


def _kinds_read(program, pc):
    op, _dst, *ops = program.code[pc]
    return [prog.decode(x)[0] for x in ops[:prog.OPCODES[op][1]]]


def test_value_read_twice_or_later_is_never_forwarded():
    v = lambda j: ("v", j)
    # v0 is read by the next instruction and again later: stored
    p = _ssa_program([("EXP", [("in", 0)]), ("ADD", [v(0), ("in", 1)]),
                      ("MUL", [v(0), v(1)])], [v(2)])
    assert not p.code[0][1] & prog.NO_STORE
    assert _kinds_read(p, 1)[0] == prog.KIND_SLOT
    assert _kinds_read(p, 2) == [prog.KIND_SLOT, prog.KIND_FWD]
    # v0 is read only after a later instruction: stored
    p = _ssa_program([("EXP", [("in", 0)]), ("NEG", [("in", 1)]),
                      ("ADD", [v(0), v(1)])], [v(2)])
    assert not p.code[0][1] & prog.NO_STORE and p.code[1][1] & prog.NO_STORE
    assert _kinds_read(p, 2) == [prog.KIND_SLOT, prog.KIND_FWD]
    # read twice by the next instruction alone (x * x): forwarded to both
    p = _ssa_program([("EXP", [("in", 0)]), ("MUL", [v(0), v(0)])], [v(1)])
    assert p.code[0][1] & prog.NO_STORE
    assert _kinds_read(p, 1) == [prog.KIND_FWD, prog.KIND_FWD]


def test_an_outputs_slot_is_always_stored():
    v = lambda j: ("v", j)
    # v0 is an output and the next instruction's only operand; v1 an output
    # and the last result; v2 (dead) is stored nowhere
    p = prog.assemble([(prog.OP["EXP"], [("in", 0)]), (prog.OP["NEG"], [v(0)])],
                      [(v(0), False), (v(1), True)], n_split=1, n_bcast=0, imms=())
    assert not p.code[0][1] & prog.NO_STORE
    assert _kinds_read(p, 1) == [prog.KIND_SLOT]
    assert prog.decode(p.outputs[0][0]) == (prog.KIND_SLOT, p.code[0][1])
    assert prog.decode(p.outputs[1][0])[0] == prog.KIND_FWD
    for name in ("black_scholes", "haversine", "quickstart"):
        program = _workload_program(name)[0]
        stored = {dst for _op, dst, *_ in program.code if not dst & prog.NO_STORE}
        for src, _is_bool in program.outputs:
            kind, idx = prog.decode(src)
            assert kind in (prog.KIND_FWD, prog.KIND_INPUT) or idx in stored
            if kind == prog.KIND_FWD:
                assert program.code[-1][1] & prog.NO_STORE


def _exact(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", ["black_scholes", "haversine", "quickstart"])
def test_plain_version_is_bit_identical_with_and_without_marks(name):
    program, split_inputs, bcasts, kinds = _workload_program(name)
    plain = prog.unmarked(program)
    assert plain.forwarded == 0 and plain.n_slots == program.n_slots
    _exact(split_pipeline_ref(program, split_inputs, bcasts, kinds),
           split_pipeline_ref(plain, split_inputs, bcasts, kinds))


@pytest.mark.parametrize("op", [name for name, _arity in prog.OPCODES])
def test_one_instruction_program_is_bit_identical_forwarded(op):
    arity = prog.ARITY[op]
    x = torch.from_numpy(np.concatenate([SPECIAL, np.linspace(-3, 3, 23, dtype=np.float32)]))
    ins = [x, torch.roll(x, 5), (x > 0).to(torch.float32)]
    srcs = [prog.operand(prog.KIND_INPUT, i) for i in range(arity)] + [0] * (3 - arity)
    stored = prog.Program(code=((prog.OP[op], 0, *srcs),), n_split=3, n_bcast=0, n_slots=1,
                          imms=(), outputs=((prog.operand(prog.KIND_SLOT, 0), False),))
    marked = prog.forward(stored)
    assert marked.forwarded == 1 and marked.stored_slots == 0
    _exact(split_pipeline_ref(marked, ins, [], [("concat", "")]),
           split_pipeline_ref(stored, ins, [], [("concat", "")]))


def test_forwarding_needs_no_more_rows_than_liveness():
    """``fits_kernel`` refuses nothing it accepted when every result had a
    slot: the stored slots never exceed the most values live at once."""
    for name in ("black_scholes", "haversine", "quickstart"):
        program = prog.unmarked(_workload_program(name)[0])
        code, outs = prog._ssa(program)
        last = {}
        for i, (_op, srcs) in enumerate(code):
            for kind, j in srcs:
                if kind == "v":
                    last[j] = i
        for (kind, j), _b in outs:
            if kind == "v":
                last[j] = len(code)
        most = max(sum(1 for j, end in last.items() if j < i <= end) + 1
                   for i in range(len(code)))
        assert prog.forward(program).stored_slots <= most


def test_kernel_wrapper_rejects_operands_it_cannot_hold():
    from repro_torch.kernels import split_pipeline as sp
    fwd_first = prog.Program(code=((prog.OP["EXP"], prog.NO_STORE, prog.operand(
        prog.KIND_FWD, 0), 0, 0),), n_split=1, n_bcast=0, n_slots=1, imms=(),
        outputs=((prog.operand(prog.KIND_FWD, 0), False),))
    unstored = prog.Program(code=((prog.OP["EXP"], prog.NO_STORE | 1, prog.operand(
        prog.KIND_INPUT, 0), 0, 0),), n_split=1, n_bcast=0, n_slots=2, imms=(),
        outputs=((prog.operand(prog.KIND_SLOT, 1), False),))
    for bad in (fwd_first, unstored):
        with pytest.raises(ValueError):
            sp._check_program(bad)
    sp._check_program(_workload_program("black_scholes")[0])


def test_geometry_rule_fits_every_program_the_kernel_accepts():
    from repro_torch.kernels import split_pipeline as sp
    for n_in in range(1, sp.MAX_IN + 1):
        for stored in range(0, sp.MAX_ROWS - n_in + 1):
            g = sp.geometry(n_in, stored, sp.MAX_SCALARS, sp.MAX_INSTR, sp.MAX_OUT, True)
            assert g.tile in sp.TILES and g.stages in sp.STAGES
            assert g.smem == sp.smem_bytes(g.tile, g.stages, n_in, stored, sp.MAX_SCALARS,
                                           sp.MAX_INSTR, sp.MAX_OUT, True) <= sp.SMEM_PER_BLOCK
    # the 56-row extreme: 1024-element tiles and one stage just fit, unless
    # 256 decoded instructions and 16 reductions take the room
    assert sp.geometry(16, 40, 4, 79, 1, False)[:2] == (1024, 1)
    assert sp.geometry(16, 40, sp.MAX_SCALARS, sp.MAX_INSTR, sp.MAX_OUT, True).tile == 512


def test_geometry_rule_takes_the_most_resident_warps_then_three_ctas_then_larger_tiles():
    from repro_torch.kernels import split_pipeline as sp
    # Black-Scholes: with one stage, 3 CTAs of 2048 (24 warps) fit an SM, as
    # do 6 of 1024; the larger tile wins the tie
    bs, _s, _b, kinds = _workload_program("black_scholes")
    g = sp.program_geometry(bs, kinds)
    assert g[:2] == (2048, 1)
    # 48 B of barriers, 4 scalars and 33 decoded instructions of 16 B, 16
    # decoded outputs, then 5 ring rows and 4 slot rows of 8 KB
    assert g.smem == 768 + 8192 * 9
    assert sp.estimated_ctas_per_sm(2048, g.smem) == 3
    # occupancy alone decides: the same warps and >= 3 CTAs everywhere ->
    # the largest tile and the deepest ring; more warps of 2048 -> 2048
    same = {2048: 3, 1024: 6, 512: 12}
    assert sp.geometry(5, 4, 4, 32, 2, False, lambda t, smem: same[t])[:2] == (2048, 3)
    more = {2048: 4, 1024: 6, 512: 10}
    assert sp.geometry(2, 3, 6, 16, 1, False, lambda t, smem: more[t])[:2] == (2048, 3)
    # the same warps, but only 512-element tiles keep three CTAs on an SM
    few = {2048: 1, 1024: 2, 512: 4}
    assert sp.geometry(16, 11, 1, 24, 12, False, lambda t, smem: few[t])[:2] == (512, 3)
    with pytest.raises(ValueError):
        sp.geometry(2, 3, 6, 16, 1, False, lambda t, smem: 0)


@pytest.mark.parametrize("n", [1, 15, 16, 1023, 1024, 1025, 100_003])
def test_load_path_rule_on_edge_sizes(n):
    from repro_torch.kernels import split_pipeline as sp
    x = torch.zeros(n + 4)
    aligned = [x[:n], torch.zeros(n, dtype=torch.bool)]
    assert all(t.data_ptr() % 16 == 0 for t in aligned)
    assert sp.load_paths(aligned, 1024) == {"bulk": n // 1024,
                                             "plain": -(-n // 1024) - n // 1024}
    # one input one element off the 16-byte grid: every tile takes plain loads
    assert sp.load_paths([x[1:n + 1], aligned[1]], 1024) == {"bulk": 0,
                                                              "plain": -(-n // 1024)}
    assert sp.load_paths([x[4:n + 4]], 512)["bulk"] == n // 512   # 16 bytes in: aligned
    meta = [torch.empty(n, device="meta")]
    assert sum(sp.load_paths(meta, 512).values()) == -(-n // 512)

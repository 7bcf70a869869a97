"""The port's planner against the JAX planner: on the quickstart chain,
Black-Scholes, Haversine, data_cleaning and two multi-stage chains, the
stage node lists, input/output split types and escaping positions are equal.
Both sides run their rewrite pass (the default), so MZ502
common-subexpression sharing collapses Black-Scholes' repeated
``multiply(e_rt, strike)`` on both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import workloads as jw
from repro.core import Along as JAlong, Generic as JGeneric, Reduce as JReduce
from repro.core import annotated_numpy as janp
from repro.core import mozart as jmozart
from repro.core import splittable as jsplittable
from repro_torch import workloads as tw
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
N = 1000


@jsplittable(x=JAlong(0), y=JAlong(0), ret=JAlong(0), elementwise=True,
             name="saxpy")
def jsaxpy(x, y):
    return 2.0 * x + y


@jsplittable(x=JGeneric("S"), ret=JReduce("add"), name="total")
def jtotal(x):
    return jnp.sum(x)


def jquickstart(x, y):
    return jtotal(janp.multiply(janp.exp(jsaxpy(x, y)), 0.5))


def data_cleaning(anp, nan):
    """Fig 4e's numeric part over one column (the column extraction of the
    table integration is not ported)."""
    def run(vals):
        bad = anp.logical_or(anp.less(vals, 0.0), anp.greater(vals, 1e6))
        clean = anp.where(bad, nan, vals)
        valid = anp.sum(anp.where(anp.isnan(clean), 0.0, 1.0))
        total = anp.sum(anp.where(anp.isnan(clean), 0.0, clean))
        return valid, total
    return run


def two_stage(anp):
    """A reduction whose result is broadcast into a second stage."""
    def run(x):
        a = anp.exp(x)
        s = anp.sum(a)
        return anp.multiply(a, s), s
    return run


def normalize_twice(anp):
    """Paper §3.1: normalize rows then columns — two split axes, two stages."""
    def run(m):
        return (anp.normalize_axis(anp.normalize_axis(m, 1), 0),)
    return run


def _cases():
    rs = np.random.RandomState(0)
    vals = (rs.rand(N) * 2e6 - 1e5).astype(np.float32)
    mat = rs.rand(N // 10, 10).astype(np.float32)
    vec = rs.rand(N).astype(np.float32)
    bs = {k: np.asarray(v) for k, v in jw.black_scholes_data(N).items()}
    hv = dict(lat2=rs.uniform(-1.5, 1.5, N).astype(np.float32),
              lon2=rs.uniform(-3.1, 3.1, N).astype(np.float32))
    qs = dict(x=np.arange(N, dtype=np.float32) / 1e6, y=np.ones(N, np.float32))
    return {
        "quickstart": (jquickstart, tw.quickstart, qs),
        "black_scholes": (jw.black_scholes, tw.black_scholes, bs),
        "haversine": (jw.haversine, tw.haversine, hv),
        "data_cleaning": (data_cleaning(janp, jnp.float32(np.nan)),
                          data_cleaning(tanp, float("nan")), dict(vals=vals)),
        "two_stage": (two_stage(janp), two_stage(tanp), dict(x=vec)),
        "normalize_twice": (normalize_twice(janp), normalize_twice(tanp),
                            dict(m=mat)),
    }


def describe(stages):
    return [dict(nodes=[n.fn.name for n in s.nodes],
                 inputs=[repr(si.split_type) for si in s.inputs.values()],
                 outs=[repr(s.out_types[n.id]) for n in s.nodes],
                 escaping=s.escape_positions()) for s in stages]


def _plans(name, pipeline):
    jfn, tfn, data = _cases()[name]
    with jmozart.session(pipeline=pipeline, **JAX_CFG) as jctx:
        jout = jfn(**{k: jnp.asarray(v) for k, v in data.items()})
        jplan = describe(jctx.last_plan())
    with tmozart.session(device="cpu", **PORT_CFG, pipeline=pipeline) as tctx:
        tout = tfn(**{k: torch.from_numpy(v) for k, v in data.items()})
        tplan = describe(tctx.last_plan())
    del jout, tout
    return jplan, tplan


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("name", ["quickstart", "black_scholes", "haversine",
                                  "data_cleaning", "two_stage",
                                  "normalize_twice"])
def test_stage_plan_matches_jax(name, pipeline):
    jplan, tplan = _plans(name, pipeline)
    assert tplan == jplan
    assert tplan                                    # something was planned


def test_black_scholes_is_one_stage_of_32_ops():
    _jplan, tplan = _plans("black_scholes", True)
    assert len(tplan) == 1 and len(tplan[0]["nodes"]) == 32
    assert len(tplan[0]["escaping"]) == 2           # call and put

"""The port's selective state-space sub-layer (``models/ssm.py``, Hymba's SSM
heads) against the JAX package's, on the CPU.

One layer's parameters are drawn with numpy from a seed at hymba-1.5b's
smoke widths (d_model 80, d_in 160, state 4, conv 4, dt_rank 5), the
float32 leaves (``dt_bias``, ``A_log``, ``D_skip``) away from their init
values so that each term carries weight, and go through
``repro.models.ssm.ssm_block`` and the port's in train mode, in prefill from
a carried state, and in a prefill followed by 3 decode steps.  S = 130 runs
past ``chunked_scan``'s 128-step chunk (a chunked scan and a ragged tail on
the JAX side).  Tolerance: ``TOL`` of ``tests/test_kernels.py``, float32
rtol 2e-5, bfloat16 2e-2, with atol the same share of the reference's
largest magnitude (near-zero entries carry only absolute error), on the
output and on both state leaves (h, conv).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jsmoke
from repro.models import ssm as jssm
from repro_torch.configs import registry
from repro_torch.models import ssm as tssm

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_LEAVES = ("dt_bias", "A_log", "D_skip")


def _cfgs(dtype):
    return (jsmoke("hymba-1.5b").with_runtime(dtype=JDT[dtype]),
            registry.get_smoke_config("hymba-1.5b").with_runtime(dtype=TDT[dtype]))


def _params(cfg, seed=0):
    """One layer's parameters as float32 numpy arrays."""
    d = cfg.d_model
    d_in, dt_rank, N, W = tssm._dims(cfg)
    r = np.random.RandomState(seed)
    n = lambda *s, scale: (r.randn(*s) * scale).astype(np.float32)
    return {
        "in_proj": n(d, 2 * d_in, scale=d ** -0.5),
        "conv_w": n(W, d_in, scale=0.2),
        "x_proj": n(d_in, dt_rank + 2 * N, scale=d_in ** -0.5),
        "dt_proj": n(dt_rank, d_in, scale=dt_rank ** -0.5),
        "dt_bias": n(d_in, scale=0.5),
        "A_log": np.log(np.tile(np.arange(1, N + 1, dtype=np.float32), (d_in, 1)))
        + n(d_in, N, scale=0.1),
        "D_skip": 1.0 + n(d_in, scale=0.2),
        "out_proj": n(d_in, d, scale=d_in ** -0.5),
    }


def _both(p, dtype):
    """The numpy parameters on each side, as each package's init types them."""
    dt = lambda k, f32, other: f32 if k in F32_LEAVES else other
    jp = {k: jnp.asarray(v, dt(k, jnp.float32, JDT[dtype])) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(dt(k, torch.float32, TDT[dtype])) for k, v in p.items()}
    return jp, tp


def _x(shape, seed, dtype):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _close(got, want, dtype, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _same(tout, tstate, jout, jstate, dtype, what):
    assert tout.dtype == TDT[dtype]
    assert tstate.h.dtype == torch.float32 and tstate.conv.dtype == TDT[dtype]
    _close(tout, jout, dtype, f"{what}: y")
    _close(tstate.h, jstate.h, dtype, f"{what}: h")
    _close(tstate.conv, jstate.conv, dtype, f"{what}: conv")


def _state(cfg, B, seed, dtype):
    """A carried state from a seed: h float32, the conv window in the model dtype."""
    d_in, _, N, W = tssm._dims(cfg)
    r = np.random.RandomState(seed)
    h = (r.randn(B, d_in, N) * 0.5).astype(np.float32)
    conv = r.randn(B, W - 1, d_in).astype(np.float32)
    return (jssm.SSMState(h=jnp.asarray(h), conv=jnp.asarray(conv, JDT[dtype])),
            tssm.SSMState(h=torch.from_numpy(h), conv=torch.from_numpy(conv).to(TDT[dtype])))


@pytest.mark.parametrize("S", [17, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_train_matches_jax(dtype, S):
    """From zeros: the causal conv's W-1 zero pad and h0 = 0."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_params(tcfg, seed=1), dtype)
    jx, tx = _x((2, S, 80), seed=2, dtype=dtype)
    jout, jst = jssm.ssm_block(jp, jx, jcfg, None, mode="train")
    tout, tst = tssm.ssm_block(tp, tx, tcfg, None, mode="train")
    _same(tout, tst, jout, jst, dtype, f"train S {S}")


@pytest.mark.parametrize("S", [5, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_prefill_from_a_state_matches_jax(dtype, S):
    """A prefill continuing a carried state: the conv pads with
    ``state.conv`` and the recurrence starts at ``state.h``."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_params(tcfg, seed=3), dtype)
    jx, tx = _x((2, S, 80), seed=4, dtype=dtype)
    js, ts = _state(tcfg, 2, seed=5, dtype=dtype)
    jout, jst = jssm.ssm_block(jp, jx, jcfg, js, mode="prefill")
    tout, tst = tssm.ssm_block(tp, tx, tcfg, ts, mode="prefill")
    _same(tout, tst, jout, jst, dtype, f"prefill from a state, S {S}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_prefill_then_decode_matches_jax(dtype):
    """A 130-token prefill, then 3 O(1) decode steps, each on the state the
    last one returned: y and (h, conv) after every step."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_params(tcfg, seed=6), dtype)
    jx, tx = _x((2, 133, 80), seed=7, dtype=dtype)
    jout, jst = jssm.ssm_block(jp, jx[:, :130], jcfg, None, mode="prefill")
    tout, tst = tssm.ssm_block(tp, tx[:, :130], tcfg, None, mode="prefill")
    _same(tout, tst, jout, jst, dtype, "prefill")
    for t in range(130, 133):
        jout, jst = jssm.ssm_block(jp, jx[:, t:t + 1], jcfg, jst, mode="decode")
        tout, tst = tssm.ssm_block(tp, tx[:, t:t + 1], tcfg, tst, mode="decode")
        assert tout.shape == (2, 1, 80)
        _same(tout, tst, jout, jst, dtype, f"decode step {t}")


def test_decode_equals_the_prefill_it_continues():
    """The port against itself, float32: a prefill of 12 tokens then 4
    decode steps gives the outputs and state of one 16-token prefill."""
    _, tcfg = _cfgs("float32")
    _, tp = _both(_params(tcfg, seed=8), "float32")
    _, tx = _x((3, 16, 80), seed=9, dtype="float32")
    whole, wst = tssm.ssm_block(tp, tx, tcfg, None, mode="prefill")
    out, st = tssm.ssm_block(tp, tx[:, :12], tcfg, None, mode="prefill")
    steps = [out]
    for t in range(12, 16):
        o, st = tssm.ssm_block(tp, tx[:, t:t + 1], tcfg, st, mode="decode")
        steps.append(o)
    torch.testing.assert_close(torch.cat(steps, 1), whole, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(st.h, wst.h, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(st.conv, wst.conv, rtol=2e-5, atol=2e-5)


def test_decode_refuses_a_sequence_or_a_missing_state():
    _, tcfg = _cfgs("float32")
    _, tp = _both(_params(tcfg, seed=10), "float32")
    with pytest.raises(ValueError, match="one token"):
        tssm.ssm_block(tp, torch.zeros(1, 2, 80), tcfg, tssm.init_ssm_state(tcfg, 1, "cpu"),
                       mode="decode")
    with pytest.raises(ValueError, match="one token"):
        tssm.ssm_block(tp, torch.zeros(1, 1, 80), tcfg, None, mode="decode")


def test_ssm_block_gradients_match_jax():
    """d/d(x, every parameter) of sum(y · w), float32, S = 130, against
    ``jax.grad``: rtol 1e-4 with atol 1e-6·max|g|, as
    ``tests/test_torch_models.py``."""
    import jax
    jcfg, tcfg = _cfgs("float32")
    p = _params(tcfg, seed=11)
    x = np.random.RandomState(12).randn(2, 130, 80).astype(np.float32)
    w = np.random.RandomState(13).randn(2, 130, 80).astype(np.float32)

    def jloss(p, x):
        out, _ = jssm.ssm_block(p, x, jcfg, None, mode="train")
        return jnp.sum(out * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                               jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, _ = tssm.ssm_block(tp, tx, tcfg, None, mode="train")
    torch.sum(out * torch.from_numpy(w)).backward()
    for name, got, want in [("x", tx.grad, jgx)] + [(k, tp[k].grad, jgp[k]) for k in p]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=name)


def test_ssm_block_runs_on_meta():
    """Abstract evaluation (a cold ``mozart`` capture) runs the block on
    ``meta`` tensors: shapes and dtypes only."""
    _, tcfg = _cfgs("bfloat16")
    _, tp = _both(_params(tcfg, seed=14), "bfloat16")
    tp = {k: v.to("meta") for k, v in tp.items()}
    st = tssm.init_ssm_state(tcfg, 3, "meta")
    out, new = tssm.ssm_block(tp, torch.empty(3, 7, 80, dtype=torch.bfloat16, device="meta"),
                              tcfg, st, mode="prefill")
    assert out.shape == (3, 7, 80) and out.dtype == torch.bfloat16 and out.is_meta
    assert new.h.shape == (3, 160, 4) and new.h.dtype == torch.float32
    assert new.conv.shape == (3, 3, 160) and new.conv.dtype == torch.bfloat16

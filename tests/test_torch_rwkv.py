"""The port's RWKV-6 layer (``models/rwkv.py``: ``time_mix`` and
``channel_mix``) against the JAX package's, on the CPU.

One layer's parameters are drawn with numpy from a seed at rwkv6-1.6b's
smoke widths (d_model 64, head_dim 16: 4 heads, d_ff 224), the float32
leaves away from their init values (``mu_*`` in (0, 1), ``decay_base``
around -6, ``bonus_u``, ``ln_x``) so that each term carries weight, and go
through ``repro.models.rwkv`` and the port, from a carried state, in a
prefill, and in decode steps on the state the last call returned.  S = 130
runs past ``chunked_scan``'s 128-step chunk.  Tolerance: ``TOL`` of
``tests/test_kernels.py``, float32 rtol 2e-5, bfloat16 2e-2, with atol the
same share of the reference's largest magnitude, on the output and on every
state field (wkv, shift_t, shift_c); the fields a block passes through
unchanged (the reference's quirk) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jsmoke
from repro.models import rwkv as jrwkv
from repro_torch.configs import registry
from repro_torch.models import rwkv as trwkv

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
D = 64


def _cfgs(dtype):
    return (jsmoke("rwkv6-1.6b").with_runtime(dtype=JDT[dtype]),
            registry.get_smoke_config("rwkv6-1.6b").with_runtime(dtype=TDT[dtype]))


def _params(cfg, seed=0):
    """One layer's parameters as float32 numpy arrays, and the names of the
    leaves each package keeps in float32."""
    Fd = cfg.d_ff
    H, hd = trwkv._dims(cfg)
    r = np.random.RandomState(seed)
    n = lambda *s, scale: (r.randn(*s) * scale).astype(np.float32)
    mu = lambda: r.uniform(0.1, 0.9, D).astype(np.float32)
    p = {f"mu_{c}": mu() for c in ("r", "k", "v", "g", "w", "ck")}
    p.update({f"w_{c}": n(D, D, scale=D ** -0.5) for c in ("r", "k", "v", "g", "o", "cr")})
    p.update({
        "decay_base": -6.0 + n(D, scale=1.0),
        "decay_a": n(D, trwkv.LORA, scale=D ** -0.5),
        "decay_b": n(trwkv.LORA, D, scale=trwkv.LORA ** -0.5),
        "bonus_u": n(H, hd, scale=0.5),
        "ln_x": 1.0 + n(D, scale=0.2),
        "w_ck": n(D, Fd, scale=D ** -0.5),
        "w_cv": n(Fd, D, scale=Fd ** -0.5),
    })
    return p


def _f32_leaf(name: str) -> bool:
    return name.startswith("mu_") or name in ("decay_base", "bonus_u", "ln_x")


def _both(p, dtype):
    jp = {k: jnp.asarray(v, jnp.float32 if _f32_leaf(k) else JDT[dtype]) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if _f32_leaf(k) else TDT[dtype])
          for k, v in p.items()}
    return jp, tp


def _x(shape, seed, dtype):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _state(cfg, B, seed, dtype):
    """A carried state from a seed: wkv float32, the shifts in the model dtype."""
    H, hd = trwkv._dims(cfg)
    r = np.random.RandomState(seed)
    wkv = (r.randn(B, H, hd, hd) * 0.3).astype(np.float32)
    st, sc = (r.randn(B, D).astype(np.float32) for _ in range(2))
    return (jrwkv.RWKVState(jnp.asarray(wkv), jnp.asarray(st, JDT[dtype]),
                            jnp.asarray(sc, JDT[dtype])),
            trwkv.RWKVState(torch.from_numpy(wkv), torch.from_numpy(st).to(TDT[dtype]),
                            torch.from_numpy(sc).to(TDT[dtype])))


def _close(got, want, dtype, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _same(tout, tst, jout, jst, dtype, what):
    assert tout.dtype == TDT[dtype]
    assert tst.wkv.dtype == torch.float32
    assert tst.shift_t.dtype == tst.shift_c.dtype == TDT[dtype]
    _close(tout, jout, dtype, f"{what}: out")
    for field in trwkv.RWKVState._fields:
        _close(getattr(tst, field), getattr(jst, field), dtype, f"{what}: {field}")


@pytest.mark.parametrize("S", [9, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_matches_jax(dtype, S):
    """From a carried state: the token shift takes ``shift_t``, the WKV
    recurrence starts at ``wkv``; ``shift_c`` passes through unchanged."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_params(tcfg, seed=1), dtype)
    jx, tx = _x((2, S, D), seed=2, dtype=dtype)
    js, ts = _state(tcfg, 2, seed=3, dtype=dtype)
    jout, jst = jrwkv.time_mix(jp, jx, jcfg, js)
    tout, tst = trwkv.time_mix(tp, tx, tcfg, ts)
    _same(tout, tst, jout, jst, dtype, f"time_mix S {S}")
    assert tst.shift_c is ts.shift_c


@pytest.mark.parametrize("S", [9, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(dtype, S):
    """The shift takes ``shift_c``; ``wkv`` and ``shift_t`` pass through."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_params(tcfg, seed=4), dtype)
    jx, tx = _x((2, S, D), seed=5, dtype=dtype)
    js, ts = _state(tcfg, 2, seed=6, dtype=dtype)
    jout, jst = jrwkv.channel_mix(jp, jx, jcfg, js)
    tout, tst = trwkv.channel_mix(tp, tx, tcfg, ts)
    _same(tout, tst, jout, jst, dtype, f"channel_mix S {S}")
    assert tst.wkv is ts.wkv and tst.shift_t is ts.shift_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_steps_match_jax(dtype):
    """A 130-token time mix and channel mix from the zero state, then 3
    one-token steps of both, each on the state the last call returned."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_params(tcfg, seed=7), dtype)
    jx, tx = _x((2, 133, D), seed=8, dtype=dtype)
    jst, tst = jrwkv.init_rwkv_state(jcfg, 2), trwkv.init_rwkv_state(tcfg, 2, "cpu")
    for lo, hi in ((0, 130), (130, 131), (131, 132), (132, 133)):
        jt, jst = jrwkv.time_mix(jp, jx[:, lo:hi], jcfg, jst)
        tt, tst = trwkv.time_mix(tp, tx[:, lo:hi], tcfg, tst)
        _same(tt, tst, jt, jst, dtype, f"time_mix [{lo}, {hi})")
        jc, jst = jrwkv.channel_mix(jp, jx[:, lo:hi], jcfg, jst)
        tc, tst = trwkv.channel_mix(tp, tx[:, lo:hi], tcfg, tst)
        _same(tc, tst, jc, jst, dtype, f"channel_mix [{lo}, {hi})")


def test_steps_equal_the_sequence_they_continue():
    """The port against itself, float32: 12 tokens then 4 one-token calls
    give the outputs and state of one 16-token call."""
    _, tcfg = _cfgs("float32")
    _, tp = _both(_params(tcfg, seed=9), "float32")
    _, tx = _x((3, 16, D), seed=10, dtype="float32")
    zero = trwkv.init_rwkv_state(tcfg, 3, "cpu")
    whole, wst = trwkv.time_mix(tp, tx, tcfg, zero)
    out, st = trwkv.time_mix(tp, tx[:, :12], tcfg, zero)
    parts = [out]
    for t in range(12, 16):
        o, st = trwkv.time_mix(tp, tx[:, t:t + 1], tcfg, st)
        parts.append(o)
    torch.testing.assert_close(torch.cat(parts, 1), whole, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(st.wkv, wst.wkv, rtol=2e-5, atol=2e-5)
    assert torch.equal(st.shift_t, wst.shift_t)


def test_time_and_channel_mix_gradients_match_jax():
    """d/d(x, every parameter) of sum(channel_mix(time_mix(x)) · w),
    float32, S = 130, against ``jax.grad``: rtol 1e-4 with atol
    1e-6·max|g|, as ``tests/test_torch_models.py``."""
    jcfg, tcfg = _cfgs("float32")
    p = _params(tcfg, seed=11)
    x = np.random.RandomState(12).randn(2, 130, D).astype(np.float32)
    w = np.random.RandomState(13).randn(2, 130, D).astype(np.float32)

    def jloss(p, x):
        st = jrwkv.init_rwkv_state(jcfg, 2)
        y, st = jrwkv.time_mix(p, x, jcfg, st)
        y, _ = jrwkv.channel_mix(p, y, jcfg, st)
        return jnp.sum(y * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                               jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, st = trwkv.time_mix(tp, tx, tcfg, trwkv.init_rwkv_state(tcfg, 2, "cpu"))
    y, _ = trwkv.channel_mix(tp, y, tcfg, st)
    torch.sum(y * torch.from_numpy(w)).backward()
    for name, got, want in [("x", tx.grad, jgx)] + [(k, tp[k].grad, jgp[k]) for k in p]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=name)


def test_time_mix_runs_on_meta():
    """Abstract evaluation (a cold ``mozart`` capture) runs the layer on
    ``meta`` tensors: shapes and dtypes only."""
    _, tcfg = _cfgs("bfloat16")
    _, tp = _both(_params(tcfg, seed=14), "bfloat16")
    tp = {k: v.to("meta") for k, v in tp.items()}
    st = trwkv.init_rwkv_state(tcfg, 3, "meta")
    x = torch.empty(3, 7, D, dtype=torch.bfloat16, device="meta")
    out, st = trwkv.time_mix(tp, x, tcfg, st)
    out, st = trwkv.channel_mix(tp, out, tcfg, st)
    assert out.shape == (3, 7, D) and out.dtype == torch.bfloat16 and out.is_meta
    assert st.wkv.shape == (3, 4, 16, 16) and st.wkv.dtype == torch.float32
    assert st.shift_t.dtype == st.shift_c.dtype == torch.bfloat16

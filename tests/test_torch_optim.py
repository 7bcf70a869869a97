"""The port's AdamW (``jnp`` and ``kernel`` paths) and its Mozart pipeline
(``fused`` and ``cuda`` executors) against the JAX package's on the same
numpy inputs, on the CPU (the ``kernel`` path and the ``cuda`` executor run
their kernels' plain versions there).

Tolerances, as ``tests/test_substrate.py::TestOptim``: float32 parameters
rtol 3e-5 / atol 3e-6 (the same float32 arithmetic; the kernel paths take
``1 - b1`` in float32, the ``jnp`` paths in float64 rounded once, an ulp
apart), moments rtol 1e-5 / atol 1e-7.  bfloat16 parameters within one
bfloat16 ulp (rtol 2^-7): an ulp-level float32 difference may round the
other way.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_7b as jgemma
from repro.core import mozart as jmozart
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.optim import mozart_adamw as jmozart_adamw
from repro_torch.models import weights
from repro_torch.optim import adamw
from repro_torch.optim.mozart_adamw import mozart_adamw_update

JAX_CFG = dict(handoff=False, plan_cache=False, autotune=False)


def _np_setup(n=1000, seed=0):
    r = np.random.RandomState(seed)
    params = {"b": r.randn(16, 8).astype(np.float32),
              "w": r.randn(n).astype(np.float32)}
    grads = {k: r.randn(*v.shape).astype(np.float32) for k, v in params.items()}
    return params, grads


def _torch(tree):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in weights.flatten(tree).items()}


def _jax(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _close(got: dict, want_tree, rtol=3e-5, atol=3e-6):
    want = weights.flatten(jax.tree_util.tree_map(np.asarray, want_tree))
    assert list(got) == list(want)
    for name, t in got.items():
        np.testing.assert_allclose(t.float().numpy(), np.asarray(want[name], np.float32),
                                   rtol=rtol, atol=atol, err_msg=name)


def _two_steps(params_np, grads_np, port_update, jax_update):
    """Two successive updates on both sides (step 1 and 2, moments carried)."""
    tp, tg = _torch(params_np), _torch(grads_np)
    jp, jg = _jax(params_np), _jax(grads_np)
    ts, js = adamw.init(tp), jadamw.init(jp)
    cfg, jcfg = adamw.AdamWConfig(), jadamw.AdamWConfig()
    for _ in range(2):
        tp, ts, _m = port_update(tp, tg, ts, cfg)
        jp, js, _j = jax_update(jp, jg, js, jcfg)
    return tp, ts, jp, js


@pytest.mark.parametrize("jax_path", ["jnp", "kernel"])
@pytest.mark.parametrize("path", ["jnp", "kernel"])
def test_update_paths_match_jax(path, jax_path):
    params, grads = _np_setup()
    tp, ts, jp, js = _two_steps(
        params, grads,
        lambda p, g, s, c: adamw.update(p, g, s, c, path=path),
        lambda p, g, s, c: jadamw.update(p, g, s, c, path=jax_path))
    _close(tp, jp)
    _close(ts.m, js.m, rtol=1e-5, atol=1e-7)
    _close(ts.v, js.v, rtol=1e-5, atol=1e-7)
    assert int(ts.step) == int(js.step) == 2 and ts.step.dtype == torch.int32


def test_kernel_path_on_gemma_bf16_leaves_matches_jax():
    """The 11 leaves of gemma-7b's smoke config in their dtypes (bfloat16
    matrices, float32 embedding and norms) through both kernel paths."""
    cfg = jgemma.smoke_config()
    params = jax.tree_util.tree_map(np.asarray, jtfm.init_model(jax.random.PRNGKey(0), cfg))
    r = np.random.RandomState(1)
    grads = jax.tree_util.tree_map(lambda a: (r.randn(*a.shape) * 0.01).astype(np.float32),
                                   params)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype.name == "bfloat16" else torch.float32)
        for k, v in weights.flatten(params).items()}
    tg = {k: torch.from_numpy(np.array(weights.flatten(grads)[k])).to(t.dtype)
          for k, t in tp.items()}
    jg = jax.tree_util.tree_map(lambda g, p: jnp.asarray(g, p.dtype), grads, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    cfg_o, jcfg_o = adamw.AdamWConfig(), jadamw.AdamWConfig()
    np_, ns, _ = adamw.update(tp, tg, adamw.init(tp), cfg_o, path="kernel")
    jnp_, jns, _ = jadamw.update(jp, jg, jadamw.init(jp), jcfg_o, path="kernel")
    jflat = weights.flatten(jax.tree_util.tree_map(np.asarray, jnp_))
    for name, t in np_.items():
        assert t.dtype == tp[name].dtype, name
        rtol = 2.0 ** -7 if t.dtype == torch.bfloat16 else 3e-5
        np.testing.assert_allclose(t.float().numpy(), np.asarray(jflat[name], np.float32),
                                   rtol=rtol, atol=3e-6, err_msg=name)
    _close(ns.m, jns.m, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("executor", ["fused", "cuda"])
def test_mozart_update_matches_jax(executor):
    params, grads = _np_setup(n=3000)
    stats = []

    def port(p, g, s, c):
        out = mozart_adamw_update(p, g, s, c, executor=executor, batch_elements=700)
        stats.append(out[2]["stats"])
        return out

    tp, ts, jp, js = _two_steps(params, grads, port,
                                lambda p, g, s, c: jadamw.update(p, g, s, c, path="jnp"))
    _close(tp, jp)
    _close(ts.m, js.m, rtol=1e-5, atol=1e-7)
    _close(ts.v, js.v, rtol=1e-5, atol=1e-7)
    if executor == "cuda":
        for st in stats:
            assert st["cuda_stages"] == st["stages"]
            assert st.get("cuda_fallback_stages", 0) == 0


@contextlib.contextmanager
def _spy_jax_sessions(monkeypatch):
    """Record the contexts of the JAX ``mozart_adamw_update``'s sessions,
    configured like the port (no handoff, plan cache or tuner)."""
    seen = []
    real = jmozart.session

    @contextlib.contextmanager
    def spy(**kw):
        with real(**kw, **JAX_CFG) as ctx:
            seen.append(ctx)
            yield ctx

    monkeypatch.setattr(jmozart_adamw.mozart, "session", spy)
    yield seen


def test_mozart_stages_equal_the_jax_planner(monkeypatch):
    """gemma-7b's smoke leaves: equal-size leaves share a stage (the four
    attention projections make one stage of 16 split inputs and 12 outputs,
    within the split-pipeline kernel's limits), on both planners."""
    cfg = jgemma.smoke_config().with_runtime(dtype=jnp.float32)
    jp = jtfm.init_model(jax.random.PRNGKey(0), cfg)
    r = np.random.RandomState(2)
    jg = jax.tree_util.tree_map(lambda a: jnp.asarray(r.randn(*a.shape), jnp.float32), jp)
    with _spy_jax_sessions(monkeypatch) as seen:
        jout, jstate, _ = jmozart_adamw.mozart_adamw_update(
            jp, jg, jadamw.init(jp), jadamw.AdamWConfig(), executor="eager")
    tp, tg = _torch(jax.tree_util.tree_map(np.asarray, jp)), \
        _torch(jax.tree_util.tree_map(np.asarray, jg))
    tout, tstate, metrics = mozart_adamw_update(tp, tg, adamw.init(tp),
                                                adamw.AdamWConfig(), executor="cuda")
    st = metrics["stats"]
    assert len(seen) == 1 and st["stages"] == seen[0].stats["stages"] == 5
    assert st["cuda_stages"] == 5 and st.get("cuda_fallback_stages", 0) == 0
    _close(tout, jout)
    _close(tstate.v, jstate.v, rtol=1e-5, atol=1e-7)


def test_schedule_matches_jax():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jcfg = jadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    steps = list(range(0, 111, 3)) + [10, 100]
    got = [float(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32))) for s in steps]
    want = [float(jadamw.schedule(jcfg, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert float(adamw.schedule(cfg, torch.tensor(0, dtype=torch.int32))) == 0.0
    assert float(adamw.schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(adamw.schedule(cfg, torch.tensor(100))) == pytest.approx(0.1)


def test_global_norm_and_step_scalars_stay_on_the_device_tensor():
    params, grads = _np_setup()
    tg = _torch(grads)
    got = adamw.global_norm(tg)
    want = jadamw.global_norm(_jax(grads))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    sc, lr, gnorm = adamw.step_scalars(adamw.AdamWConfig(), torch.tensor(1, dtype=torch.int32), tg)
    assert all(isinstance(x, torch.Tensor) for x in (sc, lr, gnorm))
    assert sc.shape == (8,) and sc.dtype == torch.float32
    np.testing.assert_allclose(float(sc[5]), min(1.0, 1.0 / float(want)), rtol=1e-6)


def test_unknown_path_raises():
    params, grads = _np_setup()
    tp, tg = _torch(params), _torch(grads)
    with pytest.raises(ValueError, match="path"):
        adamw.update(tp, tg, adamw.init(tp), adamw.AdamWConfig(), path="mozart")


def test_equal_leaves_share_one_kernel_stage():
    """Four equal-size leaves (as gemma's wq/wk/wv/wo) plan into ONE stage
    of 16 split inputs whose outputs are only the new p, m and v (12), so
    it fits the split-pipeline kernel even as the session's last stage."""
    r = np.random.RandomState(4)
    names = ["wk", "wo", "wq", "wv"]
    params = {n: r.randn(1000).astype(np.float32) for n in names}
    grads = {n: r.randn(1000).astype(np.float32) for n in names}
    tp, ts, jp, js = _two_steps(
        params, grads,
        lambda p, g, s, c: mozart_adamw_update(p, g, s, c, executor="cuda"),
        lambda p, g, s, c: jadamw.update(p, g, s, c, path="jnp"))
    _close(tp, jp)
    _close(ts.v, js.v, rtol=1e-5, atol=1e-7)
    tp2 = _torch(params)
    _p, _s, metrics = mozart_adamw_update(tp2, _torch(grads), adamw.init(tp2),
                                          adamw.AdamWConfig(), executor="cuda")
    st = metrics["stats"]
    assert st["stages"] == st["cuda_stages"] == 1
    assert st.get("cuda_fallback_stages", 0) == 0

"""Logit softcap and the banded sliding-window path against the JAX
package, on the CPU.

The same numpy-seeded inputs go through the reference's attention
functions and the port's (``_banded_attention``; the softcap of the dense,
blocked, decode and cross-attention paths), then through tiny models: a
banded config's train logits (against the reference and against the
port's own default path, as ``tests/test_models.py``'s banded test), a
softcap config's train, prefill and decode logits, its loss and every
gradient against ``jax.grad``, and a softcap config served through the
continuous batcher against the JAX batcher.

Tolerances: ``TOL`` as ``tests/test_kernels.py`` (float32 rtol/atol 2e-5;
bfloat16 2e-2, the port's bfloat16 against the reference's float32 on the
same bf16-rounded values: the reference's CPU backend has no bf16 x bf16 ->
f32 dot); logits and attention outputs rtol 2e-5 with atol 2e-5 *
max|reference|; every float32 gradient rtol 1e-4 with atol 1e-6 * max|g|,
as ``tests/test_torch_models.py``; the banded against the default path
rtol/atol 2e-4, as the reference's own test; served tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro.models.config import AttnConfig as JAttn, ModelConfig as JModel
from repro_torch.core import plan_cache as tplan_cache
from repro_torch.core.serving import ContinuousBatcher
from repro_torch.kernels import flash_attention as fl
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttfm
from repro_torch.models import weights
from repro_torch.models.config import AttnConfig as TAttn, ModelConfig as TModel

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
CAP = 30.0
MAX_LEN = 48


def _close(got, want, what="", rtol=2e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _qkv(B, Hq, Hkv, S, D, seed, dtype=torch.float32):
    """numpy draws, rounded to ``dtype``: (port tensors, JAX float32 arrays)."""
    r = np.random.RandomState(seed)
    ts = [torch.from_numpy(r.randn(B, h, S, D).astype(np.float32)).to(dtype)
          for h in (Hq, Hkv, Hkv)]
    return ts, [jnp.asarray(t.float().numpy()) for t in ts]


# ---------------------------------------------------------------------------
# the attention functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("softcap", [None, CAP], ids=["plain", "softcap"])
@pytest.mark.parametrize("shape", [(2, 4, 2, 96, 16, 16), (1, 2, 1, 130, 8, 32)],
                         ids=["even", "ragged"])
def test_banded_attention_matches_jax(shape, softcap, dtype):
    """Queries in blocks of w over their own and the previous key block;
    130 = 4 blocks of 32 and a ragged tail of 2 (padding keys masked)."""
    B, Hq, Hkv, S, D, w = shape
    (q, k, v), (jq, jk, jv) = _qkv(B, Hq, Hkv, S, D, seed=S + w, dtype=dtype)
    want = jattn._banded_attention(jq, jk, jv, window=w, softcap=softcap)
    got = tattn._banded_attention(q, k, v, window=w, softcap=softcap)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), **TOL[dtype])
    # the banded path is the dense windowed path's function
    dense = tattn._dense_attention(q, k, v, causal=True, window=w, softcap=softcap)
    np.testing.assert_allclose(got.float().numpy(), dense.float().numpy(), **TOL[dtype])


def test_banded_attention_is_self_attention_only():
    (q, k, v), _ = _qkv(1, 2, 1, 40, 8, seed=0)
    with pytest.raises(AssertionError, match="self-attention"):
        tattn._banded_attention(q, k[:, :, :39], v[:, :, :39], window=8)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("path", ["dense", "blocked"])
def test_softcap_in_dense_and_blocked_matches_jax(path, window):
    """GQA (2 kv of 4 query heads), 23 causal keys; blocked in blocks of 5
    (a ragged last block), with a per-row pad-key mask."""
    (q, k, v), (jq, jk, jv) = _qkv(2, 4, 2, 23, 16, seed=3)
    mask = np.arange(23)[None] >= np.array([0, 4])[:, None]
    jkw = dict(causal=True, window=window, softcap=CAP, kv_mask=jnp.asarray(mask))
    tkw = dict(causal=True, window=window, softcap=CAP, kv_mask=torch.from_numpy(mask))
    if path == "dense":
        want = jattn._dense_attention(jq, jk, jv, **jkw)
        got = tattn._dense_attention(q, k, v, **tkw)
    else:
        want = jattn._blocked_attention(jq, jk, jv, block_k=5, **jkw)
        got = tattn._blocked_attention(q, k, v, block_k=5, **tkw)
    _close(got, want, f"{path} softcap")
    # the cap changed something: the same call without it differs
    plain = tattn._dense_attention(q, k, v, causal=True, window=window,
                                   kv_mask=torch.from_numpy(mask))
    assert not torch.allclose(got, plain, atol=1e-4)


@pytest.mark.parametrize("window", [None, 4])
def test_softcap_in_decode_matches_jax(window):
    """Two cache blocks (the exact LSE combine), per-slot lengths and
    starts; scores scaled up so the cap bites."""
    jcfg = JModel(name="t", family="dense", n_layers=1, d_model=64, d_ff=128,
                  vocab_size=97, dtype=jnp.float32, kv_cache_blocks=2,
                  attn=JAttn(n_heads=4, n_kv_heads=2, head_dim=16))
    c = jattn.init_kv_cache(jcfg, 3, 12, per_slot=True)
    r = np.random.RandomState(5)
    k = (r.randn(*c.k.shape) * 4).astype(np.float32)
    v = r.randn(*c.v.shape).astype(np.float32)
    length, start = np.array([3, 11, 7], np.int32), np.array([0, 2, 1], np.int32)
    q = (r.randn(3, 4, 1, 16) * 4).astype(np.float32)
    jc = jattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(length), jnp.asarray(start))
    tc = tattn.KVCache(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(length),
                       torch.from_numpy(start))
    want = jattn._decode_attention_blocked(jnp.asarray(q), jc, window=window, softcap=CAP)
    got = tattn._decode_attention_blocked(torch.from_numpy(q), tc, window=window, softcap=CAP)
    _close(got, want, "decode softcap")
    plain = tattn._decode_attention_blocked(torch.from_numpy(q), tc, window=window)
    assert not torch.allclose(got, plain, atol=1e-4)


def test_softcap_in_cross_attention_matches_jax():
    """The cross path passes the layer's cap (the reference's
    attention.py:384-385); q from ``wq``, encoder K/V of 9 positions."""
    jcfg = JModel(name="t", family="audio", n_layers=1, d_model=64, d_ff=128,
                  vocab_size=97, dtype=jnp.float32,
                  attn=JAttn(n_heads=4, n_kv_heads=2, head_dim=16, logit_softcap=2.0))
    tcfg = TModel(name="t", family="audio", n_layers=1, d_model=64, d_ff=128,
                  vocab_size=97, dtype=torch.float32,
                  attn=TAttn(n_heads=4, n_kv_heads=2, head_dim=16, logit_softcap=2.0))
    p = jax.tree_util.tree_map(np.asarray, jattn.init_attn(jax.random.PRNGKey(4), jcfg))
    r = np.random.RandomState(4)
    x = r.randn(2, 5, 64).astype(np.float32)
    ek, ev = (r.randn(2, 2, 9, 16).astype(np.float32) * 3 for _ in range(2))
    want, _, _ = jattn.attention_block(p, jnp.asarray(x), jcfg,
                                       cross_kv=(jnp.asarray(ek), jnp.asarray(ev)))
    tp = {n: torch.from_numpy(np.array(a)) for n, a in p.items()}
    got, _ = tattn.attention_block(tp, torch.from_numpy(x), tcfg,
                                   cross_kv=(torch.from_numpy(ek), torch.from_numpy(ev)))
    _close(got, want, "cross softcap")
    uncapped = dataclasses.replace(tcfg, attn=dataclasses.replace(tcfg.attn, logit_softcap=None))
    plain, _ = tattn.attention_block(tp, torch.from_numpy(x), uncapped,
                                     cross_kv=(torch.from_numpy(ek), torch.from_numpy(ev)))
    assert not torch.allclose(got, plain, atol=1e-4)


# ---------------------------------------------------------------------------
# tiny models
# ---------------------------------------------------------------------------


def _tiny(attn_kw=None, **kw):
    """``tests/test_models.py``'s tiny config, in both packages (float32)."""
    base = dict(name="t", family="dense", n_layers=2, d_model=64, d_ff=128, vocab_size=97)
    base.update(kw)
    a = dict(n_heads=4, n_kv_heads=2, head_dim=16, **(attn_kw or {}))
    return (JModel(**base, dtype=jnp.float32, attn=JAttn(**a)),
            TModel(**base, dtype=torch.float32, attn=TAttn(**a)))


def _carry(jcfg, tcfg, seed):
    params = jtfm.init_model(jax.random.PRNGKey(seed), jcfg)
    return params, weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")


def _tokens(shape, seed, vocab=97):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def test_banded_config_forward_matches_jax_and_the_default_path():
    """Window 8 over 40 tokens (S > 2w): the banded path in both packages,
    and the port's banded logits against its own default (dense windowed)
    path, as ``tests/test_models.py::test_banded_config_path_matches_full_model``."""
    jcfg, tcfg = _tiny({"window": 8})
    jband, tband = (c.with_runtime(banded_attention=True) for c in (jcfg, tcfg))
    params, model = _carry(jcfg, tcfg, seed=0)
    tokens = _tokens((2, 40), seed=1)
    want, _ = jtfm.forward_train(params, jband, tokens=jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = ttfm.forward_train(model, tband, torch.from_numpy(tokens))
        default, _ = ttfm.forward_train(model, tcfg, torch.from_numpy(tokens))
    _close(got, want, "banded logits")
    np.testing.assert_allclose(got.numpy(), default.numpy(), rtol=2e-4, atol=2e-4)


def test_banded_switch_order(monkeypatch):
    """The kernel first (a banded config takes it with its window), then the
    banded path only for causal self-attention past 2w without a pad mask,
    else dense; a softcap layer never takes the kernel."""
    calls = []
    for name in ("_banded_attention", "_dense_attention", "_blocked_attention"):
        real = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, _r=real, **kw:
                            calls.append(_n) or _r(*a, **kw))
    real_ref = fl.attention_ref
    monkeypatch.setattr(fl, "attention_ref", lambda *a, **kw:
                        calls.append(("kernel", kw.get("window"))) or real_ref(*a, **kw))
    _, tcfg = _tiny({"window": 8})
    band = tcfg.with_runtime(banded_attention=True)
    _, model = _carry(_tiny({"window": 8})[0], tcfg, seed=0)
    tok = torch.from_numpy(_tokens((1, 20), seed=2))
    cases = [
        (band, 20, dict(use_kernel=True), [("kernel", 8)] * 2),
        (band, 20, dict(use_kernel=False), ["_banded_attention"] * 2),
        (band, 16, dict(use_kernel=False), ["_dense_attention"] * 2),       # S == 2w
        (band, 20, dict(use_kernel=False, pad_mask=torch.ones(1, 20, dtype=torch.bool)),
         ["_dense_attention"] * 2),
        (dataclasses.replace(band, attn=dataclasses.replace(band.attn, logit_softcap=CAP)),
         20, dict(use_kernel=True), ["_banded_attention"] * 2),
    ]
    for cfg, S, kw, want in cases:
        calls.clear()
        ttfm.prefill(model, cfg, tok[:, :S], **kw)
        assert calls == want, (S, kw, calls)


@pytest.fixture(scope="module")
def softcap_pair():
    """``tests/test_models.py``'s ``qk_norm`` tiny config: qk-norm and a
    softcap of 30.  At these scores (qk-norm bounds one by head_dim /
    sqrt(head_dim) = 4 times the norm scales' product) the cap's slope is
    ~0.98, which the gradients see; the logits test scales ``q_norm`` so
    the cap bites."""
    jcfg, tcfg = _tiny({"qk_norm": True, "logit_softcap": CAP})
    return jcfg, tcfg, jtfm.init_model(jax.random.PRNGKey(6), jcfg)


def test_softcap_train_prefill_and_decode_logits_match_jax(softcap_pair):
    """Teacher-forced logits, prefill of 6 tokens and 6 decode steps, all
    against the reference; the port's decode against its own teacher
    forcing, as ``tests/test_models.py::test_decode_matches_teacher_forcing``.
    ``q_norm`` is scaled by 16 (``wq`` would be normalised away), so the
    cap bites."""
    jcfg, tcfg, params = softcap_pair
    attn = dict(params["layers"]["attn"], q_norm=params["layers"]["attn"]["q_norm"] * 16)
    params = dict(params, layers=dict(params["layers"], attn=attn))
    model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    tokens = _tokens((2, 12), seed=7)
    jfull, _ = jtfm.forward_train(params, jcfg, tokens=jnp.asarray(tokens))
    with torch.no_grad():
        tfull, _ = ttfm.forward_train(model, tcfg, torch.from_numpy(tokens))
    _close(tfull, jfull, "train logits")
    jl, jc = jtfm.prefill(params, jcfg, tokens=jnp.asarray(tokens[:, :6]),
                          caches=jtfm.init_caches(jcfg, 2, 16))
    tl, tc = ttfm.prefill(model, tcfg, torch.from_numpy(tokens[:, :6]),
                          caches=ttfm.init_caches(tcfg, 2, 16, device="cpu"))
    _close(tl, jl, "prefill logits")
    for t in range(6, 12):
        jl, jc = jtfm.decode_step(params, jcfg, jnp.asarray(tokens[:, t:t + 1]), jc)
        tl, tc = ttfm.decode_step(model, tcfg, torch.from_numpy(tokens[:, t:t + 1]), tc)
        _close(tl, jl, f"decode step {t}")
        np.testing.assert_allclose(tl[:, 0].numpy(), tfull[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)
    # the cap bites: the same weights uncapped move the logits by over a
    # tenth of their largest magnitude
    plain = dataclasses.replace(tcfg, attn=dataclasses.replace(tcfg.attn, logit_softcap=None))
    with torch.no_grad():
        uncapped, _ = ttfm.forward_train(model, plain, torch.from_numpy(tokens))
    assert float((uncapped - tfull).abs().max()) > 0.1 * float(tfull.abs().max())


@pytest.mark.parametrize("which", ["softcap", "banded", "softcap_blocked"])
def test_loss_and_every_grad_match_jax(softcap_pair, which):
    """The loss and the gradient of every leaf against ``jax.grad``: the
    softcap config (dense path; blocked path in key blocks of 5), and a
    banded config with a softcap over 40 tokens (banded path)."""
    if which == "banded":
        jcfg, tcfg = (c.with_runtime(banded_attention=True)
                      for c in _tiny({"window": 8, "logit_softcap": CAP}))
        params = jtfm.init_model(jax.random.PRNGKey(8), jcfg)
        model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
        tokens = _tokens((2, 41), seed=8)
    else:
        jcfg, tcfg, params = softcap_pair
        if which == "softcap_blocked":
            jcfg, tcfg = (c.with_runtime(dense_attn_threshold=4, attn_block_k=5)
                          for c in (jcfg, tcfg))
        model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
        tokens = _tokens((2, 13), seed=9)
    jl, jg = jax.value_and_grad(jlm.loss_fn)(params, {"tokens": jnp.asarray(tokens)}, jcfg)
    tl = tlm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, tcfg)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=2e-5)
    jflat = weights.flatten(jax.tree_util.tree_map(np.asarray, jg))
    tflat = weights.leaves(model)
    assert list(tflat) == list(jflat)
    for name, p in tflat.items():
        want = jflat[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=name)


# ---------------------------------------------------------------------------
# serving: a softcap config through the batcher
# ---------------------------------------------------------------------------

SPECS = [(5, 3), (9, 7), (6, 2), (3, 5), (8, 4), (9, 1)]


@pytest.fixture(scope="module")
def served():
    """internlm2-20b's smoke config (GQA) with a softcap of 2 (the cap
    bites at these scores); the JAX batcher's tokens on the same weights,
    requests, 2 slots and buckets."""
    from repro.core import plan_cache as jplan_cache
    from repro.core.serving import ContinuousBatcher as JBatcher
    base = jsmoke("internlm2-20b").with_runtime(dtype=jnp.float32)
    jcfg = base.with_runtime(attn=dataclasses.replace(base.attn, logit_softcap=2.0))
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tcfg = TModel(**{**kw, "attn": TAttn(**dataclasses.asdict(jcfg.attn)),
                     "dtype": torch.float32})
    params = jtfm.init_model(jax.random.PRNGKey(14), jcfg)
    model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    model.requires_grad_(False)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32) for p, _ in SPECS]
    jplan_cache.clear()
    b = JBatcher(jcfg, params, 2, MAX_LEN, driver="jit")
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    reqs = [b.make_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
    b.run(reqs)
    jplan_cache.clear()
    return tcfg, model, prompts, [r.out for r in reqs]


@pytest.mark.parametrize("driver", ["jit", "mozart"])
def test_softcap_batcher_matches_the_jax_batcher(served, driver):
    """Six requests through two slots (left-padded prefill buckets, so the
    dense path with its pad mask; decode over per-slot caches): tokens equal
    to the reference batcher's."""
    tcfg, model, prompts, want = served
    tplan_cache.clear()
    b = ContinuousBatcher(tcfg, model, 2, MAX_LEN, driver=driver, device="cpu")
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    reqs = [b.make_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
    stats = b.run(reqs)
    assert [r.out for r in reqs] == want
    assert stats["completed"] == len(SPECS)
    tplan_cache.clear()

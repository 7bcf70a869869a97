"""The port's encoder-decoder family (seamless-m4t-large-v2) against the
JAX package: ``encode``, ``_cross_kv_per_layer``, the decoder's
cross-attention through ``forward_train``, ``prefill`` and
``decode_step(enc_out=...)``, the loss and every gradient (encoder,
``cross`` and ``ln3`` leaves included), the encdec data batches, the
parameter carry-across and which attentions reach the kernel's switch.

JAX ``init_model`` makes the parameters and ``weights.from_numpy`` carries
them across exactly; both packages then run the same numpy inputs, drawn
from a seed, at the seamless smoke config (2 encoder and 2 decoder layers,
d 64, 4 heads of 16, plain GELU MLP), ``enc_embeds`` of 11 frames.

Tolerances (``tests/test_kernels.py``): float32 2e-5, bfloat16 2e-2,
relative to max|reference|; gradients rtol 1e-4 with atol 2e-5·max|g|;
cache lengths and data batches exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jsmoke
from repro.data.pipeline import DataPipeline as JPipeline
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.data.pipeline import DataPipeline
from repro_torch.kernels import flash_attention as fl
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttfm
from repro_torch.models import weights

ARCH = "seamless-m4t-large-v2"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}         # tests/test_kernels.py
S_ENC = 11


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _pair(dtype, seed=0):
    """The smoke configs and the reference's parameters, carried across;
    the norm scales (``ln1``/``ln2``/``ln3``, ``enc_norm``) moved off their
    init ones, so that each carries weight in the gradients."""
    jcfg = jsmoke(ARCH).with_runtime(dtype=JDT[dtype])
    tcfg = tsmoke(ARCH).with_runtime(dtype=TDT[dtype])
    params = jax.tree_util.tree_map(np.asarray, jtfm.init_model(jax.random.PRNGKey(seed), jcfg))
    r = np.random.RandomState(seed)
    flat = weights.flatten(params)
    for name, v in flat.items():
        if name.endswith(("ln1", "ln2", "ln3", "enc_norm", "final_norm")):
            flat[name] = (v + 0.1 * r.randn(*v.shape)).astype(np.float32)
    params = weights.unflatten(flat)
    return jcfg, tcfg, params, weights.from_numpy(params, tcfg, "cpu")


def _enc(seed, B=2):
    return np.random.RandomState(seed).randn(B, S_ENC, 64).astype(np.float32)


def _tokens(seed, shape=(2, 9)):
    return np.random.RandomState(seed + 100).randint(0, 256, shape).astype(np.int32)


def test_init_adds_the_encoder_and_the_cross_blocks():
    _, tcfg, params, model = _pair("float32")
    flat = weights.flatten(model.tree())
    assert flat["enc_layers.attn.wq"].shape == (2, 64, 64)
    assert flat["enc_norm"].shape == (64,) and flat["layers.ln3"].shape == (2, 64)
    assert {"layers.cross.wq", "layers.cross.wk", "layers.cross.wv",
            "layers.cross.wo"} <= set(flat)
    assert ttfm.layer_kind(tcfg) == "cross"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_cross_kv_match_jax(dtype):
    """The bidirectional encoder stack and every layer's (L, B, Hkv, S_enc,
    D) cross K/V of its output; the reference under ``jax.jit``."""
    jcfg, tcfg, params, model = _pair(dtype, 1)
    enc = _enc(1)
    jout = jax.jit(lambda p, e: jtfm.encode(p, e, jcfg))(params, jnp.asarray(enc, JDT[dtype]))
    jk, jv = jax.jit(lambda p, e: jtfm._cross_kv_per_layer(p, e, jcfg))(params, jout)
    with torch.no_grad():
        tout = ttfm.encode(model, _t(enc, TDT[dtype]), tcfg)
        tk, tv = ttfm._cross_kv_per_layer(model, tout, tcfg)
    assert tout.dtype == TDT[dtype] and tk.shape == (2, 2, 4, S_ENC, 16)
    _close(tout, np.asarray(jout, np.float32), TOL[dtype], "encoder output")
    _close(tk, np.asarray(jk, np.float32), TOL[dtype], "cross k")
    _close(tv, np.asarray(jv, np.float32), TOL[dtype], "cross v")


def test_encoder_is_bidirectional():
    """Changing the last frame moves the encoder output at the first."""
    _, tcfg, _, model = _pair("float32", 1)
    enc = _enc(1)
    moved = enc.copy()
    moved[:, -1] += 1.0
    with torch.no_grad():
        a = ttfm.encode(model, _t(enc), tcfg)
        b = ttfm.encode(model, _t(moved), tcfg)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


def _f32_reference(params):
    """The reference's float32 config and the same (bfloat16-rounded)
    parameter values in float32: its CPU backend runs no bfloat16
    encoder-decoder, even under ``jax.jit`` (``BF16 x BF16 = F32`` dots are
    unimplemented there), so the port's bfloat16 run is held against the
    reference's float32 one on the same values, within the bfloat16 ``TOL``."""
    jcfg = jsmoke(ARCH).with_runtime(dtype=jnp.float32)
    return jcfg, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_matches_jax(dtype):
    jcfg, tcfg, params, model = _pair(dtype, 2)
    enc, tok = _enc(2), _tokens(2)
    if dtype == "bfloat16":
        jcfg, params = _f32_reference(params)
        enc = np.asarray(torch.from_numpy(enc).to(torch.bfloat16).float())
    jl, _ = jax.jit(lambda p, t, e: jtfm.forward_train(p, jcfg, tokens=t, enc_embeds=e))(
        params, jnp.asarray(tok), jnp.asarray(enc, jcfg.dtype))
    with torch.no_grad():
        tl, aux = ttfm.forward_train(model, tcfg, tokens=_t(tok), enc_embeds=_t(enc, TDT[dtype]))
    assert tl.dtype == TDT[dtype] and float(aux) == 0.0
    _close(tl, np.asarray(jl, np.float32), TOL[dtype], "logits")


def _same_cache(tc, jc, tol, what):
    t = weights.cache_to_numpy(tc)
    _close(t.k, jc.k, tol, f"{what} k")
    _close(t.v, jc.v, tol, f"{what} v")
    np.testing.assert_array_equal(t.length, np.asarray(jc.length))
    np.testing.assert_array_equal(t.start, np.asarray(jc.start))


def test_prefill_and_three_decode_steps_with_enc_out_match_jax():
    """float32: ``prefill(tokens, enc_embeds=...)`` into a 16-position cache
    (logits and the filled cache), then 3 ``decode_step(enc_out=encode(...))``
    on the reference's greedy tokens."""
    jcfg, tcfg, params, model = _pair("float32", 3)
    enc, tok = _enc(3), _tokens(3)
    jc = jtfm.init_caches(jcfg, 2, 16)
    tc = ttfm.init_caches(tcfg, 2, 16, device="cpu")
    jlog, jc = jtfm.prefill(params, jcfg, tokens=jnp.asarray(tok), enc_embeds=jnp.asarray(enc),
                            caches=jc)
    tlog, tc = ttfm.prefill(model, tcfg, tokens=_t(tok), enc_embeds=_t(enc), caches=tc)
    _close(tlog, jlog, TOL["float32"], "prefill logits")
    _same_cache(tc, jc, TOL["float32"], "after the prefill")
    jout = jtfm.encode(params, jnp.asarray(enc), jcfg)
    with torch.no_grad():
        tout = ttfm.encode(model, _t(enc), tcfg)
    for step in range(3):
        nxt = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None].astype(np.int32)
        jlog, jc = jtfm.decode_step(params, jcfg, jnp.asarray(nxt), jc, enc_out=jout)
        tlog, tc = ttfm.decode_step(model, tcfg, _t(nxt), tc, enc_out=tout)
        _close(tlog, jlog, TOL["float32"], f"decode step {step} logits")
        _same_cache(tc, jc, TOL["float32"], f"after decode step {step}")


def test_decode_without_enc_out_skips_cross_attention_as_the_reference():
    jcfg, tcfg, params, model = _pair("float32", 4)
    tok = _tokens(4, (2, 5))
    jc = jtfm.init_caches(jcfg, 2, 8)
    tc = ttfm.init_caches(tcfg, 2, 8, device="cpu")
    _, jc = jtfm.prefill(params, jcfg, tokens=jnp.asarray(tok), enc_embeds=jnp.asarray(_enc(4)),
                         caches=jc)
    _, tc = ttfm.prefill(model, tcfg, tokens=_t(tok), enc_embeds=_t(_enc(4)), caches=tc)
    nxt = tok[:, :1]
    jlog, _ = jtfm.decode_step(params, jcfg, jnp.asarray(nxt), jc)
    tlog, _ = ttfm.decode_step(model, tcfg, _t(nxt), tc)
    _close(tlog, jlog, TOL["float32"], "decode logits without enc_out")


def test_greedy_generate_fails_as_the_reference():
    """``lm.greedy_generate`` gives an encoder-decoder model no encoder
    input: the reference's ``encode`` gets ``None`` and raises, and so does
    the port's."""
    jcfg, tcfg, params, model = _pair("float32", 5)
    prompt = _tokens(5, (1, 4))
    with pytest.raises(AttributeError):
        jlm.greedy_generate(params, jcfg, jnp.asarray(prompt), 2)
    with pytest.raises(AttributeError):
        tlm.greedy_generate(model, tcfg, _t(prompt), 2)


def _batch(seed, B=2, S=16):
    r = np.random.RandomState(seed)
    return {"tokens": r.randint(0, 256, (B, S + 1)).astype(np.int32),
            "enc_embeds": r.randn(B, S_ENC, 64).astype(np.float32)}


def test_make_batch_views_passes_the_encoder_input():
    _, tcfg, _, _ = _pair("float32")
    b = {k: _t(v) for k, v in _batch(6).items()}
    kw, labels, mask = tlm.make_batch_views(b, tcfg)
    assert set(kw) == {"tokens", "enc_embeds"} and mask is None
    assert kw["enc_embeds"] is b["enc_embeds"]
    assert torch.equal(kw["tokens"], b["tokens"][:, :-1])
    assert torch.equal(labels, b["tokens"][:, 1:])


def test_f32_loss_and_every_grad_match_jax():
    """The loss (CE chunks of 5 over 16 positions) and every gradient,
    encoder, ``cross`` and ``ln3`` leaves included, in the reference's leaf
    order."""
    jcfg, tcfg, params, model = _pair("float32", 7)
    batch = _batch(7)
    jl, jg = jax.value_and_grad(jlm.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, 5)
    tl = tlm.loss_fn(model, {k: _t(v) for k, v in batch.items()}, tcfg, 5)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = weights.flatten(jax.tree_util.tree_map(np.asarray, jg))
    tflat = weights.leaves(model)
    assert list(tflat) == list(jflat)
    assert {"enc_norm", "enc_layers.attn.wq", "layers.cross.wk", "layers.ln3"} <= set(tflat)
    for name, p in tflat.items():
        want = jflat[name]
        assert np.any(want), name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=TOL["float32"] * float(np.abs(want).max()),
                                   err_msg=name)


def test_bf16_loss_matches_jax():
    """The port in bfloat16 against the reference in float32 on the same
    values (``_f32_reference``)."""
    jcfg, tcfg, params, model = _pair("bfloat16", 8)
    jcfg, params = _f32_reference(params)
    batch = _batch(8)
    tb = {"tokens": _t(batch["tokens"]), "enc_embeds": _t(batch["enc_embeds"], torch.bfloat16)}
    jb = {"tokens": jnp.asarray(batch["tokens"]),
          "enc_embeds": jnp.asarray(tb["enc_embeds"].float().numpy())}
    jl = jax.jit(lambda p, b: jlm.loss_fn(p, b, jcfg))(params, jb)
    with torch.no_grad():
        tl = tlm.loss_fn(model, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mozart", [True, False])
def test_encdec_batches_equal_jax_bit_for_bit(use_mozart, dtype):
    """tokens and ``enc_embeds`` (B, 64, d), unscaled, in ``cfg.dtype``, at
    steps 0, 1 and 7."""
    jcfg = jsmoke(ARCH).with_runtime(dtype=JDT[dtype])
    tcfg = tsmoke(ARCH).with_runtime(dtype=TDT[dtype])
    jp = JPipeline(jcfg, batch=3, seq=10, seed=2, use_mozart=use_mozart)
    tp = DataPipeline(tcfg, batch=3, seq=10, seed=2, use_mozart=use_mozart, device="cpu")
    for step in (0, 1, 7):
        want, got = jp.batch_for_step(step), tp.batch_for_step(step)
        assert set(got) == set(want) == {"tokens", "enc_embeds"}
        assert tuple(got["enc_embeds"].shape) == (3, 64, 64)
        for k in want:
            w = np.asarray(want[k])
            g = got[k]
            assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), k
            np.testing.assert_array_equal(g.float().numpy() if g.dtype == torch.bfloat16
                                          else g.numpy(), w.astype(np.float32)
                                          if w.dtype.name == "bfloat16" else w, err_msg=k)


def test_carry_across_round_trip_is_exact():
    """bfloat16: the encoder stack, ``enc_norm``, ``cross`` and ``ln3``
    carry across and back bit for bit."""
    _, tcfg, params, model = _pair("bfloat16", 9)
    assert model["enc_layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert model["enc_norm"].dtype == model["layers"]["ln3"].dtype == torch.float32
    back = weights.flatten(weights.to_numpy(model))
    for name, want in weights.flatten(params).items():
        np.testing.assert_array_equal(back[name], np.asarray(want, np.float32), name)
    again = weights.from_numpy(weights.to_numpy(model), tcfg, "cpu")
    for (n, x), y in zip(weights.leaves(model).items(), weights.leaves(again).values()):
        assert x.dtype == y.dtype and torch.equal(x, y), n


def test_meta_twin_and_fingerprint_cover_the_new_leaves():
    _, _, _, model = _pair("float32")
    names = [n for n, *_ in model.mozart_fingerprint()[1]]
    assert "enc_layers.attn.wq" in names and "layers.ln3" in names
    twin = model.mozart_meta()
    assert twin["enc_norm"].device.type == "meta"
    assert twin["layers"]["cross"]["wk"].shape == model["layers"]["cross"]["wk"].shape


@pytest.fixture
def attention_ref_calls(monkeypatch):
    """Each call of the kernel's plain version (what the kernel's wrapper
    runs on CPU tensors): its ``causal``."""
    calls = []
    real = fl.attention_ref

    def counted(*a, causal=True, **kw):
        calls.append(causal)
        return real(*a, causal=causal, **kw)

    monkeypatch.setattr(fl, "attention_ref", counted)
    return calls


def test_encoder_reaches_the_kernel_non_causal_and_cross_attention_never(attention_ref_calls):
    """A prefill with ``use_kernel=True``: the encoder's 2 layers reach the
    kernel's switch with ``causal=False``, the decoder's 2 self-attentions
    with ``causal=True``, cross-attention not at all; the logits equal the
    plain path's.  Without the kernel nothing reaches it."""
    _, tcfg, _, model = _pair("float32", 10)
    enc, tok = _t(_enc(10)), _t(_tokens(10))
    plain, _ = ttfm.prefill(model, tcfg, tokens=tok, enc_embeds=enc, use_kernel=False)
    assert attention_ref_calls == []
    kern, _ = ttfm.prefill(model, tcfg, tokens=tok, enc_embeds=enc, use_kernel=True)
    assert attention_ref_calls == [False, False, True, True]
    _close(kern, plain.numpy(), TOL["float32"], "kernel path vs plain")

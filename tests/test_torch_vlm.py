"""The port's vision-language family (qwen2-vl-2b) against the JAX package:
M-RoPE (``layers.apply_mrope`` and the attention's position handling),
the ``input_embeds`` input with three position streams through
``forward_train``, ``prefill`` and ``decode_step``, greedy generation on
tokens, the loss and every gradient, the vlm data batches and the
parameter carry-across.

JAX ``init_model`` makes the parameters and ``weights.from_numpy`` carries
them across exactly; both packages then run the same numpy inputs, drawn
from a seed, at the qwen2-vl-2b smoke config (2 layers, d 64, 4 heads over
2 kv heads of 16, sections (2, 3, 3)).  Positions lay out a text prefix,
an image of 3 x 4 patches (t fixed, h and w by row and column) and a text
tail after it, as Qwen2-VL lays out one image.

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
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttfm
from repro_torch.models import weights

ARCH = "qwen2-vl-2b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}         # tests/test_kernels.py


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def image_positions(B: int, prefix: int, rows: int, cols: int, tail: int) -> np.ndarray:
    """(3, B, S) t/h/w streams of one image between two text spans: the
    prefix at t = h = w = 0..prefix-1, the image's rows x cols patches at
    t = prefix, h = prefix + row, w = prefix + col, the tail from
    prefix + max(rows, cols) upward on all three."""
    text = np.arange(prefix)
    r, c = np.divmod(np.arange(rows * cols), cols)
    img = np.stack([np.full(rows * cols, prefix), prefix + r, prefix + c])
    after = prefix + max(rows, cols) + np.arange(tail)
    pos = np.concatenate([np.stack([text] * 3), img, np.stack([after] * 3)], axis=1)
    return np.broadcast_to(pos[:, None], (3, B, pos.shape[1])).astype(np.int32).copy()


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

SECTIONS = [((16, 24, 24), 128), ((2, 3, 3), 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections,D", SECTIONS)
def test_apply_mrope_matches_jax(sections, D, dtype):
    """Three distinct streams (B 2, H 3, S 11), the same numbers into both."""
    r = np.random.RandomState(D)
    x = r.randn(2, 3, 11, D).astype(np.float32)
    pos = r.randint(0, 500, (3, 2, 11)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x, JDT[dtype]), jnp.asarray(pos), 1e6, sections)
    got = tlayers.apply_mrope(_t(x, TDT[dtype]), _t(pos), 1e6, sections)
    assert got.dtype == TDT[dtype]
    _close(got, np.asarray(want, np.float32), TOL[dtype], f"mrope {sections}")


@pytest.mark.parametrize("sections,D", SECTIONS)
def test_apply_mrope_with_equal_streams_is_apply_rope(sections, D):
    """Text: three equal streams reduce M-RoPE to standard RoPE (float32,
    within 2e-5; the port's and the reference's RoPE alike)."""
    r = np.random.RandomState(D + 1)
    x = _t(r.randn(2, 3, 9, D).astype(np.float32))
    pos = _t(r.randint(0, 300, (2, 9)).astype(np.int32))
    got = tlayers.apply_mrope(x, pos.expand(3, 2, 9), 1e4, sections)
    want = tlayers.apply_rope(x, pos, 1e4)
    _close(got, want.numpy(), TOL["float32"], "equal streams")
    jwant = jlayers.apply_rope(jnp.asarray(x.numpy()), jnp.asarray(pos.numpy()), 1e4)
    _close(got, jwant, TOL["float32"], "equal streams vs the reference's RoPE")


def test_apply_mrope_refuses_sections_not_covering_half_the_head():
    with pytest.raises(AssertionError):
        tlayers.apply_mrope(torch.zeros(1, 1, 2, 16), torch.zeros(3, 1, 2, dtype=torch.int32),
                            1e4, (2, 3, 2))


def _pair(dtype, seed=0):
    jcfg = jsmoke(ARCH).with_runtime(dtype=JDT[dtype])
    tcfg = tsmoke(ARCH).with_runtime(dtype=TDT[dtype])
    params = jax.tree_util.tree_map(np.asarray, jtfm.init_model(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, params, weights.from_numpy(params, tcfg, "cpu")


@pytest.mark.parametrize("ndim", [2, 3])
def test_qkv_takes_mrope_and_broadcasts_2d_positions(ndim):
    """``_qkv`` on layer 0 of the smoke model: 3-D positions pass through,
    2-D ones become three equal streams, as the reference's ``_qkv``."""
    jcfg, tcfg, params, model = _pair("float32")
    r = np.random.RandomState(ndim)
    x = r.randn(2, 7, 64).astype(np.float32)
    pos = (r.randint(0, 50, (3, 2, 7)) if ndim == 3 else r.randint(0, 50, (2, 7))).astype(np.int32)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
    tp = {k: v[0] for k, v in model["layers"]["attn"].items()}
    want = jattn._qkv(jp, jnp.asarray(x), jcfg.attn, jnp.asarray(pos), jcfg)
    with torch.no_grad():
        got = tattn._qkv(tp, _t(x), tcfg.attn, _t(pos), tcfg)
    for g, w, n in zip(got, want, "qkv"):
        _close(g, w, TOL["float32"], n)


# ---------------------------------------------------------------------------
# the model through input_embeds
# ---------------------------------------------------------------------------


def _inputs(seed, B=2):
    """Embeddings and the image layout's positions for a 2 + 12 + 3 token
    prompt (17 positions)."""
    r = np.random.RandomState(seed)
    pos = image_positions(B, 2, 3, 4, 3)
    emb = (r.randn(B, pos.shape[-1], 64) * 0.5).astype(np.float32)
    return emb, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_through_input_embeds_matches_jax(dtype):
    """Teacher-forced logits from embeddings and 3-stream positions; the
    reference under ``jax.jit`` (eagerly its CPU backend has no bf16 x bf16
    -> f32 dot)."""
    jcfg, tcfg, params, model = _pair(dtype, 1)
    emb, pos = _inputs(1)
    jl, _ = jax.jit(lambda p, e, q: jtfm.forward_train(p, jcfg, input_embeds=e, positions=q))(
        params, jnp.asarray(emb, JDT[dtype]), jnp.asarray(pos))
    with torch.no_grad():
        tl, aux = ttfm.forward_train(model, tcfg, input_embeds=_t(emb, TDT[dtype]),
                                     positions=_t(pos))
    assert tl.dtype == TDT[dtype] and float(aux) == 0.0
    _close(tl, np.asarray(jl, np.float32), TOL[dtype], "logits")


def test_image_positions_move_the_logits():
    """The sections are in use: the same embeddings with 1-D positions give
    other logits."""
    _, tcfg, _, model = _pair("float32", 1)
    emb, pos = _inputs(1)
    flat = np.broadcast_to(np.arange(pos.shape[-1], dtype=np.int32), pos.shape[1:]).copy()
    with torch.no_grad():
        a, _ = ttfm.forward_train(model, tcfg, input_embeds=_t(emb), positions=_t(pos))
        b, _ = ttfm.forward_train(model, tcfg, input_embeds=_t(emb), positions=_t(flat))
    assert float((a - b).abs().max()) > 1e-3


def _same_cache(tc, jc, tol, what):
    t = weights.cache_to_numpy(tc)
    _close(t.k, jc.k, tol, f"{what} k")
    _close(t.v, jc.v, tol, f"{what} v")
    np.testing.assert_array_equal(t.length, np.asarray(jc.length))
    np.testing.assert_array_equal(t.start, np.asarray(jc.start))


def test_prefill_through_input_embeds_and_three_decode_steps_match_jax():
    """float32: ``prefill(input_embeds=, positions=(3, B, S))`` into a
    24-position cache (logits and the filled cache), then 3
    ``decode_step``s on the reference's greedy tokens (positions from the
    cache length, broadcast to three streams)."""
    jcfg, tcfg, params, model = _pair("float32", 2)
    emb, pos = _inputs(2)
    jc = jtfm.init_caches(jcfg, 2, 24)
    tc = ttfm.init_caches(tcfg, 2, 24, device="cpu")
    jlog, jc = jtfm.prefill(params, jcfg, input_embeds=jnp.asarray(emb), caches=jc,
                            positions=jnp.asarray(pos))
    tlog, tc = ttfm.prefill(model, tcfg, input_embeds=_t(emb), caches=tc, positions=_t(pos))
    _close(tlog, jlog, TOL["float32"], "prefill logits")
    _same_cache(tc, jc, TOL["float32"], "after the prefill")
    for step in range(3):
        tok = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None].astype(np.int32)
        jlog, jc = jtfm.decode_step(params, jcfg, jnp.asarray(tok), jc)
        tlog, tc = ttfm.decode_step(model, tcfg, _t(tok), tc)
        _close(tlog, jlog, TOL["float32"], f"decode step {step} logits")
        _same_cache(tc, jc, TOL["float32"], f"after decode step {step}")


def test_greedy_generate_on_tokens_matches_jax():
    """Tokens: 2-D positions broadcast to three equal streams."""
    jcfg, tcfg, params, model = _pair("float32", 3)
    prompt = np.random.RandomState(3).randint(0, 256, (2, 9)).astype(np.int32)
    want = np.asarray(jlm.greedy_generate(params, jcfg, jnp.asarray(prompt), 6))
    got = tlm.greedy_generate(model, tcfg, _t(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def _batch(seed, B=2, S=16):
    """A vlm batch of the reference's layout: tokens, input_embeds and
    positions over S + 1 positions."""
    r = np.random.RandomState(seed)
    pos = image_positions(B, 3, 3, 3, S + 1 - 12)
    return {"tokens": r.randint(0, 256, (B, S + 1)).astype(np.int32),
            "input_embeds": (r.randn(B, S + 1, 64) * 0.5).astype(np.float32),
            "positions": pos}


def test_make_batch_views_drops_the_last_position():
    _, tcfg, _, _ = _pair("float32")
    b = {k: _t(v) for k, v in _batch(4).items()}
    kw, labels, mask = tlm.make_batch_views(b, tcfg)
    assert set(kw) == {"input_embeds", "positions"} and mask is None
    assert kw["input_embeds"].shape == (2, 16, 64) and kw["positions"].shape == (3, 2, 16)
    assert torch.equal(labels, b["tokens"][:, 1:])
    assert torch.equal(kw["positions"], b["positions"][..., :-1])


def test_f32_loss_and_every_grad_match_jax():
    """The loss (CE chunks of 5 over 16 positions) and every gradient, in
    the reference's leaf order."""
    jcfg, tcfg, params, model = _pair("float32", 5)
    batch = _batch(5)
    jl, jg = jax.value_and_grad(jlm.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, 5)
    tl = tlm.loss_fn(model, {k: _t(v) for k, v in batch.items()}, tcfg, 5)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = weights.flatten(jax.tree_util.tree_map(np.asarray, jg))
    tflat = weights.leaves(model)
    assert list(tflat) == list(jflat)
    # the token embedding is unused on embedding input: no gradient here,
    # zeros in the reference
    assert tflat["embed"].grad is None and not np.any(jflat["embed"])
    for name, p in tflat.items():
        if name == "embed":
            continue
        want = jflat[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=TOL["float32"] * float(np.abs(want).max()),
                                   err_msg=name)


def test_bf16_loss_matches_jax():
    jcfg, tcfg, params, model = _pair("bfloat16", 6)
    batch = _batch(6)
    jb = {k: jnp.asarray(v, jnp.bfloat16) if k == "input_embeds" else jnp.asarray(v)
          for k, v in batch.items()}
    jl = jax.jit(lambda p, b: jlm.loss_fn(p, b, jcfg))(params, jb)
    tb = {k: _t(v, torch.bfloat16) if k == "input_embeds" else _t(v) for k, v in batch.items()}
    with torch.no_grad():
        tl = tlm.loss_fn(model, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mozart", [True, False])
def test_vlm_batches_equal_jax_bit_for_bit(use_mozart, dtype):
    """tokens, input_embeds (B, seq + 1, d) x 0.02 in ``cfg.dtype`` and the
    (3, B, seq + 1) int32 positions, at steps 0, 1 and 7."""
    jcfg = jsmoke(ARCH).with_runtime(dtype=JDT[dtype])
    tcfg = tsmoke(ARCH).with_runtime(dtype=TDT[dtype])
    jp = JPipeline(jcfg, batch=3, seq=10, seed=2, use_mozart=use_mozart)
    tp = DataPipeline(tcfg, batch=3, seq=10, seed=2, use_mozart=use_mozart, device="cpu")
    for step in (0, 1, 7):
        want, got = jp.batch_for_step(step), tp.batch_for_step(step)
        assert set(got) == set(want) == {"tokens", "input_embeds", "positions"}
        for k in want:
            w = np.asarray(want[k])
            g = got[k]
            assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), k
            np.testing.assert_array_equal(g.float().numpy() if g.dtype == torch.bfloat16
                                          else g.numpy(), w.astype(np.float32)
                                          if w.dtype.name == "bfloat16" else w, err_msg=k)


def test_carry_across_round_trip_is_exact():
    _, tcfg, params, model = _pair("bfloat16", 7)
    back = weights.flatten(weights.to_numpy(model))
    for name, want in weights.flatten(params).items():
        np.testing.assert_array_equal(back[name], np.asarray(want, np.float32), name)
    again = weights.from_numpy(weights.to_numpy(model), tcfg, "cpu")
    for (n, x), y in zip(weights.leaves(model).items(), weights.leaves(again).values()):
        assert x.dtype == y.dtype and torch.equal(x, y), n

"""The port's serving path against the JAX package, on the CPU: the KV cache
and the prefill/decode modes of ``attention_block``, ``prefill`` and
``decode_step``, ``greedy_generate``, the continuous batcher (with its
async front-end, deadlines, cancellation, shedding and ``fail_pending``),
the fixed-group server, and the flash-attention switch.

Models: the gemma-7b smoke config (MHA, tied embedding) and the GQA
internlm2-20b smoke config of ``tests/test_serving.py`` (6 query heads over
2 kv heads), the MoE smoke configs of olmoe-1b-7b and deepseek-moe-16b
(whose decode state is a ``{"stack", "pre"}`` dict of caches), and the
recurrent smoke configs of hymba-1.5b (``{"kv", "ssm"}``) and rwkv6-1.6b
(an ``RWKVState``), served through pad-free prefill buckets, in float32;
JAX ``init_model`` makes the parameters and
``weights.from_numpy`` carries them across.  Tolerances: logits and
attention outputs rtol 1e-5 with atol 1e-5 * max|reference| (the same
float32 arithmetic summed in another order; near-zero entries carry only
absolute error); cache K/V the same; cache lengths and starts, and every
generated token, exactly.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_7b as jgemma
from repro.configs.registry import get_smoke_config as jsmoke
from repro.core.serving import _make_prefill_bucket as j_prefill_bucket
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro_torch.core import serving
from repro_torch.core.serving import AsyncServer, ContinuousBatcher
from repro_torch.kernels import flash_attention as fl
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttfm
from repro_torch.models import weights
from repro_torch.models.config import AttnConfig as TAttn
from repro_torch.models.config import ModelConfig as TModel
from repro_torch.models.config import MoEConfig as TMoE
from repro_torch.models.config import RWKVConfig as TRWKV
from repro_torch.models.config import SSMConfig as TSSM

ARCH = "internlm2-20b"            # GQA; dense rows: batched == per-row exactly
MAX_LEN = 48

#: (prompt_len, max_new), as ``tests/test_serving.py``: mixed lengths
#: exercise two length buckets, mixed max_new forces join/leave churn.
SPECS = [(5, 3), (9, 7), (6, 2), (3, 5), (8, 4), (9, 1)]


def port_config(jcfg) -> TModel:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    sub = lambda cls, v: v and cls(**dataclasses.asdict(v))
    return TModel(**{**kw, "attn": sub(TAttn, jcfg.attn), "moe": sub(TMoE, jcfg.moe),
                     "ssm": sub(TSSM, jcfg.ssm), "rwkv": sub(TRWKV, jcfg.rwkv),
                     "dtype": torch.float32})


def _carry(jcfg, seed=0):
    params = jtfm.init_model(jax.random.PRNGKey(seed), jcfg)
    tcfg = port_config(jcfg)
    model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    model.requires_grad_(False)
    return params, tcfg, model


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


def _same_cache(tcache, jcache):
    if isinstance(jcache, dict):
        assert isinstance(tcache, dict) and set(tcache) == set(jcache)
        for name in jcache:
            _same_cache(tcache[name], jcache[name])
        return
    t = weights.cache_to_numpy(tcache)
    _close(t.k, jcache.k, "cache k")
    _close(t.v, jcache.v, "cache v")
    np.testing.assert_array_equal(t.length, np.asarray(jcache.length))
    np.testing.assert_array_equal(t.start, np.asarray(jcache.start))


@pytest.fixture(scope="module")
def gqa():
    jcfg = jsmoke(ARCH).with_runtime(dtype=jnp.float32)
    params, tcfg, model = _carry(jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32) for p, _ in SPECS]
    return jcfg, tcfg, params, model, prompts


@pytest.fixture(scope="module")
def reference(gqa):
    """Greedy tokens per request from sequential unpadded batch-1 JAX runs."""
    jcfg, _, params, _, prompts = gqa
    prefill = jax.jit(lambda p, t, c: jtfm.prefill(p, jcfg, tokens=t, caches=c))
    decode = jax.jit(lambda p, t, c: jtfm.decode_step(p, jcfg, t, c))

    def one(prompt, max_new):
        logits, caches = prefill(params, jnp.asarray(prompt[None]),
                                 jtfm.init_caches(jcfg, 1, MAX_LEN))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out = [int(tok[0, 0])]
        while len(out) < max_new:
            logits, caches = decode(params, tok, caches)
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            out.append(int(tok[0, 0]))
        return out

    return [one(p, n) for p, (_, n) in zip(prompts, SPECS)]


# ---------------------------------------------------------------------------
# attention_block: prefill and decode modes, the KV cache
# ---------------------------------------------------------------------------


def _layer0(params, model):
    jp = jax.tree_util.tree_map(lambda a: a[0], params["layers"]["attn"])
    tp = {k: v[0] for k, v in model["layers"]["attn"].items()}
    return jp, tp


@pytest.mark.parametrize("case", ["unpadded", "left_pad", "right_pad_per_slot", "window"])
def test_attention_block_prefill_matches_jax(gqa, case):
    jcfg, tcfg, params, model, _ = gqa
    jp, tp = _layer0(params, model)
    B, S = 3, 7
    x = np.random.RandomState(1).randn(B, S, jcfg.d_model).astype(np.float32)
    lens = np.array([7, 4, 1])
    mask = None
    if case == "left_pad":
        mask = np.arange(S)[None] >= S - lens[:, None]
    elif case == "right_pad_per_slot":
        mask = np.arange(S)[None] < lens[:, None]
    per_slot = case == "right_pad_per_slot"
    window = 3 if case == "window" else None
    jc = jattn.init_kv_cache(jcfg, B, 12, per_slot=per_slot)
    tc = tattn.init_kv_cache(tcfg, B, 12, per_slot=per_slot, device="cpu")
    jo, jc, _ = jattn.attention_block(jp, jnp.asarray(x), jcfg, cache=jc, mode="prefill",
                                      window=window,
                                      pad_mask=None if mask is None else jnp.asarray(mask))
    to, tc = tattn.attention_block(tp, torch.from_numpy(x), tcfg, cache=tc,
                                      mode="prefill", window=window,
                                      pad_mask=None if mask is None else torch.from_numpy(mask))
    _close(to, jo, "prefill out")
    _same_cache(tc, jc)


def _random_cache(jcfg, B, max_len, length, start, seed):
    c = jattn.init_kv_cache(jcfg, B, max_len, per_slot=np.ndim(length) > 0)
    r = np.random.RandomState(seed)
    return jattn.KVCache(
        k=jnp.asarray(r.randn(*c.k.shape), jnp.float32),
        v=jnp.asarray(r.randn(*c.v.shape), jnp.float32),
        length=jnp.asarray(length, jnp.int32), start=jnp.asarray(start, jnp.int32))


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("case", ["scalar", "per_slot", "start", "window", "capacity"])
def test_attention_block_decode_matches_jax(gqa, case, blocks):
    """Decode over the block-partitioned cache (two blocks: the exact LSE
    combine); both sides start from one cache carried across."""
    jcfg, _, params, model, _ = gqa
    jcfg = jcfg.with_runtime(kv_cache_blocks=blocks)
    tcfg = port_config(jcfg)
    jp, tp = _layer0(params, model)
    B, cap = 3, 12
    length = {"scalar": 5, "per_slot": [3, 7, 0], "start": [6, 9, 4],
              "window": [6, 11, 2], "capacity": [cap, 4, cap + 3]}[case]
    start = [0, 2, 3] if case == "start" else [0, 0, 0]
    window = 3 if case == "window" else None
    jc = _random_cache(jcfg, B, cap, length, start, seed=2)
    tc = weights.cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc), tcfg, "cpu")
    before = weights.cache_to_numpy(tc)
    x = np.random.RandomState(3).randn(B, 1, jcfg.d_model).astype(np.float32)
    jo, jc2, _ = jattn.attention_block(jp, jnp.asarray(x), jcfg, cache=jc, mode="decode",
                                       window=window)
    with torch.no_grad():
        to, tc2 = tattn.attention_block(tp, torch.from_numpy(x), tcfg, cache=tc,
                                           mode="decode", window=window)
    _close(to, jo, "decode out")
    _same_cache(tc2, jc2)
    if case == "capacity":
        # rows at or past capacity write nothing (the reference's drop)
        after = weights.cache_to_numpy(tc2)
        for row in (0, 2):
            np.testing.assert_array_equal(after.k[:, :, row], before.k[:, :, row])
            np.testing.assert_array_equal(after.v[:, :, row], before.v[:, :, row])


def test_decode_writes_in_place_and_returns_new_lengths(gqa):
    jcfg, tcfg, params, model, _ = gqa
    _, tp = _layer0(params, model)
    tc = tattn.init_kv_cache(tcfg, 2, 8, per_slot=True, device="cpu")
    with torch.no_grad():
        _, new = tattn.attention_block(tp, torch.ones(2, 1, jcfg.d_model), tcfg,
                                          cache=tc, mode="decode")
    assert new.k is tc.k and new.v is tc.v
    assert new.length.tolist() == [1, 1] and tc.length.tolist() == [0, 0]
    assert bool(tc.k[0, 0].abs().sum() > 0)


# ---------------------------------------------------------------------------
# prefill / decode_step / greedy_generate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["gemma-7b", ARCH, "granite-34b", "gemma3-4b",
                                        "olmoe-1b-7b", "deepseek-moe-16b"])
def arch(request):
    """gemma-7b (MHA, tied), internlm2-20b (GQA 3), granite-34b (MQA, plain
    GELU MLP), gemma3-4b (qk-norm, a 5:1 sliding-window pattern), olmoe
    (MoE, qk-norm) and deepseek-moe (a dense pre-layer, shared experts)."""
    jcfg = (jgemma.smoke_config() if request.param == "gemma-7b"
            else jsmoke(request.param)).with_runtime(dtype=jnp.float32)
    params, tcfg, model = _carry(jcfg, seed=4)
    return jcfg, tcfg, params, model


def test_prefill_and_decode_step_match_jax(arch):
    jcfg, tcfg, params, model = arch
    tokens = np.random.RandomState(5).randint(0, jcfg.vocab_size, (2, 7)).astype(np.int32)
    jl, jc = jtfm.prefill(params, jcfg, tokens=jnp.asarray(tokens),
                          caches=jtfm.init_caches(jcfg, 2, 16))
    tl, tc = ttfm.prefill(model, tcfg, torch.from_numpy(tokens),
                          caches=ttfm.init_caches(tcfg, 2, 16, device="cpu"))
    _close(tl, jl, "prefill logits")
    _same_cache(tc, jc)
    # decode from ONE cache: the JAX prefill's, carried across
    tc = weights.cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc), tcfg, "cpu")
    tok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    for step in range(3):
        jl, jc = jtfm.decode_step(params, jcfg, tok, jc)
        tl, tc = ttfm.decode_step(model, tcfg, torch.tensor(np.asarray(tok)), tc)
        _close(tl, jl, f"decode {step} logits")
        tok = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    _same_cache(tc, jc)


def test_right_padded_bucket_prefill_matches_jax(arch):
    """The batcher's prefill (per-slot cache, right pads masked, logits at
    each row's ``last_pos``) against the reference's."""
    jcfg, tcfg, params, model = arch
    r = np.random.RandomState(6)
    toks = r.randint(0, jcfg.vocab_size, (4, 8)).astype(np.int32)
    plens = np.array([8, 5, 1, 3], np.int32)
    jl, jc = j_prefill_bucket(jcfg, masked=True)(
        params, jnp.asarray(toks), jnp.asarray(plens),
        jtfm.init_caches(jcfg, 4, 16, per_slot=True))
    tl, tc = serving._make_prefill_bucket(tcfg)(
        model, torch.from_numpy(toks), torch.from_numpy(plens),
        ttfm.init_caches(tcfg, 4, 16, per_slot=True, device="cpu"))
    _close(tl, jl, "bucket logits")
    _same_cache(tc, jc)


def test_qk_norm_qkv_matches_the_reference():
    """gemma3-4b's ``_qkv``: q and k RMS-normalised per head with the
    layer's ``q_norm``/``k_norm`` (not all ones here) before RoPE."""
    jcfg = jsmoke("gemma3-4b").with_runtime(dtype=jnp.float32)
    params = jtfm.init_model(jax.random.PRNGKey(11), jcfg)
    r = np.random.RandomState(11)
    jp = jax.tree_util.tree_map(lambda a: np.asarray(a[0]), params["layers"]["attn"])
    jp["q_norm"] = (1 + 0.2 * r.randn(*jp["q_norm"].shape)).astype(np.float32)
    jp["k_norm"] = (1 + 0.2 * r.randn(*jp["k_norm"].shape)).astype(np.float32)
    tcfg = port_config(jcfg)
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    x = r.randn(2, 5, jcfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(5), (2, 1)).astype(np.int32)
    want = jattn._qkv({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x), jcfg.attn,
                      jnp.asarray(pos), jcfg)
    got = tattn._qkv(tp, torch.from_numpy(x), tcfg.attn, torch.from_numpy(pos), tcfg)
    for g, w, what in zip(got, want, "qkv"):
        _close(g, w, f"_qkv {what}")
    plain = tattn._qkv(tp, torch.from_numpy(x), tcfg.attn.__class__(
        **{**dataclasses.asdict(tcfg.attn), "qk_norm": False}), torch.from_numpy(pos), tcfg)
    assert not torch.allclose(plain[0], got[0])       # the norm did something


def test_sliding_window_prefill_past_the_window_matches_jax():
    """gemma3-4b's smoke config (window 8 on 5 of 6 layers) over 20 tokens:
    the local layers drop keys the global layer keeps."""
    jcfg = jsmoke("gemma3-4b").with_runtime(dtype=jnp.float32)
    params, tcfg, model = _carry(jcfg, seed=12)
    tokens = np.random.RandomState(12).randint(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, jc = jtfm.prefill(params, jcfg, tokens=jnp.asarray(tokens),
                          caches=jtfm.init_caches(jcfg, 2, 24))
    tl, tc = ttfm.prefill(model, tcfg, torch.from_numpy(tokens),
                          caches=ttfm.init_caches(tcfg, 2, 24, device="cpu"))
    _close(tl, jl, "windowed prefill logits")
    _same_cache(tc, jc)
    assert ttfm.layer_windows(tcfg) == [8] * 5 + [ttfm.BIG_WINDOW]


def test_greedy_generate_matches_jax(arch):
    jcfg, tcfg, params, model = arch
    prompt = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(jlm.greedy_generate(params, jcfg, jnp.asarray(prompt), 5))
    got = tlm.greedy_generate(model, tcfg, torch.from_numpy(prompt), 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_slot", [False, True])
def test_init_caches_layout_matches_jax_at_gemma_7b_width(per_slot):
    from repro.configs.registry import get_config as jget_config
    from repro_torch.configs.registry import get_config
    want = jax.eval_shape(lambda: jtfm.init_caches(jget_config("gemma-7b"), 4, 2080,
                                                   per_slot=per_slot))
    got = ttfm.init_caches(get_config("gemma-7b"), 4, 2080, per_slot=per_slot, device="meta")
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_cache_carry_across_round_trip_is_exact():
    jcfg = jgemma.smoke_config()                       # bfloat16 K/V
    jc = jtfm.init_caches(jcfg, 2, 8, per_slot=True)
    r = np.random.RandomState(8)
    jc = jc._replace(k=jnp.asarray(r.randn(*jc.k.shape), jnp.bfloat16),
                     length=jnp.asarray(r.randint(0, 8, jc.length.shape), jnp.int32))
    npc = jax.tree_util.tree_map(np.asarray, jc)
    tcfg = port_config(jcfg).with_runtime(dtype=torch.bfloat16)
    tc = weights.cache_from_numpy(npc, tcfg, "cpu")
    assert tc.k.dtype == torch.bfloat16 and tc.length.dtype == torch.int32
    back = weights.cache_to_numpy(tc)
    for b, w in zip(back, npc):
        np.testing.assert_array_equal(b, np.asarray(w, b.dtype))


# ---------------------------------------------------------------------------
# The flash-attention switch
# ---------------------------------------------------------------------------


@pytest.fixture
def count_plain_attention(monkeypatch):
    calls = []
    real = fl.attention_ref

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fl, "attention_ref", counted)
    return calls


def test_use_kernel_on_cpu_runs_plain_version_and_matches_dense(gqa, count_plain_attention):
    jcfg, tcfg, _, model, prompts = gqa
    tokens = torch.from_numpy(np.stack([prompts[1], prompts[5]]))
    dense, _ = ttfm.prefill(model, tcfg, tokens, use_kernel=False)
    assert count_plain_attention == []
    kern, _ = ttfm.prefill(model, tcfg, tokens, use_kernel=True)
    assert len(count_plain_attention) == tcfg.n_layers      # one per layer
    _close(kern, dense.numpy(), "kernel path vs dense")
    ttfm.prefill(model, tcfg, tokens, use_kernel=True, pad_mask=torch.ones(tokens.shape, dtype=torch.bool))
    assert len(count_plain_attention) == tcfg.n_layers      # never with a pad mask


def test_kernel_is_never_taken_while_autograd_records(gqa, count_plain_attention):
    jcfg, tcfg, params, model, _ = gqa
    _, tp = _layer0(params, model)
    tp = {k: v.detach().clone().requires_grad_(True) for k, v in tp.items()}
    x = torch.randn(1, 5, jcfg.d_model)
    out, _ = tattn.attention_block(tp, x, tcfg, use_kernel=True)
    assert out.grad_fn is not None and count_plain_attention == []
    out.sum().backward()
    with torch.no_grad():
        tattn.attention_block(tp, x, tcfg, use_kernel=True)
    assert len(count_plain_attention) == 1


def test_training_loss_takes_no_kernel(count_plain_attention):
    jcfg = jgemma.smoke_config().with_runtime(dtype=jnp.float32)
    _, tcfg, model = _carry(jcfg)
    model.requires_grad_(True)
    tokens = torch.from_numpy(np.random.RandomState(9).randint(0, 256, (2, 9)).astype(np.int32))
    tlm.loss_fn(model, {"tokens": tokens}, tcfg).backward()
    assert count_plain_attention == []
    assert all(p.grad is not None for p in model.parameters())


# ---------------------------------------------------------------------------
# Continuous batcher: scheduler tokens == sequential single-request tokens
# ---------------------------------------------------------------------------


def _batcher(gqa, batch, driver="jit", **kw):
    """A batcher on the CPU; the tests that mean the ``jit`` driver get it
    by default here (the batcher's own default is ``mozart``)."""
    _, tcfg, _, model, _ = gqa
    return ContinuousBatcher(tcfg, model, batch=batch, max_len=MAX_LEN, driver=driver,
                             device="cpu", **kw)


def _requests(b, prompts):
    return [b.make_request(p, n) for p, (_, n) in zip(prompts, SPECS)]


def test_join_leave_churn_matches_jax(gqa, reference):
    """Six requests through two slots: every admission joins mid-flight of
    another request's decode, every finish frees a slot early."""
    b = _batcher(gqa, 2)
    reqs = _requests(b, gqa[4])
    stats = b.run(reqs)
    assert [r.out for r in reqs] == reference
    assert stats["completed"] == len(SPECS) and all(r.finished for r in reqs)
    assert stats["prefill_calls"] >= 3
    assert 1 <= min(b.occupancy) <= stats["mean_occupancy"] <= 2


def test_occupancy_one_to_batch(gqa, reference):
    b = _batcher(gqa, 4)
    r = b.make_request(gqa[4][1], SPECS[1][1])
    b.run([r])
    assert r.out == reference[1]
    reqs = _requests(b, gqa[4])
    b.run(reqs)
    assert [r.out for r in reqs] == reference


def test_warmup_then_serve(gqa, reference):
    b = _batcher(gqa, 2)
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    assert b.prompt_buckets == [8, 16]
    reqs = _requests(b, gqa[4])
    b.run(reqs)
    assert [r.out for r in reqs] == reference


def test_empty_queue(gqa):
    b = _batcher(gqa, 2)
    stats = b.run([])
    assert stats["tokens"] == 0 and stats["decode_steps"] == 0
    assert b.step() is False


def test_rejects_oversized_and_empty_generation(gqa):
    b = _batcher(gqa, 2)
    with pytest.raises(ValueError, match="max_new"):
        b.submit(b.make_request(gqa[4][0], 0))
    with pytest.raises(ValueError, match="exceeds max_len"):
        b.submit(b.make_request(gqa[4][0], MAX_LEN))


def test_async_front_end(gqa, reference):
    b = _batcher(gqa, 2)
    prompts = gqa[4]

    async def main():
        with AsyncServer(b) as server:
            return await asyncio.gather(*(server.generate(prompts[i], SPECS[i][1])
                                          for i in range(len(SPECS))))

    assert asyncio.run(main()) == reference


def test_join_drops_dummy_rows(gqa):
    """A prefill group's dummy row aims at slot ``batch``: it leaves the
    rolling cache untouched; a real row replaces its slot."""
    _, tcfg, _, _, _ = gqa
    roll = ttfm.init_caches(tcfg, 2, 8, per_slot=True, device="cpu")
    pref = ttfm.init_caches(tcfg, 2, 8, per_slot=True, device="cpu")
    for leaf in pref:
        leaf.fill_(3)
    axes = serving._cache_batch_axes(tcfg, 2, 8)
    assert axes == [3, 3, 1, 1]
    serving._make_join(axes)(roll, pref, np.array([1, 2]))
    assert bool((roll.k[:, :, :, 1] == 3).all()) and bool((roll.k[:, :, :, 0] == 0).all())
    assert roll.length.tolist() == [[0, 3]] * tcfg.n_layers
    assert roll.start.tolist() == [[0, 3]] * tcfg.n_layers


# ---------------------------------------------------------------------------
# driver="mozart": serving over mozart.pipeline (plan cache, AOT)
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _fresh_port_plan_cache():
    from repro_torch.core import plan_cache
    plan_cache.clear()
    yield
    plan_cache.clear()


def test_mozart_is_the_default_driver_and_others_are_refused(gqa):
    _, tcfg, _, model, _ = gqa
    assert ContinuousBatcher(tcfg, model, 2, MAX_LEN, device="cpu").driver == "mozart"
    with pytest.raises(ValueError, match="unknown driver"):
        ContinuousBatcher(tcfg, model, 2, MAX_LEN, driver="xla", device="cpu")
    with pytest.raises(ValueError, match="unknown driver"):
        tserve.Server(tcfg, model, 2, MAX_LEN, driver="xla", device="cpu")


def test_mozart_warm_zero_retrace_across_occupancy(gqa, reference):
    """The reference's test: occupancy moves (joins, leaves, a dead-air
    tail), yet no step plans or traces: every step replays the pinned plan
    entry of its bucket, each entry labelled with its bucket."""
    b = _batcher(gqa, 2, driver="mozart")
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    reqs = _requests(b, gqa[4])
    stats = b.run(reqs)
    assert [r.out for r in reqs] == reference
    assert stats["planner_calls"] == 0 and stats["jit_traces"] == 0, stats
    assert stats["warm"] is True
    assert ("decode", 2) in b._decode.buckets
    prefill_buckets = set(b._prefill.buckets)
    assert prefill_buckets == {("prefill", bb, lb) for bb in (1, 2) for lb in (8, 16)}
    assert stats["buckets"] == sorted(prefill_buckets | {("decode", 2)})
    entries = {b._prefill.buckets[k].uid for k in prefill_buckets}
    assert len(entries) == len(prefill_buckets)
    for k in prefill_buckets:
        assert tuple(b._prefill.buckets[k].bucket) == k
    assert b._decode.warm() and b._decode.last_call_stats.get("planner_calls", 0) == 0


def test_jit_driver_summary_is_warm_without_buckets(gqa, reference):
    b = _batcher(gqa, 2)
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    reqs = _requests(b, gqa[4])
    stats = b.run(reqs)
    assert [r.out for r in reqs] == reference
    assert (stats["planner_calls"], stats["jit_traces"], stats["warm"]) == (0, 0, True)
    assert "buckets" not in stats


@pytest.fixture
def step_calls(monkeypatch):
    """Real (non-meta) calls of the model's prefill and decode steps; the
    abstract evaluation of a cold registration runs them on meta tensors."""
    calls = {"prefill": 0, "decode": 0}
    for name, fn in (("prefill", "prefill"), ("decode", "decode_step")):
        real = getattr(ttfm, fn)

        def counted(params, cfg, *a, _real=real, _name=name, **kw):
            tokens = kw.get("tokens", a[0] if a else None)
            if tokens is not None and tokens.device.type != "meta":
                calls[_name] += 1
            return _real(params, cfg, *a, **kw)

        monkeypatch.setattr(ttfm, fn, counted)
    return calls


def test_warm_mozart_step_runs_the_step_function_exactly_once(gqa, reference, step_calls):
    """K/V are written in place, so a warm step that ran its function twice
    would write twice: one real call per step, on the whole arguments (the
    returned cache shares the rolling cache's storage: nothing was split or
    merged), one stage on ``eager``, and no rewrite of the one-node graph."""
    b = _batcher(gqa, 2, driver="mozart")
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    step_calls.update(prefill=0, decode=0)
    reqs = _requests(b, gqa[4])
    stats = b.run(reqs)
    assert [r.out for r in reqs] == reference
    assert step_calls == {"prefill": stats["prefill_calls"], "decode": stats["decode_steps"]}
    k_before = b.caches.k
    (logits, caches), delta = b._call_decode(b._tok, b.caches)
    assert step_calls["decode"] == stats["decode_steps"] + 1
    assert caches.k is k_before and logits.shape[:2] == (2, 1)
    assert delta.get("stages") == 1 and delta.get("calls") == 1 and "chunks" not in delta
    assert delta.get("planner_calls", 0) == 0 and delta["jit_traces"] == 0
    assert b._decode.ctx._last_rewrites == []
    assert b._decode.ctx.counters.bytes_interior() == 0
    assert b._decode.ctx.stats.get("rewrites_applied", 0) == 0


def test_cold_mozart_registration_never_touches_a_real_weight(gqa, monkeypatch):
    """The first capture abstractly evaluates the step on the model's meta
    twin: every leaf the step reads during ``lower`` lies on ``meta``."""
    from repro_torch.models import weights as wmod
    b = _batcher(gqa, 1, driver="mozart")
    seen = []
    real = ttfm.decode_step

    def spy(params, cfg, token, caches, **kw):
        seen.append({t.device.type for t in [token, *params.parameters(), *caches]})
        return real(params, cfg, token, caches, **kw)

    monkeypatch.setattr(ttfm, "decode_step", spy)
    b._decode.lower(b.params, torch.zeros((1, 1), dtype=torch.int32), b._init_caches(1))
    assert seen == [{"meta"}]
    twin = b.params.mozart_meta()
    assert twin is b.params.mozart_meta()           # cached per fingerprint
    assert wmod._META_TWINS[b.params.mozart_fingerprint()] is twin
    assert twin.mozart_fingerprint()[1] == tuple(
        (n, sh, dt, "meta") for n, sh, dt, _dev in b.params.mozart_fingerprint()[1])


@pytest.mark.parametrize("mode", ["fixed", "continuous"])
def test_server_parity_mozart(gqa, reference, mode):
    """The reference's ``test_fixed_group_server_parity`` under
    ``driver="mozart"``, in both modes, after ``warmup``: the decode
    pipeline's last call was warm."""
    _, tcfg, _, model, prompts = gqa
    srv = tserve.Server(tcfg, model, batch=2, max_len=MAX_LEN, driver="mozart", mode=mode,
                        device="cpu")
    srv.warmup(max(p for p, _ in SPECS))
    reqs = [tserve.Request(rid=i, prompt=prompts[i], max_new=SPECS[i][1])
            for i in range(len(SPECS))]
    stats = srv.run(reqs)
    assert [r.out for r in reqs] == reference
    assert stats["decode_warm"] is True
    assert stats["decode_last_call"].get("planner_calls", 0) == 0


def test_bucket_label_round_trips_through_plan_cache(gqa, reference, tmp_path):
    """A serving plan file: ``warmup`` saves the labelled entries; after a
    restart (``plan_cache.clear()``) a second batcher on the same file and
    prompt buckets serves with zero planner calls and no warmup."""
    import json
    from repro_torch.core import plan_cache
    path = str(tmp_path / "plans.json")
    b = _batcher(gqa, 2, driver="mozart", plan_cache_path=path)
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    payload = json.load(open(path))
    assert payload["schema"] == plan_cache.SCHEMA_VERSION
    labels = {tuple(plan_cache._dec(e["bucket"])) for e in payload["entries"] if e.get("bucket")}
    assert labels == {("decode", 2)} | {("prefill", bb, lb) for bb in (1, 2) for lb in (8, 16)}
    plan_cache.clear()
    assert plan_cache.load(path) == len(labels)
    assert {e.bucket for e in plan_cache.entries()} == labels
    plan_cache.clear()
    again = _batcher(gqa, 2, driver="mozart", plan_cache_path=path,
                     prompt_buckets=b.prompt_buckets)
    reqs = _requests(again, gqa[4])
    stats = again.run(reqs)
    assert [r.out for r in reqs] == reference
    assert stats["planner_calls"] == 0 and stats["warm"] is True, stats


def test_mozart_driver_fails_the_wave_and_survives_a_step_fault(gqa, reference):
    """``serve_step`` faults on this driver: the request in flight fails
    with the injected fault, MZ405 is recorded, the next request completes
    with the reference's tokens and its steps stay warm."""
    from repro_torch.core import mozart, resilience
    b = _batcher(gqa, 2, driver="mozart")
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    resilience.clear_events()
    req = b.submit(b.make_request(gqa[4][0], SPECS[0][1]))
    server = AsyncServer(b, idle_poll_s=1e-4)
    try:
        with mozart.inject_faults("serve_step:fail:1"):
            server.start()
            assert req.done.wait(60)
            out = asyncio.run(server.generate(gqa[4][1], SPECS[1][1]))
    finally:
        server.close()
    assert isinstance(req.error, resilience.InjectedFault) and req.out == []
    assert out == reference[1]
    assert b.stats["step_failures"] == 1 and resilience.stats["MZ405"] == 1
    assert b.stats["planner_calls"] == 0 and b.stats["jit_traces"] == 0
    resilience.clear_events()


def test_serve_cli_mozart_driver_with_a_plan_file(monkeypatch, capsys, tmp_path):
    path = str(tmp_path / "serve.json")
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "gemma-7b", "--smoke", "--device",
                                     "cpu", "--requests", "3", "--batch", "2",
                                     "--prompt-len", "5", "--max-new", "3",
                                     "--driver", "mozart", "--plan-cache", path])
    tserve.main()
    out = capsys.readouterr().out
    assert "served 9 tokens" in out and "decode warm=True" in out
    import os
    assert os.path.exists(path)


def test_batcher_refuses_parameters_on_another_device(gqa):
    _, tcfg, _, model, _ = gqa
    with pytest.raises(ValueError, match="lie on"):
        ContinuousBatcher(tcfg, model, 2, MAX_LEN, device="meta")


# ---------------------------------------------------------------------------
# Serving failure domains: deadlines, cancellation, shedding, step failures
# ---------------------------------------------------------------------------


def _failing_once(b):
    real = b._call_decode
    state = {"armed": True}

    def fail(*a, **kw):
        if state["armed"]:
            state["armed"] = False
            raise RuntimeError("decode step failed")
        return real(*a, **kw)

    b._call_decode = fail


def test_deadline_times_out_and_frees_slot(gqa):
    b = _batcher(gqa, 2)
    doomed = b.make_request(gqa[4][0], 6, timeout_s=0.0)
    ok = b.make_request(gqa[4][1], 3)
    stats = b.run([doomed, ok])
    assert doomed.finished and doomed.timed_out and doomed.error is None
    assert len(doomed.out) < 6
    assert ok.finished and not ok.timed_out and len(ok.out) == 3
    assert stats["timed_out"] == 1 and stats["completed"] == 1


def test_cancel_mid_decode_keeps_partial_output(gqa):
    b = _batcher(gqa, 1)
    b.reset_metrics()
    r = b.submit(b.make_request(gqa[4][0], 8))
    while len(r.out) < 2:
        b.step()
    r.cancel()
    b.step()
    assert r.finished and r.cancelled and not r.timed_out
    assert 2 <= len(r.out) < 8
    assert b.stats["cancelled_requests"] == 1
    assert all(s is None for s in b.slots)


def test_bounded_queue_sheds_with_visible_error(gqa):
    b = _batcher(gqa, 1, max_queue=1)
    b.reset_metrics()
    kept = b.submit(b.make_request(gqa[4][0], 2))
    shed = b.submit(b.make_request(gqa[4][1], 2))
    assert shed.finished and "shed" in str(shed.error)
    assert b.stats["shed_requests"] == 1
    while not kept.finished:
        b.step()
    assert len(kept.out) == 2 and kept.error is None


def test_run_step_exception_fails_pending_never_hangs(gqa):
    b = _batcher(gqa, 2)
    _failing_once(b)
    reqs = [b.make_request(gqa[4][i], 3) for i in range(3)]
    with pytest.raises(RuntimeError, match="decode step failed"):
        b.run(reqs)
    assert all(r.finished and isinstance(r.error, RuntimeError) for r in reqs)
    assert b.stats["failed_requests"] == 3                    # 2 active + 1 queued


def test_fail_pending_resolves_active_and_queued(gqa):
    b = _batcher(gqa, 1)
    reqs = [b.submit(b.make_request(gqa[4][i], 4)) for i in range(3)]
    b.step()                                                  # one admitted
    exc = RuntimeError("replica lost")
    assert b.fail_pending(exc) == 3
    assert all(r.finished and r.error is exc for r in reqs)
    assert all(s is None for s in b.slots) and b.step() is False


def test_async_server_survives_step_failure(gqa, reference):
    b = _batcher(gqa, 2)
    _failing_once(b)
    prompts = gqa[4]
    server = AsyncServer(b, idle_poll_s=1e-4)

    async def main():
        req = b.submit(b.make_request(prompts[0], SPECS[0][1]))
        server.start()
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, req.done.wait, 60.0)
        assert req.finished and isinstance(req.error, RuntimeError)
        return await server.generate(prompts[1], SPECS[1][1])

    try:
        out = asyncio.run(main())
    finally:
        server.close()
    assert out == reference[1]
    assert b.stats["step_failures"] == 1 and b.stats["failed_requests"] == 1


def test_generate_timeout_returns_partial(gqa):
    b = _batcher(gqa, 1)

    async def main():
        with AsyncServer(b, idle_poll_s=1e-4) as server:
            return await server.generate(gqa[4][0], 6, timeout_s=0.0)

    assert len(asyncio.run(main())) < 6
    assert b.stats["timed_out_requests"] == 1


# ---------------------------------------------------------------------------
# Servers: fixed groups (left pad + mask) and continuous
# ---------------------------------------------------------------------------


def test_padded_prefill_matches_unpadded(gqa, reference):
    """Left pads with the mask threaded through prefill give the unpadded
    single-request tokens (the pad K/V never enter a softmax)."""
    _, tcfg, _, model, prompts = gqa
    S = max(len(p) for p in prompts[:2])
    padded = np.stack([np.pad(p, (S - len(p), 0)) for p in prompts[:2]])
    mask = np.stack([np.arange(S) >= S - len(p) for p in prompts[:2]])
    logits, caches = ttfm.prefill(model, tcfg, torch.from_numpy(padded),
                                  caches=ttfm.init_caches(tcfg, 2, MAX_LEN, device="cpu"),
                                  pad_mask=torch.from_numpy(mask))
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    got = [[int(t)] for t in tok[:, 0]]
    for _ in range(max(SPECS[0][1], SPECS[1][1]) - 1):
        logits, caches = ttfm.decode_step(model, tcfg, tok, caches)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        for i, t in enumerate(tok[:, 0]):
            got[i].append(int(t))
    for i in range(2):
        n = SPECS[i][1]
        assert got[i][:n] == reference[i][:n], f"rid{i} pad pollution"


@pytest.mark.parametrize("mode", ["fixed", "continuous"])
def test_server_parity(gqa, reference, mode):
    _, tcfg, _, model, prompts = gqa
    srv = tserve.Server(tcfg, model, batch=2, max_len=MAX_LEN, driver="jit", mode=mode,
                        device="cpu")
    reqs = [tserve.Request(rid=i, prompt=prompts[i], max_new=SPECS[i][1])
            for i in range(len(SPECS))]
    stats = srv.run(reqs)
    assert [r.out for r in reqs] == reference
    assert all(r.done for r in reqs) and stats["tokens"] == sum(n for _, n in SPECS)


def test_serve_cli_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "gemma-7b", "--smoke", "--device",
                                     "cpu", "--requests", "3", "--batch", "2",
                                     "--prompt-len", "5", "--max-new", "3"])
    tserve.main()
    out = capsys.readouterr().out
    assert "served 9 tokens" in out and "occupancy=" in out


def test_pow2_buckets_cover_range():
    assert serving._pow2_buckets(8, 48) == [8, 16, 32, 64]
    assert serving._pow2_buckets(1, 4) == [1, 2, 4]
    assert serving._bucket_for(5, [8, 16]) == 8
    assert serving._bucket_for(9, [8, 16]) == 16
    assert serving._bucket_for(99, [8, 16]) == 16


@pytest.mark.parametrize("offset,kv_len", [(0, None), (3, None), (0, 5), (2, 6)])
def test_dense_attention_offset_and_kv_len_match_jax(offset, kv_len):
    r = np.random.RandomState(10)
    q, k, v = (r.randn(2, 4, S, 8).astype(np.float32) for S in (4, 8, 8))
    k, v = k[:, :2], v[:, :2]                       # GQA: 4 query heads over 2
    want = jattn._dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                  window=None, offset=offset, kv_len=kv_len)
    got = tattn._dense_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=True, window=None, offset=offset, kv_len=kv_len)
    _close(got, want, "dense attention")


# ---------------------------------------------------------------------------
# MoE serving: the batcher against the JAX batcher (capacity routing makes a
# served token depend on its batch, so batch-1 decoding is no oracle)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["olmoe-1b-7b", "deepseek-moe-16b"])
def moe(request):
    jcfg = jsmoke(request.param).with_runtime(dtype=jnp.float32)
    params, tcfg, model = _carry(jcfg, seed=13)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32) for p, _ in SPECS]
    return jcfg, tcfg, params, model, prompts


@pytest.fixture(scope="module")
def moe_reference(moe):
    """The JAX batcher's tokens on the same weights, requests, 2 slots and
    prompt buckets, per driver."""
    from repro.core import plan_cache as jplan_cache
    from repro.core.serving import ContinuousBatcher as JBatcher
    jcfg, _, params, _, prompts = moe
    out = {}
    for driver in ("jit", "mozart"):
        jplan_cache.clear()
        b = JBatcher(jcfg, params, 2, MAX_LEN, driver=driver)
        b.warmup(max_prompt_len=max(p for p, _ in SPECS))
        reqs = [b.make_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
        b.run(reqs)
        out[driver] = [r.out for r in reqs]
    jplan_cache.clear()
    return out


@pytest.mark.parametrize("driver", ["jit", "mozart"])
def test_moe_batcher_matches_the_jax_batcher(moe, moe_reference, driver):
    """Six requests through two slots after ``warmup`` (buckets 8 and 16):
    tokens equal to the reference batcher's on the same driver, and the
    two drivers equal each other; the mozart driver's steps all warm.  The
    capacity drops assignments on the way (a 2-row decode step has
    capacity 1 per expert), so the equality covers dropping."""
    from repro_torch.models import mlp as tmlp
    _, tcfg, _, model, prompts = moe
    b = ContinuousBatcher(tcfg, model, 2, MAX_LEN, driver=driver, device="cpu")
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    reqs = [b.make_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
    with tmlp.count_drops() as drops:
        stats = b.run(reqs)
    assert [r.out for r in reqs] == moe_reference[driver] == moe_reference["jit"]
    assert 0 < drops.dropped < drops.routed
    assert stats["completed"] == len(SPECS)
    assert (stats["planner_calls"], stats["jit_traces"], stats["warm"]) == (0, 0, True)


def test_deepseek_dict_cache_joins_slot_by_slot():
    """``_cache_batch_axes`` walks the ``{"stack", "pre"}`` cache's leaves;
    ``_make_join`` copies a real row into its slot in both caches and drops
    the dummy row aimed at slot ``batch``."""
    tcfg = port_config(jsmoke("deepseek-moe-16b"))
    roll = ttfm.init_caches(tcfg, 2, 8, per_slot=True, device="cpu")
    pref = ttfm.init_caches(tcfg, 2, 8, per_slot=True, device="cpu")
    assert set(roll) == {"stack", "pre"}
    for c in pref.values():
        for leaf in c:
            leaf.fill_(3)
    axes = serving._cache_batch_axes(tcfg, 2, 8)
    assert axes == [3, 3, 1, 1] * 2
    out = serving._make_join(axes)(roll, pref, np.array([1, 2]))
    assert out is roll
    for name, n in (("stack", 2), ("pre", 1)):
        c = roll[name]
        assert c.k.shape[0] == n
        assert bool((c.k[:, :, :, 1] == 3).all()) and bool((c.k[:, :, :, 0] == 0).all())
        assert c.length.tolist() == [[0, 3]] * n and c.start.tolist() == [[0, 3]] * n


def test_deepseek_plan_file_warm_start(tmp_path):
    """The deepseek batcher's plan file: ``warmup`` saves the labelled
    entries (their fingerprints hold the dict of caches); after a restart a
    second batcher on the file serves the same requests with zero planner
    calls and the first batcher's tokens."""
    from repro_torch.core import plan_cache
    jcfg = jsmoke("deepseek-moe-16b").with_runtime(dtype=jnp.float32)
    _, tcfg, model = _carry(jcfg, seed=13)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32) for p, _ in SPECS]
    path = str(tmp_path / "plans.json")
    b = ContinuousBatcher(tcfg, model, 2, MAX_LEN, driver="mozart", device="cpu",
                          plan_cache_path=path)
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    first = [b.make_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
    b.run(first)
    plan_cache.clear()
    assert plan_cache.load(path) == 5                # decode + 2 batch x 2 length buckets
    plan_cache.clear()
    again = ContinuousBatcher(tcfg, model, 2, MAX_LEN, driver="mozart", device="cpu",
                              plan_cache_path=path, prompt_buckets=b.prompt_buckets)
    reqs = [again.make_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
    stats = again.run(reqs)
    assert stats["planner_calls"] == 0 and stats["warm"] is True, stats
    assert [r.out for r in reqs] == [r.out for r in first]


def test_moe_serve_cli_runs_on_the_cpu(monkeypatch, capsys):
    for driver in ("jit", "mozart"):
        monkeypatch.setattr("sys.argv", ["serve", "--arch", "olmoe-1b-7b", "--smoke",
                                         "--device", "cpu", "--requests", "3", "--batch", "2",
                                         "--prompt-len", "5", "--max-new", "3",
                                         "--driver", driver])
        tserve.main()
        assert "served 9 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the recurrent families: pad-free prefill buckets, one per exact length
# ---------------------------------------------------------------------------

#: (prompt_len, max_new): three distinct lengths, so three prefill buckets
PAD_FREE_SPECS = [(5, 3), (9, 7), (5, 2), (3, 5), (9, 4), (3, 1)]
PAD_FREE_LENS = sorted({p for p, _ in PAD_FREE_SPECS})


@pytest.fixture(scope="module", params=["hymba-1.5b", "rwkv6-1.6b"])
def recurrent(request):
    jcfg = jsmoke(request.param).with_runtime(dtype=jnp.float32)
    params, tcfg, model = _carry(jcfg, seed=17)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32) for p, _ in PAD_FREE_SPECS]
    return jcfg, tcfg, params, model, prompts


@pytest.fixture(scope="module")
def recurrent_reference(recurrent):
    """The JAX batcher's tokens on the same weights, requests, 2 slots and
    exact-length buckets, per driver, and sequential batch-1 JAX decoding
    (no capacity routing: a row's tokens do not depend on its batch)."""
    from repro.core import plan_cache as jplan_cache
    from repro.core.serving import ContinuousBatcher as JBatcher
    jcfg, _, params, _, prompts = recurrent
    out = {}
    for driver in ("jit", "mozart"):
        jplan_cache.clear()
        b = JBatcher(jcfg, params, 2, MAX_LEN, driver=driver)
        b.warmup(prompt_lens=PAD_FREE_LENS)
        reqs = [b.make_request(p, n) for p, (_, n) in zip(prompts, PAD_FREE_SPECS)]
        b.run(reqs)
        out[driver] = [r.out for r in reqs]
    jplan_cache.clear()
    prefill = jax.jit(lambda p, t, c: jtfm.prefill(p, jcfg, tokens=t, caches=c))
    decode = jax.jit(lambda p, t, c: jtfm.decode_step(p, jcfg, t, c))
    out["batch1"] = []
    for prompt, (_, max_new) in zip(prompts, PAD_FREE_SPECS):
        logits, caches = prefill(params, jnp.asarray(prompt[None]),
                                 jtfm.init_caches(jcfg, 1, MAX_LEN))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        toks = [int(tok[0, 0])]
        while len(toks) < max_new:
            logits, caches = decode(params, tok, caches)
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(int(tok[0, 0]))
        out["batch1"].append(toks)
    return out


@pytest.mark.parametrize("driver", ["jit", "mozart"])
def test_recurrent_batcher_matches_the_jax_batcher(recurrent, recurrent_reference, driver):
    """Six requests of three exact lengths through two slots after
    ``warmup(prompt_lens=...)``: tokens equal to the reference batcher's on
    the same driver, to its other driver's and to batch-1 decoding; the
    mozart driver's steps all warm, one prefill bucket per exact length."""
    _, tcfg, _, model, prompts = recurrent
    b = ContinuousBatcher(tcfg, model, 2, MAX_LEN, driver=driver, device="cpu")
    assert b.pad_free
    b.warmup(prompt_lens=PAD_FREE_LENS)
    reqs = [b.make_request(p, n) for p, (_, n) in zip(prompts, PAD_FREE_SPECS)]
    stats = b.run(reqs)
    want = recurrent_reference
    assert [r.out for r in reqs] == want[driver] == want["jit"] == want["batch1"]
    assert stats["completed"] == len(PAD_FREE_SPECS)
    assert (stats["planner_calls"], stats["jit_traces"], stats["warm"]) == (0, 0, True)
    if driver == "mozart":
        assert stats["buckets"] == sorted(
            [("decode", 2)] + [("prefill", bb, lb) for bb in (1, 2) for lb in PAD_FREE_LENS])


def test_pad_free_warmup_needs_the_exact_prompt_lens(recurrent):
    """A pad-free batcher buckets by exact length and refuses a warmup
    without the lengths it will serve (pow-2 buckets would pad)."""
    _, tcfg, _, model, _ = recurrent
    b = ContinuousBatcher(tcfg, model, 2, MAX_LEN, driver="jit", device="cpu")
    assert [b._bucket_len(n) for n in (1, 5, 7, 9)] == [1, 5, 7, 9]
    for kw in ({}, {"max_prompt_len": 16}, {"prompt_lens": []}):
        with pytest.raises(ValueError, match="pad-free"):
            b.warmup(**kw)


def test_recurrent_states_join_slot_by_slot(recurrent):
    """``_cache_batch_axes`` finds the batch axis of every leaf of the
    hybrid ``{"kv", "ssm"}`` and of an ``RWKVState``; ``_make_join`` copies
    a real row into its slot and drops the dummy row aimed at slot
    ``batch``."""
    _, tcfg, _, _, _ = recurrent
    roll = ttfm.init_caches(tcfg, 2, 8, per_slot=True, device="cpu")
    pref = ttfm.init_caches(tcfg, 2, 8, per_slot=True, device="cpu")
    for leaf in torch.utils._pytree.tree_leaves(pref):
        leaf.fill_(3)
    axes = serving._cache_batch_axes(tcfg, 2, 8)
    assert axes == ([3, 3, 1, 1, 1, 1] if tcfg.family == "hybrid" else [1, 1, 1])
    out = serving._make_join(axes)(roll, pref, np.array([1, 2]))
    assert out is roll
    for leaf, ax in zip(torch.utils._pytree.tree_leaves(roll), axes):
        assert bool((leaf.select(ax, 1) == 3).all()) and bool((leaf.select(ax, 0) == 0).all())


def test_recurrent_plan_file_warm_start(recurrent, tmp_path):
    """The plan file of a pad-free mozart batcher (fingerprints holding the
    SSM / RWKV state tuples): after a restart a second batcher on the file
    serves the same requests with zero planner calls and the same tokens."""
    from repro_torch.core import plan_cache
    _, tcfg, _, model, prompts = recurrent
    path = str(tmp_path / "plans.json")
    b = ContinuousBatcher(tcfg, model, 2, MAX_LEN, driver="mozart", device="cpu",
                          plan_cache_path=path)
    b.warmup(prompt_lens=PAD_FREE_LENS)
    first = [b.make_request(p, n) for p, (_, n) in zip(prompts, PAD_FREE_SPECS)]
    b.run(first)
    plan_cache.clear()
    assert plan_cache.load(path) == 1 + 2 * len(PAD_FREE_LENS)
    plan_cache.clear()
    again = ContinuousBatcher(tcfg, model, 2, MAX_LEN, driver="mozart", device="cpu",
                              plan_cache_path=path)
    reqs = [again.make_request(p, n) for p, (_, n) in zip(prompts, PAD_FREE_SPECS)]
    stats = again.run(reqs)
    assert stats["planner_calls"] == 0 and stats["warm"] is True, stats
    assert [r.out for r in reqs] == [r.out for r in first]


def test_recurrent_serve_cli_runs_on_the_cpu(monkeypatch, capsys):
    """``Server.warmup`` passes the prompt length as the one exact bucket."""
    for arch in ("hymba-1.5b", "rwkv6-1.6b"):
        for driver in ("jit", "mozart"):
            monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--smoke", "--device",
                                             "cpu", "--requests", "3", "--batch", "2",
                                             "--prompt-len", "5", "--max-new", "3",
                                             "--driver", driver])
            tserve.main()
            out = capsys.readouterr().out
            assert "served 9 tokens" in out
            if driver == "mozart":
                assert "warm=True" in out


# ---------------------------------------------------------------------------
# the embedding-input families: qwen2-vl-2b served on tokens (M-RoPE with
# three equal streams), seamless-m4t-large-v2 refused
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vlm():
    jcfg = jsmoke("qwen2-vl-2b").with_runtime(dtype=jnp.float32)
    params, tcfg, model = _carry(jcfg, seed=19)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32) for p, _ in SPECS]
    return jcfg, tcfg, params, model, prompts


@pytest.fixture(scope="module")
def vlm_reference(vlm):
    """The JAX batcher's tokens on the same weights, requests, 2 slots and
    prompt buckets, per driver, and sequential batch-1 JAX decoding."""
    from repro.core import plan_cache as jplan_cache
    from repro.core.serving import ContinuousBatcher as JBatcher
    jcfg, _, params, _, prompts = vlm
    out = {}
    for driver in ("jit", "mozart"):
        jplan_cache.clear()
        b = JBatcher(jcfg, params, 2, MAX_LEN, driver=driver)
        b.warmup(max_prompt_len=max(p for p, _ in SPECS))
        reqs = [b.make_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
        b.run(reqs)
        out[driver] = [r.out for r in reqs]
    jplan_cache.clear()
    out["batch1"] = [np.asarray(jlm.greedy_generate(params, jcfg, jnp.asarray(p[None]), n))[0]
                     .tolist() for p, (_, n) in zip(prompts, SPECS)]
    return out


@pytest.mark.parametrize("driver", ["jit", "mozart"])
def test_vlm_batcher_matches_the_jax_batcher(vlm, vlm_reference, driver):
    """qwen2-vl's smoke model serves token prompts like any padded family:
    six requests through two slots after ``warmup``, tokens equal to the
    reference batcher's on the same driver, its other driver's and batch-1
    decoding; the mozart driver's steps all warm."""
    _, tcfg, _, model, prompts = vlm
    b = ContinuousBatcher(tcfg, model, 2, MAX_LEN, driver=driver, device="cpu")
    assert not b.pad_free
    b.warmup(max_prompt_len=max(p for p, _ in SPECS))
    reqs = [b.make_request(p, n) for p, (_, n) in zip(prompts, SPECS)]
    stats = b.run(reqs)
    want = vlm_reference
    assert [r.out for r in reqs] == want[driver] == want["jit"] == want["batch1"]
    assert stats["completed"] == len(SPECS)
    assert (stats["planner_calls"], stats["jit_traces"], stats["warm"]) == (0, 0, True)


def test_vlm_serve_cli_runs_on_the_cpu(monkeypatch, capsys):
    for driver in ("jit", "mozart"):
        monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen2-vl-2b", "--smoke",
                                         "--device", "cpu", "--requests", "3", "--batch", "2",
                                         "--prompt-len", "5", "--max-new", "3",
                                         "--driver", driver])
        tserve.main()
        assert "served 9 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("how", ["batcher", "server continuous", "server fixed"])
def test_encoder_decoder_models_are_refused_at_construction(how):
    """The batchers have no place for an encoder input: a seamless model is
    refused with a ``ValueError`` naming the entry points that serve it."""
    jcfg = jsmoke("seamless-m4t-large-v2").with_runtime(dtype=jnp.float32)
    _, tcfg, model = _carry(jcfg)
    with pytest.raises(ValueError, match=r"prefill\(enc_embeds=...\) and "
                                         r"decode_step\(enc_out=...\)"):
        if how == "batcher":
            ContinuousBatcher(tcfg, model, 2, MAX_LEN, device="cpu")
        else:
            tserve.Server(tcfg, model, 2, MAX_LEN, mode=how.split()[1], device="cpu")

"""The port's dense model (config, layers, attention, MLP, transformer, LM
loss) and its parameter carry-across, against the JAX package.

JAX ``init_model`` makes the parameters; ``weights.from_numpy`` carries
them across exactly; both packages then compute the loss and its gradient
on the same numpy tokens, at the gemma-7b smoke config (2 layers, d 64,
vocab 256).

Tolerances: float32 loss rtol 1e-5 (same math, sums in another order);
every float32 gradient rtol 1e-4 with atol 1e-6 * max|g| (gradients sum
over more terms, and tiny entries carry only absolute error); bfloat16
loss rtol 2e-2 (bf16 rounds at other places in the two frameworks);
blocked against dense attention rtol/atol 2e-4, as ``tests/test_models.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma_7b as jgemma
from repro.configs.registry import get_config as jget_config
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro.models.config import AttnConfig as JAttn, ModelConfig as JModel
from repro.models.config import param_count as jparam_count
from repro_torch.configs import gemma_7b as tgemma
from repro_torch.configs import registry
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttfm
from repro_torch.models import weights
from repro_torch.models.config import AttnConfig as TAttn, ModelConfig as TModel
from repro_torch.models.config import MoEConfig, param_count


def _tokens(shape=(2, 17), vocab=256, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def _pair(dtype_j, dtype_t, **kw):
    return (jgemma.smoke_config().with_runtime(dtype=dtype_j, **kw),
            tgemma.smoke_config().with_runtime(dtype=dtype_t, **kw))


@pytest.fixture(scope="module")
def f32_setup():
    jcfg, tcfg = _pair(jnp.float32, torch.float32)
    params = jtfm.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, jax.tree_util.tree_map(np.asarray, params)


def test_f32_loss_and_every_grad_match_jax(f32_setup):
    """16 positions in CE chunks of 5: three chunks and a ragged tail."""
    jcfg, tcfg, params, npp = f32_setup
    tokens = _tokens()
    ce_chunk = 5
    jl, jg = jax.value_and_grad(jlm.loss_fn)(params, {"tokens": jnp.asarray(tokens)},
                                            jcfg, ce_chunk)
    model = weights.from_numpy(npp, tcfg, "cpu")
    tl = tlm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, tcfg, ce_chunk)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = weights.flatten(jax.tree_util.tree_map(np.asarray, jg))
    tflat = weights.leaves(model)
    assert list(tflat) == list(jflat)               # same 11 leaves, same order
    for name, p in tflat.items():
        want = jflat[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=name)


def test_bf16_loss_matches_jax():
    jcfg, tcfg = _pair(jnp.bfloat16, torch.bfloat16)
    params = jtfm.init_model(jax.random.PRNGKey(1), jcfg)
    tokens = _tokens(seed=1)
    jl = jlm.loss_fn(params, {"tokens": jnp.asarray(tokens)}, jcfg)
    model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    assert model["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert model["embed"].dtype == torch.float32
    with torch.no_grad():
        tl = tlm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)


def _tiny(mod, attn, dtype, **kw):
    base = dict(name="t", family="dense", n_layers=2, d_model=64, d_ff=128,
                vocab_size=97, dtype=dtype,
                attn=attn(n_heads=4, n_kv_heads=2, head_dim=16))
    base.update(kw)
    return mod(**base)


def test_blocked_attention_matches_dense_and_jax():
    """GQA (kv 2 of 4 heads), silu MLP, 12 keys in blocks of 5 (a ragged
    last block), as ``tests/test_models.py::test_blocked_attention_matches_dense``;
    the blocked path's loss and gradients also against the reference's."""
    jblk = _tiny(JModel, JAttn, jnp.float32, dense_attn_threshold=4, attn_block_k=5)
    tblk = _tiny(TModel, TAttn, torch.float32, dense_attn_threshold=4, attn_block_k=5)
    tdense = _tiny(TModel, TAttn, torch.float32)
    params = jtfm.init_model(jax.random.PRNGKey(2), jblk)
    tokens = _tokens((2, 13), vocab=97, seed=2)
    model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tblk, "cpu")
    with torch.no_grad():
        lb, _ = ttfm.forward_train(model, tblk, torch.from_numpy(tokens))
        ld, _ = ttfm.forward_train(model, tdense, torch.from_numpy(tokens))
    np.testing.assert_allclose(lb.numpy(), ld.numpy(), rtol=2e-4, atol=2e-4)

    jl, jg = jax.value_and_grad(jlm.loss_fn)(params, {"tokens": jnp.asarray(tokens)},
                                            jblk)
    tl = tlm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, tblk)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = weights.flatten(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in weights.leaves(model).items():
        want = jflat[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("n_layers", [2, 8])
def test_init_layout_matches_jax_at_gemma_7b_width(n_layers):
    """Paths, shapes and dtypes of ``init_model`` equal the reference's, at
    the published widths (made on the meta device: no memory)."""
    jcfg = jget_config("gemma-7b").with_runtime(n_layers=n_layers)
    tcfg = registry.get_config("gemma-7b").with_runtime(n_layers=n_layers)
    want = weights.flatten(jax.eval_shape(
        lambda k: jtfm.init_model(k, jcfg), jax.random.PRNGKey(0)))
    got = weights.flatten(ttfm.init_model(tcfg, None, "meta").tree())
    assert list(got) == list(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name


def test_init_model_draws_from_the_generator():
    cfg = tgemma.smoke_config()
    a = ttfm.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    b = ttfm.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    c = ttfm.init_model(cfg, torch.Generator().manual_seed(4), "cpu")
    for (n, x), y, z in zip(weights.leaves(a).items(), weights.leaves(b).values(),
                            weights.leaves(c).values()):
        assert torch.equal(x, y), n
        if n not in ("final_norm", "layers.ln1", "layers.ln2"):
            assert not torch.equal(x, z), n


def test_carry_across_round_trip_is_exact():
    jcfg, tcfg = _pair(jnp.bfloat16, torch.bfloat16)
    params = jax.tree_util.tree_map(np.asarray,
                                    jtfm.init_model(jax.random.PRNGKey(5), jcfg))
    model = weights.from_numpy(params, tcfg, "cpu")
    back = weights.flatten(weights.to_numpy(model))
    for name, want in weights.flatten(params).items():
        np.testing.assert_array_equal(back[name], np.asarray(want, np.float32), name)
    again = weights.from_numpy(weights.to_numpy(model), tcfg, "cpu")
    for (n, x), y in zip(weights.leaves(model).items(), weights.leaves(again).values()):
        assert x.dtype == y.dtype and torch.equal(x, y), n


@pytest.mark.parametrize("bad", ["missing", "shape"])
def test_from_numpy_rejects_other_layouts(bad):
    _, tcfg = _pair(jnp.float32, torch.float32)
    tree = weights.to_numpy(ttfm.init_model(tcfg, torch.Generator().manual_seed(0), "cpu"))
    if bad == "missing":
        del tree["layers"]["mlp"]["w_gate"]
        err = KeyError
    else:
        tree["embed"] = tree["embed"][:, :32]
        err = ValueError
    with pytest.raises(err):
        weights.from_numpy(tree, tcfg, "cpu")


PORTED = ("gemma-7b", "internlm2-20b", "granite-34b", "gemma3-4b", "olmoe-1b-7b",
          "deepseek-moe-16b", "hymba-1.5b", "rwkv6-1.6b", "qwen2-vl-2b",
          "seamless-m4t-large-v2")
MOE = ("olmoe-1b-7b", "deepseek-moe-16b")
RECURRENT = ("hymba-1.5b", "rwkv6-1.6b")


def _fields(cfg) -> dict:
    """A config's fields, dtype by name (the packages' dtypes differ in type)."""
    import dataclasses
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["dtype"] = getattr(out["dtype"], "__name__", str(out["dtype"])).split(".")[-1]
    for sub in ("attn", "moe", "ssm", "rwkv"):
        out[sub] = out[sub] and dataclasses.asdict(out[sub])
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_registry_has_the_ported_ids(arch):
    """Each id's full and smoke configs equal the JAX package's field by
    field, the ids are the JAX registry's, and an unknown id raises."""
    from repro.configs.registry import ARCH_IDS as JARCH_IDS
    from repro.configs.registry import get_smoke_config as jget_smoke
    assert registry.ARCH_IDS == PORTED
    assert set(registry.ARCH_IDS) == set(JARCH_IDS)
    assert not hasattr(registry, "NOT_PORTED")
    assert _fields(registry.get_config(arch)) == _fields(jget_config(arch))
    assert _fields(registry.get_smoke_config(arch)) == _fields(jget_smoke(arch))
    assert registry.get_config(arch).dtype == torch.bfloat16
    ttfm.check_ported(registry.get_config(arch))
    with pytest.raises(KeyError, match="unknown"):
        registry.get_config("no-such-arch")


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_param_count_matches_jax(which):
    jc, tc = getattr(jgemma, which)(), getattr(tgemma, which)()
    assert param_count(tc) == jparam_count(jc)
    moe = tc.with_runtime(family="moe", moe=MoEConfig(n_experts=4, top_k=2, d_expert=32))
    from repro.models.config import MoEConfig as JMoE
    jmoe = jc.with_runtime(family="moe", moe=JMoE(n_experts=4, top_k=2, d_expert=32))
    assert param_count(moe) == jparam_count(jmoe)


@pytest.mark.parametrize("which", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", PORTED[1:])
def test_param_count_matches_jax_for_the_new_ids(arch, which):
    from repro.configs.registry import get_smoke_config as jget_smoke
    jc = jget_config(arch) if which == "config" else jget_smoke(arch)
    tc = getattr(registry, f"get_{which}")(arch)
    assert param_count(tc) == jparam_count(jc)


@pytest.mark.parametrize("arch", PORTED[1:])
def test_init_layout_matches_jax_at_published_width(arch):
    """Paths, shapes and dtypes at full width and depth (meta device),
    qk-norm's stacked ``(L, head_dim)`` float32 scales included."""
    jcfg, tcfg = jget_config(arch), registry.get_config(arch)
    want = weights.flatten(jax.eval_shape(
        lambda k: jtfm.init_model(k, jcfg), jax.random.PRNGKey(0)))
    got = weights.flatten(ttfm.init_model(tcfg, None, "meta").tree())
    assert list(got) == list(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(want[name].dtype), name
    assert ("layers.attn.q_norm" in got) == bool(tcfg.attn and tcfg.attn.qk_norm)


def test_sliced_draw_keeps_the_distribution_and_the_small_leaves(monkeypatch):
    """A leaf past ``DRAW_ELEMENTS`` is drawn slice by slice into one
    preallocated leaf: the same shape, dtype and N(0, scale) statistics; a
    leaf under the limit takes the same numbers as one whole draw."""
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(0)
    whole = layers.normal((3, 40, 50), 0.5, torch.bfloat16, g, "cpu")
    g = torch.Generator().manual_seed(0)
    want = (torch.randn((3, 40, 50), generator=g) * 0.5).to(torch.bfloat16)
    assert torch.equal(whole, want)
    monkeypatch.setattr(layers, "DRAW_ELEMENTS", 1000)        # 3 slices of 1 layer
    sliced = layers.normal((7, 30, 40), 0.5, torch.bfloat16,
                           torch.Generator().manual_seed(1), "cpu")
    assert sliced.shape == (7, 30, 40) and sliced.dtype == torch.bfloat16
    x = sliced.float()
    assert abs(float(x.mean())) < 0.02 and abs(float(x.std()) - 0.5) < 0.02
    assert not torch.equal(sliced[0], sliced[1])


def test_qk_norm_carry_across_round_trip_is_exact():
    """gemma3-4b's smoke tree (``q_norm``/``k_norm`` per layer) carries
    across and back bit for bit, in bfloat16."""
    from repro.configs.registry import get_smoke_config as jget_smoke
    jcfg = jget_smoke("gemma3-4b")
    tcfg = registry.get_smoke_config("gemma3-4b")
    params = jax.tree_util.tree_map(np.asarray, jtfm.init_model(jax.random.PRNGKey(7), jcfg))
    r = np.random.RandomState(7)
    for k in ("q_norm", "k_norm"):            # not all ones: the values travel
        leaf = params["layers"]["attn"][k]
        params["layers"]["attn"][k] = (1 + 0.1 * r.randn(*leaf.shape)).astype(np.float32)
    model = weights.from_numpy(params, tcfg, "cpu")
    assert model["layers"]["attn"]["q_norm"].dtype == torch.float32
    back = weights.flatten(weights.to_numpy(model))
    for name, want in weights.flatten(params).items():
        np.testing.assert_array_equal(back[name], np.asarray(want, np.float32), name)


def test_unported_families_raise():
    cfg = tgemma.smoke_config().with_runtime(family="diffusion")
    with pytest.raises(NotImplementedError, match="family 'diffusion' not ported"):
        ttfm.init_model(cfg, None, "meta")


@pytest.mark.parametrize("what", ["logit softcap", "banded attention"])
def test_check_ported_accepts_softcap_and_banding(what):
    """A7.5: ``check_ported`` accepts a logit softcap and the banded
    sliding-window path, and a tiny model with each runs ``forward_train``,
    ``prefill`` and ``decode_step`` (finite logits of the expected shapes;
    ``tests/test_torch_softcap_band.py`` holds their values against JAX)."""
    import dataclasses
    cfg = tgemma.smoke_config().with_runtime(dtype=torch.float32)
    cfg = (cfg.with_runtime(attn=dataclasses.replace(cfg.attn, logit_softcap=30.0))
           if what == "logit softcap"
           else cfg.with_runtime(attn=dataclasses.replace(cfg.attn, window=4),
                                 banded_attention=True))
    ttfm.check_ported(cfg)
    model = ttfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens((2, 11), vocab=cfg.vocab_size))
    with torch.no_grad():
        logits, _ = ttfm.forward_train(model, cfg, tokens)
        last, caches = ttfm.prefill(model, cfg, tokens,
                                    caches=ttfm.init_caches(cfg, 2, 16, device="cpu"))
        step, _ = ttfm.decode_step(model, cfg, tokens[:, :1], caches)
    assert logits.shape == (2, 11, cfg.padded_vocab)
    assert last.shape == step.shape == (2, 1, cfg.padded_vocab)
    for t in (logits, last, step):
        assert torch.isfinite(t[..., :cfg.vocab_size]).all()


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_embedding_input_families_pass_check_ported(arch):
    """M-RoPE, the vlm and audio families and encoder-decoder stacks are
    ported: their full configs pass, and their caches are the reference's
    at published width (meta device)."""
    jcfg, tcfg = jget_config(arch), registry.get_config(arch)
    ttfm.check_ported(tcfg)
    want = jax.eval_shape(lambda: jtfm.init_caches(jcfg, 4, 2080, per_slot=True))
    got = ttfm.init_caches(tcfg, 4, 2080, per_slot=True, device="meta")
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)


def test_logits_and_plain_cross_entropy_match_jax():
    """``logits_from_hidden`` (final norm, tied head, padded vocab columns
    masked) and the unchunked ``cross_entropy`` with a mask, float32."""
    jcfg, tcfg = _pair(jnp.float32, torch.float32, vocab_pad=100)
    params = jtfm.init_model(jax.random.PRNGKey(6), jcfg)
    model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    r = np.random.RandomState(6)
    x = r.randn(2, 5, 64).astype(np.float32)
    labels = r.randint(0, 256, (2, 5)).astype(np.int32)
    mask = (r.rand(2, 5) > 0.3).astype(np.float32)
    want = np.asarray(jtfm.logits_from_hidden(params, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = ttfm.logits_from_hidden(model, torch.from_numpy(x), tcfg)
        assert got.shape == (2, 5, 300)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        ce = tlm.cross_entropy(got[..., :256], torch.from_numpy(labels),
                               torch.from_numpy(mask))
    jce = jlm.cross_entropy(jnp.asarray(want[..., :256]), jnp.asarray(labels),
                            jnp.asarray(mask))
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)


# ---------------------------------------------------------------------------
# the MoE family: olmoe-1b-7b, deepseek-moe-16b (dense pre-layer, shared experts)
# ---------------------------------------------------------------------------


def _moe_pair(arch, dtype_j, dtype_t):
    from repro.configs.registry import get_smoke_config as jget_smoke
    return (jget_smoke(arch).with_runtime(dtype=dtype_j),
            registry.get_smoke_config(arch).with_runtime(dtype=dtype_t))


@pytest.mark.parametrize("arch", MOE)
def test_moe_f32_loss_and_every_grad_match_jax(arch):
    """The smoke configs (4 experts top-2; deepseek with 2 shared experts
    and a dense pre-layer): loss with the summed aux loss, and the gradient
    of every leaf, ``pre_layers`` and the routers included, in the
    reference's leaf order; the aux loss also on its own, with a gradient."""
    jcfg, tcfg = _moe_pair(arch, jnp.float32, torch.float32)
    params = jtfm.init_model(jax.random.PRNGKey(0), jcfg)
    tokens = _tokens()
    jl, jg = jax.value_and_grad(jlm.loss_fn)(params, {"tokens": jnp.asarray(tokens)}, jcfg, 5)
    model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    tl = tlm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, tcfg, 5)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = weights.flatten(jax.tree_util.tree_map(np.asarray, jg))
    tflat = weights.leaves(model)
    assert list(tflat) == list(jflat)
    assert ("pre_layers.0.mlp.w_in" in tflat) == (arch == "deepseek-moe-16b")
    for name, p in tflat.items():
        want = jflat[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=name)
    _, jaux = jtfm.forward_hidden(params, jcfg, tokens=jnp.asarray(tokens[:, :-1]))
    _, taux = ttfm.forward_hidden(model, tcfg, torch.from_numpy(tokens[:, :-1]))
    assert taux.requires_grad and float(taux.detach()) > 0
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_bf16_loss_matches_jax(arch):
    """bfloat16 matrices, float32 routers; the reference under ``jax.jit``
    (eagerly its CPU backend has no bf16 x bf16 -> f32 dot for the pre-layer)."""
    jcfg, tcfg = _moe_pair(arch, jnp.bfloat16, torch.bfloat16)
    params = jtfm.init_model(jax.random.PRNGKey(1), jcfg)
    tokens = _tokens(seed=1)
    jl = jax.jit(lambda p, t: jlm.loss_fn(p, {"tokens": t}, jcfg))(params, jnp.asarray(tokens))
    model = weights.from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    assert model["layers"]["moe"]["w_in"].dtype == torch.bfloat16
    assert model["layers"]["moe"]["router"].dtype == torch.float32
    with torch.no_grad():
        tl = tlm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)


def test_pre_layers_carry_across_round_trip_is_exact():
    """deepseek-moe's smoke tree in bfloat16, the list ``pre_layers``
    included, carries across and back bit for bit; the port's tree holds the
    list as an ``nn.ModuleList`` and its meta twin keeps it."""
    jcfg, tcfg = _moe_pair("deepseek-moe-16b", jnp.bfloat16, torch.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, jtfm.init_model(jax.random.PRNGKey(5), jcfg))
    model = weights.from_numpy(params, tcfg, "cpu")
    assert isinstance(model["pre_layers"], torch.nn.ModuleList)
    assert model["pre_layers"][0]["mlp"]["w_in"].shape == (64, 48)
    tree = weights.to_numpy(model)
    assert isinstance(tree["pre_layers"], list) and len(tree["pre_layers"]) == 1
    back = weights.flatten(tree)
    for name, want in weights.flatten(params).items():
        np.testing.assert_array_equal(back[name], np.asarray(want, np.float32), name)
    again = weights.from_numpy(tree, tcfg, "cpu")
    for (n, x), y in zip(weights.leaves(model).items(), weights.leaves(again).values()):
        assert x.dtype == y.dtype and torch.equal(x, y), n
    twin = model.mozart_meta()
    assert [n for n, _ in twin.named_parameters()] == [n for n, _ in model.named_parameters()]
    assert isinstance(twin["pre_layers"], torch.nn.ModuleList)


@pytest.mark.parametrize("arch", MOE)
def test_moe_caches_at_published_width(arch):
    """The decode state is a stacked ``KVCache`` or ``{"stack", "pre"}`` as
    the reference's, and ``layer_windows`` keeps all ``n_layers`` entries
    (the parameters' layout is ``test_init_layout_matches_jax_at_published_width``'s)."""
    jcfg, tcfg = jget_config(arch), registry.get_config(arch)
    kd = tcfg.moe.first_k_dense
    want = jax.eval_shape(lambda: jtfm.init_caches(jcfg, 4, 2080, per_slot=True))
    caches = ttfm.init_caches(tcfg, 4, 2080, per_slot=True, device="meta")
    assert isinstance(caches, dict) == bool(kd)
    pairs = ([(caches[k], want[k]) for k in ("stack", "pre")] if kd else [(caches, want)])
    for g, w in pairs:
        for gl, wl in zip(g, w):
            assert tuple(gl.shape) == wl.shape
            assert str(gl.dtype).split(".")[-1] == str(wl.dtype)
    assert len(ttfm.layer_windows(tcfg)) == tcfg.n_layers


# ---------------------------------------------------------------------------
# the recurrent families: hymba-1.5b (attention + SSM heads), rwkv6-1.6b
# ---------------------------------------------------------------------------

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}         # tests/test_kernels.py


def _rec_pair(arch, dtype):
    """The smoke configs; hymba's with ``pattern_period`` 2, so its 8-key
    windows (shorter than the 17-token inputs) sit beside a global layer."""
    import dataclasses
    from repro.configs.registry import get_smoke_config as jget_smoke
    j = jget_smoke(arch).with_runtime(dtype=JDT[dtype])
    t = registry.get_smoke_config(arch).with_runtime(dtype=TDT[dtype])
    if j.attn is not None:
        j = j.with_runtime(attn=dataclasses.replace(j.attn, pattern_period=2))
        t = t.with_runtime(attn=dataclasses.replace(t.attn, pattern_period=2))
    return j, t


def _rec_params(jcfg, seed):
    """The reference's init as numpy arrays, with the SSM and RWKV float32
    leaves (``A_log``, ``D_skip``, ``dt_bias``, ``mu_*``, ``decay_base``,
    ``bonus_u``, ``ln_x``) moved off their init constants, so that each
    term they scale carries weight."""
    params = jax.tree_util.tree_map(np.asarray, jtfm.init_model(jax.random.PRNGKey(seed), jcfg))
    r = np.random.RandomState(seed)
    for group in ("ssm", "rwkv"):
        leaves = params["layers"].get(group, {})
        for k, v in leaves.items():
            if v.dtype == np.float32:
                leaves[k] = (v + 0.1 * r.randn(*v.shape)).astype(np.float32)
    return params


def _close_rel(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _same_state(tcache, jcache, tol, what):
    """Every leaf of two decode states (the port's through
    ``cache_to_numpy``), in the reference's order; integer leaves exactly."""
    got = jax.tree_util.tree_leaves(weights.cache_to_numpy(tcache))
    want = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jcache))
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        name = f"{what} {jax.tree_util.keystr(path)}"
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            _close_rel(g, w, tol, name)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_forward_train_logits_match_jax(arch):
    """Teacher-forced logits of the whole smoke model (2 layers) on 17
    tokens, float32."""
    jcfg, tcfg = _rec_pair(arch, "float32")
    params = _rec_params(jcfg, 0)
    tokens = _tokens()
    jl, _ = jtfm.forward_train(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                               tokens=jnp.asarray(tokens))
    model = weights.from_numpy(params, tcfg, "cpu")
    with torch.no_grad():
        tl, taux = ttfm.forward_train(model, tcfg, torch.from_numpy(tokens))
    assert tl.dtype == torch.float32 and float(taux) == 0.0
    _close_rel(tl, jl, TOL["float32"], f"{arch} logits")


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_bf16_loss_matches_jax(arch):
    """bfloat16 matrices, float32 recurrences: the loss within the bfloat16
    ``TOL`` (rtol 2e-2), as ``test_bf16_loss_matches_jax``.  Logits are not
    compared in bfloat16: the RWKV stack amplifies rounding, and the
    reference's own bfloat16 logits sit 6% of max|logit| from its float32
    ones.  The reference runs under ``jax.jit`` (eagerly its CPU backend
    has no bf16 x bf16 -> f32 dot for the attention scores)."""
    jcfg, tcfg = _rec_pair(arch, "bfloat16")
    params = _rec_params(jcfg, 0)
    tokens = _tokens(seed=4)
    jl = jax.jit(lambda p, t: jlm.loss_fn(p, {"tokens": t}, jcfg))(params, jnp.asarray(tokens))
    model = weights.from_numpy(params, tcfg, "cpu")
    with torch.no_grad():
        tl = tlm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL["bfloat16"])


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_and_decode_match_jax(arch):
    """float32: ``prefill`` of 17 tokens into a 24-position cache, then 4
    ``decode_step``s on the reference's greedy tokens: logits and every
    leaf of the decode state (K/V, lengths, starts, SSM h and conv window,
    RWKV wkv and shifts) after each.  Then the reference's state after the
    prefill carries across (``cache_from_numpy``) and one port decode step
    from it equals the reference's."""
    jcfg, tcfg = _rec_pair(arch, "float32")
    params = _rec_params(jcfg, 1)
    model = weights.from_numpy(params, tcfg, "cpu")
    tokens = _tokens(seed=1)
    jc = jtfm.init_caches(jcfg, 2, 24)
    tc = ttfm.init_caches(tcfg, 2, 24, device="cpu")
    jlog, jc = jtfm.prefill(params, jcfg, tokens=jnp.asarray(tokens), caches=jc)
    tlog, tc = ttfm.prefill(model, tcfg, torch.from_numpy(tokens), caches=tc)
    _close_rel(tlog, jlog, TOL["float32"], "prefill logits")
    _same_state(tc, jc, TOL["float32"], "after the prefill")
    carried = weights.cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc), tcfg, "cpu")
    first = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None].astype(np.int32)
    tok = first
    for step in range(4):
        jlog, jc = jtfm.decode_step(params, jcfg, jnp.asarray(tok), jc)
        tlog, tc = ttfm.decode_step(model, tcfg, torch.from_numpy(tok), tc)
        _close_rel(tlog, jlog, TOL["float32"], f"decode step {step} logits")
        _same_state(tc, jc, TOL["float32"], f"after decode step {step}")
        if step == 0:
            clog, _ = ttfm.decode_step(model, tcfg, torch.from_numpy(first), carried)
            _close_rel(clog, jlog, TOL["float32"], "decode from the carried state")
        tok = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None].astype(np.int32)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_f32_loss_and_every_grad_match_jax(arch):
    """The smoke configs' loss (CE chunks of 5 over 16 positions) and the
    gradient of every leaf, the SSM's and RWKV's float32 leaves included,
    in the reference's leaf order.  Gradients rtol 1e-4 with atol the
    float32 ``TOL`` (2e-5) times max|g|: the RWKV stack's gradients move by
    up to 1.7e-5·max|g| under float32 reordering alone (the reference's
    literal per-step einsum in the port moves them as much)."""
    jcfg, tcfg = _rec_pair(arch, "float32")
    params = _rec_params(jcfg, 2)
    tokens = _tokens(seed=2)
    jl, jg = jax.value_and_grad(jlm.loss_fn)(jax.tree_util.tree_map(jnp.asarray, params),
                                            {"tokens": jnp.asarray(tokens)}, jcfg, 5)
    model = weights.from_numpy(params, tcfg, "cpu")
    tl = tlm.loss_fn(model, {"tokens": torch.from_numpy(tokens)}, tcfg, 5)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = weights.flatten(jax.tree_util.tree_map(np.asarray, jg))
    tflat = weights.leaves(model)
    assert list(tflat) == list(jflat)
    assert ("layers.ssm.A_log" in tflat) == (arch == "hymba-1.5b")
    assert ("layers.rwkv.bonus_u" in tflat) == (arch == "rwkv6-1.6b")
    for name, p in tflat.items():
        want = jflat[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=TOL["float32"] * float(np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_carry_across_round_trip_is_exact(arch):
    """bfloat16 smoke trees carry across and back bit for bit; the SSM and
    RWKV vectors stay float32, their matrices take the model dtype."""
    jcfg, tcfg = _rec_pair(arch, "bfloat16")
    params = _rec_params(jcfg, 3)
    model = weights.from_numpy(params, tcfg, "cpu")
    layers = model["layers"]
    if arch == "hymba-1.5b":
        assert layers["ssm"]["A_log"].dtype == torch.float32
        assert layers["ssm"]["in_proj"].dtype == torch.bfloat16
    else:
        assert layers["rwkv"]["mu_r"].dtype == layers["rwkv"]["bonus_u"].dtype == torch.float32
        assert layers["rwkv"]["w_r"].dtype == torch.bfloat16
    back = weights.flatten(weights.to_numpy(model))
    for name, want in weights.flatten(params).items():
        np.testing.assert_array_equal(back[name], np.asarray(want, np.float32), name)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_caches_at_published_width(arch):
    """The decode state is the reference's: ``{"kv": KVCache, "ssm":
    SSMState}`` (hybrid) or an ``RWKVState``, every leaf stacked over the
    layers, the same shapes and dtypes (meta device: no memory)."""
    jcfg, tcfg = jget_config(arch), registry.get_config(arch)
    want = jax.eval_shape(lambda: jtfm.init_caches(jcfg, 4, 2080, per_slot=True))
    caches = ttfm.init_caches(tcfg, 4, 2080, per_slot=True, device="meta")
    got = jax.tree_util.tree_leaves(caches)
    assert len(got) == len(jax.tree_util.tree_leaves(want))
    for g, w in zip(got, jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert isinstance(caches, dict) == (arch == "hymba-1.5b")

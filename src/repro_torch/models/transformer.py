"""The transformer stack: the counterpart of
``src/repro/models/transformer.py`` for the dense, MoE, hybrid (Hymba),
RWKV, vision-language (Qwen2-VL) and encoder-decoder (SeamlessM4T)
families.

The reference scans a homogeneous per-layer block over parameters stacked
along a leading ``L`` axis, with ``jax.checkpoint`` remat per layer (and a
nested scan at 8+ layers, which changes memory, not values).  The port
keeps the stacked layout and runs the stack as a Python loop over layers,
each layer under ``torch.utils.checkpoint`` in train mode when
``cfg.remat``.  Decode state is the reference's pytree of stacked per-layer
states (leaves with a leading ``L`` axis): a ``KVCache`` for attention
stacks, ``{"kv": KVCache, "ssm": SSMState}`` for the hybrid stack (Hymba's
parallel attention and SSM heads) and an ``RWKVState`` for RWKV.  Prefill
and decode write each layer's K/V into the cache in place; every other
leaf (lengths, starts, recurrent states) is restacked from the layers' new
values, so a caller keeps only the returned state.

MoE stacks with leading dense layers (DeepSeekMoE's ``first_k_dense``) keep
them apart, as the reference does: a list ``params["pre_layers"]`` of
unstacked dense blocks (global attention, ``cfg.d_ff``) before the stack of
MoE blocks, and the decode state ``{"stack": KVCache, "pre": KVCache}``.
The vision-language and audio families take precomputed embeddings, as
the reference's stub frontends give them: ``input_embeds`` in place of
token embeddings (with M-RoPE's three position streams for Qwen2-VL), and
an encoder-decoder's ``enc_embeds``, which ``encode`` runs through a
bidirectional stack (``enc_layers``, ``enc_norm``).  Each decoder block of
an encoder-decoder model then attends the encoder output through its own
cross-attention (``cross``, normed by ``ln3``) between self-attention and
the MLP; ``_cross_kv_per_layer`` projects every layer's K/V from the
encoder output at once.  A logit softcap applies in every attention
sub-layer (self and cross, every mode) and a ``banded_attention`` config
takes the O(S·w) banded path in train and long prefill
(``attention.attention_block``).

Under tensor parallelism (``models.tensor_parallel``) the stack runs on
this rank's ``"model"`` slices, each sub-layer deciding from its leaves'
shapes; the encoder and the cross K/V of an encoder-decoder and the
embedding inputs of a vision-language model take the same layers.  In
prefill and decode under the groups (``models.data_parallel`` beside it)
each rank runs its data rows, its decode state is the pieces
``launch.shardings.cache_specs`` places on it (``init_caches``: the KV
cache in sequence blocks over ``"model"``, rows over the data axes), and
the logits are gathered over the head's vocabulary columns, so every
``"model"`` rank returns the whole vocabulary of its rows.  The leaves
``tensor_parallel.plan`` gathers are whole: the caller views them once
(``tensor_parallel.serving_view``), and each call checks it.  A pad mask
and per-slot lengths are not ported under a group.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import data_parallel
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import shard_ctx
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import tensor_parallel
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_tokens, normal, rms_norm, unembed
from repro_torch.models.weights import ParamTree

BIG_WINDOW = 1 << 30      # "global attention" encoded as a huge window


#: families whose model code the port runs.
PORTED_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for what the port's model code does not run: a family it does
    not know, and attention-free stacks other than RWKV's."""
    a = cfg.attn
    missing = [what for what, cond in (
        (f"family {cfg.family!r}", cfg.family not in PORTED_FAMILIES),
        ("attention", a is None and cfg.family != "ssm")) if cond]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port runs the "
            f"{', '.join(PORTED_FAMILIES)} families)")


def layer_kind(cfg: ModelConfig) -> str:
    """The stack's block kind, as the reference's ``layer_kind``."""
    if cfg.family == "ssm":
        return "rwkv"
    if cfg.family == "hybrid":
        return "hybrid"
    if cfg.moe is not None:
        return "moe"
    return "cross" if cfg.encdec else "dense"


def first_dense(cfg: ModelConfig) -> int:
    """Leading dense layers kept apart from the stack (DeepSeekMoE)."""
    return cfg.moe.first_k_dense if cfg.moe is not None else 0


def init_model(cfg: ModelConfig, generator: torch.Generator | None,
               device: torch.device | str = "cuda") -> ParamTree:
    """Random parameters in the reference's layout and dtypes (float32
    embedding and norms, ``cfg.dtype`` matrices).  The values follow the
    reference's distributions, not its numbers: JAX keys and torch
    generators draw differently (``weights.from_numpy`` carries exact
    values across)."""
    check_ported(cfg)
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)
    tree = {"embed": normal((V, D), 0.02, torch.float32, generator, device),
            "final_norm": ones(D)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal((D, V), D ** -0.5, cfg.dtype, generator, device)
    kd = first_dense(cfg)
    n = L - kd
    kind = layer_kind(cfg)
    layers = tree["layers"] = {"ln1": ones(n, D), "ln2": ones(n, D)}
    if kind == "rwkv":
        layers["rwkv"] = rwkv_mod.init_rwkv(cfg, generator, device, n)
    else:
        layers["attn"] = attn_mod.init_attn(cfg, generator, device, n)
        if kind == "hybrid":
            layers["ssm"] = ssm_mod.init_ssm(cfg, generator, device, n)
        if kind == "moe":
            layers["moe"] = mlp_mod.init_moe(cfg, generator, device, n)
        else:
            layers["mlp"] = mlp_mod.init_mlp(cfg, generator, device, n)
        if kind == "cross":              # an encoder-decoder's decoder block
            layers["cross"] = attn_mod.init_attn(cfg, generator, device, n)
            layers["ln3"] = ones(n, D)
    if cfg.encdec:                       # the encoder: a dense stack and its norm
        ne = cfg.n_encoder_layers
        tree["enc_layers"] = {"ln1": ones(ne, D), "ln2": ones(ne, D),
                              "attn": attn_mod.init_attn(cfg, generator, device, ne),
                              "mlp": mlp_mod.init_mlp(cfg, generator, device, ne)}
        tree["enc_norm"] = ones(D)
    if kd:
        tree["pre_layers"] = [
            {"attn": attn_mod.init_attn(cfg, generator, device, None),
             "ln1": ones(D), "ln2": ones(D),
             "mlp": mlp_mod.init_mlp(cfg, generator, device, None)} for _ in range(kd)]
    return ParamTree(tree)


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer effective attention window, for all ``n_layers`` (the
    pre-layers' entries included; they run global whatever it says)."""
    L, a = cfg.n_layers, cfg.attn
    if a is None:
        return [BIG_WINDOW] * L
    if a.pattern_period and a.window:
        return [BIG_WINDOW if i % a.pattern_period == a.pattern_period - 1
                else a.window for i in range(L)]
    if a.window:
        return [a.window] * L
    return [BIG_WINDOW] * L


def _unstack(tree, n: int) -> list[dict]:
    """Layer ``i``'s parameters for every ``i``: one ``unbind`` per stacked
    leaf, so backward stacks each leaf's layer gradients once."""
    per: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if hasattr(v, "items") else torch.unbind(v, 0)
        for i in range(n):
            per[i][k] = parts[i]
    return per


def _apply_block(p: dict, x: torch.Tensor, cfg: ModelConfig, window: int,
                 positions: torch.Tensor | None, cache=None,
                 mode: str = "train", pad_mask: torch.Tensor | None = None,
                 use_kernel: bool | None = None, causal: bool = True,
                 cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None):
    """One block: (x, new_cache, aux), aux None but for an MoE block.
    ``cache`` is the layer's ``KVCache``, ``{"kv", "ssm"}`` (hybrid) or
    ``RWKVState`` (None in train mode: recurrent states start at zero).
    ``causal`` is False in the encoder; ``cross_kv`` is an encoder-decoder
    layer's (K, V) of the encoder output: its cross sub-layer runs between
    self-attention and the MLP (skipped without it, as the reference's)."""
    x = shard_ctx.constrain_residual(x)
    if "rwkv" in p:
        st = cache if cache is not None else rwkv_mod.init_rwkv_state(
            cfg, x.shape[0], x.device, rwkv_mod.state_heads(p["rwkv"], cfg))
        tm, st = rwkv_mod.time_mix(p["rwkv"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, st)
        x = x + tm
        cm, st = rwkv_mod.channel_mix(p["rwkv"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg, st)
        return x + cm, st, None
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    hybrid = "ssm" in p
    a_out, new_cache = attn_mod.attention_block(
        p["attn"], h, cfg, positions=positions, causal=causal, window=window,
        cache=cache["kv"] if hybrid and cache is not None else cache, mode=mode,
        use_kernel=use_kernel, pad_mask=pad_mask)
    if hybrid:            # parallel heads on the same input, mean combine
        s_out, ssm_new = ssm_mod.ssm_block(p["ssm"], h, cfg,
                                           None if cache is None else cache["ssm"], mode=mode)
        a_out = 0.5 * (a_out + s_out)
        new_cache = {"kv": new_cache, "ssm": ssm_new}
    x = x + a_out
    if "cross" in p and cross_kv is not None:
        c_out, _ = attn_mod.attention_block(
            p["cross"], rms_norm(x, p["ln3"], cfg.norm_eps), cfg, cross_kv=cross_kv)
        x = x + c_out
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        m_out, aux = mlp_mod.moe_block(p["moe"], h2, cfg)
        return x + m_out, new_cache, aux
    return x + mlp_mod.mlp_block(p["mlp"], h2, cfg), new_cache, None


def _layer_state(stacked, i: int):
    """Layer ``i``'s view of a stacked decode state (any of its forms)."""
    if isinstance(stacked, dict):
        return {k: _layer_state(v, i) for k, v in stacked.items()}
    return type(stacked)(*(leaf[i] for leaf in stacked))


def _restack(stacked, news: list):
    """The stacked decode state after every layer ran: K/V went into
    ``stacked`` in place; every other leaf (lengths, starts, recurrent
    states) is stacked from the layers' new values."""
    if isinstance(stacked, dict):
        return {k: _restack(v, [n[k] for n in news]) for k, v in stacked.items()}
    if isinstance(stacked, KVCache):
        return KVCache(stacked.k, stacked.v, torch.stack([n.length for n in news]),
                       torch.stack([n.start for n in news]))
    return type(stacked)(*(torch.stack(leaves).to(old.dtype)
                           for old, leaves in zip(stacked, zip(*news))))


def run_stack(params, x: torch.Tensor, cfg: ModelConfig, *,
              caches=None, mode: str = "train",
              positions: torch.Tensor | None = None,
              cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
              pad_mask: torch.Tensor | None = None, use_kernel: bool | None = None):
    """The pre-layers (if any, global attention), then the layer stack.
    Returns (x, new_caches, aux): ``caches`` is the stacked decode state
    (``init_caches``'s form; ``{"stack", "pre"}`` with pre-layers; None in
    train mode); ``cross_kv`` the stacked (L, B, Hkv, S_enc, D) K and V of
    an encoder-decoder's cross-attention (``_cross_kv_per_layer``), layer
    ``i`` taking slice ``i``; ``pad_mask`` (B, S) marks real tokens;
    ``use_kernel`` picks the flash-attention kernel where it applies
    (``attention._takes_kernel``); ``aux`` is the MoE load-balance loss
    summed over the layers (0 for other models)."""
    kd = first_dense(cfg)
    remat = cfg.remat and mode == "train"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # DeepSeekMoE's {"stack", "pre"}, told apart from the hybrid {"kv", "ssm"} by key
    split = isinstance(caches, dict) and "stack" in caches

    def run(layers, windows, stacked, ckv=None):
        nonlocal x, aux
        news = []
        for i, (p, window) in enumerate(zip(layers, windows)):
            cache = None if stacked is None else _layer_state(stacked, i)
            args = (p, x, cfg, window, positions, cache, mode, pad_mask, use_kernel,
                    True, None if ckv is None else (ckv[0][i], ckv[1][i]))
            x, new, a = (checkpoint(_apply_block, *args, use_reentrant=False) if remat
                         else _apply_block(*args))
            if a is not None:
                aux = aux + a
            if stacked is not None:
                news.append(new)
        return None if stacked is None else _restack(stacked, news)

    pre = None
    if kd:
        pre = run([p.tree() if isinstance(p, ParamTree) else p for p in params["pre_layers"]],
                  [BIG_WINDOW] * kd, caches["pre"] if split else None)
    stack = run(_unstack(params["layers"], cfg.n_layers - kd), layer_windows(cfg)[kd:],
                caches["stack"] if split else caches, cross_kv)
    return x, ({"stack": stack, "pre": pre} if split else stack), aux


def encode(params, enc_embeds: torch.Tensor, cfg: ModelConfig,
           use_kernel: bool | None = None) -> torch.Tensor:
    """The encoder of an encoder-decoder model (SeamlessM4T): its dense
    stack over ``enc_embeds`` (B, S_enc, d), bidirectional (every layer's
    self-attention non-causal and global, RoPE over ``arange`` positions),
    no cache, then ``enc_norm``.  Under ``cfg.remat`` each layer is
    checkpointed while autograd records.  Under a ``"model"`` group the
    leaves ``tensor_parallel.plan`` gathers must be whole already
    (training's ``tensor_parallel.view``, serving's ``serving_view``)."""
    tensor_parallel.check_viewed(params, cfg)
    x = enc_embeds.to(cfg.dtype)
    n = cfg.n_encoder_layers
    remat = cfg.remat and torch.is_grad_enabled()
    for p in _unstack(params["enc_layers"], n):
        args = (p, x, cfg, BIG_WINDOW, None, None, "train", None, use_kernel, False)
        x, _, _ = (checkpoint(_apply_block, *args, use_reentrant=False) if remat
                   else _apply_block(*args))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv_per_layer(params, enc_out: torch.Tensor, cfg: ModelConfig):
    """Every decoder layer's cross-attention K and V of the encoder output
    at once: each (L, B, Hkv, S_enc, D).  Under tensor parallelism
    (``models.tensor_parallel``) they enter the rank-local compute: this
    rank's heads where ``wk``/``wv`` are a ``"model"`` slice by heads, else
    every head."""
    a = cfg.attn
    B, S, _ = enc_out.shape
    cross = params["layers"]["cross"]
    mg = tensor_parallel.current()
    if mg is not None and cross["wq"].shape[-1] == a.n_heads * a.head_dim:
        mg = None                        # whole heads: the single-device layer
    split = mg is not None and cross["wk"].shape[-1] != a.n_kv_heads * a.head_dim
    src = mg.enter(enc_out) if split else enc_out

    def heads(w):                        # (L, D, Hkv*hd) -> (L, B, Hkv, S, hd)
        y = torch.einsum("bsd,ldo->lbso", src, w.to(enc_out.dtype))
        y = y.reshape(-1, B, S, w.shape[-1] // a.head_dim, a.head_dim).transpose(2, 3)
        return y if mg is None or split else mg.enter(y)
    return (shard_ctx.constrain_cross_kv(heads(cross["wk"])),
            shard_ctx.constrain_cross_kv(heads(cross["wv"])))


def _inputs_to_embeds(params, cfg: ModelConfig, tokens: torch.Tensor | None = None,
                      input_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """``input_embeds`` (a stub frontend's, cast to ``cfg.dtype``) where
    given, else the token embeddings."""
    if input_embeds is not None:
        return input_embeds.to(cfg.dtype)
    return embed_tokens(params["embed"], tokens, cfg)


def _encoded_cross_kv(params, cfg: ModelConfig, enc_embeds, use_kernel=None):
    """An encoder-decoder's stacked cross K/V of ``enc_embeds`` (None for
    other models)."""
    if not cfg.encdec:
        return None
    return _cross_kv_per_layer(params, encode(params, enc_embeds, cfg, use_kernel), cfg)


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_from_hidden(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The logits of the final-normed ``x`` over ``padded_vocab`` columns,
    the padding ones masked.  A head that is this rank's ``"model"`` slice
    of the vocabulary (``models.tensor_parallel``) masks its columns by
    their global ids, then the columns are gathered over the group."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x, _head(params, cfg))
    V = logits.shape[-1]
    mg = tensor_parallel.current()
    if mg is None or V == cfg.padded_vocab:
        mg = None
    if cfg.padded_vocab != cfg.vocab_size:      # mask the TP padding columns
        col = (0 if mg is None else mg.index * V) + torch.arange(V, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits if mg is None else mg.gather(logits, -1, "columns")


def forward_hidden(params, cfg: ModelConfig, tokens: torch.Tensor | None = None,
                   input_embeds: torch.Tensor | None = None,
                   enc_embeds: torch.Tensor | None = None,
                   positions: torch.Tensor | None = None):
    """Teacher-forced forward up to the final norm: (hidden, aux_loss);
    aux is the MoE load-balance loss summed over the layers (0 if dense).
    The input is ``tokens`` (B, S) or ``input_embeds`` (B, S, d);
    ``positions`` (B, S) or M-RoPE's (3, B, S); an encoder-decoder model
    also takes ``enc_embeds`` (B, S_enc, d)."""
    x = _inputs_to_embeds(params, cfg, tokens, input_embeds)
    x, _, aux = run_stack(params, x, cfg, positions=positions,
                          cross_kv=_encoded_cross_kv(params, cfg, enc_embeds))
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward_train(params, cfg: ModelConfig, tokens: torch.Tensor | None = None,
                  input_embeds: torch.Tensor | None = None,
                  enc_embeds: torch.Tensor | None = None,
                  positions: torch.Tensor | None = None):
    """Teacher-forced forward: (logits, aux_loss)."""
    hidden, aux = forward_hidden(params, cfg, tokens=tokens, input_embeds=input_embeds,
                                 enc_embeds=enc_embeds, positions=positions)
    return unembed(hidden, _head(params, cfg)), aux


# -- serving ------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int, per_slot: bool = False,
                device: torch.device | str = "cuda"):
    """Decode state, every layer's stacked along a leading ``L`` axis, as
    the reference's: a ``KVCache``; ``{"stack": KVCache(L - k), "pre":
    KVCache(k)}`` for a model with ``k`` pre-layers; ``{"kv": KVCache,
    "ssm": SSMState}`` for the hybrid family; an ``RWKVState`` for RWKV.
    ``per_slot=True`` gives every batch row its own position counter
    (continuous batching: rows join and leave mid-flight).

    Under the data and ``"model"`` groups (``models.data_parallel``,
    ``models.tensor_parallel``) it returns this rank's pieces of the
    ``batch`` rows' state as ``launch.shardings.cache_specs`` places them,
    allocated at their own size: the KV cache's blocks over ``"model"``
    (``kv_cache_blocks`` a multiple of the extent) and rows over the data
    group, SSM and RWKV states by channels or heads, ``length`` and
    ``start`` whole."""
    check_ported(cfg)
    mesh = _groups_mesh()
    if mesh is not None:
        from repro_torch.launch import shardings as shd
        dg = data_parallel.current()
        if per_slot:
            raise ValueError("per-slot lengths under a data or \"model\" group are not ported")
        if dg is not None and batch % dg.size:
            raise ValueError(f"{batch} rows over a data group of {dg.size}")
        with data_parallel.use(None), tensor_parallel.use(None):
            whole = init_caches(cfg, batch, max_len, device="meta")
        specs = shd.cache_specs(whole, mesh, cfg)
        return shd.map_with_path(
            lambda path, leaf: torch.zeros(
                shd.local_shape(tuple(leaf.shape), shd.at_path(specs, path), mesh),
                dtype=leaf.dtype, device=device), whole)

    def stacked(one, n: int):
        return type(one)(*(leaf.unsqueeze(0).repeat(n, *([1] * leaf.dim())) for leaf in one))

    kind, L = layer_kind(cfg), cfg.n_layers
    if kind == "rwkv":
        return stacked(rwkv_mod.init_rwkv_state(cfg, batch, device), L)
    kv = attn_mod.init_kv_cache(cfg, batch, max_len, per_slot=per_slot, device=device)
    if kind == "hybrid":
        return {"kv": stacked(kv, L), "ssm": stacked(ssm_mod.init_ssm_state(cfg, batch, device), L)}
    kd = first_dense(cfg)
    if kd:
        return {"stack": stacked(kv, L - kd), "pre": stacked(kv, kd)}
    return stacked(kv, L)


def _groups_mesh():
    """The (data, model) ``AbstractMesh`` of the installed groups (None
    without any)."""
    dg, mg = data_parallel.current(), tensor_parallel.current()
    if dg is None and mg is None:
        return None
    from repro_torch.launch.mesh import AbstractMesh
    return AbstractMesh((1 if dg is None else dg.size, 1 if mg is None else mg.size),
                        ("data", "model"))


def _refuse_under_groups(pad_mask=None, caches=None) -> None:
    """What serving under a data or ``"model"`` group does not port: a pad
    mask and per-slot lengths (ROADMAP)."""
    if _groups_mesh() is None:
        return
    if pad_mask is not None:
        raise ValueError("pad_mask under a data or \"model\" group is not ported")
    if any(c.length.dim() > 1 for c in _kv_caches(caches)):
        raise ValueError("a per-slot length under a data or \"model\" group is not ported")


def _kv_caches(caches) -> list[KVCache]:
    if isinstance(caches, KVCache):
        return [caches]
    if isinstance(caches, dict):
        return [c for v in caches.values() for c in _kv_caches(v)]
    return []


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor | None = None,
            input_embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None, caches=None,
            positions: torch.Tensor | None = None, pad_mask: torch.Tensor | None = None,
            last_pos: torch.Tensor | None = None, use_kernel: bool | None = None):
    """Process the prompt, fill caches, return logits of the LAST position.

    The prompt is ``tokens`` (B, S) or ``input_embeds`` (B, S, d) with
    ``positions`` (B, S) or M-RoPE's (3, B, S) (Qwen2-VL); an
    encoder-decoder model encodes ``enc_embeds`` first (SeamlessM4T; the
    encoder's attention takes the kernel non-causal where the decoder's
    does, its cross-attention never).

    ``pad_mask`` (B, S) bool, True = real token: pad key positions are
    masked out of every attention softmax and the cache records each row's
    valid span.  ``last_pos`` (B,) selects each row's own last REAL position
    for the returned logits (right-padded rows); default is the final array
    position (correct for unpadded and left-padded prompts).  Without a pad
    mask every layer's attention takes the flash-attention kernel on a CUDA
    device (``use_kernel``, default: there)."""
    _refuse_under_groups(pad_mask, caches)
    tensor_parallel.check_viewed(params, cfg)
    x = _inputs_to_embeds(params, cfg, tokens, input_embeds)
    x, caches, _ = run_stack(params, x, cfg, caches=caches, mode="prefill",
                             positions=positions, pad_mask=pad_mask, use_kernel=use_kernel,
                             cross_kv=_encoded_cross_kv(params, cfg, enc_embeds, use_kernel))
    if last_pos is not None:
        idx = last_pos.long()[:, None, None].expand(-1, 1, x.shape[-1])
        x = torch.gather(x, 1, idx)
    else:
        x = x[:, -1:]
    return logits_from_hidden(params, x, cfg), caches


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
                enc_out: torch.Tensor | None = None,
                positions: torch.Tensor | None = None):
    """One decode step.  token: (B, 1) integer.  Returns (logits, caches).
    An encoder-decoder model attends ``enc_out`` (``encode``'s output),
    whose cross K/V every layer recomputes at every step, as the
    reference's; without it the cross sub-layers are skipped."""
    _refuse_under_groups(caches=caches)
    tensor_parallel.check_viewed(params, cfg)
    x = embed_tokens(params["embed"], token, cfg)
    cross_kv = (_cross_kv_per_layer(params, enc_out, cfg)
                if cfg.encdec and enc_out is not None else None)
    x, caches, _ = run_stack(params, x, cfg, caches=caches, mode="decode",
                             positions=positions, cross_kv=cross_kv)
    return logits_from_hidden(params, x, cfg), caches

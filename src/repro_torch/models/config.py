"""Model configuration: the counterpart of ``src/repro/models/config.py``.

The same frozen dataclasses with torch dtypes.  The port's model code runs
every family: dense, MoE, hybrid (``ssm``: Hymba's SSM heads), RWKV
(``rwkv``), vision-language (M-RoPE) and encoder-decoder audio, with or
without a logit softcap and the banded sliding-window path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0              # always-active shared experts (deepseek)
    first_k_dense: int = 0         # leading dense layers (deepseek layer 0)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2                # d_inner = expand * d_model
    dt_rank: int = 0               # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    mrope: bool = False            # qwen2-vl 3-section rotary
    mrope_sections: tuple[int, ...] = (16, 24, 24)   # t,h,w (x2 = head_dim)
    window: int | None = None      # sliding window width for local layers
    # local:global pattern period, e.g. 6 with 1 global -> 5:1 (gemma3);
    # 0 = all layers global.
    pattern_period: int = 0
    qk_norm: bool = False
    logit_softcap: float | None = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: AttnConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    # enc-dec (seamless): n_layers = decoder layers
    encdec: bool = False
    n_encoder_layers: int = 0
    # MLP
    gated_mlp: bool = True
    activation: str = "silu"       # silu | gelu
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma multiplies embeddings by sqrt(d)
    max_seq_len: int = 8192
    dtype: Any = torch.bfloat16
    # capability flags (drive shape-cell applicability)
    subquadratic: bool = False     # can run long_500k
    decode_supported: bool = True
    # runtime knobs (overridden by launcher, not architecture identity)
    remat: bool = True
    scan_layers: bool = True
    attn_block_k: int = 1024       # KV block for blocked attention
    dense_attn_threshold: int = 8192   # use dense softmax at/below this S_kv
    kv_cache_blocks: int = 1       # seq-sharded decode blocks (mesh model dim)
    vocab_pad: int = 1             # round vocab up for TP (padded cols masked)
    ce_chunk: int = 512            # sequence chunk for the CE loss
    layer_scan_inner: int = 0      # nested layer-scan chunk (0=auto, 1=flat)
    banded_attention: bool = False # O(S*w) exact sliding-window path
    seq_shard_residual: bool = True  # sequence-parallel residual stream
    remat_policy: str = "nothing"    # nothing | dots (save matmul outputs)
    moe_groups: int = 1            # token dispatch groups (mesh device count)

    def with_runtime(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad, 1)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_head_total(self) -> int:
        return self.attn.n_heads * self.attn.head_dim if self.attn else 0


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embeddings + layers), for roofline N."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    total = V * D                                 # token embedding
    if not cfg.tie_embeddings:
        total += V * D                            # lm head

    def attn_params():
        a = cfg.attn
        qk = D * a.n_heads * a.head_dim
        kv = 2 * D * a.n_kv_heads * a.head_dim
        o = a.n_heads * a.head_dim * D
        return qk + kv + o

    def mlp_params(ff):
        mats = 3 if cfg.gated_mlp else 2
        return mats * D * ff

    def moe_params():
        m = cfg.moe
        mats = 3 if cfg.gated_mlp else 2
        routed = m.n_experts * mats * D * m.d_expert
        shared = m.n_shared * mats * D * m.d_expert
        router = D * m.n_experts
        return routed + shared + router

    def ssm_params():
        s = cfg.ssm
        d_in = s.expand * D
        dt_rank = s.dt_rank or -(-D // 16)
        return (D * 2 * d_in) + (d_in * s.conv_width) + \
               (d_in * (dt_rank + 2 * s.state_dim)) + (dt_rank * d_in) + \
               (d_in * D) + 2 * d_in

    def rwkv_params():
        # time-mix: r,k,v,g,o + decay/a/extras ~ 6*D*D ; channel-mix ~ 2*D*3.5D
        return 6 * D * D + int(2 * D * 3.5 * D)

    per_layer = 0
    if cfg.family == "ssm":       # rwkv
        per_layer = rwkv_params()
    else:
        if cfg.attn is not None:
            per_layer = attn_params()
        if cfg.family == "hybrid":
            per_layer += ssm_params()
        if cfg.moe is not None:
            per_layer += moe_params()
            total += cfg.moe.first_k_dense * (attn_params() + mlp_params(F))
            per_layer_count = L - cfg.moe.first_k_dense
        else:
            per_layer += mlp_params(F)
            per_layer_count = L
    if cfg.moe is None:
        per_layer_count = L
    total += per_layer * per_layer_count

    if cfg.encdec:
        enc_layer = attn_params() + mlp_params(F)
        total += cfg.n_encoder_layers * enc_layer
        total += L * attn_params()               # cross-attention per dec layer
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Active-per-token parameters (MoE: only top-k + shared experts), the
    N of ``launch.roofline.model_flops``."""
    if cfg.moe is None:
        return param_count(cfg)
    m = cfg.moe
    mats = 3 if cfg.gated_mlp else 2
    D, L = cfg.d_model, cfg.n_layers
    moe_layers = L - m.first_k_dense
    routed_all = m.n_experts * mats * D * m.d_expert
    routed_act = m.top_k * mats * D * m.d_expert
    return param_count(cfg) - moe_layers * (routed_all - routed_act)

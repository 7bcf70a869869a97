"""MLP (gated / plain) and Mixture-of-Experts feed-forward layers: the
counterpart of ``src/repro/models/mlp.py``.

MoE is capacity-based Switch-style dispatch: top-k routing, per-expert token
buffers of capacity C, gather dispatch and gather combine, the expert FFN as
batched products over the experts.  Shared experts (DeepSeekMoE) run densely
for every token.  Capacity makes a token's output depend on the rest of its
group: assignments past an expert's C slots are dropped (``count_drops``
reads how many).  The reference's expert-parallel ``shard_map`` branch waits
for the mesh port; ``moe_block`` raises if asked for it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; F.gelu does not
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def init_mlp(cfg: ModelConfig, generator: torch.Generator | None,
             device: torch.device | str, n_layers: int | None,
             d_ff: int | None = None) -> dict:
    """Stacked ``(L, in, out)`` matrices; ``n_layers=None`` gives one
    layer's, unstacked (a DeepSeekMoE dense pre-layer)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    lead = () if n_layers is None else (n_layers,)
    p = {"w_in": normal((*lead, d, f), d ** -0.5, cfg.dtype, generator, device),
         "w_out": normal((*lead, f, d), f ** -0.5, cfg.dtype, generator, device)}
    if cfg.gated_mlp:
        p["w_gate"] = normal((*lead, d, f), d ** -0.5, cfg.dtype, generator, device)
    return p


def mlp_block(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = x @ p["w_in"].to(x.dtype)
    if cfg.gated_mlp:
        h = _act(x @ p["w_gate"].to(x.dtype), cfg.activation) * h
    else:
        h = _act(h, cfg.activation)
    return h @ p["w_out"].to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


def init_moe(cfg: ModelConfig, generator: torch.Generator | None,
             device: torch.device | str, n_layers: int) -> dict:
    """Stacked per layer: ``router`` (L, D, E) float32, ``w_in``/``w_gate``
    (L, E, D, F) and ``w_out`` (L, E, F, D) in ``cfg.dtype``, and with shared
    experts ``shared/{w_in, w_gate, w_out}`` at ``F * n_shared``.  Every leaf
    is drawn on its own (the reference draws the three shared matrices from
    one key, so its ``shared/w_in`` equals its ``shared/w_gate``)."""
    m = cfg.moe
    d, f, e, L = cfg.d_model, m.d_expert, m.n_experts, n_layers
    p = {"router": normal((L, d, e), d ** -0.5, torch.float32, generator, device),
         "w_in": normal((L, e, d, f), d ** -0.5, cfg.dtype, generator, device),
         "w_out": normal((L, e, f, d), f ** -0.5, cfg.dtype, generator, device)}
    if cfg.gated_mlp:
        p["w_gate"] = normal((L, e, d, f), d ** -0.5, cfg.dtype, generator, device)
    if m.n_shared:
        p["shared"] = init_mlp(cfg, generator, device, L, d_ff=f * m.n_shared)
    return p


class Drops:
    """Assignments routed and dropped by capacity over the ``moe_block``
    calls made while counting; reading syncs with the device once."""

    def __init__(self):
        self.keeps: list[torch.Tensor] = []

    @property
    def routed(self) -> int:
        return sum(k.numel() for k in self.keeps)

    @property
    def dropped(self) -> int:
        return int(sum((~k).sum() for k in self.keeps)) if self.keeps else 0


_COUNTING: list[Drops] = []


@contextlib.contextmanager
def count_drops():
    """``with count_drops() as d: ...``: every ``moe_block`` call on real
    (not ``meta``) tensors inside records its ``keep`` mask into ``d``."""
    d = Drops()
    _COUNTING.append(d)
    try:
        yield d
    finally:
        _COUNTING.remove(d)


def route(p, xt: torch.Tensor, cfg: ModelConfig):
    """Router -> softmax -> top-k -> renormalised gates, in float32, and the
    Switch load-balance loss ``E * sum_e me_e * ce_e * aux_loss_weight``.
    Returns (gate_vals (T, k) float32, expert_idx (T, k) int64, aux).

    The top k come from a stable descending sort, so equal probabilities
    (an all-zero row ties every expert) take the lower expert index first,
    as ``lax.top_k`` does; ``torch.topk`` breaks ties otherwise."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)     # (T, E)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    ce = torch.zeros(E, dtype=torch.float32, device=xt.device).index_add_(
        0, expert_idx.reshape(-1), torch.ones(expert_idx.numel(), device=xt.device))
    aux = E * torch.sum(me * (ce / xt.shape[0])) * m.aux_loss_weight
    return gate_vals, expert_idx, aux


def ranks(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """Each assignment's rank within its expert, from a stable sort over the
    group's flattened (token, k) assignments.  Returns (order, counts,
    starts, pos, keep): ``keep = pos < capacity``."""
    eidx = expert_idx.reshape(-1)
    Tk = eidx.numel()
    order = torch.argsort(eidx, stable=True)
    counts = torch.zeros(n_experts, dtype=eidx.dtype, device=eidx.device).index_add_(
        0, eidx, torch.ones_like(eidx))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(Tk, device=eidx.device) - starts[eidx[order]]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    return order, counts, starts, pos, pos < capacity


def _dispatch_one_group(xt: torch.Tensor, gate_vals: torch.Tensor,
                        expert_idx: torch.Tensor, p, cfg: ModelConfig, capacity: int):
    """Capacity-based dispatch, expert FFN and combine for ONE token group,
    in the reference's gather formulation: slot (e, c) of the (E, C) table
    holds sorted assignment ``starts[e] + c``; token (t, k) reads
    ``out_buf[e(t, k), pos(t, k)]`` back if it was kept.  Buffers, gates
    and the k-sum are in ``xt.dtype``.  Returns (out (T, D), keep (T*k,))."""
    m = cfg.moe
    T, D = xt.shape
    E, k = m.n_experts, m.top_k
    Tk = T * k
    order, counts, starts, pos, keep = ranks(expert_idx, E, capacity)

    slot = torch.arange(capacity, device=xt.device)
    slotpos = starts[:, None] + slot[None, :]                             # (E, C)
    slot_valid = slot[None, :] < counts[:, None]
    src_tok = (order // k)[torch.clamp(slotpos, 0, Tk - 1)]
    buf = xt[src_tok] * slot_valid[..., None].to(xt.dtype)                # (E, C, D)

    h = torch.bmm(buf, p["w_in"].to(xt.dtype))
    if cfg.gated_mlp:
        h = _act(torch.bmm(buf, p["w_gate"].to(xt.dtype)), cfg.activation) * h
    else:
        h = _act(h, cfg.activation)
    out_buf = torch.bmm(h, p["w_out"].to(xt.dtype))                        # (E, C, D)

    gathered = out_buf[expert_idx.reshape(-1), torch.clamp(pos, 0, capacity - 1)]
    gathered = gathered * keep[:, None].to(xt.dtype)
    weighted = gathered * gate_vals.reshape(-1, 1).to(xt.dtype)
    return weighted.reshape(T, k, D).sum(1), keep


def moe_block(p, x: torch.Tensor, cfg: ModelConfig, *, mesh=None):
    """Returns (out, aux_loss).  x: (B, S, D).

    ``cfg.moe_groups`` > 1 (dividing B * S) splits the tokens into
    independent dispatch groups with per-group capacity (the reference's
    single-device ``vmap`` branch).  ``mesh`` asks for the reference's
    expert-parallel ``shard_map`` branch, which is not ported: it raises."""
    if mesh is not None:
        raise NotImplementedError("the expert-parallel shard_map dispatch is not ported "
                                  "yet (it waits for the mesh port)")
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, k = m.n_experts, m.top_k
    xt = x.reshape(T, D)
    G = max(cfg.moe_groups, 1)
    if T % G != 0:
        G = 1

    gate_vals, expert_idx, aux = route(p, xt, cfg)
    Tg = T // G
    capacity = int(max(1, (Tg * k * m.capacity_factor) // E))
    parts = [_dispatch_one_group(xt[g * Tg:(g + 1) * Tg], gate_vals[g * Tg:(g + 1) * Tg],
                                 expert_idx[g * Tg:(g + 1) * Tg], p, cfg, capacity)
             for g in range(G)]
    out = torch.cat([o for o, _ in parts]) if G > 1 else parts[0][0]
    if _COUNTING and x.device.type != "meta":
        _COUNTING[-1].keeps.extend(keep.detach() for _, keep in parts)

    if m.n_shared:
        out = out + mlp_block(p["shared"], xt, cfg)
    return out.reshape(B, S, D), aux

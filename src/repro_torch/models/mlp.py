"""MLP (gated / plain) and Mixture-of-Experts feed-forward layers: the
counterpart of ``src/repro/models/mlp.py``.

MoE is capacity-based Switch-style dispatch: top-k routing, per-expert token
buffers of capacity C, gather dispatch and gather combine, the expert FFN as
batched products over the experts.  Shared experts (DeepSeekMoE) run densely
for every token.  Capacity makes a token's output depend on the rest of its
group: assignments past an expert's C slots are dropped (``count_drops``
reads how many).  Under a data-parallel group (``models.data_parallel``)
the routing stays the reference's on the global batch: the aux statistics
are over every rank's tokens, and capacity is per group of the global
tokens.  Under tensor parallelism (``models.tensor_parallel``) the
experts' F is a ``"model"`` slice: routing runs on the replicated tokens,
each rank's FFN on its F slice, and ``out_buf`` is all-reduced over the
group before the combine.

The reference's expert-parallel branch (its ``shard_map``) runs where
``models.shard_ctx`` has ``_MOE_GROUPS`` and ``_RESIDUAL`` set and
``moe_groups`` > 1: one dispatch group per device of the mesh, device
(d, m) routing batch block d and sequence block m with per-device
capacity, the aux loss from statistics over every token.  The port's
residual is whole on every ``"model"`` rank (Megatron), so each rank
routes all M sequence blocks of its rows as M groups, runs its F slice of
every expert on all of them, combines, and only then all-reduces over
``"model"``: the combine is linear in ``out_buf``, so the collective
carries (tokens, D) instead of (E, C, D).  Each device's tokens get the
whole expert FFN; the reference's psum of ``out_buf`` over ``"model"``
also adds the other ranks' sequence blocks into each rank's buffers
(ROADMAP, reference quirks), which the port does not reproduce.  Prefill
and decode under the groups take the same paths; a decode step (one
position) cannot split its sequence over ``"model"``, so under the
expert-parallel context it raises, as the reference's ``shard_map`` does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models import data_parallel, shard_ctx, tensor_parallel
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


def mlp_block(p, x: torch.Tensor, cfg: ModelConfig, d_ff: int | None = None) -> torch.Tensor:
    """The FFN of width ``d_ff`` (``cfg.d_ff`` by default).  Matrices that
    are a ``"model"`` slice of it (``models.tensor_parallel``) compute this
    rank's columns and a partial sum of ``w_out``'s rows, all-reduced."""
    mg = tensor_parallel.current()
    if mg is not None and p["w_in"].shape[-1] == (d_ff or cfg.d_ff):
        mg = None
    if mg is not None:
        x = mg.enter(x)
    h = x @ p["w_in"].to(x.dtype)
    if cfg.gated_mlp:
        h = _act(x @ p["w_gate"].to(x.dtype), cfg.activation) * h
    else:
        h = _act(h, cfg.activation)
    out = h @ p["w_out"].to(x.dtype)
    return out if mg is None else mg.exit(out)


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


def route(p, xt: torch.Tensor, cfg: ModelConfig, dg=None):
    """Router -> softmax -> top-k -> renormalised gates, in float32, and the
    Switch load-balance loss ``E * sum_e me_e * ce_e * aux_loss_weight``.
    Returns (gate_vals (T, k) float32, expert_idx (T, k) int64, aux).

    The top k come from a stable descending sort, so equal probabilities
    (an all-zero row ties every expert) take the lower expert index first,
    as ``lax.top_k`` does; ``torch.topk`` breaks ties otherwise.  With a
    ``data_parallel.DataGroup`` ``dg``, ``me`` and ``ce`` are means over
    every rank's tokens (sums all-reduced, ``me``'s differentiably): the
    global aux loss."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)     # (T, E)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    ce = torch.zeros(E, dtype=torch.float32, device=xt.device).index_add_(
        0, expert_idx.reshape(-1), torch.ones(expert_idx.numel(), device=xt.device))
    if dg is None:
        me, T = probs.mean(0), xt.shape[0]
    else:
        T = xt.shape[0] * dg.size
        me, ce = dg.sum(probs.sum(0), grad=True) / T, dg.sum(ce)
    aux = E * torch.sum(me * (ce / T)) * m.aux_loss_weight
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


def _expert_group(p, cfg: ModelConfig):
    """The model group the experts' F is split over (None for whole
    experts)."""
    mg = tensor_parallel.current()
    return None if mg is None or p["w_in"].shape[-1] == cfg.moe.d_expert else mg


def _dispatch_one_group(xt: torch.Tensor, gate_vals: torch.Tensor,
                        expert_idx: torch.Tensor, p, cfg: ModelConfig, capacity: int,
                        mg: tensor_parallel.ModelGroup | None = None):
    """Capacity-based dispatch, expert FFN and combine for ONE token group,
    in the reference's gather formulation: slot (e, c) of the (E, C) table
    holds sorted assignment ``starts[e] + c``; token (t, k) reads
    ``out_buf[e(t, k), pos(t, k)]`` back if it was kept.  Buffers, gates
    and the k-sum are in ``xt.dtype``.  Experts that are an F slice give
    this rank's partial sum of ``out_buf``, all-reduced over ``mg`` before
    the combine where one is given.  Returns (out (T, D), keep (T*k,))."""
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

    if mg is not None:                   # this rank's F slice of every expert
        buf = mg.enter(buf)
    h = torch.bmm(buf, p["w_in"].to(xt.dtype))
    if cfg.gated_mlp:
        h = _act(torch.bmm(buf, p["w_gate"].to(xt.dtype)), cfg.activation) * h
    else:
        h = _act(h, cfg.activation)
    out_buf = torch.bmm(h, p["w_out"].to(xt.dtype))                        # (E, C, D)
    if mg is not None:
        out_buf = mg.exit(out_buf)

    gathered = out_buf[expert_idx.reshape(-1), torch.clamp(pos, 0, capacity - 1)]
    gathered = gathered * keep[:, None].to(xt.dtype)
    weighted = gathered * gate_vals.reshape(-1, 1).to(xt.dtype)
    return weighted.reshape(T, k, D).sum(1), keep


def moe_block(p, x: torch.Tensor, cfg: ModelConfig):
    """Returns (out, aux_loss).  x: (B, S, D).

    ``cfg.moe_groups`` > 1 (dividing B * S) splits the tokens into
    independent dispatch groups with per-group capacity (the reference's
    single-device ``vmap`` branch), or, with ``models.shard_ctx``'s
    ``_MOE_GROUPS`` and ``_RESIDUAL`` set, into one group per device of
    the mesh (``_expert_parallel``).

    Under a data-parallel group x holds this rank's rows of the global
    batch, and the groups are the global batch's.  Where the rows hold
    whole groups (the group count a multiple of the ranks) they dispatch
    here with the global statistics; otherwise every rank's tokens are
    gathered and routed together, and this rank keeps its rows' output.
    The aux loss returned is the global one."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    dg = data_parallel.current()
    n_ranks = 1 if dg is None else dg.size
    G = max(cfg.moe_groups, 1)
    if (B * S * n_ranks) % G != 0:
        G = 1
    if G > 1 and shard_ctx._MOE_GROUPS is not None and shard_ctx._RESIDUAL is not None:
        return _expert_parallel(p, x, cfg, dg)
    if G % n_ranks != 0:                  # groups span ranks: route globally
        with data_parallel.use(None):
            out, aux = moe_block(p, dg.gather_rows(x), cfg)
        return dg.local_rows(out), aux
    G //= n_ranks                         # this rank's whole groups
    T = B * S
    xt = x.reshape(T, D)

    gate_vals, expert_idx, aux = route(p, xt, cfg, dg)
    Tg = T // G
    capacity = int(max(1, (Tg * k * m.capacity_factor) // E))
    mg = _expert_group(p, cfg)
    parts = [_dispatch_one_group(xt[g * Tg:(g + 1) * Tg], gate_vals[g * Tg:(g + 1) * Tg],
                                 expert_idx[g * Tg:(g + 1) * Tg], p, cfg, capacity, mg)
             for g in range(G)]
    out = torch.cat([o for o, _ in parts]) if G > 1 else parts[0][0]
    return _finish(p, x, xt, out, parts, cfg), aux


def _finish(p, x: torch.Tensor, xt: torch.Tensor, out: torch.Tensor, parts: list,
            cfg: ModelConfig) -> torch.Tensor:
    """The routed experts' (T, D) ``out`` plus the shared experts, as
    (B, S, D); the groups' ``keep`` masks go to ``count_drops``."""
    m = cfg.moe
    if _COUNTING and x.device.type != "meta":
        _COUNTING[-1].keeps.extend(keep.detach() for _, keep in parts)
    if m.n_shared:
        out = out + mlp_block(p["shared"], xt, cfg, d_ff=m.d_expert * m.n_shared)
    return out.reshape(x.shape)


def _expert_parallel(p, x: torch.Tensor, cfg: ModelConfig, dg):
    """The reference's expert-parallel dispatch on ``shard_ctx``'s mesh of
    n devices, M of them on ``"model"``: device (d, m) routes its block of
    x, the rows of batch block d (this rank's rows under the data group
    ``dg``, else every row) at sequence block m, as one group of Tl tokens
    with capacity ``max(1, Tl * k * capacity_factor // E)``; the aux loss
    is ``E * sum(me * ce) * aux_loss_weight`` with ``me`` and ``ce`` summed
    over every token and divided by their count, equal on every rank.

    x is whole on every ``"model"`` rank, so each rank routes its rows
    once (routing is per token; the statistics are summed over the data
    group alone, the ``"model"`` ranks holding the same tokens) and
    dispatches all M sequence blocks as M groups, identically on every
    ``"model"`` rank.  Where the experts are this rank's F slice
    (``models.tensor_parallel``), each group's combine gives a partial sum
    that is all-reduced once over ``"model"`` for all M groups; the tokens
    and the gates enter the rank-local compute, so their gradients are
    summed over the group in the backward.  Returns the whole (B, S, D)
    output on every rank, as the rest of the block expects."""
    from repro_torch.launch.mesh import tp_extent
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    M = tp_extent(shard_ctx._MOE_GROUPS[0])
    if S % M:
        raise ValueError(f"the expert-parallel dispatch splits the sequence over "
                         f"\"model\": {S} positions over {M} ranks")
    Sl = S // M
    Tl = B * Sl
    xt = x.reshape(B * S, D)
    gate_vals, expert_idx, aux = route(p, xt, cfg, dg)
    capacity = int(max(1, (Tl * k * m.capacity_factor) // E))
    mg = _expert_group(p, cfg)
    xe = xt if mg is None else mg.enter(xt)
    ge = gate_vals if mg is None else mg.enter(gate_vals)

    def block(t: torch.Tensor, j: int) -> torch.Tensor:   # sequence block j, (b, s) order
        return t.reshape(B, S, -1)[:, j * Sl:(j + 1) * Sl].reshape(Tl, -1)
    parts = [_dispatch_one_group(block(xe, j), block(ge, j), block(expert_idx, j), p, cfg,
                                 capacity) for j in range(M)]
    out = torch.cat([o.reshape(B, Sl, D) for o, _ in parts], dim=1).reshape(B * S, D)
    if mg is not None:
        out = mg.exit(out)
    return _finish(p, x, xt, out, parts, cfg), aux

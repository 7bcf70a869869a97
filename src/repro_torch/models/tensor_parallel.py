"""Tensor parallelism over the mesh's ``"model"`` axis: the group a
training forward runs in, its differentiable collectives, and which leaves
split the compute.

The reference shards parameters over ``"model"`` by
``shardings.param_specs`` and lets GSPMD render the compute.  The port is
SPMD: each rank holds its ``"model"`` slice of every leaf ``param_specs``
shards there (``weights.model_slices``), and the layers compute on those
slices Megatron-style, where the slice falls on the computation's own
boundary:

* attention ``wq``/``wo`` by heads (``wo`` row-parallel: a partial sum,
  all-reduced); ``wk``/``wv`` by heads where every query head of a rank
  reads a KV head of the same rank (multi-head attention), else computed
  whole on every rank;
* the dense MLP (and shared experts) ``w_in``/``w_gate`` by columns,
  ``w_out`` by rows, and RWKV's channel mix ``w_ck``/``w_cv`` the same;
* RWKV's time mix by heads (``w_o`` row-parallel) and Hymba's SSM by
  channels (``x_proj`` and ``out_proj`` partial sums);
* the MoE experts' F: routing on the replicated tokens, the expert FFN on
  the local F slice, its ``out_buf`` all-reduced before the combine;
* ``embed`` by vocabulary rows (masked lookup, all-reduce) and the head by
  vocabulary columns (``lm.chunked_cross_entropy``'s log-sum-exp and gold
  logit over the sharded vocabulary).

RWKV's time mix by heads and Hymba's SSM heads by channels run on the
slices too, the per-channel leaves they share cut to the rank's part.  A
slice that does not fall on such a boundary (a head split mid-head,
Hymba's ``in_proj`` across its x/z halves) is GATHERED: ``view`` all-gathers the leaf
in the forward and the backward keeps this rank's slice of its gradient,
which every rank computes whole and alike.  ``plan`` is the table of both,
per leaf, with the rule that decided it.

A layer tells a split leaf from the whole one by its shape against the
config (a slice is ``1 / size`` of it); it then reads the group installed
by ``use`` (``current``).  As ``models.data_parallel``'s group, it is
installed around the forward AND the backward, process-wide: CUDA's
autograd runs the backward, and remat's recompute with its collectives, on
its own device thread.  The collectives come in Megatron's pairs:

* ``enter``: identity forward, all-reduce backward (a replicated value
  entering rank-local compute, whose gradient is partial per rank);
* ``exit``: all-reduce forward, identity backward (a partial sum leaving
  it, whose gradient is replicated);
* ``gather_weight``: all-gather forward, this rank's slice backward.

A replicated leaf used inside rank-local compute (qk-norm scales on a
rank's heads) enters through ``enter``, so its gradient is whole and equal
on every rank.  Without a group the model is the single-device one.

Prefill and decode run in the same groups, under ``torch.no_grad()``, with
the decode state placed as ``launch.shardings.cache_specs`` places it: the
KV cache in sequence blocks, one block of every KV head per ``"model"``
rank.  Their collectives have no backward and count the bytes this
process hands ``torch.distributed`` in ``serving_bytes``, by what they
carry (an all-gather: its output; an all-to-all: its input):

* ``gather``: the shard-ordered all-gather (decode's q, K and V row of the
  new token, the partial softmax of each rank's cache blocks; the head's
  vocabulary columns);
* ``exchange``: the all-to-all that sends chunk ``j`` of a value to the
  rank of shard ``j`` (prefill's K and V by heads turned into K and V by
  sequence blocks).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools

import torch
import torch.distributed as dist

from repro_torch.models.data_parallel import DataGroup

_group: ModelGroup | None = None

#: bytes the serving collectives of this process handed ``torch.distributed``,
#: by what they carried; ``reset_serving_bytes`` zeroes it.
serving_bytes: collections.Counter = collections.Counter()


def reset_serving_bytes() -> None:
    serving_bytes.clear()


@dataclasses.dataclass(frozen=True)
class ModelGroup(DataGroup):
    """The ranks of one ``"model"`` line of the mesh: ``group``, ``size``,
    ``index`` this rank's coordinate on ``"model"``, ``order`` the
    coordinate of each group rank.  ``DataGroup``'s shard-ordered
    collectives (``all_gather``, ``sum``, ``local_rows``) apply along it."""

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _Exit.apply(x, self)

    def gather_weight(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherWeight.apply(w, self, dim)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group (no gradient)."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def gather(self, x: torch.Tensor, dim: int, what: str) -> torch.Tensor:
        """Every rank's ``x`` along ``dim`` in shard order (no gradient),
        its bytes counted under ``what``."""
        out = self.all_gather(x.detach(), dim)
        serving_bytes[what] += _nbytes(out)
        return out

    def exchange(self, x: torch.Tensor, split: int, cat: int, what: str) -> torch.Tensor:
        """All-to-all (no gradient): chunk ``j`` of ``x`` along ``split``
        (``size`` equal chunks) goes to the rank of shard ``j``; returns the
        chunks this rank received, concatenated along ``cat`` in shard order.
        Its input bytes are counted under ``what``."""
        chunks = torch.chunk(x.detach(), self.size, split)
        if len({c.shape for c in chunks}) != 1 or len(chunks) != self.size:
            raise ValueError(f"exchange of {tuple(x.shape)} in {self.size} chunks along {split}")
        inp = torch.stack([chunks[j] for j in self.order])   # group rank r gets shard order[r]
        out = torch.empty_like(inp)
        serving_bytes[what] += _nbytes(inp)
        dist.all_to_all_single(out, inp, group=self.group)
        by_shard = [None] * self.size
        for j, part in zip(self.order, out):                 # part r came from group rank r
            by_shard[j] = part
        return torch.cat(by_shard, dim=cat)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mg._all_reduce(g), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        return mg._all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mg, dim):
        ctx.mg, ctx.dim = mg, dim
        return mg.all_gather(w, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mg.local_rows(g, ctx.dim).contiguous(), None, None


@contextlib.contextmanager
def use(group: ModelGroup | None):
    """Install ``group`` for the ``with`` block (process-wide)."""
    global _group
    prev, _group = _group, group
    try:
        yield group
    finally:
        _group = prev


def current() -> ModelGroup | None:
    return _group


# ---------------------------------------------------------------------------
# Which leaves split the compute and which are gathered
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rule:
    """``kind`` "split" (the layer computes on the slice) or "gather" (the
    leaf is all-gathered in the forward); ``dim`` the leaf's dim sharded
    over ``"model"``; ``why`` the rule that decided it."""
    kind: str
    dim: int
    why: str


def _attention_rule(leaf: str, a, n: int) -> tuple[str, str]:
    if a.n_heads % n:
        return "gather", f"mid-head: {a.n_heads} query heads over {n} ranks"
    if leaf in ("wq", "wo"):
        return "split", f"heads: {a.n_heads // n} query heads per rank"
    if a.n_kv_heads % n:
        return "gather", f"mid-head: {a.n_kv_heads} KV heads over {n} ranks"
    if a.n_kv_heads != a.n_heads:
        return "gather", (f"grouped: a rank's query heads read every one of the "
                          f"{a.n_kv_heads} KV heads")
    return "split", f"heads: {a.n_kv_heads // n} KV heads per rank"


def _leaf_rule(name: str, cfg, n: int) -> tuple[str, str]:
    path = name.split(".")
    leaf = path[-1]
    if name == "embed":
        return "split", "vocabulary rows: masked lookup, all-reduce"
    if name == "lm_head":
        return "split", "vocabulary columns: sharded log-sum-exp"
    if "attn" in path or "cross" in path:
        return _attention_rule(leaf, cfg.attn, n)
    if "ssm" in path:
        if leaf == "in_proj":
            return "gather", "the x/z halves: a slice takes one half's channels"
        return "split", "SSM channels: the recurrence per channel, x_proj and out_proj partial sums"
    if "rwkv" in path:
        if leaf in ("w_ck", "w_cv"):
            return "split", "channel mix: w_ck columns, w_cv rows"
        heads = cfg.d_model // (cfg.rwkv.head_dim if cfg.rwkv else 64)
        if heads % n:
            return "gather", f"mid-head: {heads} RWKV heads over {n} ranks"
        return "split", f"time mix by heads: {heads // n} per rank"
    if "moe" in path and "shared" not in path:
        return "split", "expert F: out_buf all-reduced before the combine"
    if "mlp" in path or "shared" in path:
        return "split", "FFN: w_in/w_gate columns, w_out rows"
    return "gather", "no split rule"


def plan(cfg, mesh) -> dict[str, Rule]:
    """``{leaf: Rule}`` for every leaf ``shardings.param_specs`` shards over
    ``"model"`` on ``mesh`` (a ``DeviceMesh`` or a ``launch.mesh.AbstractMesh``)."""
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import tp_extent
    from repro_torch.models.transformer import init_model
    n = tp_extent(mesh)
    dims = shd.model_dims(init_model(cfg, None, "meta"), mesh)
    out = {}
    for name, d in dims.items():
        if d is not None:
            kind, why = _leaf_rule(name, cfg, n)
            out[name] = Rule(kind, d, why)
    return out


@functools.lru_cache(maxsize=16)
def _gathered(cfg, n: int) -> dict[str, tuple[Rule, int]]:
    """``{leaf: (rule, the whole leaf's size along rule.dim)}`` of the
    leaves ``plan`` gathers on a ``"model"`` extent of ``n``."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import weights
    from repro_torch.models.transformer import init_model
    whole = weights.leaves(init_model(cfg, None, "meta"))
    return {name: (r, whole[name].shape[r.dim])
            for name, r in plan(cfg, AbstractMesh((1, n), ("data", "model"))).items()
            if r.kind == "gather"}


def serving_view(params, cfg):
    """The parameters as prefill and decode read them under the installed
    group: ``view`` of the leaves ``plan`` gathers where they are still
    this rank's slices, ``params`` itself where there are none.  A server
    views once, before its first step (``lm.greedy_generate``);
    ``check_viewed`` holds each step to it."""
    mg = current()
    if mg is None:
        return params
    todo = {n: r for n, (r, size) in _gathered(cfg, mg.size).items()
            if _at(params, n).shape[r.dim] != size}
    return view(params, todo, mg) if todo else params


def check_viewed(params, cfg) -> None:
    """Raise where a leaf ``plan`` gathers is still this rank's slice:
    prefill, decode and the encoder read the leaves whole under a group
    (``serving_view``, or training's ``view``)."""
    mg = current()
    if mg is None:
        return
    for name, (r, size) in _gathered(cfg, mg.size).items():
        if _at(params, name).shape[r.dim] != size:
            raise ValueError(f"{name} is this rank's slice: serving under a \"model\" "
                             f"group reads tensor_parallel.serving_view(params, cfg)")


def _at(params, name: str):
    """The leaf of a nested parameter tree at ``weights.flatten``'s name."""
    for k in name.split("."):
        params = params[int(k)] if k.isdigit() else params[k]
    return params


def view(params, table: dict[str, Rule], mg: ModelGroup) -> dict:
    """The parameters as the forward reads them: a nested dict in the
    reference's layout of this rank's slices, each gathered leaf of
    ``table`` all-gathered whole (with autograd)."""
    from repro_torch.models import weights
    flat = weights.leaves(params)
    return weights.unflatten({
        n: mg.gather_weight(p, table[n].dim) if n in table and table[n].kind == "gather"
        else p for n, p in flat.items()})

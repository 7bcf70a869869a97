"""Production dry run: trace one rank's step of every (arch x shape x mesh)
cell.  The counterpart of ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell's train, prefill or decode step
on 512 placeholder host devices and reads XLA's cost and memory analyses
off the per-device SPMD module.  Torch has no such compile, so the port
runs rank 0's program of the same SPMD step once, for real code but on no
data: the process's default group is a ``"fake"`` c10d world of 512 ranks
(its collectives move nothing), ``launch.mesh.make_production_mesh`` builds
16 x 16 on its first 256 ranks or 2 x 16 x 16 on all of them, and the step
runs on the ``meta`` device under ``FakeTensorMode`` with the port's own
builders: ``train.rank_params(..., generator=None)`` for the rank's
parameter slices, ``adamw.init_sharded`` and ``train.make_zero1_step`` for
a ZeRO-1 train step, ``transformer.init_caches`` under the data and
``"model"`` groups for the decode state, ``tensor_parallel.serving_view``
once before a prefill or decode step, and ``models.shard_ctx``'s
placements installed as the reference installs them.  On ``meta`` no
hand-written kernel is taken, as the reference's CPU compile never takes a
Pallas kernel, and the recurrent families' per-token loops are skipped
(``models/ssm.py``, ``models/rwkv.py``), so their FLOPs are ``analyze_cell``'s
analytic term alone, as in the reference.

One dispatch mode (``_Counter``) counts the step:

* ``flops``: matmul-class FLOPs in ``torch.utils.flop_counter``'s formulas,
  backward and recompute included.  The routed experts' FFN runs under a
  ``record_function("moe_experts")`` label while the counter runs
  (``models/mlp.py``'s ``labelling_experts``); its FLOPs,
  forward and their backward, go to ``moe_flops_traced`` and not to
  ``flops``, because ``analyze_cell`` adds them analytically;
* ``hlo_bytes``: the eager program's traffic, each aten op reading its
  inputs' bytes and writing its outputs' bytes, views counting nothing.
  An unfused upper bound, not XLA's fused count; the key is kept because
  ``report.py`` and ``roofline.analyze_cell`` read it;
* ``collective``: the bytes and count of each c10d op under the HLO names:
  ``all-gather`` (output bytes), ``all-reduce``, ``reduce-scatter`` and
  ``all-to-all`` (input bytes), and their ``total_bytes``;
* ``memory``: ``argument_bytes`` the rank's inputs (its parameter slices,
  moments, rows and decode state), ``output_bytes`` its outputs,
  ``alias_bytes`` the donated inputs (parameters and optimizer state in
  train, the decode state in prefill and decode, as the reference's
  ``donate_argnums``); ``temp_bytes`` the peak of the storage bytes the
  step allocates and holds at once (no view, and no storage an input
  already holds, counts), plus the leaves ``serving_view`` holds whole
  beside their slices, less the outputs that alias no input, which XLA
  books under ``output_bytes``; ``peak_bytes`` the reference's formula,
  temp + argument + output - alias, which is then what the rank holds at
  the step's peak;
* ``lower_s`` the seconds to build the rank's inputs, ``compile_s`` the
  seconds of the traced step.

A record has the reference's keys and ``moe_flops_traced``.  The trace
counts every layer, so the two cost variants of ``roofline.main`` extrapolate
exactly for a uniform stack.

``dryrun_cell`` needs the fake world and owns its process, as the
reference's needs its 512 forced devices::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        --out results/dryrun [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, applicable, input_specs
from repro_torch.launch import shardings as shd
from repro_torch.launch import train as T
from repro_torch.launch.mesh import data_axes_of, dp_extent, make_production_mesh, tp_extent
from repro_torch.models import data_parallel, mlp, shard_ctx, tensor_parallel, weights
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, active_param_count, param_count
from repro_torch.optim import adamw

#: ranks of the fake world: 2 x 16 x 16, the reference's forced device count
WORLD = 512


def init_world() -> None:
    """Make this process rank 0 of a ``"fake"`` c10d world of ``WORLD``
    ranks (no store traffic, no peer), unless it already has a default
    group.  The backend is registered by
    ``torch.testing._internal.distributed.fake_pg`` where torch does not
    register it itself."""
    if dist.is_initialized():
        return
    try:
        dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=WORLD)
    except (AssertionError, ValueError, RuntimeError):
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
        dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=WORLD)


def _check_world() -> None:
    if not (dist.is_initialized() and dist.get_backend() == "fake"
            and dist.get_world_size() == WORLD):
        have = (f"a {dist.get_backend()!r} group of {dist.get_world_size()} ranks"
                if dist.is_initialized() else "no process group")
        raise ValueError(f"dryrun_cell traces rank 0 of a \"fake\" world of {WORLD} ranks "
                         f"(dryrun.init_world() in a process of its own); this process "
                         f"has {have}")


def runtime_config(cfg: ModelConfig, mesh, shape) -> ModelConfig:
    """Install mesh-dependent runtime knobs on the arch config."""
    return cfg.with_runtime(
        kv_cache_blocks=tp_extent(mesh),
        moe_groups=int(mesh.size()),
        dense_attn_threshold=2048 if shape.kind == "train" else 8192,
        attn_block_k=1024,
        vocab_pad=16 * 16,     # logits shard over TP even for odd vocabs
    )


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch, caches):
        kw = {k: v for k, v in batch.items() if k != "tokens"}
        logits, caches = tfm.prefill(params, cfg, tokens=batch.get("tokens"),
                                     caches=caches, **kw)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), caches
    return prefill_step


def build_serve_step(cfg: ModelConfig):
    def serve_step(params, token, caches, enc_out=None):
        logits, caches = tfm.decode_step(params, cfg, token, caches, enc_out=enc_out)
        return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32), caches
    return serve_step


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------

#: the c10d ops of the port's collectives -> (HLO name, the argument whose
#: bytes are counted: all-gather's outputs, the others' inputs)
_C10D = {"c10d.allreduce_": ("all-reduce", 0), "c10d.allgather_": ("all-gather", 0),
         "c10d.reduce_scatter_": ("reduce-scatter", 1), "c10d.alltoall_base_": ("all-to-all", 1)}
#: ops that allocate without writing
_ALLOC_ONLY = ("aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
               "aten.new_empty_strided")


def _tensors(tree) -> list:
    """The tensors of ``tree`` (a ``ParamTree`` gives its parameters)."""
    tree = pytree.tree_map(lambda x: weights.leaves(x) if isinstance(x, torch.nn.Module) else x,
                           tree, is_leaf=lambda x: isinstance(x, torch.nn.Module))
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def nbytes(tree) -> int:
    """Bytes of every tensor of ``tree`` (a ``DTensor``'s local shard)."""
    return sum(_local(t).numel() * _local(t).element_size() for t in _tensors(tree))


class _Counter(TorchDispatchMode):
    """FLOPs, bytes, collectives and the peak of live storage of every aten
    op it sees (module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = self.moe_flops = 0
        self.bytes = 0
        self.coll_bytes: collections.Counter = collections.Counter()
        self.coll_counts: collections.Counter = collections.Counter()
        self.ops: dict[str, list] = {}
        self.labels: list = []                 # open scopes: (name, first sequence nr)
        self.moe_seq: list[tuple[int, int]] = []   # autograd nodes made under the label
        self.live: dict[int, int] = {}
        self.cur = self.peak = 0

    # -- the label ------------------------------------------------------------
    def _in_moe(self) -> bool:
        if any(name == mlp.EXPERTS_LABEL for name, _ in self.labels):
            return True
        node = torch._C._current_autograd_node()
        if node is None:
            return False
        n = node._sequence_nr()
        return any(lo <= n < hi for lo, hi in self.moe_seq)

    def _label(self, func, args, out) -> bool:
        if func is torch.ops.profiler._record_function_enter_new.default:
            self.labels.append((args[0], torch._C._autograd._get_sequence_nr()))
            return True
        if func is torch.ops.profiler._record_function_exit._RecordFunction:
            # scopes close in the order they opened (the handle's Python
            # wrapper differs between enter and exit)
            name, lo = self.labels.pop()
            if name == mlp.EXPERTS_LABEL:
                self.moe_seq.append((lo, torch._C._autograd._get_sequence_nr()))
            return True
        return False

    # -- storage --------------------------------------------------------------
    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def _track(self, func, inputs, out) -> None:
        """Count the storages ``out`` holds that the op allocated: not a
        view's, and none an input already holds (an in-place op's, or an
        argument of the step's that an op only reads or writes)."""
        if func.is_view:
            return
        held = {_local(t).untyped_storage()._cdata for t in _tensors(inputs)}
        for t in _tensors(out):
            st = _local(t).untyped_storage()
            key = st._cdata
            if key in self.live or key in held:
                continue
            self.live[key] = st.nbytes()
            self.cur += self.live[key]
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.cur)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._label(func, args, out):
            return out
        name = str(func.overloadpacket)
        if name.startswith("prim."):
            return out
        row = self.ops.setdefault(name, [0, 0, 0])
        row[0] += 1
        formula = self.registry.get(func.overloadpacket)
        if formula is not None:
            f = int(formula(*args, **kwargs, out_val=out))
            if self._in_moe():
                self.moe_flops += f
            else:
                self.flops += f
                row[1] += f
        if name.startswith(("c10d.", "_c10d_functional.")):
            if name not in _C10D:
                raise NotImplementedError(f"the dry run does not count {name}")
            hlo, at = _C10D[name]
            self.coll_bytes[hlo] += nbytes(args[at])
            self.coll_counts[hlo] += 1
        if not func.is_view:
            b = (0 if name in _ALLOC_ONLY else nbytes(out)) + nbytes((args, kwargs))
            self.bytes += b
            row[2] += b
        self._track(func, (args, kwargs), out)
        return out

    def table(self) -> str:
        """The per-op table ``--save-hlo`` writes: op, calls, FLOPs, bytes."""
        lines = [f"{'op':48s} {'calls':>8s} {'flops':>14s} {'bytes':>16s}"]
        for name, (calls, f, b) in sorted(self.ops.items(), key=lambda kv: -kv[1][2]):
            lines.append(f"{name:48s} {calls:8d} {f:14.6g} {b:16.6g}")
        lines.append(f"{'moe_experts (outside flops)':48s} {'':8s} {self.moe_flops:14.6g}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# One dry-run cell
# ---------------------------------------------------------------------------

def install_placements(cfg: ModelConfig, mesh, batch: int) -> None:
    """``shard_ctx``'s placements as ``src/repro/launch/dryrun.py:169-183``
    installs them, in the port's ``(mesh, placements)`` pairs."""
    dpa = data_axes_of(mesh)
    dp_spec = dpa if len(dpa) > 1 else (dpa[0] if dpa else None)
    bspec = dp_spec if batch % dp_extent(mesh) == 0 else None
    seq_spec = "model" if cfg.seq_shard_residual else None
    shard_ctx.set_residual((mesh, shd.placements((bspec, seq_spec, None), mesh)))
    me = tp_extent(mesh)
    if cfg.encdec and cfg.attn is not None:
        hspec = "model" if me > 1 and cfg.attn.n_kv_heads % me == 0 else None
        shard_ctx.set_cross_kv((mesh, shd.placements((None, bspec, hspec, None, None), mesh)))
    if cfg.moe is not None:
        shard_ctx.set_moe_groups((mesh, shd.placements((tuple(mesh.mesh_dim_names),), mesh)))
    if cfg.padded_vocab % me == 0:
        shard_ctx.set_logits((mesh, shd.placements((bspec, None, "model"), mesh)))


def _inputs(cfg: ModelConfig, shape, mesh, zero: adamw.Zero1):
    """(step, args, donated, argument bytes, bytes of the leaves viewed
    whole) of rank 0's step on ``meta``, under the groups the step runs
    in."""
    params = T.rank_params(cfg, zero, None, torch.device("meta"))
    if shape.kind == "train":
        opt = adamw.init_sharded(weights.leaves(params), zero)
        batch = input_specs(cfg, shape)
        local, _ = T.local_batch(batch, mesh, zero.dg)
        step = T.make_zero1_step(cfg, adamw.AdamWConfig(), zero)
        return step, (params, opt, batch), (params, opt), nbytes((params, opt, local)), 0
    spec = input_specs(cfg, shape)
    local, _ = T.local_batch(spec, mesh, zero.dg)
    caches = tfm.init_caches(cfg, shape.global_batch, shape.seq_len, device="meta")
    ins = (local, caches) if shape.kind == "prefill" else (local["token"], caches)
    if shape.kind == "decode" and cfg.encdec:
        ins += (local["enc_out"],)
    # viewed once, as a server views them; the leaves it gathers whole
    # are held beside the slices, as the reference's step holds them as
    # temporaries: their bytes go to temp
    view = tensor_parallel.serving_view(params, cfg)
    held = {id(t) for t in _tensors(params)}
    gathered = sum(nbytes(t) for t in _tensors(view) if id(t) not in held)
    step = build_prefill_step(cfg) if shape.kind == "prefill" else build_serve_step(cfg)
    return step, (view, *ins), caches, nbytes((params, *ins)), gathered


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                save_hlo: str | None = None, cfg_override=None,
                runtime_overrides: dict | None = None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = SHAPES[shape_name]
    base_cfg = cfg_override or get_config(arch)
    ok, reason = applicable(base_cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    _check_world()
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    cfg = runtime_config(base_cfg, mesh, shape)
    if runtime_overrides:
        cfg = cfg.with_runtime(**runtime_overrides)
    t0 = time.time()
    try:
        # the groups read the mesh's rank grid (``nonzero``), which fake
        # tensors refuse: they are built first
        zero = T.zero1_layout(mesh, tfm.init_model(cfg, None, "meta"))
        serving = shape.kind != "train"
        # serving installs the data group only where the rows divide (else
        # every rank holds every row, as cache_specs places them);
        # make_zero1_step decides that itself
        dg = zero.dg if shape.global_batch % dp_extent(mesh) == 0 else None
        install_placements(cfg, mesh, shape.global_batch)
        with FakeTensorMode(allow_non_fake_inputs=True), \
                data_parallel.use(dg if serving else None), \
                tensor_parallel.use(zero.mg if serving else None), \
                torch.no_grad() if serving else contextlib.nullcontext():
            step, args, donated, arg_bytes, gathered = _inputs(cfg, shape, mesh, zero)
            t_lower = time.time() - t0
            counter = _Counter()
            with counter, mlp.labelling_experts():
                out = step(*args)
            out_bytes = nbytes(out)
            t_compile = time.time() - t0 - t_lower
        alias = nbytes(donated)
        temp = max(counter.peak + gathered - (out_bytes - alias), 0)
        if save_hlo:
            Path(save_hlo).write_text(counter.table())
        rec.update(
            status="ok",
            lower_s=round(t_lower, 1),
            compile_s=round(t_compile, 1),
            flops=float(counter.flops),
            hlo_bytes=float(counter.bytes),
            collective={"bytes_by_op": {k: float(v) for k, v in counter.coll_bytes.items()},
                        "counts_by_op": dict(counter.coll_counts),
                        "total_bytes": float(sum(counter.coll_bytes.values()))},
            memory=dict(
                argument_bytes=int(arg_bytes),
                output_bytes=int(out_bytes),
                temp_bytes=int(temp),
                alias_bytes=int(alias),
                # donated outputs alias their argument buffers
                peak_bytes=int(temp + arg_bytes + out_bytes - alias),
            ),
            n_devices=int(mesh.size()),
            params=param_count(base_cfg),
            active_params=active_param_count(base_cfg),
            moe_flops_traced=float(counter.moe_flops),
        )
        print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: OK "
              f"(lower {t_lower:.0f}s, compile {t_compile:.0f}s, "
              f"temp/device {rec['memory']['temp_bytes']/2**30:.2f} GiB)")
    except Exception as e:  # noqa: BLE001 — recorded as cell failure
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        print(f"[dryrun] {arch} x {shape_name}: FAIL {type(e).__name__}: {e}")
    finally:
        shard_ctx.clear()
    return rec


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--save-hlo", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the chip of the roofline line printed per cell")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all required"
        cells = [(args.arch, args.shape)]

    init_world()
    for arch, shape in cells:
        tag = f"{arch}__{shape}__{'mp' if args.multi_pod else 'sp'}"
        path = outdir / f"{tag}.json"
        if path.exists():
            print(f"[dryrun] {tag}: cached, skipping")
            continue
        rec = dryrun_cell(arch, shape, multi_pod=args.multi_pod,
                          save_hlo=args.save_hlo)
        path.write_text(json.dumps(rec, indent=2))
        if rec["status"] == "ok":
            _print_terms(rec, args.device)


def _print_terms(rec: dict, device: str) -> None:
    """The record's own roofline terms on ``device``'s chip: every layer
    traced, without ``roofline.analyze_cell``'s analytic terms."""
    from repro_torch.launch import roofline
    terms = roofline.roofline_terms(rec["flops"], rec["hlo_bytes"],
                                    rec["collective"]["total_bytes"], device=device)
    print(f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']} on {device}: "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in terms.items()))


if __name__ == "__main__":
    main()

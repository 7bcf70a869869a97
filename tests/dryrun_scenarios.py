"""The production dry run's cells, run by both packages.

Every cell runs on the arch's smoke config at the production shapes and
meshes (16 x 16; 2 x 16 x 16 for ``multi_pod``).  The reference runs in ONE
subprocess per test file (``run_jax``): its ``launch/dryrun.py`` forces 512
host devices at import, and its ``make_production_mesh`` is replaced, in
that subprocess only, by one with Auto axes (jax 0.9's default Explicit
axes turn the reference's sharding constraints into asserts that fail on
every cell; ``tests/sharded_scenarios.py::jax_mesh`` builds meshes the same
way).  The port runs in ONE subprocess per test file too (``run_torch``):
``dryrun.init_world()`` makes it rank 0 of a ``"fake"`` world of 512 ranks.
Each side writes its records (JSON) and the port also what its checks read
beside them.

This module imports neither JAX nor torch at import time.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: test file -> its (arch, shape, multi_pod) cells
CELLS = {
    "dryrun": (("gemma-7b", "train_4k", False), ("gemma-7b", "prefill_32k", False),
               ("gemma-7b", "decode_32k", False), ("gemma-7b", "long_500k", False),
               ("gemma-7b", "decode_32k", True)),
    "dryrun_ref": (("olmoe-1b-7b", "prefill_32k", False), ("olmoe-1b-7b", "decode_32k", False),
                   ("olmoe-1b-7b", "train_4k", False), ("hymba-1.5b", "prefill_32k", False), ("rwkv6-1.6b", "long_500k", False),
                   ("qwen2-vl-2b", "train_4k", False),
                   ("seamless-m4t-large-v2", "decode_32k", False)),
    "report": (("gemma-7b", "decode_32k", False), ("olmoe-1b-7b", "decode_32k", False),
               ("gemma-7b", "decode_32k", True)),
}
#: the MoE train cell traced a second time with the experts' label off
MOE_TRAIN_CELL = ("olmoe-1b-7b", "train_4k", False)
#: the cost-variant depths traced for the linearity check (gemma-7b x train_4k)
LINEAR_CELL, LINEAR_DEPTHS = ("gemma-7b", "train_4k"), (2, 3, 4)
#: a gemma-7b smoke config whose 16 heads (one per "model" rank) take the
#: serving paths that split by heads: prefill's all-to-all block exchange
WIDE_HEADS = 16


def tag(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}"


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


def run_jax(which: str, out_path: str) -> None:
    from repro.launch import dryrun           # forces 512 host devices first
    import jax
    from jax.sharding import AxisType
    from repro.configs.registry import get_smoke_config

    def auto_mesh(*, multi_pod: bool = False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

    dryrun.make_production_mesh = auto_mesh
    recs = {tag(*c): dryrun.dryrun_cell(c[0], c[1], multi_pod=c[2],
                                        cfg_override=get_smoke_config(c[0]))
            for c in CELLS[which]}
    Path(out_path).write_text(json.dumps(recs))


# ---------------------------------------------------------------------------
# The port
# ---------------------------------------------------------------------------


def _cell(dryrun, tp, arch, shape, multi_pod, cfg) -> dict:
    """A port record and the serving bytes its trace counted."""
    before = collections.Counter(tp.serving_bytes)
    rec = dryrun.dryrun_cell(arch, shape, multi_pod=multi_pod, cfg_override=cfg)
    moved = collections.Counter(tp.serving_bytes)
    moved.subtract(before)
    return {"record": rec, "serving_bytes": {k: v for k, v in moved.items() if v}}


def real_peak(arch: str, shape_name: str, multi_pod: bool) -> int:
    """The peak bytes ``MemTracker`` sees when rank 0's decode step of the
    cell runs for real on the CPU in the fake world, with the dry run's
    builders and real tensors (its slices drawn from a seed), the step's
    arguments and viewed parameters tracked as resident."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils import _pytree as pytree
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import SHAPES, input_specs
    from repro_torch.launch import dryrun, train
    from repro_torch.models import data_parallel, shard_ctx, tensor_parallel
    from repro_torch.models import transformer as tfm
    shape = SHAPES[shape_name]
    mesh = dryrun.make_production_mesh(multi_pod=multi_pod, device="cpu")
    cfg = dryrun.runtime_config(get_smoke_config(arch), mesh, shape)
    zero = train.zero1_layout(mesh, tfm.init_model(cfg, None, "meta"))
    dg = zero.dg if shape.global_batch % zero.dg.size == 0 else None
    gen = torch.Generator().manual_seed(0)
    dryrun.install_placements(cfg, mesh, shape.global_batch)
    try:
        with data_parallel.use(dg), tensor_parallel.use(zero.mg), torch.no_grad():
            params = train.rank_params(cfg, zero, gen, torch.device("cpu"))
            caches = tfm.init_caches(cfg, shape.global_batch, shape.seq_len, device="cpu")
            local, _ = train.local_batch(input_specs(cfg, shape), mesh, zero.dg)
            ins = {k: (torch.randn(tuple(v.shape), generator=gen, dtype=v.dtype)
                       if v.dtype.is_floating_point else
                       torch.randint(0, cfg.vocab_size, tuple(v.shape), generator=gen,
                                     dtype=v.dtype)) for k, v in local.items()}
            view = tensor_parallel.serving_view(params, cfg)
            args = (view, ins["token"], caches) + ((ins["enc_out"],) if cfg.encdec else ())
            tracker = MemTracker()
            tracker.track_external(params, *[t for t in pytree.tree_leaves(args)
                                             if isinstance(t, torch.Tensor)])
            with tracker:
                dryrun.build_serve_step(cfg)(*args)
    finally:
        shard_ctx.clear()
    (peak,) = [v["Total"] for v in tracker.get_tracker_snapshot("peak").values()]
    return int(peak)


def run_torch(which: str, out_path: str) -> None:
    import contextlib
    import dataclasses
    from unittest import mock

    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import mlp
    from repro_torch.models import tensor_parallel as tp
    torch.set_num_threads(1)
    dryrun.init_world()
    out = {"cells": {tag(*c): _cell(dryrun, tp, *c, get_smoke_config(c[0]))
                     for c in CELLS[which]}}
    out["real_peak"] = {tag(*c): real_peak(*c) for c in CELLS[which]
                        if which != "report" and SHAPES[c[1]].kind == "decode"
                        and out["cells"][tag(*c)]["record"]["status"] == "ok"}
    if which == "dryrun":
        arch, shape = LINEAR_CELL
        rt = dict(roofline.VARIANT_OVERRIDES, ce_chunk=SHAPES[shape].seq_len + 1)
        out["linear"] = {
            n: dryrun.dryrun_cell(arch, shape, runtime_overrides=rt,
                                  cfg_override=get_smoke_config(arch).with_runtime(n_layers=n))
            for n in LINEAR_DEPTHS}
        cfg = get_smoke_config("gemma-7b")
        wide = cfg.with_runtime(attn=dataclasses.replace(
            cfg.attn, n_heads=WIDE_HEADS, n_kv_heads=WIDE_HEADS, head_dim=16))
        out["wide"] = {s: _cell(dryrun, tp, "gemma-7b", s, False, wide)
                       for s in ("prefill_32k", "decode_32k")}
    if which == "dryrun_ref":
        # every FLOP in "flops", none booked apart
        with mock.patch.object(mlp, "labelling_experts", contextlib.nullcontext):
            out["unlabelled"] = dryrun.dryrun_cell(
                *MOE_TRAIN_CELL[:2], cfg_override=get_smoke_config(MOE_TRAIN_CELL[0]))
    if which == "report":
        out["main"] = _roofline_main(dryrun, roofline, Path(out_path).parent)
    Path(out_path).write_text(json.dumps(out))


def _roofline_main(dryrun, roofline, work: Path) -> dict:
    """``dryrun.main`` and ``roofline.main`` over ``work`` on smoke configs
    (both modules' ``get_config`` replaced): a traced cell, a cached
    record, cached variants, a missing record, a failed variant and a
    record that is not ok."""
    from repro_torch.configs.registry import get_smoke_config
    dryrun.get_config = roofline.get_config = get_smoke_config
    d, v, o = (work / "dryrun", work / "variants", work / "roofline")
    out = {}
    dryrun.main(["--arch", "gemma-7b", "--shape", "decode_32k", "--out", str(d),
                 "--device", "cpu"])
    first = (d / "gemma-7b__decode_32k__sp.json").read_text()
    dryrun.main(["--arch", "gemma-7b", "--shape", "decode_32k", "--out", str(d)])
    out["cached_record_kept"] = (d / "gemma-7b__decode_32k__sp.json").read_text() == first
    # traced variants: the full cell
    roofline.main(["--dryrun-dir", str(d), "--variants-dir", str(v), "--out", str(o),
                   "--arch", "gemma-7b", "--shape", "decode_32k", "--device", "cpu"])
    real = json.loads(first)
    # cached variants: gemma3-4b's record and variants are gemma-7b's files,
    # and tracing anything raises
    for n in (2, 3):
        (v / f"gemma3-4b__decode_32k__L{n}.json").write_text(
            (v / f"gemma-7b__decode_32k__L{n}.json").read_text())
    (d / "gemma3-4b__decode_32k__sp.json").write_text(json.dumps(dict(real, arch="gemma3-4b")))
    # a failed variant (granite-34b) and a skipped record (gemma-7b x long_500k)
    (d / "granite-34b__decode_32k__sp.json").write_text(json.dumps(dict(real, arch="granite-34b")))
    (v / "granite-34b__decode_32k__L2.json").write_text(json.dumps(
        {"status": "error", "error": "RuntimeError: a variant that failed"}))
    (v / "granite-34b__decode_32k__L3.json").write_text(
        (v / "gemma-7b__decode_32k__L3.json").read_text())
    (d / "gemma-7b__long_500k__sp.json").write_text(json.dumps(
        dryrun.dryrun_cell("gemma-7b", "long_500k")))

    def refuse(*a, **k):
        raise AssertionError("a cached variant was traced again")
    roofline.variant_record = refuse
    t0 = time.time()
    for arch in ("gemma3-4b", "granite-34b", "internlm2-20b", "gemma-7b"):
        for shape in ("decode_32k", "long_500k"):
            roofline.main(["--dryrun-dir", str(d), "--variants-dir", str(v), "--out", str(o),
                           "--arch", arch, "--shape", shape, "--device", "cpu"])
    out["cached_seconds"] = time.time() - t0
    out["files"] = sorted(p.name for p in o.glob("*.json"))
    return out


def run_pair(which: str, tmp: Path, timeout_s: float = 300.0) -> tuple[dict, dict, dict]:
    """Both sides' subprocesses, started together: (reference records,
    port results, seconds of each)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    env["JAX_PLATFORMS"] = "cpu"
    paths = {side: tmp / f"{side}.json" for side in ("jax", "torch")}
    t0 = time.time()
    procs = {side: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), side, which, str(p)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for side, p in paths.items()}
    seconds, logs = {}, {}
    for side, proc in procs.items():
        logs[side] = proc.communicate(timeout=timeout_s)[0]
        seconds[side] = time.time() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{side} side of {which} failed:\n{logs[side][-4000:]}")
    return (json.loads(paths["jax"].read_text()), json.loads(paths["torch"].read_text()),
            seconds)


if __name__ == "__main__":          # side which out_path
    (run_jax if sys.argv[1] == "jax" else run_torch)(sys.argv[2], sys.argv[3])

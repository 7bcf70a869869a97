"""Roofline analysis from the dry run: the counterpart of
``src/repro/launch/roofline.py``.

The reference compiles two cost variants of every (arch, shape) cell with
layers unrolled at n0 / n1 layers and extrapolates linearly to the full
depth, because a compiled ``while`` body is counted once whatever its trip
count:

    X_total = X(n1) + (L - n1) * (X(n1) - X(n0))

The recurrent families' per-token scans (RWKV WKV / Mamba-style SSM) and
the MoE expert FFNs inside the dispatch are added analytically.  The terms
are per chip:

    compute    = flops / peak_bf16
    memory     = bytes / hbm_bw
    collective = sum(collective operand bytes) / (links * link_bw)

This module holds the plain functions of that method: ``model_flops``
(6·N·D train, 2·N·D forward), the analytic FLOP and byte corrections,
``extrapolate``, ``roofline_terms`` and ``analyze_cell``, on plain dict
records with the reference's keys.  ``variant_record`` traces a cost
variant through ``launch/dryrun.py``'s ``dryrun_cell`` (its records leave
the routed experts' FLOPs and skip the recurrent loops, so the analytic
terms count each FLOP once), and ``main`` sweeps the registry over the
dry run's records.  The port's trace counts every layer, so for a uniform
stack the extrapolation from its variants is exact.  The chip is an
argument: by default ``hardware.chip_for(device)``, the card's constants
on a CUDA device.

``variant_record`` (so ``main``) needs the dry run's fake 512-rank world
and starts it itself, so it owns its process; importing this module starts
nothing::

    PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun-dir results/dryrun \
        [--arch gemma-7b --shape decode_32k] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch import hardware
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models.config import active_param_count

# ---------------------------------------------------------------------------
# Analytic FLOP and byte counts (see module docstring)
# ---------------------------------------------------------------------------


def moe_flops_per_device(cfg, shape, n_devices: int) -> float:
    """Expert FFN FLOPs inside the MoE dispatch.  Capacity-based: per
    device, slots = (T/n_dev)*k*cf across E experts, each a (slots, D)x(D,
    F/tp) pair of matmuls (3 with gating), fwd x1 / train x4 (bwd 2x +
    remat)."""
    if cfg.moe is None:
        return 0.0
    m = cfg.moe
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.seq_len * shape.global_batch
    mult = 4.0 if shape.kind == "train" else 1.0
    mats = 3 if cfg.gated_mlp else 2
    slots_per_dev = (tokens / n_devices) * m.top_k * m.capacity_factor
    per_layer = 2.0 * mats * slots_per_dev * cfg.d_model * m.d_expert
    n_moe_layers = cfg.n_layers - m.first_k_dense
    return mult * per_layer * n_moe_layers


def recurrent_flops_per_device(cfg, shape, n_devices: int) -> float:
    """RWKV WKV / SSM scan FLOPs, linear in the tokens."""
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        mult = 4.0           # fwd + bwd(2x) + remat recompute(1x)
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        mult = 1.0
    else:
        tokens = shape.global_batch           # one token per sequence
        mult = 1.0
    total = 0.0
    if cfg.family == "ssm" and cfg.rwkv is not None:
        hd = cfg.rwkv.head_dim
        H = cfg.d_model // hd
        per_tok_layer = H * 8 * hd * hd       # kv outer + r·S + decay update
        total = cfg.n_layers * tokens * per_tok_layer
    if cfg.family == "hybrid" and cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        per_tok_layer = d_in * 8 * cfg.ssm.state_dim
        total = cfg.n_layers * tokens * per_tok_layer
    return mult * total / n_devices


def attention_score_bytes_per_device(cfg, shape, n_devices: int) -> float:
    """Memory traffic of materialized (Sq, Skv) float32 attention scores in
    dense attention: ~4 passes fwd+bwd per layer (2 forward only).  The
    flash kernel keeps these tiles on chip; subtracting them gives the
    flash-adjusted memory term."""
    if cfg.attn is None or shape.kind == "decode":
        return 0.0
    a = cfg.attn
    S = shape.seq_len
    B = shape.global_batch
    passes = 4.0 if shape.kind == "train" else 2.0
    per_layer = B * a.n_heads * S * S * 4.0 * passes
    return cfg.n_layers * per_layer / n_devices


def model_flops(cfg, shape, n_devices: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (fwd-only), N = active params."""
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        per_tok = 6 * n_active
    elif shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        per_tok = 2 * n_active
    else:
        tokens = shape.global_batch
        per_tok = 2 * n_active
    return per_tok * tokens / n_devices


# ---------------------------------------------------------------------------
# Cost variants
# ---------------------------------------------------------------------------

VARIANT_OVERRIDES = dict(
    scan_layers=False,
    dense_attn_threshold=1 << 30,
    remat=True,
)


def variant_record(arch: str, shape_name: str, n_layers: int,
                   multi_pod: bool = False) -> dict:
    """Trace a cost variant in ``dryrun.init_world()``'s world, which it
    starts where the process has no default group."""
    from repro_torch.launch import dryrun
    dryrun.init_world()
    cfg = get_config(arch)
    over = dict(n_layers=n_layers)
    if cfg.encdec:
        over["n_encoder_layers"] = n_layers
    if cfg.moe is not None and cfg.moe.first_k_dense:
        over["moe"] = dataclasses.replace(cfg.moe, first_k_dense=1)
    cfg2 = cfg.with_runtime(**over)
    shape = SHAPES[shape_name]
    rt = dict(VARIANT_OVERRIDES)
    rt["ce_chunk"] = shape.seq_len + 1            # single CE map iteration
    return dryrun.dryrun_cell(arch, shape_name, multi_pod=multi_pod,
                              cfg_override=cfg2, runtime_overrides=rt)


# ---------------------------------------------------------------------------
# Extrapolation and the roofline terms
# ---------------------------------------------------------------------------


def extrapolate(rec0: dict, rec1: dict, n0: int, n1: int, L: int) -> dict:
    """Two cost-variant records at n0 and n1 layers, extrapolated linearly
    to L layers (collective bytes per op, clamped at 0)."""
    def lin(key):
        x0, x1 = rec0[key], rec1[key]
        return x1 + (L - n1) * ((x1 - x0) / (n1 - n0))

    out = {"flops": lin("flops"), "hlo_bytes": lin("hlo_bytes")}
    c0 = rec0["collective"]["bytes_by_op"]
    c1 = rec1["collective"]["bytes_by_op"]
    coll = {}
    for op in set(c0) | set(c1):
        a, b = c0.get(op, 0.0), c1.get(op, 0.0)
        coll[op] = max(b + (L - n1) * ((b - a) / (n1 - n0)), 0.0)
    out["collective_bytes_by_op"] = coll
    out["collective_bytes"] = sum(coll.values())
    return out


def roofline_terms(flops: float, bytes_: float, coll_bytes: float,
                   chip: "hardware.Chip | None" = None,
                   device: torch.device | str = "cuda") -> dict:
    """Seconds of each term on ``chip`` (default: ``chip_for(device)``)."""
    c = chip if chip is not None else hardware.chip_for(device)
    return {
        "compute_s": flops / c.peak_bf16_flops,
        "memory_s": bytes_ / c.hbm_bandwidth,
        "collective_s": coll_bytes / (c.ici_links * c.ici_link_bandwidth),
    }


def analyze_cell(arch: str, shape_name: str, real_rec: dict,
                 rec0: dict, rec1: dict, n0: int = 2, n1: int = 3,
                 chip: "hardware.Chip | None" = None,
                 device: torch.device | str = "cuda") -> dict:
    """One cell's roofline from its production dry-run record ``real_rec``
    (``n_devices``, ``mesh``, ``memory.peak_bytes``, ``params``,
    ``active_params``) and two cost-variant records at n0 / n1 layers."""
    c = chip if chip is not None else hardware.chip_for(device)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    L = cfg.n_layers
    n_dev = real_rec["n_devices"]
    ext = extrapolate(rec0, rec1, n0, n1, L)
    rec_flops = recurrent_flops_per_device(cfg, shape, n_dev)
    rec_flops += moe_flops_per_device(cfg, shape, n_dev)
    flops = ext["flops"] + rec_flops
    terms = roofline_terms(flops, ext["hlo_bytes"], ext["collective_bytes"], c)
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, n_dev)
    score_bytes = attention_score_bytes_per_device(cfg, shape, n_dev)
    mem_flash = max(ext["hlo_bytes"] - score_bytes, 0.0)
    peak_term = terms["compute_s"]
    return {
        "arch": arch, "shape": shape_name, "mesh": real_rec["mesh"],
        "n_devices": n_dev,
        "flops_per_device": flops,
        "bytes_per_device": ext["hlo_bytes"],
        "collective_bytes_per_device": ext["collective_bytes"],
        "collective_by_op": ext["collective_bytes_by_op"],
        "recurrent_flops_per_device": rec_flops,
        **terms,
        # the flash kernel keeps scores on chip: the memory term without
        # materialized score traffic
        "memory_flash_s": mem_flash / c.hbm_bandwidth,
        "attention_score_bytes": score_bytes,
        "dominant": dominant.replace("_s", ""),
        "model_flops_per_device": mf,
        "useful_flops_ratio": mf / max(flops, 1.0),
        # perfect overlap bound: step >= max(term); roofline fraction =
        # compute term / max-term (1.0 when compute-bound with full overlap)
        "roofline_fraction": peak_term / max(max(terms.values()), 1e-12),
        "memory_peak_gib": real_rec["memory"]["peak_bytes"] / 2**30,
        "params": real_rec["params"],
        "active_params": real_rec["active_params"],
    }


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="results/dryrun")
    ap.add_argument("--variants-dir", default="results/roofline_variants")
    ap.add_argument("--out", default="results/roofline")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the chip of the roofline terms (chip_for)")
    args = ap.parse_args(argv)
    chip = hardware.chip_for(args.device)

    vdir = Path(args.variants_dir)
    vdir.mkdir(parents=True, exist_ok=True)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = []
    for arch in ([args.arch] if args.arch else ARCH_IDS):
        for shape in ([args.shape] if args.shape else SHAPES):
            cells.append((arch, shape))

    for arch, shape in cells:
        real_path = Path(args.dryrun_dir) / f"{arch}__{shape}__sp.json"
        out_path = outdir / f"{arch}__{shape}.json"
        if out_path.exists():
            continue
        if not real_path.exists():
            continue
        real = json.loads(real_path.read_text())
        if real["status"] != "ok":
            out_path.write_text(json.dumps(real, indent=2))
            continue
        recs = {}
        fail = None
        for n in (2, 3):
            vpath = vdir / f"{arch}__{shape}__L{n}.json"
            if vpath.exists():
                recs[n] = json.loads(vpath.read_text())
            else:
                recs[n] = variant_record(arch, shape, n)
                vpath.write_text(json.dumps(recs[n], indent=2))
            if recs[n]["status"] != "ok":
                fail = recs[n]
        if fail is not None:
            out_path.write_text(json.dumps(
                {"arch": arch, "shape": shape, "status": "variant_error",
                 "error": fail.get("error")}, indent=2))
            print(f"[roofline] {arch} x {shape}: VARIANT FAIL")
            continue
        cell = analyze_cell(arch, shape, real, recs[2], recs[3], chip=chip)
        out_path.write_text(json.dumps(cell, indent=2))
        print(f"[roofline] {arch} x {shape}: dominant={cell['dominant']} "
              f"compute={cell['compute_s']*1e3:.1f}ms "
              f"memory={cell['memory_s']*1e3:.1f}ms "
              f"coll={cell['collective_s']*1e3:.1f}ms "
              f"useful={cell['useful_flops_ratio']:.2f}")


if __name__ == "__main__":
    main()

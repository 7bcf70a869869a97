"""The dry-run and roofline tables from ``results/``: the counterpart of
``src/repro/launch/report.py``.  Fed the same record files, its three
functions return the reference's strings, byte for byte::

    PYTHONPATH=src python -m repro_torch.launch.report
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES

#: the tables' row order: the reference's registry order, which the port's
#: registry (the same ids) does not keep
ARCH_IDS = ("olmoe-1b-7b", "deepseek-moe-16b", "seamless-m4t-large-v2", "gemma-7b",
            "gemma3-4b", "internlm2-20b", "granite-34b", "hymba-1.5b", "qwen2-vl-2b",
            "rwkv6-1.6b")
if set(ARCH_IDS) != set(registry.ARCH_IDS):
    raise ImportError(f"report.ARCH_IDS {sorted(ARCH_IDS)} is not the registry's "
                      f"{sorted(registry.ARCH_IDS)}")


def _load(path: Path) -> dict | None:
    return json.loads(path.read_text()) if path.exists() else None


def dryrun_table(dryrun_dir="results/dryrun") -> str:
    d = Path(dryrun_dir)
    lines = [
        "| arch | shape | 16x16: status / peak GiB / compile s | 2x16x16: status / peak GiB |",
        "|------|-------|----------------------------------|---------------------------|",
    ]
    n_ok_sp = n_ok_mp = n_skip = 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            sp = _load(d / f"{arch}__{shape}__sp.json")
            mp = _load(d / f"{arch}__{shape}__mp.json")

            def fmt(r, with_compile=False):
                if r is None:
                    return "—"
                if r["status"] == "skipped":
                    return "skip (sub-quadratic rule)"
                if r["status"] != "ok":
                    return f"ERROR {r.get('error','')[:40]}"
                peak = r["memory"]["peak_bytes"] / 2**30
                s = f"ok / {peak:.1f}"
                if with_compile:
                    s += f" / {r.get('compile_s', 0):.0f}s"
                return s

            if sp and sp["status"] == "ok":
                n_ok_sp += 1
            if sp and sp["status"] == "skipped":
                n_skip += 1
            if mp and mp["status"] == "ok":
                n_ok_mp += 1
            lines.append(f"| {arch} | {shape} | {fmt(sp, True)} | {fmt(mp)} |")
    lines.append("")
    lines.append(f"Single-pod: **{n_ok_sp} ok**, {n_skip} documented skips; "
                 f"multi-pod: **{n_ok_mp} ok**.")
    return "\n".join(lines)


def roofline_table(roofline_dir="results/roofline") -> str:
    d = Path(roofline_dir)
    lines = [
        "| arch | shape | compute ms | memory ms | collective ms | dominant | useful FLOP ratio | roofline frac | peak GiB |",
        "|------|-------|-----------|-----------|---------------|----------|-------------------|---------------|----------|",
    ]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            r = _load(d / f"{arch}__{shape}.json")
            if r is None:
                continue
            if "compute_s" not in r:
                reason = r.get("reason", r.get("error", r.get("status", "")))
                lines.append(f"| {arch} | {shape} | — | — | — | skip | — | — | — |")
                continue
            lines.append(
                f"| {arch} | {shape} | {r['compute_s']*1e3:.1f} | "
                f"{r['memory_s']*1e3:.1f} | {r['collective_s']*1e3:.2f} | "
                f"{r['dominant']} | {r['useful_flops_ratio']:.2f} | "
                f"{r['roofline_fraction']:.2f} | {r['memory_peak_gib']:.1f} |")
    return "\n".join(lines)


def collective_detail(roofline_dir="results/roofline", top=6) -> str:
    d = Path(roofline_dir)
    rows = []
    for f in sorted(d.glob("*.json")):
        r = _load(f)
        if r and "collective_s" in r:
            rows.append((r["collective_s"], r))
    rows.sort(reverse=True, key=lambda t: t[0])
    lines = ["Most collective-bound cells (per-device bytes by op):", ""]
    for _, r in rows[:top]:
        ops = {k: f"{v/2**30:.2f}GiB" for k, v in r["collective_by_op"].items()
               if v > 2**20}
        lines.append(f"* {r['arch']} × {r['shape']}: {ops}")
    return "\n".join(lines)


if __name__ == "__main__":
    print("## Dry-run\n")
    print(dryrun_table())
    print("\n## Roofline\n")
    print(roofline_table())
    print()
    print(collective_detail())

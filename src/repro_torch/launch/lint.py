"""Mozart lint CLI: run the annotation verifier over the whole repo.

The counterpart of ``src/repro/launch/lint.py``::

    PYTHONPATH=src python -m repro_torch.launch.lint [-v] [--json out.json]
    PYTHONPATH=src python -m repro_torch.launch.lint --device cpu
    PYTHONPATH=src python -m repro_torch.launch.lint --rewrite-report

Three sweeps, all through ``repro_torch.core.analysis``:

* **contract**: every shipped split type against the MZ1xx laws, every
  integration's annotated ops against the SA condition (MZ108), plus the
  plan-cache guard audit (MZ205);
* **examples**: representative pipelines (the shapes of the reference's
  examples/: numpy chain, image chain, table chain, NLP chain) traced and
  run through the dataflow analyzer (MZ2xx) on stream-capable and
  chunk-loop executors;
* **configs**: every architecture in ``configs/registry.py`` must
  construct in both full and smoke flavors (MZ110).

The sweeps run on the card unless ``--device`` names another device (the
probes, the example tensors and the throwaway contexts all live there).
Exit status is nonzero iff any MZ *error* was found: warnings and info
notes never gate.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

import numpy as np
import torch

from repro_torch.core import analysis


def _example_pipelines(device: torch.device | str = "cuda"
                       ) -> list[tuple[str, Any, tuple, dict]]:
    """(name, fn, args, config) cells, the reference's: the same ops, the
    same stage shapes, n = 64, with every tensor and context on ``device``."""
    from repro_torch.core import annotated_image as img
    from repro_torch.core import annotated_nlp as nlp
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import annotated_table as tbl

    n = 64
    f32 = dict(dtype=torch.float32, device=device)
    x = torch.linspace(0.1, 0.9, n, **f32)
    y = torch.linspace(0.2, 1.1, n, **f32)

    def numpy_chain(x, y):                   # examples/quickstart.py shape
        a = anp.exp(x)
        b = anp.add(a, y)
        c = anp.multiply(b, 0.5)
        return anp.sum(c)

    im = torch.arange(n * 8 * 3, **f32).reshape(n, 8, 3) / float(n * 8 * 3)

    def image_chain(im):                     # examples/image_pipeline.py shape
        a = img.colortone(im, (0.2, 0.3, 0.5), 0.5, True)
        b = img.gamma(a, 2.2)
        return img.contrast(b, 1.4)

    t = tbl.Table({"k": torch.from_numpy((np.arange(n) % 5).astype(np.int32)).to(device),
                   "v": torch.linspace(0.5, 2.0, n, **f32)})
    keep = torch.from_numpy(np.arange(n) % 2 == 0).to(device)

    def table_chain(t):
        t2 = tbl.with_column(t, "v2", torch.linspace(1.0, 3.0, n, **f32))
        f = tbl.filter_rows(t2, keep)
        return tbl.groupby_agg(f, "k", "v", "sum")

    corpus = nlp.make_corpus(n, max_len=16, vocab=50, seed=0, device=device)
    r = np.random.RandomState(1)
    emb = torch.from_numpy(r.standard_normal((50, 8)).astype(np.float32)).to(device)
    head = torch.from_numpy(r.standard_normal((8, 5)).astype(np.float32)).to(device)

    def nlp_chain(corpus):
        c = nlp.normalize_case(corpus, 50)
        tags = nlp.pos_tag(c, emb, head)
        return anp.sum(tags), nlp.token_counts(c)

    on = {"device": device}
    cells = []
    for executor in ("fused", "scan"):
        cells.append((f"numpy_chain/{executor}", numpy_chain, (x, y),
                      {"executor": executor, **on}))
    cells.append(("image_chain/fused", image_chain, (im,),
                  {"executor": "fused", **on}))
    cells.append(("table_chain/fused", table_chain, (t,),
                  {"executor": "fused", **on}))
    cells.append(("nlp_chain/fused", nlp_chain, (corpus,),
                  {"executor": "fused", **on}))
    cells.append(("numpy_chain/eager-nopipe", numpy_chain, (x, y),
                  {"executor": "eager", "pipeline": False, **on}))
    return cells


def _sweep(check, device) -> analysis.Report:
    """``check(fn, *args, **config)`` over every example cell, subjects
    prefixed with the cell's name."""
    rep = analysis.Report()
    for name, fn, args, config in _example_pipelines(device):
        sub = check(fn, *args, **config)
        for d in sub.diagnostics:
            rep.diagnostics.append(analysis.Diagnostic(
                d.code, d.severity, f"{name}: {d.subject}", d.message,
                d.where))
        rep.checked += 1
    return rep


def check_examples(device: torch.device | str = "cuda") -> analysis.Report:
    """The dataflow analyzer (MZ2xx, and the rewrite pass's MZ5xx notes)
    over every example cell."""
    return _sweep(analysis.verify_pipeline, device)


def rewrite_report(device: torch.device | str = "cuda") -> analysis.Report:
    """Dry-run the static rewrite pass over every example pipeline and
    report the MZ5xx rewrites that WOULD apply (with cost-model deltas): no
    execution, no plan-cache mutation (``--rewrite-report``)."""
    return _sweep(analysis.rewrite_report, device)


def check_configs() -> analysis.Report:
    """MZ110: every registered architecture constructs, full and smoke."""
    from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config

    rep = analysis.Report()
    for aid in ARCH_IDS:
        rep.checked += 1
        for flavor, getter in (("config", get_config),
                               ("smoke_config", get_smoke_config)):
            try:
                getter(aid)
            except Exception as e:  # noqa: BLE001 - the raise is the finding
                rep.diagnostics.append(analysis.Diagnostic(
                    "MZ110", "error", f"configs.{aid}",
                    f"{flavor}() raised {type(e).__name__}: {e}"))
    return rep


def _write_json(rep: analysis.Report, path: str | None) -> None:
    if path:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(rep.to_json(), f, indent=2)
        print(f"wrote {path}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.lint",
        description="Mozart annotation verifier (zero-MZ-error gate)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="show info-severity notes too")
    ap.add_argument("--json", metavar="PATH",
                    help="also dump the structured report as JSON")
    ap.add_argument("--skip-contract", action="store_true",
                    help="skip the split-type/annotated-op law sweep")
    ap.add_argument("--skip-examples", action="store_true",
                    help="skip the example-pipeline dataflow sweep")
    ap.add_argument("--skip-configs", action="store_true",
                    help="skip the architecture-config construction sweep")
    ap.add_argument("--plan-cache", metavar="PATH", default=None,
                    help="persisted plan-cache file to audit (MZ205)")
    ap.add_argument("--rewrite-report", action="store_true",
                    help="dry-run only the static graph rewrite pass over "
                         "the example pipelines and print the MZ5xx "
                         "rewrites it would apply (no plan-cache mutation)")
    ap.add_argument("--device", default="cuda",
                    help="device the probes, example tensors and contexts "
                         "live on (default: the card; 'cpu' runs without one)")
    args = ap.parse_args(argv)

    rep = analysis.Report()
    if args.rewrite_report:
        print("== rewrite report: static graph rewrite dry-run (MZ5xx) ==")
        rep.extend(rewrite_report(args.device))
        # MZ5xx notes are info severity: always shown, they ARE the output.
        print(rep.render(verbose=True))
        _write_json(rep, args.json)
        return 0 if rep.ok else 1
    if not args.skip_contract:
        print("== contract: split-type laws + SA condition ==")
        rep.extend(analysis.check_split_types(device=args.device))
        rep.extend(analysis.check_annotated_ops(device=args.device))
        rep.extend(analysis.check_plan_cache(args.plan_cache))
    if not args.skip_examples:
        print("== examples: pipeline dataflow analysis ==")
        rep.extend(check_examples(args.device))
    if not args.skip_configs:
        print("== configs: registry construction ==")
        rep.extend(check_configs())

    print(rep.render(verbose=args.verbose))
    _write_json(rep, args.json)
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())

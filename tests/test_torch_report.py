"""``launch/report.py`` against the reference's, and ``roofline.main``.

Both packages' ``dryrun_table``, ``roofline_table`` and ``collective_detail``
read one directory of records and must return the same strings: the
reference's own smoke records (``dryrun_scenarios.py``'s subprocess), the
port's, a skipped and a failed record, and roofline records from
``roofline.main`` (a traced cell, cached variants, a variant that failed, a
skipped cell) beside ``analyze_cell`` records large enough for
``collective_detail`` to list their ops.  ``roofline.main`` and
``dryrun.main`` ran in the port's subprocess on smoke configs over a
temporary directory: a record already written is kept, a cell without a
record writes nothing, cached variants are read and not traced again, a
failed variant gives ``variant_error``, and the traced cell's output is
``analyze_cell`` of its record and variants on the host's constants.
"""

import json
import shutil

import numpy as np
import pytest

import dryrun_scenarios as DS
from repro.configs.registry import ARCH_IDS
from repro.launch import report as jreport
from repro_torch import hardware
from repro_torch.configs import registry as tregistry
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun, report, roofline


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("report")
    ref, port, _ = DS.run_pair("report", tmp)
    return tmp, ref, port


def _synthetic(arch: str, shape: str, seed: int) -> dict:
    """An ``analyze_cell`` record of large made-up counts."""
    r = np.random.RandomState(seed)
    ops = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")

    def variant(n):
        return {"status": "ok", "flops": float(r.uniform(1e12, 1e15)) * n,
                "hlo_bytes": float(r.uniform(1e9, 1e12)) * n,
                "collective": {"bytes_by_op": {op: float(r.uniform(1e5, 1e10)) * n
                                               for op in ops}}}
    real = {"status": "ok", "n_devices": 256, "mesh": "16x16",
            "memory": {"peak_bytes": int(r.uniform(1e9, 9e10))},
            "params": int(r.uniform(1e9, 3e10)), "active_params": int(r.uniform(1e9, 3e10))}
    return roofline.analyze_cell(arch, shape, real, variant(2), variant(3), chip=hardware.H100)


@pytest.fixture(scope="module")
def dirs(run, tmp_path_factory):
    tmp, ref, port = run
    d = tmp_path_factory.mktemp("records")
    for tag, rec in ref.items():
        (d / f"{tag}.json").write_text(json.dumps(rec))
    (d / "olmoe-1b-7b__decode_32k__sp.json").write_text(
        json.dumps(port["cells"][DS.tag("olmoe-1b-7b", "decode_32k", False)]["record"]))
    (d / "olmoe-1b-7b__decode_32k__mp.json").write_text(
        json.dumps(port["cells"][DS.tag("gemma-7b", "decode_32k", True)]["record"]))
    (d / "gemma-7b__long_500k__sp.json").write_text(json.dumps(
        dryrun.dryrun_cell("gemma-7b", "long_500k", cfg_override=get_smoke_config("gemma-7b"))))
    (d / "hymba-1.5b__train_4k__sp.json").write_text(json.dumps(
        {"arch": "hymba-1.5b", "shape": "train_4k", "mesh": "16x16", "status": "error",
         "error": "RuntimeError: a cell that failed to trace, with a long message"}))
    o = tmp_path_factory.mktemp("roofline")
    for f in (tmp / "roofline").glob("*.json"):
        shutil.copy(f, o / f.name)
    for i, (arch, shape) in enumerate((("internlm2-20b", "train_4k"),
                                       ("olmoe-1b-7b", "prefill_32k"),
                                       ("rwkv6-1.6b", "long_500k"))):
        (o / f"{arch}__{shape}.json").write_text(json.dumps(_synthetic(arch, shape, i)))
    return d, o


def test_dryrun_table_equals_the_reference(dirs):
    d, _ = dirs
    got = report.dryrun_table(d)
    assert got == jreport.dryrun_table(d)
    assert "ERROR RuntimeError" in got and "skip (sub-quadratic rule)" in got


def test_roofline_table_equals_the_reference(dirs):
    _, o = dirs
    got = report.roofline_table(o)
    assert got == jreport.roofline_table(o)
    assert "| gemma-7b | long_500k | — |" in got


def test_collective_detail_equals_the_reference(dirs):
    _, o = dirs
    for top in (2, 6):
        got = report.collective_detail(o, top=top)
        assert got == jreport.collective_detail(o, top=top)
    assert "GiB" in report.collective_detail(o)


def test_row_order_is_the_reference_registry_s():
    assert report.ARCH_IDS == ARCH_IDS
    assert set(report.ARCH_IDS) == set(tregistry.ARCH_IDS)


def test_dryrun_main_keeps_a_written_record(run):
    assert run[2]["main"]["cached_record_kept"]


def test_roofline_main_writes_each_path(run):
    tmp, _, port = run
    o = tmp / "roofline"
    assert port["main"]["files"] == ["gemma-7b__decode_32k.json", "gemma-7b__long_500k.json",
                                     "gemma3-4b__decode_32k.json",
                                     "granite-34b__decode_32k.json"]
    assert not (o / "internlm2-20b__decode_32k.json").exists()    # no record: nothing
    failed = json.loads((o / "granite-34b__decode_32k.json").read_text())
    assert failed == {"arch": "granite-34b", "shape": "decode_32k", "status": "variant_error",
                      "error": "RuntimeError: a variant that failed"}
    skipped = json.loads((o / "gemma-7b__long_500k.json").read_text())
    assert skipped["status"] == "skipped"


def test_roofline_main_analyzes_a_traced_cell(run, monkeypatch):
    tmp, _, _ = run
    monkeypatch.setattr(roofline, "get_config", get_smoke_config)
    real = json.loads((tmp / "dryrun" / "gemma-7b__decode_32k__sp.json").read_text())
    v = {n: json.loads((tmp / "variants" / f"gemma-7b__decode_32k__L{n}.json").read_text())
         for n in (2, 3)}
    assert real["status"] == v[2]["status"] == v[3]["status"] == "ok"
    assert v[3]["flops"] > v[2]["flops"]
    for name in ("gemma-7b", "gemma3-4b"):        # traced, then from cached variants
        got = json.loads((tmp / "roofline" / f"{name}__decode_32k.json").read_text())
        want = json.loads(json.dumps(roofline.analyze_cell(
            name, "decode_32k", dict(real, arch=name), v[2], v[3], chip=hardware.CPU_HOST)))
        assert set(got) == set(want)
        for k, x in want.items():
            if isinstance(x, float):
                assert got[k] == pytest.approx(x, rel=1e-12, abs=0.0), (name, k)
            elif isinstance(x, dict):
                assert got[k] == pytest.approx(x, rel=1e-12, abs=0.0), (name, k)
            else:
                assert got[k] == x, (name, k)

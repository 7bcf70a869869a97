"""The port's lint CLI (``repro_torch.launch.lint``) against the JAX
package's (``src/repro/launch/lint.py``), on the CPU.

Each sweep is compared with the reference's by (code, severity, subject),
node ids renumbered by first appearance (both packages number nodes their
own way), and by ``checked``: the example pipelines' dataflow analysis, the
rewrite pass's dry run, and the registry's construction (MZ110, also with a
broken config planted in both registries).  ``main`` with ``--device cpu``
exits 0 in its full and ``--rewrite-report`` forms, as
``tests/test_rewrite.py::test_lint_*``, and writes the same JSON report.
The verifier reaches no Pallas kernel, so nothing runs in interpret mode.
"""

import collections
import json
import re

import pytest

from repro.configs import registry as jregistry
from repro.core import plan_cache as jpc
from repro.launch import lint as jlint
from repro_torch.configs import registry as tregistry
from repro_torch.core import plan_cache as tpc
from repro_torch.launch import lint

_NODE = re.compile(r"#(\d+)")


@pytest.fixture(autouse=True)
def _fresh_caches():
    tpc.clear()
    jpc.clear()
    yield
    tpc.clear()
    jpc.clear()


def _normalized(rep):
    """(code, severity, subject) multiset, node ids renumbered by first
    appearance within each cell."""
    out = collections.Counter()
    ids: dict[tuple, str] = {}
    for d in rep.diagnostics:
        cell = d.subject.split(":", 1)[0]

        def renumber(m, cell=cell):
            return "#" + ids.setdefault((cell, m.group(1)),
                                        str(sum(1 for k in ids if k[0] == cell)))
        out[(d.code, d.severity, _NODE.sub(renumber, d.subject))] += 1
    return out


def test_example_cells_are_the_references():
    port = [(name, cfg) for name, _fn, _args, cfg in lint._example_pipelines("cpu")]
    ref = [(name, cfg) for name, _fn, _args, cfg in jlint._example_pipelines()]
    assert [n for n, _ in port] == [n for n, _ in ref]
    assert [{k: v for k, v in c.items() if k != "device"} for _, c in port] == [c for _, c in ref]
    assert all(c["device"] == "cpu" for _, c in port)


@pytest.mark.parametrize("sweep", ("check_examples", "rewrite_report"))
def test_example_sweeps_equal_the_reference(sweep):
    port, ref = getattr(lint, sweep)("cpu"), getattr(jlint, sweep)()
    assert port.checked == ref.checked == 6
    assert _normalized(port) == _normalized(ref)
    assert port.ok and ref.ok


def test_rewrite_report_finds_the_references_declines():
    rep = lint.rewrite_report("cpu")
    codes = collections.Counter(d.code for d in rep.diagnostics)
    assert codes == collections.Counter(d.code for d in jlint.rewrite_report().diagnostics)
    assert set(codes) <= {"MZ501", "MZ502", "MZ503", "MZ504", "MZ505"}
    assert all(d.severity == "info" for d in rep.diagnostics)


def test_check_configs_equal_the_reference():
    port, ref = lint.check_configs(), jlint.check_configs()
    assert port.checked == ref.checked == len(tregistry.ARCH_IDS) == len(jregistry.ARCH_IDS)
    assert port.diagnostics == [] and ref.diagnostics == []


def test_broken_config_yields_mz110_in_both(monkeypatch):
    def broken(arch_id):
        raise ValueError("d_model must be positive")
    for reg in (jregistry, tregistry):
        monkeypatch.setattr(reg, "get_smoke_config", broken)
    port, ref = lint.check_configs(), jlint.check_configs()
    assert _normalized(port) == _normalized(ref)
    assert {d.code for d in port.diagnostics} == {"MZ110"}
    assert len(port.diagnostics) == len(tregistry.ARCH_IDS)
    assert all(d.severity == "error" and "smoke_config() raised ValueError" in d.message
               for d in port.diagnostics)
    assert not port.ok


def test_main_exits_zero_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "lint.json"
    assert lint.main(["--device", "cpu", "--json", str(out)]) == 0
    jout = tmp_path / "jlint.json"
    assert jlint.main(["--json", str(jout)]) == 0
    text = capsys.readouterr().out
    assert "== contract" in text and "== examples" in text and "== configs" in text
    port, ref = json.loads(out.read_text()), json.loads(jout.read_text())
    assert port["checked"] == ref["checked"]
    assert port["ok"] and ref["ok"]
    assert (sorted((d["code"], d["severity"]) for d in port["diagnostics"])
            == sorted((d["code"], d["severity"]) for d in ref["diagnostics"]))


def test_main_rewrite_report_exits_zero_on_the_cpu(capsys):
    assert lint.main(["--rewrite-report", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rewrite report" in out and "MZ5" in out


def test_main_exits_nonzero_on_an_error(monkeypatch):
    def broken(arch_id):
        raise ValueError("broken")
    monkeypatch.setattr(tregistry, "get_config", broken)
    assert lint.main(["--device", "cpu", "--skip-contract", "--skip-examples"]) == 1
    assert lint.main(["--device", "cpu", "--skip-contract", "--skip-examples",
                      "--skip-configs"]) == 0

"""The port's verifier (``repro_torch.core.analysis``) against the JAX
package's (``src/repro/core/analysis.py``), on the CPU.

Case for case ``tests/test_analysis.py`` up to its sanitizer section (held
in ``tests/test_torch_sanitizer.py``), each held against the reference run in
the same process on the same numpy values: the law matrix over
``CONTRACT_LAWS`` x ``builtin_probes(device="cpu")`` (each probe's findings
equal to the reference's on its probe of the same name), the whole sweep
(``verify(n=12)``: the same ``checked`` and the same (code, severity,
subject) multiset; prose may differ), the five seeded mutants, the
SA-condition pair (MZ108), the dataflow analyzer's reports (node ids
renumbered by first appearance: both packages number nodes their own way),
``mozart.verify``'s dispatcher, the MZ205 plan-cache audits, and the
verifier's read-only use of the plan cache (the counterparts of
``tests/test_rewrite.py::test_verify_*``).  The verifier reaches no Pallas
kernel, so nothing runs in interpret mode.
"""

import collections
import json
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analysis as janalysis
from repro.core import annotated_numpy as janp
from repro.core import annotated_table as jtb
from repro.core import mozart as jmozart
from repro.core import plan_cache as jpc
from repro.core.annotation import annotate as jannotate
from repro.core import split_types as jst
from repro_torch.core import analysis
from repro_torch.core import annotated_numpy as anp
from repro_torch.core import annotated_table as tbl
from repro_torch.core import mozart, plan_cache, rewrite
from repro_torch.core import split_types as st
from repro_torch.core.annotation import annotate

from test_torch_table import same_values, to_np

PROBES = analysis.builtin_probes(device="cpu")
JPROBES = {p.name: p for p in janalysis.builtin_probes()}
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _fresh_caches():
    plan_cache.clear()
    jpc.clear()
    yield
    plan_cache.clear()
    jpc.clear()


def _error_codes(diags):
    return {d.code for d in diags if d.severity == "error"}


def _multiset(diags):
    return collections.Counter((d.code, d.severity, d.subject) for d in diags)


_NODE = re.compile(r"#(\d+)")


def _normalized(rep):
    """(code, severity, subject) per diagnostic in order, node ids renumbered
    by first appearance."""
    ids: dict[str, str] = {}

    def renumber(m):
        return "#" + ids.setdefault(m.group(1), str(len(ids)))

    return [(d.code, d.severity, _NODE.sub(renumber, d.subject)) for d in rep.diagnostics]


# ---------------------------------------------------------------------------
# The law matrix: every contract law against every shipped probe.
# ---------------------------------------------------------------------------


def test_probes_and_codes_are_the_references():
    assert [p.name for p in PROBES] == list(JPROBES)
    assert analysis.CODES == janalysis.CODES
    assert set(rewrite.REWRITE_CODES.values()) == {c for c in analysis.CODES if c.startswith("MZ5")}
    assert [(l.code, l.name) for l in analysis.CONTRACT_LAWS] == \
        [(l.code, l.name) for l in janalysis.CONTRACT_LAWS]
    for p in PROBES:
        # unknown-family params count instances; treedef reprs differ by package
        if not p.expect_unique and p.name != "PytreeSplit":
            assert p.split_type.params == JPROBES[p.name].split_type.params, p.name
        assert p.expect_unique == JPROBES[p.name].expect_unique
        leaves = [l for v in (p.value, p.pieces, p.reference) if v is not None
                  for l in torch.utils._pytree.tree_leaves(v)]
        assert all(l.device.type == "cpu" for l in leaves if isinstance(l, torch.Tensor))


@pytest.mark.parametrize("law", analysis.CONTRACT_LAWS, ids=lambda l: l.name)
@pytest.mark.parametrize("probe", PROBES, ids=lambda p: p.name)
def test_contract_law_holds(law, probe):
    diags = analysis.check_split_type(probe, laws=[law])
    errors = [d for d in diags if d.severity == "error"]
    assert not errors, "\n".join(str(d) for d in errors)
    jlaw = next(l for l in janalysis.CONTRACT_LAWS if l.name == law.name)
    jdiags = janalysis.check_split_type(JPROBES[probe.name], laws=[jlaw])
    assert _multiset(diags) == _multiset(jdiags)


def test_laws_cover_every_contract_code():
    """Each MZ1xx code is either a law or checked by a dedicated sweep
    (MZ108 = check_annotated_fn, MZ110 = the config-registry sweep)."""
    law_codes = {law.code for law in analysis.CONTRACT_LAWS}
    contract = {c for c in analysis.CODES if c.startswith("MZ1")}
    assert contract - law_codes == {"MZ108", "MZ110"}


def test_builtin_sweep_has_zero_errors():
    rep = analysis.check_split_types(probes=PROBES)
    assert rep.ok, "\n".join(str(d) for d in rep.errors)
    assert rep.checked == len(PROBES)


def test_annotated_ops_sweep_equals_the_reference():
    rep = analysis.check_annotated_ops(n=10, **CPU)
    assert rep.ok and not rep.warnings, rep.render()
    assert rep.checked > 40            # every integration contributes ops
    jrep = janalysis.check_annotated_ops(n=10)
    assert rep.checked == jrep.checked
    assert _multiset(rep.diagnostics) == _multiset(jrep.diagnostics)


def test_numpy_probe_examples_are_the_references():
    """``annotated_numpy.__probe_examples__``: the reference's ops and
    values, on the CPU (float32 within 2e-5: ``linspace`` rounds its own
    way in each package)."""
    texs, jexs = anp.__probe_examples__(device="cpu"), janp.__probe_examples__()
    assert set(texs) == set(jexs) == set(anp.__all_ops__)
    for name, jex in jexs.items():
        tex = texs[name]
        for tkw, jkw in zip(tex if isinstance(tex, list) else [tex],
                            jex if isinstance(jex, list) else [jex]):
            assert list(tkw) == list(jkw)
            for k in jkw:
                if isinstance(jkw[k], int):
                    assert tkw[k] == jkw[k]
                    continue
                got, want = tkw[k].numpy(), np.asarray(jkw[k])
                assert got.shape == want.shape and got.dtype == want.dtype, (name, k)
                np.testing.assert_allclose(got, want, rtol=2e-5, err_msg=f"{name}.{k}")


def test_verify_sweep_equals_the_reference():
    """``mozart.verify()`` at n = 12, plan caches empty: the reference's
    83 subjects and (code, severity, subject) multiset (two MZ107 info
    notes), no error and no warning."""
    rep = mozart.verify(n=12, **CPU)
    jrep = janalysis.verify(n=12)
    assert rep.checked == jrep.checked == 83
    assert _multiset(rep.diagnostics) == _multiset(jrep.diagnostics)
    assert rep.ok and not rep.warnings
    assert {(d.code, d.severity) for d in rep.diagnostics} == {("MZ107", "info")}


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for call in (analysis.builtin_probes, analysis.check_annotated_ops, analysis.verify,
                 lambda: analysis.verify(lambda x: anp.exp(x), torch.ones(4))):
        with pytest.raises(RuntimeError, match="torch.cuda is not available"):
            call()


# ---------------------------------------------------------------------------
# Seeded mutants: each broken SplitType must trip its law's MZ code.
# ---------------------------------------------------------------------------

_N = 8
_M = torch.arange(_N * 3, dtype=torch.float32).reshape(_N, 3) / (_N * 3)


def _array_probe(split_type, **kw):
    return analysis.Probe("mutant", split_type, value=_M,
                          extent_of=lambda v: int(v.shape[0]), **kw)


class _WrongAxisMerge(st.ArraySplit):
    """Splits rows apart but glues them back as columns."""

    def merge(self, chunks):
        return torch.cat(list(chunks), dim=1)


class _LossyRechunk(st.ArraySplit):
    """Re-grids correctly, then drops the first row of every chunk."""

    def rechunk(self, chunks, src, dst):
        new, copied = super().rechunk(chunks, src, dst)
        return [c[1:] for c in new], copied


class _OverconfidentHandoff(st.ArraySplit):
    """Grants handoff to any consumer grid, compatible or not."""

    def can_handoff(self, consumer):
        return True


class _LyingReduce(st.ReduceSplit):
    """Claims the declared combiner but always folds with addition."""

    def merge(self, chunks):
        out = chunks[0]
        for c in chunks[1:]:
            out = out + c
        return out


class _SilentEmptyMerge(st.ArraySplit):
    def merge(self, chunks):
        if not chunks:
            return torch.zeros((0, 3), dtype=torch.float32)
        return super().merge(chunks)


def test_mutant_wrong_merge_axis_trips_mz101():
    probe = _array_probe(_WrongAxisMerge((_N, 3), 0))
    assert "MZ101" in _error_codes(analysis.check_split_type(probe))


def test_mutant_lossy_rechunk_trips_mz106():
    probe = _array_probe(_LossyRechunk((_N, 3), 0))
    assert "MZ106" in _error_codes(analysis.check_split_type(probe))


def test_mutant_false_can_handoff_trips_mz105():
    probe = _array_probe(
        _OverconfidentHandoff((_N, 3), 0),
        consumers=(st.ArraySplit((_N, 3), 1),))
    assert "MZ105" in _error_codes(analysis.check_split_type(probe))


def test_mutant_wrong_reduce_combiner_trips_mz104():
    pieces = [torch.tensor([1.0, 5.0]), torch.tensor([4.0, 2.0])]
    probe = analysis.Probe("mutant", _LyingReduce("max"), pieces=pieces)
    assert "MZ104" in _error_codes(analysis.check_split_type(probe))


def test_mutant_silent_empty_merge_trips_mz109():
    probe = _array_probe(_SilentEmptyMerge((_N, 3), 0))
    diags = analysis.check_split_type(probe)
    assert any(d.code == "MZ109" and d.severity == "warning" for d in diags)


def test_sa_condition_catches_unchunkable_function():
    """cumsum annotated Along(0) is a lie: each chunk's prefix sums ignore
    the rows before it, so F(a) != merge(F(a1..ak)) -> MZ108, as in the
    reference."""
    bad = annotate(lambda x: torch.cumsum(x, 0), name="bad_cumsum",
                   x=st.Along(0), ret=st.Along(0))
    diags = analysis.check_annotated_fn(bad, {"x": torch.arange(12.0)})
    jbad = jannotate(lambda x: jnp.cumsum(x), name="bad_cumsum",
                     x=jst.Along(0), ret=jst.Along(0))
    jdiags = janalysis.check_annotated_fn(jbad, {"x": jnp.arange(12.0)})
    assert "MZ108" in _error_codes(diags)
    assert _multiset(diags) == _multiset(jdiags)


def test_sa_condition_accepts_chunkable_function():
    good = annotate(lambda x: torch.exp(x), name="good_exp",
                    x=st.Along(0), ret=st.Along(0))
    assert analysis.check_annotated_fn(good, {"x": torch.arange(12.0)}) == []


def test_sa_condition_runs_the_bare_function():
    """MZ108 calls ``call_raw``: a float64 argument reaches the function as
    given, where a lazy or eager call narrows it to float32 first."""
    seen = []

    def probe_fn(x):
        seen.append(x.dtype)
        return x * 2.0

    fn = annotate(probe_fn, name="probe_fn", x=st.Along(0), ret=st.Along(0))
    assert analysis.check_annotated_fn(fn, {"x": torch.arange(6.0, dtype=torch.float64)}) == []
    assert torch.float64 in seen
    assert fn.call_raw({"x": torch.ones(2, dtype=torch.float64)}).dtype == torch.float64
    assert fn(torch.ones(2, dtype=torch.float64)).dtype == torch.float32


# ---------------------------------------------------------------------------
# Regression: GroupSplit key/val must not shadow SplitType.key() (MZ107).
# ---------------------------------------------------------------------------


def test_group_split_params_do_not_shadow_identity():
    a = tbl.GroupSplit("sum", "k", "v")
    b = tbl.GroupSplit("sum", "k", "v")
    assert a == b and len({a, b}) == 1
    assert callable(a.key)             # still the identity method, not a str
    probe = analysis.Probe("GroupSplit/sum", a)
    assert analysis._law_params_round_trip(probe) == []
    jprobe = janalysis.Probe("GroupSplit/sum", jtb.GroupSplit("sum", "k", "v"))
    assert janalysis._law_params_round_trip(jprobe) == []


def test_group_probe_partials_are_the_references():
    """The ``GroupSplit/{op}`` probes' partials, from
    ``_group_reduce_partial`` as in the reference."""
    for op in ("sum", "count", "mean", "max", "min"):
        got = PROBES[[p.name for p in PROBES].index(f"GroupSplit/{op}")].pieces
        want = JPROBES[f"GroupSplit/{op}"].pieces
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            same_values(to_np(g), {k: np.asarray(v) for k, v in to_np(w).items()}, op)


# ---------------------------------------------------------------------------
# Dataflow analyzer (MZ2xx), each report held against the reference's
# ---------------------------------------------------------------------------


def _crafted(np_mod):
    def crafted(m, v):
        a = np_mod.exp(m)
        np_mod.log1p(a)                        # result dropped on the floor: dead
        nm = np_mod.normalize_axis(a, axis=0)  # output split on axis 1
        return np_mod.matvec(nm, v)            # consumer splits on axis 0
    return crafted


def test_dataflow_dead_stage_and_axis_mismatch():
    m = np.arange(48.0, dtype=np.float32).reshape(8, 6) / 48.0
    v = np.linspace(0.1, 1.0, 6, dtype=np.float32)
    rep = analysis.verify_pipeline(_crafted(anp), torch.from_numpy(m), torch.from_numpy(v),
                                   executor="eager", pipeline=False, **CPU)
    jrep = janalysis.verify_pipeline(_crafted(janp), jnp.asarray(m), jnp.asarray(v),
                                     executor="eager", pipeline=False)
    assert "MZ201" in rep.codes()
    mismatches = [d for d in rep.diagnostics
                  if d.code == "MZ203" and d.severity == "warning"]
    assert any("axis mismatch" in d.message for d in mismatches)
    assert _normalized(rep) == _normalized(jrep)
    assert rep.checked == jrep.checked


def test_dataflow_scalar_only_stage_is_whole_value():
    rep = analysis.verify_pipeline(
        lambda: anp.add(torch.tensor(1.0), torch.tensor(2.0)),
        executor="eager", pipeline=False, **CPU)
    jrep = janalysis.verify_pipeline(
        lambda: janp.add(jnp.float32(1.0), jnp.float32(2.0)),
        executor="eager", pipeline=False)
    assert "MZ204" in rep.codes()
    assert _normalized(rep) == _normalized(jrep)
    assert rep.checked == jrep.checked


def test_dataflow_clean_chain_has_no_errors():
    x = np.linspace(0.1, 0.9, 16, dtype=np.float32)

    def chain(np_mod):
        return lambda x: np_mod.sum(np_mod.multiply(np_mod.exp(x), 0.5))

    rep = analysis.verify_pipeline(chain(anp), torch.from_numpy(x), executor="fused", **CPU)
    jrep = janalysis.verify_pipeline(chain(janp), jnp.asarray(x), executor="fused")
    assert rep.ok, "\n".join(str(d) for d in rep.errors)
    assert _normalized(rep) == _normalized(jrep)
    assert rep.checked == jrep.checked


def test_verify_dispatcher():
    x = torch.linspace(0.1, 0.9, 16)
    rep = mozart.verify(lambda x: anp.sum(anp.exp(x)), x, executor="fused", **CPU)
    assert isinstance(rep, analysis.Report) and rep.ok
    with pytest.raises(TypeError):
        analysis.verify(42)
    from repro_torch.core import Diagnostic, Report, verify
    assert Report is analysis.Report and Diagnostic is analysis.Diagnostic
    assert verify is analysis.verify


# ---------------------------------------------------------------------------
# Plan-cache guard audit (MZ205)
# ---------------------------------------------------------------------------


def _ghost_report(pc, check):
    key = ("ghost-executor", "ghost-chip", "p", "m", "h")
    with pc._lock:
        pc._entries[key] = SimpleNamespace()
    try:
        return check()
    finally:
        with pc._lock:
            pc._entries.pop(key, None)


def test_plan_cache_unreplayable_live_entry():
    rep = _ghost_report(plan_cache, analysis.check_plan_cache)
    assert any(d.code == "MZ205" and d.severity == "error"
               and "ghost-executor" in d.subject for d in rep.diagnostics)
    assert any(d.code == "MZ205" and d.severity == "warning"
               and "chip guard" in d.message for d in rep.diagnostics)
    jrep = _ghost_report(jpc, janalysis.check_plan_cache)
    assert _multiset(rep.diagnostics) == _multiset(jrep.diagnostics)
    assert rep.checked == jrep.checked == 1


def test_plan_cache_live_entries_of_this_host_replay():
    """Entries a CPU session made carry the host's chip guard: no MZ205."""
    with mozart.session(executor="fused", **CPU):
        anp.exp(torch.ones(8)).value
    rep = analysis.check_plan_cache()
    assert rep.checked == plan_cache.cache_info()["entries"] == 1
    assert rep.diagnostics == []


def test_plan_cache_persisted_file_audit(tmp_path):
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"schema": 1, "chip": "x", "entries": []}))
    rep = analysis.check_plan_cache(str(stale))
    assert any(d.code == "MZ205" and d.severity == "error"
               and "schema" in d.message for d in rep.diagnostics)
    jrep = janalysis.check_plan_cache(str(stale))
    assert _multiset(rep.diagnostics) == _multiset(jrep.diagnostics)

    broken = tmp_path / "broken.json"
    broken.write_text('{"schema": 5, "entr')
    rep = analysis.check_plan_cache(str(broken))
    assert any(d.code == "MZ205" and "unreadable" in d.message
               for d in rep.diagnostics)
    jrep = janalysis.check_plan_cache(str(broken))
    assert _multiset(rep.diagnostics) == _multiset(jrep.diagnostics)


# ---------------------------------------------------------------------------
# The verifier and the plan cache (tests/test_rewrite.py::test_verify_*)
# ---------------------------------------------------------------------------


def _simple(np_mod):
    def f(x):
        np_mod.exp(x)                       # dead
        b1 = np_mod.exp(x)
        b2 = np_mod.exp(x)                  # CSE pair
        return np_mod.add(b1, b2)
    return f


def test_verify_reports_rewrites_without_mutating_cache():
    x = np.linspace(0.1, 1.0, 32, dtype=np.float32)
    rep = analysis.verify_pipeline(_simple(anp), torch.from_numpy(x), executor="fused", **CPU)
    codes = {d.code for d in rep.diagnostics}
    assert "MZ501" in codes and "MZ502" in codes    # the dry-run reports
    assert "MZ201" in codes                          # on the UNREWRITTEN plan
    assert plan_cache.cache_info()["entries"] == 0   # peek never writes
    jrep = janalysis.verify_pipeline(_simple(janp), jnp.asarray(x), executor="fused")
    assert _normalized(rep) == _normalized(jrep)
    rw = analysis.rewrite_report(_simple(anp), torch.from_numpy(x), executor="fused", **CPU)
    assert [d for d in _normalized(rw)] == [d for d in _normalized(rep) if d[0] >= "MZ5"]
    assert plan_cache.cache_info()["entries"] == 0


def _add_exp(np_mod):
    return lambda x: np_mod.add(np_mod.exp(x), 1.0)


def test_verify_reuses_recorded_handoff():
    """verify() reuses the handoff decisions the plan entry already
    carries (a read-only peek: no entry is created or promoted), as the
    reference does."""
    x = np.linspace(0.1, 1.0, 64, dtype=np.float32)
    counts = {}
    for name, mz, np_mod, pc, xs, cfg in (
            ("port", mozart, anp, plan_cache, torch.from_numpy(x), CPU),
            ("jax", jmozart, janp, jpc, jnp.asarray(x), {})):
        f = _add_exp(np_mod)
        verify = analysis.verify_pipeline if name == "port" else janalysis.verify_pipeline
        with mz.session(executor="fused", **cfg):
            np.asarray(f(xs).value)
            np.asarray(f(xs).value)
        entries_before = [e.uid for e in pc.entries()]
        base = pc.stats.get("verify_handoff_reused", 0)
        rep = verify(f, xs, executor="fused", **cfg)
        assert rep.ok
        counts[name] = pc.stats["verify_handoff_reused"] - base
        assert [e.uid for e in pc.entries()] == entries_before
    assert counts == {"port": 1, "jax": 1}

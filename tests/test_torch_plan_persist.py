"""The port's plan-cache persistence (schema v7), case for case the
reference's ``tests/test_plan_persist.py``: a round trip; schema, cross-chip
and truncated files rejected without a crash; a missing file is a cold
start; a steady-state save is a no-op; concurrent saves from threads; a
cross-process warm start and a corrupt-file recovery, each in a subprocess
that imports only ``repro_torch``.  The encodings are held against the JAX
package's: the same fingerprint and split type encode to the same JSON.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import plan_cache as jpc
from repro.core import split_types as jst
from repro.testing import given, hst, settings
from repro_torch import hardware as thw
from repro_torch.core import annotated_numpy as anp
from repro_torch.core import mozart, plan_cache
from repro_torch.core import split_types as st
from repro_torch.core import splittable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_cache():
    plan_cache.clear()
    yield
    plan_cache.clear()


def _pipeline(x):
    return anp.sum(anp.multiply(anp.exp(x), 0.5))


def _session(**kw):
    return mozart.session(device="cpu", **kw)


def _entry_snapshot(e):
    """Everything persistence must preserve, in comparable form."""
    return {
        "key": e.key,
        "fn_names": e.fn_names,
        "tuned": dict(e.tuned_batch),
        "chosen": dict(e.chosen_exec),
        "timings": {k: dict(v) for k, v in e.exec_timings.items()},
        "blocks": dict(e.block_shape),
        "handoff": None if e.handoff is None else {
            k: h.to_json() for k, h in e.handoff.items()},
        "templates": [
            (tuple(tm.positions), tuple(tm.inputs),
             tuple(sorted(tm.out_types.items())),
             tuple(sorted(tm.arg_types.items())))
            for tm in e.stage_templates
        ],
    }


# ---------------------------------------------------------------------------
# Encoder round trip (property), held against the JAX package's encoder
# ---------------------------------------------------------------------------


def _key_strategy():
    scalars = hst.sampled_from([
        "arr", "f32[8]", "", "node", 0, 1, -3, 2**40, True, False, None,
        0.5, -1.75, 1e300, b"\x00\xff", complex(1.5, -2.5),
    ])
    return hst.lists(
        hst.lists(scalars, min_size=0, max_size=4), min_size=0, max_size=5)


@given(raw=_key_strategy())
@settings(max_examples=60, deadline=None)
def test_fingerprint_encoding_roundtrip_is_identity(raw):
    key = tuple(tuple(inner) for inner in raw)
    enc = plan_cache._enc(key)
    assert enc == jpc._enc(key)
    wire = json.loads(json.dumps(enc))
    assert plan_cache._dec(wire) == key == jpc._dec(wire)


@given(nrows=hst.integers(1, 64), axis=hst.integers(0, 1),
       op=hst.sampled_from(["add", "max", "min", "mul"]))
@settings(max_examples=30, deadline=None)
def test_split_type_encoding_roundtrip(nrows, axis, op):
    classes = plan_cache._split_type_classes()
    pairs = ((st.ArraySplit((nrows, 3), axis), jst.ArraySplit((nrows, 3), axis)),
             (st.ReduceSplit(op), jst.ReduceSplit(op)),
             (st.ScalarSplit(), jst.ScalarSplit()),
             (st.ConcatSplit("tag", axis), jst.ConcatSplit("tag", axis)))
    for t, jt in pairs:
        enc = plan_cache._type_enc(t)
        assert enc == jpc._type_enc(jt)
        assert plan_cache._type_dec(enc, classes) == t


# ---------------------------------------------------------------------------
# save -> load identity on real cached plans
# ---------------------------------------------------------------------------


@given(n=hst.sampled_from([48, 96, 192]), batch=hst.integers(5, 40),
       executor=hst.sampled_from(["fused", "scan", "pipelined", "cuda"]))
@settings(max_examples=8, deadline=None)
def test_save_load_roundtrip_identity(tmp_path_factory, n, batch, executor):
    plan_cache.clear()
    x = torch.linspace(0.0, 1.0, n)
    with _session(executor=executor, batch_elements=batch):
        _ = float(_pipeline(x).value)
    (entry,) = plan_cache.entries()
    entry.pin(0, batch)
    entry.pin_exec(0, "scan")
    entry.record_exec_timing(0, "fused", 0.0125)
    entry.pin_block_shape(0, (1, 1024))
    want = _entry_snapshot(entry)

    path = str(tmp_path_factory.mktemp("pc") / "plans.json")
    assert plan_cache.save(path) == 1
    plan_cache.clear()
    assert plan_cache.load(path) == 1
    (loaded,) = plan_cache.entries()
    assert loaded.loaded and loaded.fns is None
    assert _entry_snapshot(loaded) == want


def test_loaded_entry_hits_without_planner(tmp_path):
    x = torch.linspace(0.0, 1.0, 256)
    with _session(executor="fused"):
        v1 = float(_pipeline(x).value)
    path = str(tmp_path / "plans.json")
    plan_cache.save(path)
    plan_cache.clear()
    plan_cache.load(path)
    with _session(executor="fused") as c2:
        v2 = float(_pipeline(x).value)
    assert c2.stats["planner_calls"] == 0
    assert c2.stats["plan_cache_hits"] == 1
    assert plan_cache.stats["warm_hits"] == 1
    assert np.isclose(v1, v2)


def test_loaded_handoff_decisions_replay(tmp_path):
    """Decisions recorded at plan time persist: a warm-started chain streams
    from its first call with zero analysis or planning."""
    x = torch.linspace(0.0, 1.0, 4096)

    def chain():
        with _session(executor="fused", batch_elements=512) as ctx:
            y = anp.multiply(anp.add(x, 1.0), 0.5)
            z = anp.exp(y)
            out = z.value
        return out, ctx

    want, _ = chain()
    (entry,) = plan_cache.entries()
    recorded = {k: h.to_json() for k, h in entry.handoff.items()}
    path = str(tmp_path / "plans.json")
    plan_cache.save(path)
    plan_cache.clear()
    plan_cache.load(path)
    got, ctx = chain()
    assert ctx.stats["planner_calls"] == 0
    (loaded,) = plan_cache.entries()
    assert {k: h.to_json() for k, h in loaded.handoff.items()} == recorded
    torch.testing.assert_close(got, want)


class _Tagged(st.ArraySplit):
    """An array split whose params do not rebuild it (an extra tag)."""

    name = "Tagged"

    def __init__(self, shape, axis=0):
        super().__init__(shape, axis)
        self.params = self.params + ("tag",)


class _TaggedSpec(st.SplitSpec):
    def construct(self, value, bound, generics):
        return _Tagged(tuple(value.shape), 0)


@splittable(x=st.Along(0), ret=_TaggedSpec(), elementwise=True, name="tagged_exp")
def _tagged_exp(x):
    return torch.exp(x)


def test_unpersistable_split_types_are_skipped_not_fatal(tmp_path):
    """An entry whose split type does not rebuild from its params is
    skipped; everything else still persists.  (The reference's example,
    ``compress``'s ``UnknownSplit``, persists in the port: see
    ``test_unknown_split_entries_persist_unlike_the_reference``.)"""
    x = torch.linspace(0.0, 1.0, 64)
    with _session(executor="pipelined", batch_elements=16):
        _ = float(_pipeline(x).value)                  # persistable
    with _session(executor="pipelined", batch_elements=16):
        _ = float(anp.sum(_tagged_exp(x)).value)       # Tagged: not rebuildable
    assert len(plan_cache.entries()) == 2
    path = str(tmp_path / "plans.json")
    assert plan_cache.save(path) == 1
    assert plan_cache.stats["persist_skipped"] >= 1


def _compressed_sum(x):
    with _session(executor="pipelined", batch_elements=16) as ctx:
        kept = anp.compress(anp.greater(x, 0.5), x)    # dynamic -> UnknownSplit
        total = float(anp.sum(kept).value)
    return total, ctx


def test_unknown_split_entries_persist_unlike_the_reference(tmp_path):
    """The reference skips every entry holding an ``UnknownSplit`` (its uid
    is process-local), so a pipeline returning ``Unknown`` (a serving step)
    never persists there.  The port persists it by axis, one fresh unknown
    per persisted uid of an entry, and a restarted process replays it with
    zero planner calls."""
    x = torch.linspace(0.0, 1.0, 64)
    want, _ = _compressed_sum(x)
    jx = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    from repro.core import annotated_numpy as janp
    from repro.core import mozart as jmozart
    jpc.clear()
    with jmozart.session(executor="pipelined", batch_elements=16):
        float(janp.sum(janp.compress(janp.greater(jx, 0.5), jx)))
    jpath, path = str(tmp_path / "jax.json"), str(tmp_path / "plans.json")
    assert jpc.save(jpath) == 0 and jpc.stats["persist_skipped"] == 1
    jpc.clear()
    assert plan_cache.save(path) == 1
    payload = json.load(open(path))
    kinds = {t["cls"] for tm in payload["entries"][0]["templates"]
             for t in plan_cache._template_types(tm)}
    assert "UnknownSplit" in kinds
    plan_cache.clear()
    assert plan_cache.load(path) == 1
    got, ctx = _compressed_sum(x)
    assert ctx.stats["planner_calls"] == 0 and got == want


# ---------------------------------------------------------------------------
# Guard rails: version / chip / corruption fall back to cold planning
# ---------------------------------------------------------------------------


def _saved_file(tmp_path):
    x = torch.linspace(0.0, 1.0, 128)
    with _session(executor="fused"):
        _ = float(_pipeline(x).value)
    path = str(tmp_path / "plans.json")
    assert plan_cache.save(path) == 1
    plan_cache.clear()
    return path, x


def _assert_cold_planning_still_works(x):
    with _session(executor="fused") as ctx:
        v = float(_pipeline(x).value)
    assert ctx.stats["planner_calls"] == 1
    want = float(np.sum(np.exp(np.linspace(0.0, 1.0, 128, dtype=np.float32)) * 0.5))
    assert np.isclose(v, want, rtol=1e-5)


def test_file_names_the_schema_and_the_chip(tmp_path):
    path, _ = _saved_file(tmp_path)
    payload = json.load(open(path))
    assert payload["schema"] == plan_cache.SCHEMA_VERSION == jpc.SCHEMA_VERSION == 7
    want = thw.chip_for("cuda" if torch.cuda.is_available() else "cpu").name
    assert payload["chip"] == want


def test_schema_version_mismatch_rejected(tmp_path):
    path, x = _saved_file(tmp_path)
    payload = json.load(open(path))
    payload["schema"] = plan_cache.SCHEMA_VERSION + 1
    json.dump(payload, open(path, "w"))
    assert plan_cache.load(path) == 0
    assert plan_cache.stats["persist_rejected_schema"] == 1
    assert plan_cache.cache_info()["entries"] == 0
    _assert_cold_planning_still_works(x)


def test_cross_chip_file_rejected(tmp_path):
    path, x = _saved_file(tmp_path)
    payload = json.load(open(path))
    payload["chip"] = "some_other_chip"
    json.dump(payload, open(path, "w"))
    assert plan_cache.load(path) == 0
    assert plan_cache.stats["persist_rejected_chip"] == 1
    _assert_cold_planning_still_works(x)


@given(cut=hst.integers(1, 40))
@settings(max_examples=10, deadline=None)
def test_truncated_file_rejected_not_fatal(tmp_path_factory, cut):
    plan_cache.clear()
    tmp_path = tmp_path_factory.mktemp("pc")
    path, x = _saved_file(tmp_path)
    blob = open(path).read()
    open(path, "w").write(blob[:max(0, len(blob) - cut)])
    assert plan_cache.load(path) == 0
    assert plan_cache.stats["persist_corrupt"] >= 1
    _assert_cold_planning_still_works(x)


def test_missing_file_is_a_cold_start(tmp_path):
    assert plan_cache.load(str(tmp_path / "nope.json")) == 0
    assert plan_cache.stats["persist_missing"] == 1


def test_unresolved_split_type_classes_keep_path_retryable(tmp_path):
    path, _ = _saved_file(tmp_path)
    payload = json.load(open(path))
    deferred = json.loads(json.dumps(payload["entries"][0]))
    deferred["key"] = plan_cache._enc(("other", "pipeline", "key"))
    for tm in deferred["templates"]:
        for t in tm["out_types"].values():
            t["cls"] = "NotYetImportedSplit"
    payload["entries"].append(deferred)
    json.dump(payload, open(path, "w"))

    assert plan_cache.load_once(path) == 1
    assert plan_cache.stats["persist_unresolved"] == 1
    assert plan_cache.stats["persist_skipped"] == 0
    assert os.path.abspath(path) not in plan_cache._loaded_paths
    assert plan_cache.load_once(path) == 0
    assert plan_cache.cache_info()["entries"] == 1


def test_steady_state_saves_are_noops(tmp_path):
    path = str(tmp_path / "plans.json")
    x = torch.linspace(0.0, 1.0, 256)

    def once():
        with _session(executor="fused", plan_cache_path=path) as ctx:
            _ = float(_pipeline(x).value)
        return ctx

    once()                                        # miss: entry added -> write
    once()                                        # first hit: pins -> write
    before = os.stat(path).st_mtime_ns, plan_cache.stats["persist_save_noop"]
    once()
    after = os.stat(path).st_mtime_ns, plan_cache.stats["persist_save_noop"]
    assert after[0] == before[0]
    assert after[1] > before[1]


def test_concurrent_saves_do_not_corrupt(tmp_path):
    x = torch.linspace(0.0, 1.0, 96)
    with _session(executor="fused", batch_elements=24):
        _ = float(_pipeline(x).value)
    path = str(tmp_path / "plans.json")
    errors = []

    def worker():
        try:
            for _ in range(10):
                plan_cache.save(path)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    payload = json.load(open(path))
    assert payload["schema"] == plan_cache.SCHEMA_VERSION
    plan_cache.clear()
    assert plan_cache.load(path) == 1
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_environment_variable_prewarms_every_context(tmp_path, monkeypatch):
    path, x = _saved_file(tmp_path)
    monkeypatch.setenv("MOZART_PLAN_CACHE", path)
    with _session(executor="fused") as ctx:
        _ = float(_pipeline(x).value)
    assert ctx.plan_cache_path == path
    assert ctx.stats["planner_calls"] == 0 and plan_cache.stats["warm_hits"] == 1


# ---------------------------------------------------------------------------
# Cross-process warm start (real subprocesses importing only repro_torch)
# ---------------------------------------------------------------------------

_PRELUDE = """
import json, sys
import torch
from repro_torch import hardware
from repro_torch.core import mozart, plan_cache
from repro_torch.core import annotated_numpy as anp
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
               for m in sys.modules)

TINY = hardware.Chip(name="tiny_subproc_chip", peak_bf16_flops=1e11,
                     hbm_bandwidth=2e10, ici_link_bandwidth=1e10, ici_links=1,
                     hbm_bytes=2**30, vmem_bytes=64 * 1024, mozart_c=1.0)

def pipeline(x):
    return anp.sum(anp.multiply(anp.exp(x), 0.5))

x = torch.linspace(0.0, 1.0, 50_000)
path = sys.argv[1]
"""

_PROC_A = _PRELUDE + """
for _ in range(2):
    with mozart.session(executor="auto", device="cpu", chip=TINY,
                        plan_cache_path=path) as ctx:
        v = float(pipeline(x).value)
print(json.dumps({"v": v, "ctx": dict(ctx.stats), "pc": dict(plan_cache.stats)}))
"""

_PROC_B = _PRELUDE + """
with mozart.session(executor="auto", device="cpu", chip=TINY, plan_cache_path=path) as ctx:
    v = float(pipeline(x).value)
print(json.dumps({"v": v, "ctx": dict(ctx.stats), "pc": dict(plan_cache.stats)}))
"""


def _run_subprocess(code, path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("MOZART_PLAN_CACHE", None)
    out = subprocess.run([sys.executable, "-c", code, path],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cross_process_warm_start(tmp_path):
    """Process A plans, measures and tunes, then saves; a FRESH process B
    replays the persisted plan: zero planner calls, zero tuning, zero
    executor measurements, and the same answer."""
    path = str(tmp_path / "plans.json")
    a = _run_subprocess(_PROC_A, path)
    assert a["ctx"].get("plan_cache_hits") == 1
    assert a["ctx"].get("auto_measured_stages", 0) >= 1
    assert os.path.exists(path)

    b = _run_subprocess(_PROC_B, path)
    assert b["pc"].get("persist_loaded", 0) >= 1
    assert b["pc"].get("hits") == 1
    assert b["pc"].get("warm_hits") == 1
    assert b["ctx"].get("planner_calls", 0) == 0
    assert b["ctx"].get("plan_cache_hits") == 1
    assert b["ctx"].get("autotuned_stages", 0) == 0
    assert b["ctx"].get("auto_measured_stages", 0) == 0
    assert b["ctx"].get("auto_pinned_replays", 0) >= 1
    assert b["ctx"].get("tuning_sample_elems", 0) == 0
    assert np.isclose(a["v"], b["v"], rtol=1e-5)


def test_cross_process_corrupt_file_recovers(tmp_path):
    path = str(tmp_path / "plans.json")
    a = _run_subprocess(_PROC_A, path)
    blob = open(path).read()
    open(path, "w").write(blob[: len(blob) // 2])

    b = _run_subprocess(_PROC_B, path)
    assert b["pc"].get("persist_corrupt", 0) >= 1
    assert b["pc"].get("persist_loaded", 0) == 0
    assert b["ctx"].get("planner_calls", 0) >= 1
    assert np.isclose(a["v"], b["v"], rtol=1e-5)

    with open(path) as f:
        payload = json.load(f)
    assert payload["entries"]
    c = _run_subprocess(_PROC_B, path)
    assert c["pc"].get("persist_corrupt", 0) == 0
    assert c["pc"].get("persist_loaded", 0) >= 1

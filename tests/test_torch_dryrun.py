"""The port's production dry run (``launch/dryrun.py``) held against the
reference's (``src/repro/launch/dryrun.py``) on gemma-7b's four shapes and
one 2 x 16 x 16 cell, smoke configs at the production shapes and meshes
(``dryrun_scenarios.py``: one subprocess per side); the other families are
in ``test_torch_dryrun_ref.py``, which shares the checks here.

* the same keys (the port adds ``moe_flops_traced``), status, skip reason,
  ``mesh``, ``n_devices``, ``params`` and ``active_params``, and the same
  ``argument_bytes`` (XLA leaves a parameter the step never reads out of
  its arguments);
* the inputs counted exactly: ``argument_bytes`` and ``alias_bytes`` equal
  the rank's inputs summed here from ``shardings.local_shape`` over
  ``param_specs``, ``zero1_specs``, ``batch_specs`` and ``cache_specs``,
  and ``peak_bytes`` is the reference's formula, at least the arguments;
* a decode record's ``peak_bytes`` equals the peak ``MemTracker`` sees
  when the same step runs for real on the CPU (the views of the step's
  arguments are no new storage, ROADMAP C17);
* ``flops`` at least ``roofline.model_flops`` in the dense train and
  prefill cells;
* the 2- and 3-layer cost variants of gemma-7b x train_4k extrapolate to
  the traced 4-layer record exactly (rel 1e-12: the trace counts every
  layer);
* the serving cells' all-gather and all-to-all bytes equal
  ``tensor_parallel.serving_bytes`` counted in the same trace, with a
  16-head gemma config that takes prefill's all-to-all as well;
* ``dryrun_cell`` refuses a process that is not rank 0 of the fake
  512-rank world, and its skip decisions are ``applicable``'s for every
  registry id x shape.
"""

import math

import pytest
import torch

import dryrun_scenarios as DS
from repro.configs import shapes as jshapes
from repro.configs.registry import ARCH_IDS, get_config as jget, get_smoke_config as jsmoke
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES, applicable, input_specs
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import param_count

#: a decode step of an encoder-decoder never reads the encoder's leaves;
#: XLA drops unused parameters from its arguments
UNREAD = {"seamless-m4t-large-v2": ("enc_layers.", "enc_norm")}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return DS.run_pair("dryrun", tmp_path_factory.mktemp("dryrun"))


def abstract_mesh(multi_pod: bool) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _bytes(shape, spec, mesh, dtype) -> int:
    return math.prod(shd.local_shape(tuple(shape), spec, mesh)) * dtype.itemsize


def _tree_bytes(tree, specs, mesh) -> int:
    leaves, total = [], 0
    shd.map_with_path(lambda path, leaf: leaves.append((path, leaf)), tree)
    for path, leaf in leaves:
        total += _bytes(leaf.shape, shd.at_path(specs, path), mesh, leaf.dtype)
    return total


def expected_inputs(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The rank's argument, alias and unread-parameter bytes, from the
    sharding rules alone."""
    mesh = abstract_mesh(multi_pod)
    shape = SHAPES[shape_name]
    cfg = dryrun.runtime_config(get_smoke_config(arch), mesh, shape)
    params = {n: p for n, p in tfm.init_model(cfg, None, "meta").named_parameters()}
    specs = shd.param_specs(params, mesh)
    p_bytes = sum(_bytes(p.shape, specs[n], mesh, p.dtype) for n, p in params.items())
    unread = sum(_bytes(p.shape, specs[n], mesh, p.dtype) for n, p in params.items()
                 if shape.kind == "decode" and n.startswith(UNREAD.get(arch, ("-",))))
    spec_in = input_specs(cfg, shape)
    batch = _tree_bytes(spec_in, shd.batch_specs(spec_in, mesh), mesh)
    if shape.kind == "train":
        zspecs = shd.zero1_specs(params, mesh)
        moments = 2 * sum(_bytes(p.shape, zspecs[n], mesh, torch.float32)
                          for n, p in params.items())
        alias = p_bytes + moments + 4                  # and the int32 step
        return {"argument": alias + batch, "alias": alias, "unread": unread}
    caches = tfm.init_caches(cfg, shape.global_batch, shape.seq_len, device="meta")
    c_bytes = _tree_bytes(caches, shd.cache_specs(caches, mesh, cfg), mesh)
    return {"argument": p_bytes + batch + c_bytes, "alias": c_bytes, "unread": unread}


def check_against_reference(ref: dict, got: dict) -> None:
    """Keys, status, reason, mesh, device count, parameter counts and the
    arguments of a port record against the reference's."""
    assert got["status"] == ref["status"], (got.get("error"), ref.get("error"))
    for k in ("arch", "shape", "mesh"):
        assert got[k] == ref[k], k
    if ref["status"] == "skipped":
        assert got == ref
        return
    assert set(got) == set(ref) | {"moe_flops_traced"}
    for k in ("n_devices", "params", "active_params"):
        assert got[k] == ref[k], k
    assert set(got["memory"]) == set(ref["memory"])
    assert set(got["collective"]) == set(ref["collective"])
    want = expected_inputs(got["arch"], got["shape"], got["mesh"] == "2x16x16")
    assert ref["memory"]["argument_bytes"] == got["memory"]["argument_bytes"] - want["unread"]


def check_inputs(arch: str, shape: str, multi_pod: bool, rec: dict) -> None:
    """Argument and alias bytes counted exactly; the peak formula."""
    want = expected_inputs(arch, shape, multi_pod)
    m = rec["memory"]
    assert m["argument_bytes"] == want["argument"]
    assert m["alias_bytes"] == want["alias"]
    assert m["peak_bytes"] == (m["temp_bytes"] + m["argument_bytes"] + m["output_bytes"]
                               - m["alias_bytes"])
    assert m["peak_bytes"] >= m["argument_bytes"]
    assert m["temp_bytes"] > 0 and m["output_bytes"] >= m["alias_bytes"]
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["params"] == param_count(get_smoke_config(arch))


def check_useful(arch: str, shape: str, rec: dict) -> None:
    mf = roofline.model_flops(get_smoke_config(arch), SHAPES[shape], rec["n_devices"])
    assert rec["flops"] >= mf > 0


@pytest.mark.parametrize("cell", DS.CELLS["dryrun"], ids=lambda c: DS.tag(*c))
def test_record_matches_the_reference(pair, cell):
    ref, port, _ = pair
    check_against_reference(ref[DS.tag(*cell)], port["cells"][DS.tag(*cell)]["record"])


@pytest.mark.parametrize("cell", [c for c in DS.CELLS["dryrun"] if c[1] != "long_500k"],
                         ids=lambda c: DS.tag(*c))
def test_inputs_are_counted_exactly(pair, cell):
    check_inputs(*cell, pair[1]["cells"][DS.tag(*cell)]["record"])


def check_real_peak(port: dict, cell: tuple) -> None:
    """The decode record's ``peak_bytes`` is what ``MemTracker`` sees when
    the same step runs for real on the CPU (``dryrun_scenarios.real_peak``)."""
    assert port["cells"][DS.tag(*cell)]["record"]["memory"]["peak_bytes"] == \
        port["real_peak"][DS.tag(*cell)]


@pytest.mark.parametrize("cell", [c for c in DS.CELLS["dryrun"]
                                  if c[1] == "decode_32k"], ids=lambda c: DS.tag(*c))
def test_peak_is_the_real_step_s(pair, cell):
    check_real_peak(pair[1], cell)


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k"))
def test_flops_cover_the_model_flops(pair, shape):
    check_useful("gemma-7b", shape, pair[1]["cells"][DS.tag("gemma-7b", shape, False)]["record"])


def test_cost_variants_extrapolate_exactly(pair):
    recs = pair[1]["linear"]
    r2, r3, r4 = recs["2"], recs["3"], recs["4"]
    assert all(r["status"] == "ok" for r in (r2, r3, r4))
    ext = roofline.extrapolate(r2, r3, 2, 3, 4)
    assert ext["flops"] == pytest.approx(r4["flops"], rel=1e-12, abs=0.0)
    assert ext["hlo_bytes"] == pytest.approx(r4["hlo_bytes"], rel=1e-12, abs=0.0)
    by_op = r4["collective"]["bytes_by_op"]
    assert set(ext["collective_bytes_by_op"]) == set(by_op)
    for op, b in by_op.items():
        assert ext["collective_bytes_by_op"][op] == pytest.approx(b, rel=1e-12, abs=0.0), op
    assert r3["flops"] > r2["flops"]


@pytest.mark.parametrize("case", ("prefill_32k", "decode_32k", "wide_prefill_32k",
                                  "wide_decode_32k"))
def test_serving_collectives_are_the_serving_bytes(pair, case):
    shape = case.removeprefix("wide_")
    res = (pair[1]["wide"][shape] if case.startswith("wide_")
           else pair[1]["cells"][DS.tag("gemma-7b", shape, False)])
    by_op = res["record"]["collective"]["bytes_by_op"]
    moved = by_op.get("all-gather", 0.0) + by_op.get("all-to-all", 0.0)
    assert moved == sum(res["serving_bytes"].values()) > 0
    if case == "wide_prefill_32k":        # one head per rank: K and V change hands
        assert by_op["all-to-all"] > 0


def test_dryrun_cell_needs_the_fake_world():
    with pytest.raises(ValueError, match="fake"):
        dryrun.dryrun_cell("gemma-7b", "decode_32k", cfg_override=get_smoke_config("gemma-7b"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skip_decisions_are_applicable_s(arch):
    """Smoke and published configs: a cell ``applicable`` refuses is
    skipped with its reason before any world or trace is needed."""
    for smoke in (True, False):
        for shape in SHAPES:
            jcfg = jsmoke(arch) if smoke else jget(arch)
            cfg = get_smoke_config(arch) if smoke else get_config(arch)
            ok, reason = jshapes.applicable(jcfg, jshapes.SHAPES[shape])
            assert applicable(cfg, SHAPES[shape]) == (ok, reason)
            if ok:
                continue
            for multi_pod in (False, True):
                got = dryrun.dryrun_cell(arch, shape, multi_pod=multi_pod,
                                         cfg_override=cfg if smoke else None)
                assert got == {"arch": arch, "shape": shape,
                               "mesh": "2x16x16" if multi_pod else "16x16",
                               "status": "skipped", "reason": reason}

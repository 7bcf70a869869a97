"""The port's production dry run held against the reference's on the
other families (``test_torch_dryrun.py``'s checks; one subprocess per
side): olmoe-1b-7b's prefill (the expert-parallel dispatch) and decode (one
dispatch group: 128 tokens do not fill 256), hymba-1.5b's prefill,
rwkv6-1.6b's 500k decode (one row, whole on every data rank),
qwen2-vl-2b's train step and seamless-m4t-large-v2's decode step (with
``enc_out``); each decode record's peak against ``MemTracker`` on the
same step run for real.  In olmoe's prefill the routed experts' FLOPs, booked apart
as ``moe_flops_traced``, are within 2% of ``roofline.moe_flops_per_device``;
in olmoe's train step too, their backward and recompute included, and no
FLOP of the step is booked twice.
"""

import pytest

import dryrun_scenarios as DS
from repro_torch.configs.registry import get_smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline
from test_torch_dryrun import (check_against_reference, check_inputs, check_real_peak,
                               check_useful)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return DS.run_pair("dryrun_ref", tmp_path_factory.mktemp("dryrun_ref"))


@pytest.mark.parametrize("cell", DS.CELLS["dryrun_ref"], ids=lambda c: DS.tag(*c))
def test_record_matches_the_reference(pair, cell):
    ref, port, _ = pair
    check_against_reference(ref[DS.tag(*cell)], port["cells"][DS.tag(*cell)]["record"])


@pytest.mark.parametrize("cell", DS.CELLS["dryrun_ref"], ids=lambda c: DS.tag(*c))
def test_inputs_are_counted_exactly(pair, cell):
    check_inputs(*cell, pair[1]["cells"][DS.tag(*cell)]["record"])


@pytest.mark.parametrize("cell", [c for c in DS.CELLS["dryrun_ref"]
                                  if SHAPES[c[1]].kind == "decode"], ids=lambda c: DS.tag(*c))
def test_peak_is_the_real_step_s(pair, cell):
    check_real_peak(pair[1], cell)


def test_flops_cover_the_model_flops(pair):
    check_useful("qwen2-vl-2b", "train_4k",
                 pair[1]["cells"][DS.tag("qwen2-vl-2b", "train_4k", False)]["record"])


def test_moe_experts_are_booked_apart(pair):
    rec = pair[1]["cells"][DS.tag("olmoe-1b-7b", "prefill_32k", False)]["record"]
    want = roofline.moe_flops_per_device(get_smoke_config("olmoe-1b-7b"),
                                         SHAPES["prefill_32k"], rec["n_devices"])
    assert rec["moe_flops_traced"] == pytest.approx(want, rel=0.02)
    for cell in DS.CELLS["dryrun_ref"]:            # nothing booked where no expert runs
        got = pair[1]["cells"][DS.tag(*cell)]["record"]
        if get_smoke_config(cell[0]).moe is None:
            assert got["moe_flops_traced"] == 0.0, cell


def test_moe_train_experts_are_booked_once(pair):
    """The routed experts' backward and remat recompute carry no label; the
    counter finds them by autograd sequence numbers.  Booked apart, they are
    ``moe_flops_per_device``'s four passes, and ``analyze_cell``'s FLOPs
    (``flops`` plus that analytic term) stay within the whole step's count,
    traced again with the label off."""
    rec = pair[1]["cells"][DS.tag(*DS.MOE_TRAIN_CELL)]["record"]
    want = roofline.moe_flops_per_device(get_smoke_config(DS.MOE_TRAIN_CELL[0]),
                                         SHAPES[DS.MOE_TRAIN_CELL[1]], rec["n_devices"])
    assert rec["moe_flops_traced"] == pytest.approx(want, rel=0.02)
    whole = pair[1]["unlabelled"]
    assert whole["status"] == "ok" and whole["moe_flops_traced"] == 0.0
    assert rec["flops"] + rec["moe_flops_traced"] == whole["flops"]
    assert rec["flops"] + want <= whole["flops"] * 1.02

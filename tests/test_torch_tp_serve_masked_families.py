"""The batchers' prefill steps for the other families under the ``"model"``
group, held against the reference's sharded jit on a (1, 2) mesh
(``tp_serve_scenarios.py``'s "masked_families" world; the checks and
tolerances are ``test_torch_tp_serve.py``'s): gemma3-4b (a sliding window
over per-row lengths) and olmoe-1b-7b (its pad tokens routed, capacity per
dispatch group as the reference's) through the right-padded bucket, and
hymba-1.5b through the pad-free bucket of the recurrent families with
per-slot lengths in its KV part."""

import pytest

import tp_serve_scenarios as TS
from test_torch_tp import run_world
from test_torch_tp_serve import check_case


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    return run_world("masked_families", tmp_path_factory, TS)


@pytest.mark.parametrize("name", TS.WORLDS["masked_families"][1])
def test_masked_serving_matches_the_reference(families, name):
    check_case(families, name)


def test_the_row_at_capacity_writes_on_no_rank(families):
    _ref, ranks = families
    for name in TS.WORLDS["masked_families"][1]:
        assert [res[name]["cap_row_kept"] for res in ranks] == [True, True], name


def test_hymba_lengths_are_per_slot_and_pad_free(families):
    """The pad-free bucket fills every row to ``SEQ``: hymba-1.5b's KV part
    carries per-slot lengths, ``SEQ + STEPS`` after the steps, whole on
    both ranks, beside its SSM state by channels."""
    _ref, ranks = families
    for res in ranks:
        got = res["hymba-1.5b_slots_1x2"]
        assert got["decode_cache"]["kv"].length.tolist() == \
            [[TS.SEQ + TS.STEPS] * TS.BATCH] * got["decode_cache"]["kv"].length.shape[0]

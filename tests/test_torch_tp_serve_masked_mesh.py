"""The batchers' masked prefill steps across four ranks, held against the
reference's sharded jit (``tp_serve_scenarios.py``'s "masked_mesh" world;
the checks and tolerances are ``test_torch_tp_serve.py``'s): gemma-7b
right-padded on (2, 2), each rank holding two of the four rows and their
spans gathered over the data group, and granite-34b left-padded on (1, 4),
its single KV head gathered whole for the mask (a mid-head split) and row
3's ``start`` (15) past the first two ranks' blocks of 6."""

import pytest

import tp_serve_scenarios as TS
from test_torch_tp import run_world
from test_torch_tp_serve import check_case


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    return run_world("masked_mesh", tmp_path_factory, TS)


@pytest.mark.parametrize("name", TS.WORLDS["masked_mesh"][1])
def test_masked_serving_matches_the_reference(mesh, name):
    check_case(mesh, name)


def test_spans_are_gathered_once_over_the_data_group(mesh):
    """On (2, 2) each rank's prefill gathers every row's (start, end) once:
    4 rows x 2 int32, 32 bytes, under "lengths"; the decode steps gather
    none.  On (1, 4) nothing goes to them."""
    _ref, ranks = mesh
    for res in ranks:
        got = res["gemma-7b_right_2x2"]
        assert got["prefill_bytes"]["lengths"] == TS.BATCH * 2 * 4
        assert got["bytes"]["lengths"] == TS.BATCH * 2 * 4
        assert "lengths" not in res["granite-34b_left_1x4"]["bytes"]


def test_the_row_at_capacity_writes_on_no_rank(mesh):
    """Row ``CAP_ROW`` lies in data rank 1's rows: its two ``"model"`` ranks
    keep its K and V as they came, the other two do not hold it."""
    _ref, ranks = mesh
    kept = {res["gemma-7b_right_2x2"]["rows"]: res["gemma-7b_right_2x2"]["cap_row_kept"]
            for res in ranks}
    assert kept == {0: None, 1: True}
    for res in ranks:
        assert res["gemma-7b_right_2x2"]["cap_row_kept"] in (None, True)

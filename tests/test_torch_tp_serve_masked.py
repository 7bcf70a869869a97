"""The batchers' masked prefill steps under the ``"model"`` group, held
against the reference's sharded jit on a (1, 2) mesh
(``tp_serve_scenarios.py``'s "masked" world; the checks and tolerances are
``test_torch_tp_serve.py``'s): gemma-7b through the continuous batcher's
right-padded bucket into a per-slot cache (row 1's decode writes cross from
rank 0's block into rank 1's) and through the static ``Server``'s
left-padded prefill into a scalar-length cache, and granite-34b (one KV
head, its ``wk``/``wv`` gathered) right-padded.  Decode alone runs from
the reference's per-slot prefill cache with row ``CAP_ROW`` at capacity."""

import pytest

import tp_serve_scenarios as TS
from test_torch_tp import run_world
from test_torch_tp_serve import check_case


@pytest.fixture(scope="module")
def masked(tmp_path_factory):
    return run_world("masked", tmp_path_factory, TS)


@pytest.mark.parametrize("name", TS.WORLDS["masked"][1])
def test_masked_serving_matches_the_reference(masked, name):
    check_case(masked, name)


def test_lengths_and_starts_are_each_rows_own(masked):
    """After the right-padded prefill every row's ``length`` is its prompt
    length, whole on both ranks; after the left-padded one ``length`` is
    ``SEQ`` and each row's ``start`` its pad; the three decode steps add
    three to each."""
    ref, ranks = masked
    for res in ranks:
        right, left = res["gemma-7b_right_1x2"], res["gemma-7b_left_1x2"]
        assert right["prefill_cache"].length.tolist() == [list(TS.PLENS)] * 2
        assert right["decode_cache"].length.tolist() == [[n + TS.STEPS for n in TS.PLENS]] * 2
        assert (right["prefill_cache"].start == 0).all()
        assert left["prefill_cache"].length.tolist() == [TS.SEQ] * 2
        assert left["prefill_cache"].start.tolist() == [list(TS.LEFT_PADS)] * 2


def test_the_row_at_capacity_writes_on_no_rank(masked):
    """Decode alone from a cache whose row ``CAP_ROW`` holds ``MAX_LEN``
    tokens: that row's K and V stay as they came on both ranks."""
    _ref, ranks = masked
    for name in ("gemma-7b_right_1x2", "granite-34b_right_1x2"):
        assert [res[name]["cap_row_kept"] for res in ranks] == [True, True], name


def test_no_lengths_cross_a_data_group_of_one(masked):
    """On (1, 2) the data group has one rank: no bytes go to the rows'
    spans; gemma-7b's K and V still go all-to-all into blocks."""
    _ref, ranks = masked
    for res in ranks:
        for name in TS.WORLDS["masked"][1]:
            assert "lengths" not in res[name]["bytes"], name
        assert res["gemma-7b_right_1x2"]["prefill_bytes"]["kv_blocks"] > 0

"""Tensor-parallel prefill and decode for the hybrid and RWKV families,
held against the reference's sharded jit on a (1, 2) mesh
(``tp_serve_scenarios.py``'s "families" world; the checks and tolerances
are ``test_torch_tp_serve.py``'s): hymba-1.5b (5 query heads: the
attention gathered; the SSM state by channels) and rwkv6-1.6b (``wkv`` by
heads, the shifts whole)."""

import pytest

import tp_serve_scenarios as TS
from test_torch_tp import run_world
from test_torch_tp_serve import check_case


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    return run_world("families", tmp_path_factory, TS)


@pytest.mark.parametrize("name", TS.WORLDS["families"][1])
def test_tensor_parallel_serving_matches_the_reference(families, name):
    check_case(families, name)


def test_states_are_split_as_cache_specs_places_them(families):
    """hymba-1.5b's SSM ``h`` and ``conv`` hold half the channels on each
    rank, its KV cache one sequence block; rwkv6-1.6b's ``wkv`` half the
    heads, its shifts whole."""
    ref, ranks = families
    for res in ranks:
        got, want = res["hymba-1.5b_1x2"]["prefill_cache"], ref["hymba-1.5b_1x2"]["prefill_cache"]
        assert got["ssm"].h.shape[2] * 2 == want["ssm"].h.shape[2]
        assert got["ssm"].conv.shape[3] * 2 == want["ssm"].conv.shape[3]
        assert got["kv"].k.shape[1] == 1
        st, want = res["rwkv6-1.6b_1x2"]["prefill_cache"], ref["rwkv6-1.6b_1x2"]["prefill_cache"]
        assert st.wkv.shape[2] * 2 == want.wkv.shape[2]
        assert st.shift_t.shape == want.shift_t.shape and st.shift_c.shape == want.shift_c.shape


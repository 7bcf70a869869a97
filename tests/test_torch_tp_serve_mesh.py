"""Tensor-parallel prefill and decode with data parallelism beside it,
held against the reference's sharded jit on a (2, 2) mesh
(``tp_serve_scenarios.py``'s four-rank "mesh" world; the checks and
tolerances are ``test_torch_tp_serve.py``'s): gemma-7b and olmoe-1b-7b
(four MoE groups, two per data rank); ``test_torch_tp_serve_mesh_inputs.py``
has the embedding inputs.  Each rank holds two of the four rows, one
sequence block of the cache of its rows, and the whole ``start``."""

import pytest

import tp_serve_scenarios as TS
from test_torch_tp import run_world
from test_torch_tp_serve import check_case


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    return run_world("mesh", tmp_path_factory, TS)


@pytest.mark.parametrize("name", TS.WORLDS["mesh"][1])
def test_tensor_parallel_serving_matches_the_reference(mesh, name):
    check_case(mesh, name)


def test_start_is_whole_and_rows_are_the_data_rows(mesh):
    """``cache_specs`` replicates ``start`` (L, B): every rank holds every
    row's; the KV cache holds the rank's data rows."""
    _ref, ranks = mesh
    for res in ranks:
        kv = res["gemma-7b_2x2"]["prefill_cache"]
        assert kv.start.shape == (kv.k.shape[0], TS.BATCH)
        assert kv.k.shape[3] == TS.BATCH // 2

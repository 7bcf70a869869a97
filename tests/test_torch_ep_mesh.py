"""The expert-parallel MoE dispatch on four ranks (``ep_scenarios.py``'s
"four" world; the harness, oracles and tolerances are
``test_torch_ep.py``'s): one MoE block of smoke olmoe-1b-7b and smoke
deepseek-moe-16b on (4, 1) (the reference's own branch) and (2, 2) (the
permuted mesh-free oracle, gradients included), and
``train(mesh=make_host_mesh(2, 2))`` with the context installed for 3
steps at ``capacity_factor = n_experts / top_k``, where an expert has a
slot for every token of its group, so nothing drops and the result cannot
depend on the grouping: its losses equal the mesh-free ``train()``'s with
``moe_groups`` 4 within ``test_torch_tp.py``'s loss tolerance."""

import numpy as np
import pytest

import ep_scenarios as EP
from test_torch_ep import check_block
from test_torch_tp import LOSS_RTOL, run_world


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_world("four", tmp_path_factory, EP)


@pytest.mark.parametrize("name", EP.WORLDS["four"][1])
def test_expert_parallel_block_matches_its_oracle(four, name):
    check_block(four, name)


@pytest.mark.parametrize("tag", sorted(EP.TRAIN))
def test_expert_parallel_training_matches_mesh_free(four, tag):
    """Every rank's three losses equal the mesh-free run's, and every MoE
    layer of the forward and of remat's recompute took the expert-parallel
    branch (none in the mesh-free run)."""
    _ref, ranks = four
    for r, res in enumerate(ranks):
        got = res["train"][tag]
        np.testing.assert_allclose(got["losses"], got["plain"], rtol=LOSS_RTOL,
                                   err_msg=f"rank {r}")
        assert got["losses"] == ranks[0]["train"][tag]["losses"], r
        assert got["ep_calls"] > 0 and got["plain_ep_calls"] == 0, got

"""The expert-parallel MoE dispatch (``models.shard_ctx`` installed as the
reference's ``launch/dryrun.py`` installs it) held against the reference
(``ep_scenarios.py`` holds the cases, run by both packages): this file's
two-rank world runs one MoE block of smoke olmoe-1b-7b and smoke
deepseek-moe-16b (shared experts) on (2, 1) and (1, 2) meshes;
``test_torch_ep_mesh.py`` runs (4, 1) and (2, 2) and trains on (2, 2).
Float32, the default capacity factor (the routing drops).

The oracles: on a data-only mesh the reference's own expert-parallel
branch (its ``shard_map``), forward and aux loss; wherever ``"model"`` > 1
the reference's mesh-free ``moe_block`` with ``moe_groups`` the device
count on x permuted so that each device's block is one group, forward,
aux loss and the gradients of its loss (``jax.grad``), which also hold
the data-only meshes' gradients.  The reference's own branch over
``"model"`` > 1 sums other ranks' tokens into each rank's buffers: it is
recorded against the oracle, not held.  Tolerance: ``TOL`` of
``tests/test_kernels.py`` for float32 (rtol and atol 2e-5).
"""

import numpy as np
import pytest

import ep_scenarios as EP
from test_torch_tp import run_world

RTOL = ATOL = 2e-5


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return run_world("two", tmp_path_factory, EP)


def check_block(world, name):
    """Every rank's output, aux loss and gradients against the case's
    oracle, the aux loss against the one-group block's, and the routing
    dropped assignments (the oracle holds drops included)."""
    ref, ranks = world
    want = ref[name]
    shape = EP.CASES[name][1]
    oracle = want["oracle"] if shape[1] > 1 else want["shard_map"]
    for r, got in enumerate(ranks):
        got = got[name]
        np.testing.assert_allclose(got["out"], oracle["out"], rtol=RTOL, atol=ATOL,
                                   err_msg=f"out rank {r}")
        np.testing.assert_allclose(got["aux"], oracle["aux"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["aux"], want["aux_plain"], rtol=RTOL, atol=ATOL)
        assert set(got["grads"]) == set(want["oracle"]["grads"])
        for n, g in want["oracle"]["grads"].items():
            assert np.abs(g).max() > 0, n
            np.testing.assert_allclose(got["grads"][n], g, rtol=RTOL, atol=ATOL,
                                       err_msg=f"grad {n} rank {r}")
        assert 0 < got["dropped"] < got["routed"], got
    np.testing.assert_allclose(want["shard_map"]["aux"], want["aux_plain"], rtol=RTOL)


@pytest.mark.parametrize("name", EP.WORLDS["two"][1])
def test_expert_parallel_block_matches_its_oracle(two, name):
    check_block(two, name)


def test_data_only_shard_map_is_the_permuted_oracle(two):
    """On (2, 1) the reference's own branch equals the grouped mesh-free
    block (the permutation is the identity there), so both oracles agree."""
    ref, _ranks = two
    for name in ("olmoe_2x1", "deepseek_2x1"):
        np.testing.assert_allclose(ref[name]["shard_map"]["out"], ref[name]["oracle"]["out"],
                                   rtol=RTOL, atol=ATOL)


def test_reference_shard_map_over_model_is_recorded_not_held(two):
    """On (1, 2) the reference's branch psums ``out_buf`` over ``"model"``
    while each ``"model"`` device holds another sequence block: its output
    moves far from the oracle (ROADMAP reference quirks: 3.74 against
    max|out| 2.48 at a capacity where nothing drops), while its aux loss
    stays the oracle's and the port's output is the oracle's."""
    ref, ranks = two
    for name in ("olmoe_1x2", "deepseek_1x2"):
        quirk = np.abs(ref[name]["shard_map"]["out"] - ref[name]["oracle"]["out"]).max()
        assert quirk > 0.1 * np.abs(ref[name]["oracle"]["out"]).max(), (name, quirk)
        np.testing.assert_allclose(ref[name]["shard_map"]["aux"], ref[name]["oracle"]["aux"],
                                   rtol=RTOL)
        assert np.abs(ranks[0][name]["out"] - ref[name]["oracle"]["out"]).max() < ATOL * 10

"""Tensor parallelism over ``"model"`` with data parallelism beside it,
held against the reference's ``train(mesh=...)`` on the same mesh shape
(``tp_scenarios.py``'s four-rank "mesh" world; the harness and the
tolerances are ``test_torch_tp.py``'s): (2, 2) for gemma-7b, olmoe-1b-7b
(``moe_groups`` 1: the tokens gathered over the data group, and 2, the
data extent: each data rank's rows a whole group) and qwen2-vl-2b, where
each rank's moments are its model slice cut again by data; (1, 4) for
internlm2-20b (6 query heads over 4 ranks: the attention gathered) and
granite-34b (one KV head split mid-head); and one step on a masked batch
on (2, 2)."""

import numpy as np
import pytest

import tp_scenarios as TP
from test_torch_tp import PARAM_ATOL, check_case, run_world


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    return run_world("mesh", tmp_path_factory)


@pytest.mark.parametrize("name", TP.WORLDS["mesh"][1])
def test_model_parallel_training_matches_the_reference(mesh, name):
    check_case(mesh, name)


def test_moments_are_model_slices_cut_by_data(mesh):
    """On (2, 2) a moment's placements are ``Shard`` on both mesh dims, the
    data one on the first dim the model slice leaves whole and divisible
    (``zero1_specs``), so its local shape is a quarter of a leaf both split
    and a half of one only one of them splits."""
    ref, ranks = mesh
    name = "gemma-7b_2x2"
    pl = ranks[0][name]["placements"]
    assert pl["layers.mlp.w_in"] == ("S(0)", "S(2)")        # (L, D, F): L by data, F by model
    assert pl["layers.ln1"] == ("S(0)", "R")
    shapes = ranks[0][name]["moment_shards"]
    assert shapes["layers.mlp.w_in"] == (1, 64, 128) == ref[name]["moment_shards"]["layers.mlp.w_in"]
    assert shapes["layers.ln1"] == (1, 64)


def test_masked_batch_uses_the_global_denominator(mesh):
    """One step on the masked batch (5, 20, 33 and 24 tokens kept) on
    (2, 2): the loss and the gradient norm equal the reference's on the
    whole batch (rtol 1e-5) only with the global ``sum(mask)`` and with
    every element of the whole model counted once in the norm."""
    ref, ranks = mesh
    want = ref["masked"]
    for res in ranks:
        got = res["masked"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
        for n, v in want["params"].items():
            np.testing.assert_allclose(got["params"][n], v, rtol=0, atol=PARAM_ATOL, err_msg=n)

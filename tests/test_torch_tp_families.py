"""Tensor parallelism over ``"model"`` in ``train(mesh=...)`` for the
families with their own layers, held against the reference's on a (1, 2)
mesh (``tp_scenarios.py``'s "families" world; the harness and the
tolerances are ``test_torch_tp.py``'s): olmoe-1b-7b (the experts' F
split, ``out_buf`` all-reduced), deepseek-moe-16b (shared experts and a
dense pre-layer), hymba-1.5b (5 query heads over 2 ranks: gathered; the
SSM heads by channels, ``in_proj`` gathered), rwkv6-1.6b (the time mix by
heads, the channel mix by columns and rows) and
seamless-m4t-large-v2 (the encoder and the cross-attention's K and V)."""

import pytest

import tp_scenarios as TP
from test_torch_tp import check_case, run_world


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    return run_world("families", tmp_path_factory)


@pytest.mark.parametrize("name", TP.WORLDS["families"][1])
def test_model_parallel_training_matches_the_reference(families, name):
    check_case(families, name)

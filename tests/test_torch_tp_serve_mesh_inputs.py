"""Tensor-parallel prefill and decode with data parallelism beside it for
the models that take embedding inputs, held against the reference's
sharded jit on a (2, 2) mesh (``tp_serve_scenarios.py``'s four-rank
"mesh_inputs" world; the checks and tolerances are
``test_torch_tp_serve.py``'s): qwen2-vl-2b (M-RoPE positions and
``input_embeds`` by data rows) and seamless-m4t-large-v2 (``enc_embeds``
by data rows, the cross K/V)."""

import pytest

import tp_serve_scenarios as TS
from test_torch_tp import run_world
from test_torch_tp_serve import check_case


@pytest.fixture(scope="module")
def mesh_inputs(tmp_path_factory):
    return run_world("mesh_inputs", tmp_path_factory, TS)


@pytest.mark.parametrize("name", TS.WORLDS["mesh_inputs"][1])
def test_tensor_parallel_serving_matches_the_reference(mesh_inputs, name):
    check_case(mesh_inputs, name)

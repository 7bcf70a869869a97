"""Tensor-parallel prefill and decode of gemma3-4b (qk-norm, a window)
and qwen2-vl-2b (M-RoPE ``positions``, ``input_embeds``), held against the
reference's sharded jit on a (1, 2) mesh (``tp_serve_scenarios.py``'s
"vlm" world; the checks and tolerances are ``test_torch_tp_serve.py``'s)."""

import pytest

import tp_serve_scenarios as TS
from test_torch_tp import run_world
from test_torch_tp_serve import check_case


@pytest.fixture(scope="module")
def vlm(tmp_path_factory):
    return run_world("vlm", tmp_path_factory, TS)


@pytest.mark.parametrize("name", TS.WORLDS["vlm"][1])
def test_tensor_parallel_serving_matches_the_reference(vlm, name):
    check_case(vlm, name)

"""Tensor-parallel prefill and decode of the MoE families, held against
the reference's sharded jit on a (1, 2) mesh (``tp_serve_scenarios.py``'s
"moe" world; the checks and tolerances are ``test_torch_tp_serve.py``'s):
olmoe-1b-7b (the experts' F split, ``out_buf`` all-reduced, two dispatch
groups) and deepseek-moe-16b (shared experts, a dense pre-layer with its
own cache).

And the expert-parallel MoE with ``models.shard_ctx`` installed as the
reference's ``launch/dryrun.py`` installs it: the port's prefill against
the mesh-free prefill whose MoE blocks dispatch each device's block as
one group (the permuted oracle), and the decode step, whose one position
the dispatch cannot split over ``"model"``, raising in both packages
(ROADMAP C, reference quirks)."""

import numpy as np
import pytest

import tp_serve_scenarios as TS
from test_torch_tp import run_world
from test_torch_tp_serve import _close_cache, _close_logits, _want_piece, check_case


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    return run_world("moe", tmp_path_factory, TS)


@pytest.mark.parametrize("name", [n for n in TS.WORLDS["moe"][1] if n != TS.EP_CASE])
def test_tensor_parallel_serving_matches_the_reference(moe, name):
    check_case(moe, name)


def test_expert_parallel_prefill_is_the_permuted_oracle_and_decode_raises(moe):
    """olmoe-1b-7b on (1, 2), ``shard_ctx`` installed: the port's prefill
    (the expert-parallel dispatch, one group per device) equals the
    mesh-free prefill with each device's (batch, sequence) block one MoE
    group, logits and cache pieces; the decode step raises in the
    reference (its ``shard_map`` splits one position over two devices)
    and in the port (``_expert_parallel``'s ``S % M``)."""
    ref, ranks = moe
    want = ref[TS.EP_CASE]
    assert "not evenly divisible" in want["decode_error"], want["decode_error"]
    for r, res in enumerate(ranks):
        got = res[TS.EP_CASE]
        _close_logits(got["prefill_logits"], want["prefill_logits"], f"rank {r} prefill")
        _close_cache(got["prefill_cache"], _want_piece(want["prefill_cache"], TS.EP_CASE,
                                                       got["coord"]), f"rank {r} cache")
        assert "splits the sequence" in got["decode_error"], got["decode_error"]
    # the installed context changed the routing: the plain (1, 2) case's logits differ
    plain = ref["olmoe-1b-7b_1x2"]["prefill_logits"]
    assert np.abs(plain - want["prefill_logits"]).max() > 1e-3

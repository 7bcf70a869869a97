"""Tensor-parallel prefill and decode over four ``"model"`` ranks, held
against the reference's sharded jit on a (1, 4) mesh
(``tp_serve_scenarios.py``'s "wide" world; the checks and tolerances are
``test_torch_tp_serve.py``'s): internlm2-20b (6 query heads over 4 ranks:
the attention gathered and run whole, q and the cache's blocks still
split four ways) and granite-34b (one KV head split mid-head: ``wk``/``wv``
gathered, the cache holding that head's four sequence blocks); and
gemma-7b with one KV block, which ``cache_specs`` leaves whole on every
rank: prefill gathers K and V by heads into it, and decode needs no
combine."""

import pytest

import tp_serve_scenarios as TS
from test_torch_tp import run_world
from test_torch_tp_serve import check_case


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    return run_world("wide", tmp_path_factory, TS)


@pytest.mark.parametrize("name", TS.WORLDS["wide"][1])
def test_tensor_parallel_serving_matches_the_reference(wide, name):
    check_case(wide, name)


def test_gathered_attention_sends_no_q(wide):
    """internlm2-20b's query heads do not divide over 4 ranks, so every
    rank computes all of them: decode gathers no q, only the partials."""
    _ref, ranks = wide
    for res in ranks:
        got = res["internlm2-20b_1x4"]["bytes"]
        assert "qkv_row" not in got and got["partials"] > 0


def test_one_block_cache_is_whole_on_every_rank(wide):
    """With ``kv_cache_blocks`` 1 every rank holds the whole cache: the
    prefill gathers the heads (``kv_heads``), no block is exchanged and
    decode gathers no partials."""
    _ref, ranks = wide
    for res in ranks:
        got = res[TS.WHOLE_CASE]
        assert got["prefill_cache"].k.shape[1:3] == (1, TS.MAX_LEN)
        assert got["prefill_bytes"]["kv_heads"] > 0 and "kv_blocks" not in got["prefill_bytes"]
        assert "partials" not in got["bytes"]

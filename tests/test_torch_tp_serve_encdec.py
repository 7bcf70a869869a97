"""Tensor-parallel prefill and decode for the encoder-decoder family and
a padded vocabulary, held against the reference's sharded jit on a (1, 2)
mesh (``tp_serve_scenarios.py``'s "encdec" world; the checks and
tolerances are ``test_torch_tp_serve.py``'s): seamless-m4t-large-v2 (the
encoder, the cross K/V recomputed at every step); and gemma-7b with its
vocabulary padded from 256 to 384 columns, so that rank 1's half of the
head masks its padding columns by their global ids before the columns are
gathered."""

import numpy as np
import pytest

import tp_serve_scenarios as TS
from test_torch_tp import run_world
from test_torch_tp_serve import check_case


@pytest.fixture(scope="module")
def encdec(tmp_path_factory):
    return run_world("encdec", tmp_path_factory, TS)


@pytest.mark.parametrize("name", TS.WORLDS["encdec"][1])
def test_tensor_parallel_serving_matches_the_reference(encdec, name):
    check_case(encdec, name)


def test_padding_columns_are_masked_by_global_id(encdec):
    """Every rank returns all 384 columns of its rows, the 128 past the
    vocabulary at -1e30, as the reference's."""
    ref, ranks = encdec
    want = ref[TS.PAD_CASE]["prefill_logits"]
    assert want.shape[-1] == 384 and np.all(want[..., 256:] == -1e30)
    for res in ranks:
        got = res[TS.PAD_CASE]["prefill_logits"]
        assert got.shape == want.shape and np.all(got[..., 256:] == -1e30)
        assert np.all(got[..., :256] > -1e29)


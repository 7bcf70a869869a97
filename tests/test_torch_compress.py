"""``repro_torch.optim.compress`` against ``repro.optim.compress``, bit for
bit on the CPU: int8 codes, float32 scales, decompressed gradients and
error-feedback residuals over sizes 1, 2047, 2048, 2049 and 10^5 (one
block, a block less one, exactly one, one more, many with a ragged tail),
an all-zero block (scale 0: codes 0, no division by zero), bfloat16
gradients, rounding ties, and several error-feedback rounds; then the byte
count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jc
from repro_torch.optim import compress as tc

SIZES = (1, 2047, 2048, 2049, 100_000)


def _grad(n, seed, dtype=np.float32):
    r = np.random.RandomState(seed)
    g = (r.randn(n) * 10.0 ** r.randint(-6, 2, n)).astype(np.float32)
    return g.astype(dtype)


def _eq(t: torch.Tensor, a) -> None:
    a = np.asarray(a)
    got = t.numpy()
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got.view(np.uint8), a.view(np.uint8))   # bits


@pytest.mark.parametrize("n", SIZES)
def test_quantize_codes_and_scales_bit_equal(n):
    x = _grad(n, n)
    jcodes, jscale = jc._quantize(jnp.asarray(x))
    tcodes, tscale = tc._quantize(torch.from_numpy(x))
    _eq(tcodes, jcodes)
    _eq(tscale, jscale)
    _eq(tc._dequantize(tcodes, tscale, n), jc._dequantize(jcodes, jscale, n))


def test_all_zero_block_and_rounding_ties():
    """A zero block has scale 0 and codes 0; a block whose scaled values are
    exact halves rounds them to even, as ``jnp.round``."""
    x = np.zeros(3 * tc.BLOCK, np.float32)
    x[tc.BLOCK] = 127.0                                  # block 1: scale 1
    x[tc.BLOCK + 1:tc.BLOCK + 9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    x[2 * tc.BLOCK:] = 1e-3
    jcodes, jscale = jc._quantize(jnp.asarray(x))
    tcodes, tscale = tc._quantize(torch.from_numpy(x))
    _eq(tcodes, jcodes)
    _eq(tscale, jscale)
    assert float(tscale[0, 0]) == 0.0 and not tcodes[0].any()
    assert tcodes[1, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", SIZES)
def test_error_feedback_rounds_bit_equal(n, dtype):
    """Four rounds of ``apply`` on a tree of two leaves (one (n,), one
    matrix), each round's gradients new and the residual carried: the
    decompressed gradients and the residuals equal the reference's."""
    shape = (n,) if n % 7 else (7, n // 7)
    jstate = tstate = None
    for rnd in range(4):
        g1 = _grad(n, 100 * rnd + n).reshape(shape)
        g2 = _grad(257, rnd).reshape(1, 257)
        if dtype == "bfloat16":
            tg = {"a": torch.from_numpy(g1).to(torch.bfloat16),
                  "b": torch.from_numpy(g2).to(torch.bfloat16)}
            jg = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) for k, v in tg.items()}
        else:
            tg = {"a": torch.from_numpy(g1), "b": torch.from_numpy(g2)}
            jg = {k: jnp.asarray(v.numpy()) for k, v in tg.items()}
        if jstate is None:
            jstate, tstate = jc.init(jg), tc.init(tg)
        jout, jstate = jc.apply(jg, jstate)
        tout, tstate = tc.apply(tg, tstate)
        for k in ("a", "b"):
            _eq(tout[k], jout[k])
            _eq(tstate.residual[k], jstate.residual[k])
    assert any(float(r.abs().max()) > 0 for r in tstate.residual.values())


def test_compress_decompress_single_tensor_and_bytes():
    g = _grad(5000, 3).reshape(50, 100)
    jd, jr = jc.compress_decompress(jnp.asarray(g), jnp.zeros(g.shape, jnp.float32))
    td, tr = tc.compress_decompress(torch.from_numpy(g), torch.zeros(g.shape))
    _eq(td, jd)
    _eq(tr, jr)
    tree = {"x": torch.zeros(1), "y": {"z": torch.zeros(2049), "w": torch.zeros(100_000)}}
    jtree = {"x": jnp.zeros(1), "y": {"z": jnp.zeros(2049), "w": jnp.zeros(100_000)}}
    assert tc.compressed_bytes(tree) == jc.compressed_bytes(jtree) == \
        1 + 4 + 2049 + 8 + 100_000 + 49 * 4

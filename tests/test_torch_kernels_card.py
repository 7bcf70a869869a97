"""The port's hand-written CUDA kernels against their plain versions on the
card.  Marked ``cuda``: each test skips itself where no card is present
(the kernels have no CPU mode).  The file imports no JAX, so it runs on a
machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_kernels_card.py

Tolerances: float32 rtol 2e-5 (the same float32 arithmetic; nvcc's FMA
contraction moves results by ulps); a bfloat16 p within one bfloat16 ulp
(an ulp-level float32 difference may round the other way).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_adamw as fa
from repro_torch.kernels.ref import adamw_ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 1000, 70001])
def test_fused_adamw_matches_plain_version(n, dtype, offset):
    """Ragged tails, both dtypes, and views off the vector grid (offset 1)."""
    _card()
    r = np.random.RandomState(n)
    base = [torch.from_numpy(r.randn(n + offset).astype(np.float32)).cuda()
            for _ in range(4)]
    p, g = (x[offset:].to(dtype) for x in base[:2])
    m, v = base[2][offset:] * 0.01, (base[3][offset:] * 0.01).abs()
    if offset:
        p, g = (torch.empty(n + 1, dtype=dtype, device="cuda")[1:].copy_(x) for x in (p, g))
    sc = fa.scalar_row(1e-3, 0.9, 0.95, torch.tensor(7, dtype=torch.int32, device="cuda"), 0.5)
    before = fa.fused_adamw.launches
    got = fa.fused_adamw(p, g, m, v, sc, eps=1e-8, wd=0.1)
    want = adamw_ref(p, g, m, v, sc, eps=1e-8, wd=0.1)
    torch.cuda.synchronize()
    assert fa.fused_adamw.launches == before + 1
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got[0].float().cpu().numpy(), want[0].float().cpu().numpy(),
                               rtol=rtol, atol=2e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-5, atol=1e-7)

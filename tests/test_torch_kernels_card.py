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


# -- flash attention ----------------------------------------------------------

#: ``tests/test_kernels.py``'s tolerances: the same float32 arithmetic in
#: another summation order; bfloat16 outputs round once more.
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _rand(shape, dtype, seed):
    r = np.random.RandomState(seed)
    return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dtype).cuda()


def _attn_case(B, Hq, Hkv, Sq, Sk, D, dtype, causal, window):
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels.ref import attention_ref
    q = _rand((B, Hq, Sq, D), dtype, 1)
    k = _rand((B, Hkv, Sk, D), dtype, 2)
    v = _rand((B, Hkv, Sk, D), dtype, 3)
    before = fl.flash_attention.launches
    got = fl.flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fl.flash_attention.launches == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 2, 2, 128, 64),      # MHA
    (2, 4, 2, 256, 64),      # GQA group 2
    (1, 8, 1, 128, 128),     # MQA
    (1, 2, 2, 256, 256),     # gemma's head dim
])
def test_flash_attention_causal_matches_plain_version(B, Hq, Hkv, S, D, dtype):
    """``tests/test_kernels.py::TestFlashAttention.test_vs_ref_causal``."""
    _card()
    _attn_case(B, Hq, Hkv, S, S, D, dtype, True, None)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (128, 128, False, None),       # non-causal
    (256, 256, True, 32),          # sliding windows
    (256, 256, True, 128),
    (64, 256, False, None),        # Sk > Sq (cross attention)
    (100, 77, True, None),         # ragged Sq and Sk
    (77, 200, False, 50),          # ragged, non-causal window
    (128, 128, True, 1 << 30),     # the transformer's "global" window
])
def test_flash_attention_masks_match_plain_version(Sq, Sk, causal, window):
    _card()
    _attn_case(1, 2, 2, Sq, Sk, 64, torch.float32, causal, window)


# -- RMSNorm --------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128), (3, 512), (2, 5, 256), (300, 1024),
                                   (4, 3072), (2, 5000)])
def test_rmsnorm_matches_plain_version(shape, dtype):
    """``tests/test_kernels.py::TestRMSNorm`` shapes, gemma's width, and a row
    wider than the kernel's registers hold."""
    _card()
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_ref
    x = _rand(shape, dtype, 0)
    w = _rand(shape[-1:], torch.float32, 1) + 1.0
    before = rn.rmsnorm.launches
    got = rn.rmsnorm(x, w)
    want = rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 1
    assert got.shape == x.shape and got.dtype == x.dtype
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])

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


def _head_split(B, H, S, D, dtype, seed):
    """The model's (B, H, S, D) view of a (B, S, H * D) projection."""
    return _rand((B, S, H * D), dtype, seed).view(B, S, H, D).transpose(1, 2)


def _attn_case(B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, *, split=False, variant=None):
    """One launch against the plain version; ``variant`` is the variant the
    launch must take (default: tc for bfloat16, simt for float32)."""
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels.ref import attention_ref
    make = _head_split if split else (lambda B, H, S, D, dt, seed: _rand((B, H, S, D), dt, seed))
    q = make(B, Hq, Sq, D, dtype, 1)
    k = make(B, Hkv, Sk, D, dtype, 2)
    v = make(B, Hkv, Sk, D, dtype, 3)
    variant = variant or ("tc" if dtype == torch.bfloat16 else "simt")
    before = fl.flash_attention.launches
    by_variant = dict(fl.flash_attention.variant_launches)
    got = fl.flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fl.flash_attention.launches == before + 1
    assert fl.flash_attention.variant_launches[variant] == by_variant[variant] + 1
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (128, 128, False, None),       # non-causal
    (256, 256, True, 32),          # sliding windows
    (256, 256, True, 128),
    (64, 256, False, None),        # Sk > Sq (cross attention)
    (100, 77, True, None),         # ragged Sq and Sk
    (77, 200, False, 50),          # ragged, non-causal window
    (128, 128, True, 1 << 30),     # the transformer's "global" window
])
def test_flash_attention_masks_match_plain_version(Sq, Sk, causal, window, dtype):
    _card()
    _attn_case(1, 2, 2, Sq, Sk, 64, dtype, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,causal,window,split", [
    (2, 4, 4, 300, 300, 256, True, None, True),    # head-split views, ragged, gemma's D
    (1, 4, 2, 190, 190, 128, True, None, True),    # GQA head-split views
    (1, 2, 2, 200, 333, 256, False, None, False),  # ragged D-256, Sk > Sq
    (1, 2, 2, 333, 333, 256, True, 40, False),     # window shorter than a tile
    (1, 2, 2, 70, 70, 64, True, 5, True),
    (2, 2, 1, 129, 129, 256, True, None, False),   # one row past a 128-row CTA
])
def test_flash_attention_tensor_core_edges_match_plain_version(B, Hq, Hkv, Sq, Sk, D, causal,
                                                              window, split):
    """The tensor-core variant's edges: strided q/k/v, ragged Sq/Sk at D 256,
    short windows; each case must take the tc variant."""
    _card()
    _attn_case(B, Hq, Hkv, Sq, Sk, D, torch.bfloat16, causal, window, split=split)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [40, 24])
def test_flash_attention_bfloat16_outside_the_rule_takes_simt(D):
    """A bfloat16 head dim that is not a multiple of 16 goes to the CUDA-core
    variant, by the rule and counted."""
    _card()
    _attn_case(1, 2, 2, 100, 100, D, torch.bfloat16, True, None, variant="simt")


@pytest.mark.cuda
def test_flash_attention_forced_simt_matches_tc():
    """The CUDA-core variant forced (``_attention(..., variant="simt")``) on
    inputs the rule sends to tc: both within the bfloat16 tolerance of the
    plain version and of each other."""
    _card()
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels.ref import attention_ref
    q, k, v = (_head_split(1, 4, 256, 128, torch.bfloat16, s) for s in (1, 2, 3))
    fl.reset_counts()
    tc_out = fl.flash_attention(q, k, v)
    simt_out = fl._attention(q, k, v, variant="simt")
    want = attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert fl.flash_attention.variant_launches == {"tc": 1, "simt": 1}
    for got in (tc_out, simt_out):
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   **TOL[torch.bfloat16])


# -- RMSNorm --------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 128), (3, 512), (2, 5, 256), (300, 1024),
                                   (4, 3072), (2, 5000), (2, 20000)])
def test_rmsnorm_matches_plain_version(shape, dtype):
    """``tests/test_kernels.py::TestRMSNorm`` shapes, gemma's width, a row
    wider than the kernel's registers hold, and one wider than its
    shared-memory copy of w (12288 columns)."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 3072), (5, 1000)])
def test_rmsnorm_misaligned_view_matches_plain_version(shape, dtype):
    """x one element into its storage: no row is 16-byte aligned, so every
    row takes the kernel's scalar loop."""
    _card()
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_ref
    n, d = shape
    x = _rand((n * d + 1,), dtype, 0)[1:].view(n, d)
    assert x.data_ptr() % 16
    w = _rand((d,), torch.float32, 1) + 1.0
    got = rn.rmsnorm(x, w)
    want = rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(10001, 8), (4099, 64), (777, 3)])
def test_rmsnorm_many_short_rows_match_plain_version(shape, dtype):
    """Many rows shorter than a warp's vectors, with a ragged last CTA."""
    _card()
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_ref
    x = _rand(shape, dtype, 0)
    w = _rand(shape[-1:], torch.float32, 1) + 1.0
    got = rn.rmsnorm(x, w)
    want = rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_offset", [0, 1])
def test_rmsnorm_weight_dtypes_and_views_match_plain_version(x_dtype, w_dtype, w_offset):
    """w in either dtype, and w one element into its storage: the kernel's
    vector loads of w (16 or 8 bytes) and its column-at-a-time reads."""
    _card()
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_ref
    d = 3072
    x = _rand((6, d), x_dtype, 0)
    w = (_rand((d + w_offset,), torch.float32, 1) + 1.0).to(w_dtype)[w_offset:]
    assert (w.data_ptr() % 16 != 0) == bool(w_offset)
    got = rn.rmsnorm(x, w)
    want = rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[x_dtype])

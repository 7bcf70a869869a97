"""The port's flash-attention wrapper and its plain version against the JAX
package, on the CPU.

Each case of ``tests/test_kernels.py::TestFlashAttention`` goes through the
JAX ``ops.flash_attention`` (the Pallas kernel in interpret mode), the JAX
``ref.attention_ref``, and the port's ``ops.flash_attention``, kernel
wrapper and ``attention_ref`` on CPU tensors (which take the plain
version), from the same seeded numpy inputs.  Tolerances: ``TOL`` of
``tests/test_kernels.py`` (float32 2e-5, bfloat16 2e-2).  The kernel itself
runs only on a card (``tests/test_torch_kernels_card.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.transformer import BIG_WINDOW

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(shapes, dtype):
    """The same values on both sides: float32 numpy, rounded once to the
    working dtype by each framework (both round to nearest even)."""
    jd, td = DTYPES[dtype]
    out = []
    for i, shape in enumerate(shapes, start=1):
        x = np.random.RandomState(i).randn(*shape).astype(np.float32)
        out.append((jnp.asarray(x, jd), torch.from_numpy(x).to(td)))
    return [j for j, _ in out], [t for _, t in out]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check_all(jq, jk, jv, tq, tk, tv, dtype, *, block, **kw):
    """JAX kernel (interpret), JAX oracle, port ops / wrapper / oracle."""
    want = _f32(jref.attention_ref(jq, jk, jv, **kw))
    jkern = _f32(jops.flash_attention(jq, jk, jv, block_q=block, block_k=block, **kw))
    np.testing.assert_allclose(jkern, want, **TOL[dtype])
    before = fl.flash_attention.launches
    got_ops = tops.flash_attention(tq, tk, tv, block_q=block, block_k=block, **kw)
    got_wrap = fl.flash_attention(tq, tk, tv, **kw)
    got_ref = tref.attention_ref(tq, tk, tv, **kw)
    assert fl.flash_attention.launches == before      # CPU tensors never launch
    for got in (got_ops, got_wrap, got_ref):
        assert got.dtype == tq.dtype and tuple(got.shape) == tuple(jq.shape)
        np.testing.assert_allclose(_f32(got), want, **TOL[dtype])
        np.testing.assert_allclose(_f32(got), jkern, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,block", [
    (1, 2, 2, 128, 64, 64),     # MHA
    (2, 4, 2, 256, 64, 128),    # GQA group 2
    (1, 8, 1, 128, 128, 64),    # MQA (granite-style kv=1)
    (1, 2, 2, 256, 256, 128),   # gemma-style head_dim 256
])
def test_causal_matches_jax(B, Hq, Hkv, S, D, block, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)],
                                         dtype)
    _check_all(jq, jk, jv, tq, tk, tv, dtype, block=block, causal=True)


@pytest.mark.parametrize("causal,window", [(False, None), (True, 32), (True, 128)])
def test_non_causal_and_sliding_window_match_jax(causal, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs([(1, 2, 256, 64)] * 3, "float32")
    _check_all(jq, jk, jv, tq, tk, tv, "float32", block=64, causal=causal, window=window)


def test_cross_attention_kv_longer_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _inputs([(1, 2, 64, 64), (1, 2, 256, 64), (1, 2, 256, 64)],
                                         "float32")
    _check_all(jq, jk, jv, tq, tk, tv, "float32", block=64, causal=False)


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (100, 77, True, None), (77, 200, False, 50), (5, 3, True, 2)])
def test_ragged_lengths_match_jax_oracle(Sq, Sk, causal, window):
    """Lengths that divide no block: the reference kernel asserts, the
    port's kernel masks; its plain version against the JAX oracle (rows
    with no visible key give 0)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs([(2, 4, Sq, 32), (2, 2, Sk, 32), (2, 2, Sk, 32)],
                                         "float32")
    want = _f32(jref.attention_ref(jq, jk, jv, causal=causal, window=window))
    got = fl.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), want, **TOL["float32"])


def test_rows_without_visible_keys_are_zero():
    (_jq, _jk, _jv), (tq, tk, tv) = _inputs([(1, 2, 8, 16), (1, 2, 4, 16), (1, 2, 4, 16)],
                                            "float32")
    got = fl.flash_attention(tq, tk, tv, causal=True, window=0)   # k <= q and k > q
    assert torch.equal(got, torch.zeros_like(got))


def test_global_window_equals_no_window():
    """The transformer encodes global attention as ``BIG_WINDOW = 2**30``."""
    _j, (tq, tk, tv) = _inputs([(1, 2, 64, 32)] * 3, "float32")
    assert torch.equal(fl.flash_attention(tq, tk, tv, window=BIG_WINDOW),
                       fl.flash_attention(tq, tk, tv, window=None))


def test_sm_scale_is_passed_through():
    (jq, jk, jv), (tq, tk, tv) = _inputs([(1, 2, 64, 32)] * 3, "float32")
    want = _f32(jref.attention_ref(jq, jk, jv, sm_scale=0.3))
    np.testing.assert_allclose(_f32(tops.flash_attention(tq, tk, tv, sm_scale=0.3)), want,
                               **TOL["float32"])


@pytest.mark.parametrize("bad", ["rank", "heads", "head_dim", "kv_shapes"])
def test_wrapper_rejects_bad_shapes(bad):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    v = torch.zeros(1, 2, 8, 16)
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        k = v = torch.zeros(1, 3, 8, 16)
    elif bad == "head_dim":
        k = v = torch.zeros(1, 2, 8, 8)
    else:
        v = torch.zeros(1, 2, 9, 16)
    with pytest.raises(ValueError):
        fl.flash_attention(q, k, v)


def test_wrapper_rejects_mixed_devices():
    q = torch.zeros(1, 2, 8, 16)
    kv = torch.zeros(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="lies on"):
        fl.flash_attention(q, kv, kv)


def _head_split(B, H, S, D, dtype=torch.bfloat16, device="meta"):
    """The model's (B, H, S, D) view of a (B, S, H * D) projection."""
    return torch.empty(B, S, H * D, dtype=dtype, device=device).view(B, S, H, D).transpose(1, 2)


def _offset_view(B, H, S, D):
    """A contiguous (B, H, S, D) view one element into its storage: its base
    is 2 bytes off 16-byte alignment."""
    return torch.zeros(B * H * S * D + 1, dtype=torch.bfloat16)[1:].view(B, H, S, D)


@pytest.mark.parametrize("make,want", [
    (lambda: [_head_split(4, 16, 2048, 256)] * 3, "tc"),                 # gemma's prefill
    (lambda: [torch.empty(4, 16, 2048, 256, dtype=torch.bfloat16, device="meta")] * 3, "tc"),
    (lambda: [torch.empty(1, 2, 77, 64, dtype=torch.bfloat16)] * 3, "tc"),  # ragged S
    (lambda: [_head_split(4, 16, 2048, 256, torch.float32)] * 3, "simt"),  # float32
    (lambda: [torch.empty(1, 2, 64, 40, dtype=torch.bfloat16)] * 3, "simt"),  # D = 40
    (lambda: [torch.empty(1, 2, 64, 264, dtype=torch.bfloat16, device="meta")] * 3, "simt"),
    (lambda: [_offset_view(1, 2, 64, 64)] * 3, "simt"),                  # unaligned base
    (lambda: [torch.empty(1, 2, 64, 64, dtype=torch.bfloat16),
              torch.empty(1, 2, 0, 64, dtype=torch.bfloat16),
              torch.empty(1, 2, 0, 64, dtype=torch.bfloat16)], "simt"),  # no keys
    (lambda: [torch.empty(1, 2, 64, 68, dtype=torch.bfloat16)[..., :64]] * 3,
     "simt"),                                                            # row stride 68
    (lambda: [torch.empty(1, 1, 1, 64, dtype=torch.bfloat16).as_strided(
        (1, 1, 1, 64), (3, 5, 7, 1))] * 3, "tc"),                         # size-1 dims
])
def test_variant_rule(make, want):
    """The one dispatch rule between the tensor-core and CUDA-core variants:
    bfloat16, D a multiple of 16 up to 256, Sk >= 1, 16-byte aligned bases
    and strides (of dimensions longer than 1) that are multiples of 8."""
    q, k, v = make()
    assert fl._variant(q, k, v) == want


def test_variant_argument_is_checked_and_cpu_counts_nothing():
    (_j, (tq, tk, tv)) = _inputs([(1, 2, 64, 32)] * 3, "bfloat16")
    with pytest.raises(ValueError, match="variant"):
        fl._attention(tq, tk, tv, variant="mma")
    fl.reset_counts()
    got = fl._attention(tq, tk, tv, variant="simt")     # CPU: the plain version
    assert torch.equal(got, tref.attention_ref(tq, tk, tv))
    assert fl.flash_attention.launches == 0
    assert fl.flash_attention.variant_launches == {"tc": 0, "simt": 0}

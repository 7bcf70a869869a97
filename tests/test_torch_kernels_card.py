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

import sharded_scenarios as S

from repro_torch.kernels import fused_adamw as fa
from repro_torch.kernels.program import OPCODES
from repro_torch.kernels.ref import adamw_ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.fixture(autouse=True)
def _fresh_plan_cache():
    """Each test starts with an empty plan cache, so no test replays (or
    tunes) a plan another test left behind."""
    from repro_torch.core import plan_cache
    plan_cache.clear()
    yield


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
@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", [
    (4, 48, 8, 2048, 128, None),     # internlm2-20b: GQA group 6
    (4, 48, 1, 2048, 128, None),     # granite-34b: MQA, group 48
    (4, 8, 4, 2048, 256, 1024),      # gemma3-4b's local layers: 1024-key window
    (4, 8, 4, 2048, 256, None),      # gemma3-4b's global layers
    (4, 16, 16, 2048, 128, None),    # olmoe-1b-7b and deepseek-moe-16b: MHA
])
def test_flash_attention_at_the_new_models_prefill_shapes(B, Hq, Hkv, S, D, window):
    """A greedy prefill's attention (batch 4 x 2048, causal, bfloat16, the
    model's head-split views) at the published widths of the dense and MoE
    configs served since the gemma-7b slice: the tc variant, within the
    bfloat16 tolerance of the plain version."""
    _card()
    _attn_case(B, Hq, Hkv, S, S, D, torch.bfloat16, True, window, split=True)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [64, None])
def test_flash_attention_at_hymbas_head_dim_and_odd_group(window):
    """hymba-1.5b's attention at a small size: head dim 64 (128-byte rows),
    GQA group 5 (an odd group, 10 q heads over 2 kv heads), the model's
    head-split views, a ragged 300 keys, causal, bfloat16, with a 64-key
    window and without: the tc variant, within the bfloat16 tolerance of
    the plain version."""
    _card()
    _attn_case(2, 10, 2, 300, 300, 64, torch.bfloat16, True, window, split=True)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,causal", [
    (4, 12, 2, 2048, 128, True),     # qwen2-vl-2b: GQA group 6
    (4, 16, 16, 2048, 64, True),     # seamless-m4t-large-v2's decoder
    (4, 16, 16, 2048, 64, False),    # seamless-m4t-large-v2's encoder: non-causal
])
def test_flash_attention_at_the_embedding_input_models_prefill_shapes(B, Hq, Hkv, S, D, causal):
    """A 4 x 2048 prefill's attention at qwen2-vl-2b's and seamless's
    published widths (bfloat16, the model's head-split views), the encoder's
    without the causal mask: the tc variant, within the bfloat16 tolerance
    of the plain version."""
    _card()
    _attn_case(B, Hq, Hkv, S, S, D, torch.bfloat16, causal, None, split=True)


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


# -- split pipeline -----------------------------------------------------------

def _sp_check(program, ins, bcast, kinds):
    """One launch against the plain version on the same inputs.  Concat
    outputs: the same float32 operations, rtol 2e-5 (atol 2e-5 * max|ref|);
    reductions sum in another order, rtol 1e-4; bools exactly."""
    from repro_torch.kernels import split_pipeline as sp
    from repro_torch.kernels.ref import split_pipeline_ref
    before = sp.split_pipeline.launches
    got = sp.split_pipeline(program, ins, bcast, kinds)
    want = split_pipeline_ref(program, ins, bcast, kinds)
    torch.cuda.synchronize()
    assert sp.split_pipeline.launches == before + 1
    for (kind, _op), g, w in zip(kinds, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == torch.bool:
            assert torch.equal(g, w)
            continue
        g, w = g.cpu().double().numpy(), w.cpu().double().numpy()
        finite = np.abs(w[np.isfinite(w)]) if w.ndim else np.abs(w[None][np.isfinite(w[None])])
        atol = 2e-5 * float(finite.max()) if finite.size else 0.0
        np.testing.assert_allclose(g, w, rtol=1e-4 if kind == "reduce" else 2e-5, atol=atol,
                                   equal_nan=True)


def _sp_inputs(n, k, seed, offset=0):
    r = np.random.RandomState(seed)
    return [torch.from_numpy((r.randn(n + offset) * 2.0).astype(np.float32)).cuda()[offset:]
            for _ in range(k)]


def _sp_chain():
    """A Haversine-like program: results forwarded and stored, scalars."""
    from repro_torch.kernels import program as P
    v = lambda j: ("v", j)
    code = [(P.OP["SUB"], [("in", 0), ("sc", 0)]), (P.OP["MUL"], [("in", 1), ("sc", 1)]),
            (P.OP["SIN"], [v(1)]), (P.OP["MUL"], [v(2), v(2)]), (P.OP["COS"], [("in", 0)]),
            (P.OP["MUL"], [v(4), v(0)]), (P.OP["ADD"], [v(3), v(5)]), (P.OP["ABS"], [v(6)]),
            (P.OP["SQRT"], [v(7)])]
    return P.assemble(code, [(v(8), False), (v(0), False)], n_split=2, n_bcast=2, imms=())


_OPS = [(name, scalar) for name, arity in OPCODES
        for scalar in ((False, True) if arity >= 2 else (False,))]


@pytest.mark.cuda
@pytest.mark.parametrize("op,scalar", _OPS)
def test_split_pipeline_every_opcode_matches_plain_version(op, scalar):
    """Each opcode on split operands (and a broadcast second operand), its
    result stored in a slot and forwarded from registers."""
    _card()
    from repro_torch.kernels import program as P
    n = 5003
    a, b = _sp_inputs(n, 2, 11)
    a[:6] = torch.tensor([0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1.0])
    c = (b > 0).to(torch.float32)
    arity = P.ARITY[op]
    srcs = [P.operand(P.KIND_INPUT, i) for i in range(3)][:arity]
    bcast = []
    if scalar:
        srcs[1], bcast = P.operand(P.KIND_SCALAR, 0), [0.75]
    stored = P.Program(code=((P.OP[op], 0, *srcs, *([0] * (3 - arity))),), n_split=3,
                       n_bcast=len(bcast), n_slots=1, imms=(),
                       outputs=((P.operand(P.KIND_SLOT, 0), op in P.BOOL_RESULT),))
    for program in (stored, P.forward(stored)):
        _sp_check(program, [a, b, c], bcast, [("concat", "")])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 16, 511, 513, 1023, 1024, 1025, 2047, 2049, 100_003])
def test_split_pipeline_ragged_lengths_match_plain_version(n):
    _card()
    _sp_check(_sp_chain(), _sp_inputs(n, 2, n), [0.7, 0.5], [("concat", "")] * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_split_pipeline_misaligned_views_match_plain_version(offset):
    """Bases off the 16-byte grid take the plain-load path for every tile."""
    _card()
    from repro_torch.kernels import split_pipeline as sp
    ins = _sp_inputs(100_003, 2, offset, offset)
    assert ins[0].data_ptr() % 16 and sp.load_paths(ins, 1024)["bulk"] == 0
    before = dict(sp.split_pipeline.tile_paths)
    _sp_check(_sp_chain(), ins, [0.7, 0.5], [("concat", "")] * 2)
    assert sp.split_pipeline.tile_paths["bulk"] == before["bulk"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1025, 100_003])
@pytest.mark.parametrize("offset", [0, 1])
def test_split_pipeline_bool_inputs_and_outputs_match_plain_version(n, offset):
    _card()
    from repro_torch.kernels import program as P
    v = lambda j: ("v", j)
    program = P.assemble([(P.OP["GT"], [("in", 0), ("sc", 0)]), (P.OP["AND"], [v(0), ("in", 1)]),
                          (P.OP["WHERE"], [("in", 2), ("in", 0), ("sc", 1)]),
                          (P.OP["OR"], [("in", 1), ("in", 2)])],
                         [(v(1), True), (v(2), False), (v(3), True)], n_split=3, n_bcast=2,
                         imms=())
    x, y, z = _sp_inputs(n, 3, n, offset)
    _sp_check(program, [x, y > 0.5, z > -0.5], [0.1, -2.0], [("concat", "")] * 3)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
@pytest.mark.parametrize("n", [1, 1500, 1_000_003])
def test_split_pipeline_reductions_match_plain_version(op, n):
    _card()
    from repro_torch.kernels import program as P
    r = np.random.RandomState(n)
    x = (1.0 + 1e-4 * r.randn(n) if op == "mul" else r.rand(n) - 0.25).astype(np.float32)
    program = P.Program(code=(), n_split=1, n_bcast=0, n_slots=0, imms=(),
                        outputs=((P.operand(P.KIND_INPUT, 0), False),))
    _sp_check(program, [torch.from_numpy(x).cuda()], [], [("reduce", op)])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [511, 513, 100_003])
def test_split_pipeline_sixteen_inputs_and_the_row_limit_match_plain_version(n):
    """16 inputs and 12 outputs (one summed), as the Mozart AdamW stage, and
    a program of 16 inputs and 40 stored slots, the 56-row limit."""
    _card()
    from repro_torch.kernels import program as P
    code, outs = [], []
    for j in range(12):
        code.append((P.OP["MUL"], [("in", j), ("sc", 0)]))
        code.append((P.OP["ADD"], [("v", len(code) - 1), ("in", j + 4)]))
        outs.append((("v", len(code) - 1), False))
    wide = P.assemble(code, outs, n_split=16, n_bcast=1, imms=())
    code = [(P.OP["MUL"], [("in", i % 16), ("sc", i % 4)]) for i in range(40)]
    acc = ("v", 0)
    for i in range(1, 40):
        code.append((P.OP["ADD"], [acc, ("v", i)]))
        acc = ("v", len(code) - 1)
    rows = P.assemble(code, [(acc, False)], n_split=16, n_bcast=4, imms=())
    assert rows.n_split + rows.stored_slots == 56
    ins = _sp_inputs(n, 16, n)
    _sp_check(wide, ins, [0.5], [("reduce", "add")] + [("concat", "")] * 11)
    _sp_check(rows, ins, [0.5, -1.5, 0.25, 2.0], [("concat", "")])


# -- stream ingest: the split-pipeline kernel taking handed-off chunk lists --

#: stream form -> (producer executor, producer batch, consumer batch, n,
#: the ``ctx.stats`` key of the ingest path the ``cuda`` consumer takes).
STREAM_FORMS = {
    "views": ("fused", 4096, 4096, 1 << 16, "cuda_ingest_views"),
    "views_off_grid": ("fused", 4096, 4096, 1 << 16, "cuda_ingest_views"),
    "carry": ("scan", 4096, 4096, 1 << 16, "cuda_ingest_carry"),
    "carry_tail": ("scan", 4096, 4096, (1 << 16) + 3, "cuda_ingest_carry_tail"),
    "concat": ("fused", 4096, 4096, (1 << 16) + 3, "cuda_ingest_concat"),
    "rechunk": ("fused", 6000, 1024, (1 << 16) + 3, "cuda_ingest_concat"),
}


def stream_ingest_case(form: str, device: str):
    """A producer stage on ``fused``/``scan`` leaves its output as a stream
    of the given form; a ``cuda`` stage (``exp``) then ingests it.  Returns
    (consumer output, the plain result, the session).  ``views*``: an
    identity function's chunks are adjacent views of the input (one
    element off the 16-byte grid for ``views_off_grid``)."""
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart, splittable
    from repro_torch.core.split_types import Along

    first, b1, b2, n, _key = STREAM_FORMS[form]
    base = torch.linspace(0.0, 1.0, n + 1, device=device)
    x = base[1:] if form == "views_off_grid" else base[:n]
    ident = splittable(x=Along(0), ret=Along(0), elementwise=True,
                       name="ident")(lambda x: x)
    with mozart.session(executor=first, device=device, batch_elements=b1) as ctx:
        a = ident(x) if form.startswith("views") else anp.multiply(anp.add(x, 1.0), 0.5)
        mozart.evaluate()
        mozart.configure(executor="cuda", batch_elements=b2)
        got = anp.exp(a).value
    want = torch.exp(x if form.startswith("views") else (x + 1.0) * 0.5)
    return got, want, ctx


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(STREAM_FORMS))
def test_split_pipeline_ingests_stream_form(form):
    _card()
    from repro_torch.kernels import split_pipeline as sp
    sp.reset_counts()
    got, want, ctx = stream_ingest_case(form, "cuda")
    torch.cuda.synchronize()
    assert sp.split_pipeline.launches == 1
    assert ctx.stats[STREAM_FORMS[form][4]] == 1
    assert ctx.stats["stream_ingests"] == 1 and ctx.stats.get("stream_materialized", 0) == 0
    assert ctx.stats["cuda_stages"] == 1 and ctx.stats.get("cuda_fallback_stages", 0) == 0
    assert ctx.stats.get("handoff_rechunks", 0) == (1 if form == "rechunk" else 0)
    if form == "views_off_grid":
        assert sp.split_pipeline.tile_paths["bulk"] == 0 < sp.split_pipeline.tile_paths["plain"]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=1e-6)


@pytest.mark.cuda
def test_uint32_reductions_on_the_card():
    """uint8 sums and products accumulate in int64 and cast to uint32 (torch
    has no uint32 sum); the cast and the partials' merge exist on the card."""
    _card()
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart
    x = torch.full((40,), 251, dtype=torch.uint8, device="cuda")
    with mozart.session(executor="fused", batch_elements=7) as ctx:
        s, p = anp.sum(x), anp.prod(x)
        got = (int(s.value), int(p.value))
    assert s.value.dtype == p.value.dtype == torch.uint32
    assert got == (40 * 251, pow(251, 40, 2**32))
    assert ctx.stats["chunks"] == 6          # one stage of both reductions, 40 / 7


@pytest.mark.cuda
def test_warm_pinned_cuda_call_launches_and_lowers_nothing():
    """``mozart.pipeline(fn, executor="cuda")`` compiled once: every warm
    call launches the kernel once per stage with zero planner calls, traces,
    lowerings and builds, and equals the kernel's plain version (the same
    pipeline on CPU copies of the inputs)."""
    _card()
    from repro_torch import workloads as w
    from repro_torch.core import mozart
    from repro_torch.kernels import split_pipeline as sp
    data = w.black_scholes_data(1 << 20, seed=0, device="cuda")
    p = mozart.pipeline(w.black_scholes, executor="cuda")
    p.lower(**data).compile()
    assert p.warm()
    for _ in range(3):
        sp.reset_counts()
        got = p(**data)
        torch.cuda.synchronize()
        st = p.last_call_stats
        assert st.get("planner_calls", 0) == 0 and st["jit_traces"] == 0
        assert st.get("exec_builds", 0) == 0
        assert st["cuda_stages"] == sp.split_pipeline.launches == 1
        assert st.get("cuda_fallback_stages", 0) == 0
    assert p.plan_entry.block_shape[0][1] in sp.TILES
    with mozart.session(executor="cuda", device="cpu") as ctx:
        outs = w.black_scholes(**{k: v.cpu() for k, v in data.items()})
        want = [o.value for o in outs]
    assert ctx.stats["cuda_stages"] == 1
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), v.numpy(), rtol=2e-5,
                                   atol=2e-5 * float(v.abs().max()))


@pytest.mark.cuda
def test_injected_compile_fault_demotes_cuda_then_the_kernel_launches_again(monkeypatch):
    """An injected ``compile`` fault on a pipeline's first call walks the
    reference's ladder, ``cuda -> sharded -> scan`` (no mesh: ``sharded``
    raises), and quarantines both; the calls within
    ``QUARANTINE_TTL`` dispatch ``scan`` (counted skips, no launch), and the
    call after the quarantine ages out launches the kernel again, equal to
    its plain version."""
    _card()
    from repro_torch import workloads as w
    from repro_torch.core import mozart, resilience
    from repro_torch.kernels import split_pipeline as sp
    monkeypatch.setattr(resilience, "QUARANTINE_TTL", 3)
    data = w.black_scholes_data(1 << 20, seed=0, device="cuda")
    p = mozart.pipeline(w.black_scholes, executor="cuda")
    sp.reset_counts()
    with mozart.inject_faults("compile:fail:1") as plan:
        first = p(**data)
    assert plan.fired and p.last_call_stats["exec_demotions"] == 2
    assert p.last_call_stats["exec_demoted_to_sharded"] == 1
    assert p.last_call_stats["exec_demoted_to_scan"] == 1 and sp.split_pipeline.launches == 0
    trail = []
    for _ in range(3):
        got = p(**data)
        torch.cuda.synchronize()
        trail.append((p.last_call_stats.get("exec_quarantine_skips", 0),
                      sp.split_pipeline.launches))
    assert trail == [(1, 0), (1, 0), (0, 1)]
    with mozart.session(executor="cuda", device="cpu"):
        outs = w.black_scholes(**{k: v.cpu() for k, v in data.items()})
        want = [o.value for o in outs]
    for out in (first, got):
        for g, v in zip(out, want):
            np.testing.assert_allclose(g.cpu().numpy(), v.numpy(), rtol=2e-5,
                                       atol=2e-5 * float(v.abs().max()))


# -- the split pipeline at every dtype (ROADMAP B1) ----------------------------

#: the kernel's dtypes other than float32, and the edge sizes of a launch.
TYPED = ["bool", "int8", "int16", "int32", "uint8", "uint16", "uint32", "float16",
         "bfloat16"]
EDGES = [1, 1000, 70001, (1 << 20) + 3]
#: halves: one ulp of the dtype (the kernel and its plain version round the
#: same float32 results; a libm ulp may round the other way).
HALF_RTOL = {torch.float16: 2.0 ** -10, torch.bfloat16: 2.0 ** -7}


def _typed_check(program, ins, bcast, kinds):
    """One launch against the plain version: integers and bools exactly,
    halves within one ulp, float32 as ``_sp_check``."""
    from repro_torch.kernels import split_pipeline as sp
    from repro_torch.kernels.ref import split_pipeline_ref
    before = sp.split_pipeline.launches
    got = sp.split_pipeline(program, ins, bcast, kinds)
    want = split_pipeline_ref(program, ins, bcast, kinds)
    torch.cuda.synchronize()
    assert sp.split_pipeline.launches == before + 1
    for (kind, _op), g, w in zip(kinds, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        if not g.dtype.is_floating_point:
            assert torch.equal(g.cpu(), w.cpu()), (kind, g, w)
            continue
        half = HALF_RTOL.get(g.dtype)
        rtol = (2 * half if kind == "reduce" else half) if half else 2e-5
        if kind == "reduce":
            rtol = max(rtol, 1e-4)       # another summation order
        g, w = g.cpu().double().numpy(), w.cpu().double().numpy()
        finite = np.abs(w[np.isfinite(w)]) if w.ndim else np.abs(w[None][np.isfinite(w[None])])
        atol = rtol * float(finite.max()) if finite.size else 0.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True)


def _typed_data(dname, n, seed):
    r = np.random.RandomState(seed)
    if dname == "bool":
        return [torch.from_numpy(r.rand(n) > 0.5) for _ in range(2)]
    if dname in ("float16", "bfloat16"):
        return [torch.from_numpy((r.randn(n) * 3).astype(np.float32)).to(getattr(torch, dname))
                for _ in range(2)]
    lo = 0 if dname.startswith("uint") else -200
    x = r.randint(lo, 250, n)
    y = r.randint(lo, 13, n)
    y[::7] = 0                           # integer mod by zero gives 0
    return [torch.from_numpy(v.astype(np.int64)).to(getattr(torch, dname)) for v in (x, y)]


def _typed_chain(anp, dname):
    """A chain per dtype that wraps narrow integers, rounds halves, mods by
    zero and compares, with a reduction and a concat output."""
    if dname == "bool":
        def run(x, y):
            b = anp.logical_or(anp.logical_and(x, y), anp.logical_not(y))
            return b, anp.sum(b), anp.max(anp.add(x, y))
        return run
    if dname in ("float16", "bfloat16"):
        def run(x, y):
            t = anp.add(anp.exp(anp.multiply(x, 0.1)), anp.mod(y, 1.5))
            return anp.where(anp.greater(x, y), t, anp.sqrt(anp.abs(y))), anp.sum(t)
        return run

    def run(x, y):
        b = anp.add(anp.multiply(x, 3), 117)
        m = anp.mod(b, y)
        return m, anp.sum(b), anp.max(anp.where(anp.greater(b, y), m, y))
    return run


def _typed_launch(dname, n, seed):
    """The chain lowered on the CPU (the ``cuda`` executor's program) and its
    inputs moved to the card."""
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import cuda_exec, mozart
    data = dict(zip("xy", _typed_data(dname, n, seed)))
    with mozart.session(executor="cuda", device="cpu") as ctx:
        outs = _typed_chain(anp, dname)(**data)
        stage = ctx.last_plan()[0]
        concrete = {k: ctx.graph.resolve(si.value) for k, si in stage.inputs.items()}
        program, ins, bcast, kinds = cuda_exec.prepare_launch(stage, concrete, ctx)
        del outs
    return program, [x.cuda() for x in ins], bcast, kinds


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGES)
@pytest.mark.parametrize("dname", TYPED)
def test_split_pipeline_typed_chain_matches_plain_version(dname, n):
    _card()
    _typed_check(*_typed_launch(dname, n, n))


def _typed_opcodes():
    from repro_torch.kernels import program as P
    cases = []
    for dname in TYPED[1:]:
        code = P.CODE[getattr(torch, dname)]
        for name, arity in P.OPCODES:
            if name in ("CAST", "WHERE") or (name in P.FLOAT_ONLY and P.CLASS[code] != P.FLOAT):
                continue
            cases.append((dname, name))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dname,op", _typed_opcodes())
def test_split_pipeline_every_opcode_at_every_dtype_matches_plain_version(dname, op):
    """Each opcode computing in each dtype, stored and forwarded."""
    _card()
    from repro_torch.kernels import program as P
    code = P.CODE[getattr(torch, dname)]
    x, y = _typed_data(dname, 5003, 3)
    if op == "POW":                                     # small exponents
        y = (y.to(torch.int64) % 5).to(y.dtype) if not y.dtype.is_floating_point else y
    x, y = x.cuda(), y.cuda()
    arity = P.ARITY[op]
    srcs = [P.operand(P.KIND_INPUT, i) for i in range(arity)]
    rdt = P.BOOL if op in P.BOOL_RESULT else code
    stored = P.Program(code=((P.OP[op], 0, *srcs, *([0] * (3 - arity))),), n_split=2,
                       n_bcast=0, n_slots=1, imms=(),
                       outputs=((P.operand(P.KIND_SLOT, 0), rdt == P.BOOL),),
                       types=((code, rdt),), in_dtypes=(code, code), out_dtypes=(rdt,))
    for program in (stored, P.forward(stored)):
        _typed_check(program, [x, y], [], [("concat", "")])


@pytest.mark.cuda
@pytest.mark.parametrize("src", ["float32"] + TYPED)
def test_split_pipeline_casts_match_plain_version(src):
    """CAST from one dtype to every other, on values inside every target's
    range (a float out of range converts as the platform does)."""
    _card()
    from repro_torch.kernels import program as P
    r = np.random.RandomState(5)
    vals = r.randint(0, 100, 4099).astype(np.float32) + (0.25 if "float" in src else 0.0)
    vals[::3] = 0.0
    x = torch.from_numpy(vals).to(getattr(torch, src)).cuda()
    s = P.CODE[x.dtype]
    for d in range(len(P.DTYPES)):
        program = P.Program(code=((P.OP["CAST"], P.NO_STORE | 0, P.operand(P.KIND_INPUT, 0),
                                   0, 0),), n_split=1, n_bcast=0, n_slots=1, imms=(),
                            outputs=((P.operand(P.KIND_FWD, 0), d == P.BOOL),),
                            types=((s, d),), in_dtypes=(s,), out_dtypes=(d,))
        _typed_check(program, [x], [], [("concat", "")])


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "max", "min", "mul"])
@pytest.mark.parametrize("dname", ["int32", "uint32", "float16", "bfloat16"])
def test_split_pipeline_typed_reductions_match_plain_version(dname, op):
    """Per-CTA partials in the accumulator's class (a wrapped 32-bit
    integer, or float32 rounded once at the end) at the edge sizes."""
    _card()
    from repro_torch.kernels import program as P
    code = P.CODE[getattr(torch, dname)]
    for n in EDGES:
        x = _typed_data(dname, n, n)[0]
        if op == "mul":                  # factors near 1: a product that stays finite
            x = (1 + x.float() * 1e-3).to(x.dtype) if x.dtype.is_floating_point else \
                (x.to(torch.int64) % 3 + 1).to(x.dtype)
        program = P.Program(code=(), n_split=1, n_bcast=0, n_slots=0, imms=(),
                            outputs=((P.operand(P.KIND_INPUT, 0), False),),
                            in_dtypes=(code,), out_dtypes=(code,))
        _typed_check(program, [x.cuda()], [], [("reduce", op)])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("dname", ["uint8", "int16", "bfloat16"])
def test_split_pipeline_narrow_misaligned_views_match_plain_version(dname, offset):
    """1- and 2-byte inputs off the 16-byte grid take plain loads."""
    _card()
    from repro_torch.kernels import split_pipeline as sp
    program, ins, bcast, kinds = _typed_launch(dname, 100_003 + offset, 7)
    views = [torch.empty(x.numel() + offset, dtype=x.dtype, device="cuda")[offset:].copy_(x)
             for x in ins]
    assert sp.load_paths(views, 1024)["bulk"] == 0
    _typed_check(program, views, bcast, kinds)


# -- banded attention and the library integrations (ROADMAP A7.5, A9) ---------


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", [
    (2, 4, 4, 1100, 128, 256),     # S > 2w, a ragged last band
    (1, 4, 2, 2048, 256, 512),     # gemma's head dim, GQA
    (1, 2, 2, 700, 256, 300),      # a window that is no multiple of a tile
])
def test_flash_attention_window_matches_the_banded_path(B, Hq, Hkv, S, D, window):
    """The tc kernel's window mask (keys in (q - w, q]) against the model's
    banded path, which a banded config would take instead, on the model's
    head-split views in its head order (``attention._kernel_attention``)."""
    _card()
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.models import attention
    q, k, v = (_head_split(B, H, S, D, torch.bfloat16, seed)
               for H, seed in ((Hq, 1), (Hkv, 2), (Hkv, 3)))
    before = dict(fl.flash_attention.variant_launches)
    got = attention._kernel_attention(q, k, v, causal=True, window=window)
    want = attention._banded_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fl.flash_attention.variant_launches["tc"] == before["tc"] + 1
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **TOL[torch.bfloat16])
    rel = float((got.double() - want.double()).norm() / want.double().norm())
    assert rel <= 1e-2, rel


def _lib_case(name):
    """(annotated op, its arguments on ``device``) for one op of each library."""
    from repro_torch import workloads as w
    from repro_torch.core import annotated_image as img
    from repro_torch.core import annotated_nlp as nlp
    from repro_torch.core import annotated_table as tb
    r = np.random.RandomState(5)
    if name == "groupby_agg":
        t = w.crime_table(100_003, device="cpu")
        return tb.groupby_agg, lambda dev: dict(
            t=tb.Table({k: c.to(dev) for k, c in t.cols.items()}), key="city", val="crime",
            op="max")
    if name == "groupby_agg_nan":
        keys = r.randint(0, 50, 100_003).astype(np.float64)
        keys[r.rand(100_003) < 0.1] = np.nan
        t = tb.Table({"city": torch.from_numpy(keys),
                      "crime": torch.from_numpy(r.rand(100_003))})
        return tb.groupby_agg, lambda dev: dict(
            t=tb.Table({k: c.to(dev) for k, c in t.cols.items()}), key="city", val="crime",
            op="count")
    if name == "pos_tag_out_of_range":
        toks = torch.from_numpy(r.randint(-10_000, 10_000, (3001, 64)).astype(np.int32))
        c = nlp.Corpus(toks, torch.full((3001,), 64, dtype=torch.int32))
        emb = torch.from_numpy(r.randn(5000, 32).astype(np.float32))
        head = torch.from_numpy(r.randn(32, 17).astype(np.float32))
        return nlp.pos_tag, lambda dev: dict(corpus=nlp.Corpus(c.tokens.to(dev),
                                                               c.lengths.to(dev)),
                                             emb=emb.to(dev), head=head.to(dev))
    if name == "modulate":
        im = w.image(301, 257, device="cpu")
        return img.modulate, lambda dev: dict(img=im.to(dev), brightness=120.0,
                                              saturation=10.0, hue=130.0)
    c = nlp.make_corpus(3001, 64, 5000, seed=1, device="cpu")
    emb = torch.from_numpy(r.randn(5000, 32).astype(np.float32))
    head = torch.from_numpy(r.randn(32, 17).astype(np.float32))
    return nlp.pos_tag, lambda dev: dict(corpus=nlp.Corpus(c.tokens.to(dev), c.lengths.to(dev)),
                                         emb=emb.to(dev), head=head.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("executor", ["eager", "pipelined", "cuda"])
@pytest.mark.parametrize("name", ["groupby_agg", "modulate", "pos_tag", "groupby_agg_nan",
                                  "pos_tag_out_of_range"])
def test_library_op_on_the_card_matches_the_cpu(name, executor):
    """One op of each integration on CUDA tensors against the same op on
    CPU tensors (results on the card, dtypes equal; group keys, counts and
    tags exactly but for tag near-ties, float64 extrema exactly, float32
    images within 2e-5); on ``cuda`` the stage falls back to ``fused``.
    ``groupby_agg_nan``: float64 keys with NaNs form one NaN group, last,
    also against numpy (ROADMAP C11; ``torch.unique`` on CUDA is another
    implementation); ``pos_tag_out_of_range``: ids outside the vocabulary
    wrap once and clamp, with no device assert (ROADMAP C12)."""
    _card()
    from repro_torch.core import mozart
    fn, args = _lib_case(name)
    out = {}
    for dev in ("cpu", "cuda"):
        with mozart.session(executor=executor, device=dev, batch_elements=4096) as ctx:
            out[dev] = fn(**args(dev)).value
        if executor == "cuda":
            assert ctx.stats["cuda_fallback_stages"] == ctx.stats["stages"] == 1
    got, want = out["cuda"], out["cpu"]
    if name == "groupby_agg_nan":
        keys = args("cpu")["t"].cols["city"].numpy()
        nan = np.isnan(keys)
        uniq = np.append(np.unique(keys[~nan]), np.nan)
        np.testing.assert_array_equal(got.cols["city"].cpu().numpy(), uniq)
        np.testing.assert_array_equal(
            got.cols["count"].cpu().numpy(),
            [int((keys == k).sum()) for k in uniq[:-1]] + [int(nan.sum())])
    if name.startswith("groupby_agg"):
        assert all(c.is_cuda for c in got.cols.values())
        for k in want.cols:
            assert got.cols[k].dtype == want.cols[k].dtype
            np.testing.assert_array_equal(got.cols[k].cpu().numpy(), want.cols[k].numpy())
    elif name == "modulate":
        assert got.is_cuda and got.dtype == want.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    else:
        assert got.is_cuda and got.dtype == want.dtype == torch.int32
        assert float((got.cpu() != want).float().mean()) < 1e-4


@pytest.mark.cuda
def test_verify_sweep_on_the_card_matches_the_cpu():
    """``mozart.verify()`` on the card: every probe value on the card, no
    error, and the CPU sweep's ``checked`` and (code, severity, subject)
    multiset."""
    _card()
    import collections
    from repro_torch.core import analysis, mozart
    probes = analysis.builtin_probes()
    leaves = [l for p in probes for v in (p.value, p.pieces, p.reference) if v is not None
              for l in torch.utils._pytree.tree_leaves(v) if isinstance(l, torch.Tensor)]
    assert leaves and all(l.is_cuda for l in leaves)
    rep, cpu = mozart.verify(), mozart.verify(device="cpu")

    def multiset(r):
        return collections.Counter((d.code, d.severity, d.subject) for d in r.diagnostics)

    assert rep.ok and not rep.warnings, rep.render()
    assert rep.checked == cpu.checked == 83 and multiset(rep) == multiset(cpu)


@pytest.mark.cuda
def test_verify_pipeline_on_the_card_launches_nothing():
    """``mozart.verify(black_scholes, ..., executor="cuda")`` on card data:
    no kernel launch, no plan-cache entry, no memory left allocated; a
    ``cuda`` session on the same inputs then launches once per stage the
    verifier walked, and the session's rewrite records carry the codes
    the verifier reported."""
    _card()
    from repro_torch import workloads as w
    from repro_torch.core import mozart, plan_cache
    from repro_torch.kernels import split_pipeline as sp
    data = w.black_scholes_data(1 << 20, device="cuda")
    launches, mem = sp.split_pipeline.launches, torch.cuda.memory_allocated()
    rep = mozart.verify(w.black_scholes, *data.values(), executor="cuda")
    assert rep.ok, rep.render()
    assert sp.split_pipeline.launches == launches
    assert plan_cache.cache_info()["entries"] == 0
    assert torch.cuda.memory_allocated() == mem
    with mozart.session(executor="cuda") as ctx:
        call, put = w.black_scholes(**data)
        call.value, put.value
    assert ctx.stats["stages"] == rep.checked == sp.split_pipeline.launches - launches
    assert sorted(d.code for d in rep.diagnostics if d.code.startswith("MZ5")) == \
        sorted(r.code for r in ctx._last_rewrites)


# -- the boundary sanitizer (MOZART_SANITIZE=1) --------------------------------


def _card_chain(executor, n=1 << 20, batch=None):
    """The smoke/handoff chain on the card: three evaluations of
    ``multiply(add(x, 1.0), 0.5)``; a ``cuda`` row's first on ``fused``."""
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart
    from repro_torch.kernels import split_pipeline as sp
    first = "fused" if executor == "cuda" else executor
    x = torch.linspace(0.1, 2.0, n, device="cuda")
    before = sp.split_pipeline.launches
    with mozart.session(executor=first, handoff=True, batch_elements=batch,
                        plan_cache=False, autotune=False) as ctx:
        cur = x
        for i in range(3):
            cur = anp.multiply(anp.add(cur, 1.0), 0.5)
            mozart.evaluate()
            if i == 0 and first != executor:
                mozart.configure(executor=executor)
        out = cur.value
    torch.cuda.synchronize()
    return out, ctx, sp.split_pipeline.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("executor", ["fused", "scan", "cuda"])
def test_sanitized_handoff_chain_on_the_card_equals_unsanitized(monkeypatch, executor):
    """Same values, the same counters and the same split-pipeline launches
    with the sanitizer on; no trip."""
    _card()
    monkeypatch.setenv("MOZART_SANITIZE", "0")
    plain, plain_ctx, plain_launches = _card_chain(executor, batch=1 << 17)
    monkeypatch.setenv("MOZART_SANITIZE", "1")
    got, ctx, launches = _card_chain(executor, batch=1 << 17)
    assert got.is_cuda and torch.equal(got, plain)
    assert dict(ctx.stats) == dict(plain_ctx.stats)
    assert launches == plain_launches == (2 if executor == "cuda" else 0)
    assert ctx.stats["stream_ingests"] > 0


@pytest.mark.cuda
def test_each_sanitizer_code_is_raised_with_card_tensors(monkeypatch):
    """MZ301: a scan carry released by a real ``cuda`` launch, read again;
    MZ302: a holed stream of card chunks; MZ303: a corrupted scope; and a
    trip inside a ``cuda`` stage leaves the session undemoted."""
    _card()
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart, resilience
    from repro_torch.core import split_types as st
    from repro_torch.core import stage_exec as se
    from repro_torch.kernels import split_pipeline as sp
    monkeypatch.setenv("MOZART_SANITIZE", "1")
    resilience.clear_events()
    x = torch.linspace(0.1, 2.0, 1 << 20, device="cuda")
    before = sp.split_pipeline.launches
    with mozart.session(executor="scan", batch_elements=1 << 17) as ctx:
        a = anp.multiply(anp.add(x, 1.0), 0.5)
        mozart.evaluate()
        stream = a._node.result
        mozart.configure(executor="cuda")
        b = anp.add(a, 1.0)
        del a
        mozart.evaluate()
        assert sp.split_pipeline.launches == before + 1
        assert ctx.stats["cuda_ingest_carry"] == 1 and stream.consumed
        with pytest.raises(se.SanitizerError, match=r"MZ301.*stage \d+ input"):
            stream.materialize()
        assert torch.allclose(b.value, x * 0.5 + 1.5)

    t = st.ArraySplit((6, 2), 0)
    y = torch.arange(12, dtype=torch.float32, device="cuda").reshape(6, 2)
    holed = se.ChunkStream([y[:2], y[3:]], [(0, 2), (3, 6)], t, st.aval_of(y))
    with pytest.raises(se.SanitizerError, match=r"MZ302.*do not tile"):
        se._check_stream_tiles(holed, t, "stage 1 input ('x', 0)")

    c = se.BoundaryCounters()
    with pytest.raises(se.SanitizerError, match=r"MZ303"):
        with se.counter_scope(c):
            c.interior += int(y.nbytes)

    def trips(*args, **kw):
        raise se.SanitizerError("[MZ302] planted in a cuda stage")
    monkeypatch.setattr(sp, "_launch", trips)
    with pytest.raises(se.SanitizerError, match="planted"):
        with mozart.session(executor="cuda") as ctx:
            anp.sum(anp.exp(x)).value
    assert ctx.stats.get("exec_demotions", 0) == 0
    assert resilience.stats["MZ402"] == 0


# ---------------------------------------------------------------------------
# The sharded executor on a one-rank NCCL mesh (the multi-rank collectives
# are held on the CPU by tests/test_torch_sharded*.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _end_process_group():
    """The one-rank NCCL group the sharded tests start ends with the module."""
    yield
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _card_mesh():
    _card()
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh()


@pytest.mark.cuda
def test_sharded_black_scholes_on_a_one_rank_nccl_mesh_equals_fused():
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch import workloads as w
    from repro_torch.core import mozart
    mesh = _card_mesh()
    data = w.black_scholes_data(1 << 20, seed=0, device="cuda")
    with mozart.session(executor="fused", batch_elements=1 << 16):
        want = [o.value for o in w.black_scholes(**data)]
    with mozart.session(executor="sharded", mesh=mesh, batch_elements=1 << 16) as ctx:
        outs = w.black_scholes(**data)
        mozart.evaluate()
        raw = [o._node.result for o in outs]
        got = [o.value for o in outs]
    assert ctx.stats["sharded_stages"] == ctx.stats["stages"] >= 1
    for r, g, wv in zip(raw, got, want):
        assert isinstance(r, DTensor) and r.placements[0] == Shard(0)
        assert r.to_local().is_cuda and tuple(r.to_local().shape) == (1 << 20,)
        np.testing.assert_allclose(g.cpu().numpy(), wv.cpu().numpy(), rtol=2e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", S.REDUCE_CASES,
                         ids=[f"{n}-{d}" for n, d in S.REDUCE_CASES])
def test_sharded_reduction_through_nccl_equals_fused(name, dtype):
    """Each op on each input dtype of the CPU worlds (``REDUCE_CASES``):
    the partial through NCCL (int16, uint16 and uint32 widened on the wire,
    bools as bytes) equals ``fused``; floats but float16 (exact here)
    within tolerance."""
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart
    mesh = _card_mesh()
    x = torch.from_numpy(S.reduce_input(dtype)).to("cuda")
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    n = x.numel()
    with mozart.session(executor="fused", batch_elements=n // 8):
        want = getattr(anp, name)(x).value
    with mozart.session(executor="sharded", mesh=mesh, batch_elements=n // 8) as ctx:
        got = getattr(anp, name)(x).value
    assert ctx.stats["sharded_stages"] == 1 and got.is_cuda and got.dtype == want.dtype
    if dtype in ("bfloat16", "float32"):
        torch.testing.assert_close(got, want, rtol=2e-2 if dtype == "bfloat16" else 2e-5,
                                   atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_sharded_to_cuda_handoff_launches_the_split_pipeline():
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart
    from repro_torch.kernels import split_pipeline as sp
    mesh = _card_mesh()
    x = torch.linspace(0.0, 1.0, 1 << 20, device="cuda")
    before = sp.split_pipeline.launches
    with mozart.session(executor="sharded", mesh=mesh) as ctx:
        a = anp.multiply(anp.add(x, 1.0), 0.5)
        mozart.evaluate()
        mozart.configure(executor="cuda")
        b = anp.multiply(anp.add(a, 1.0), 0.5)
        got = b.value
    assert ctx.stats["sharded_stages"] == 1 and ctx.stats["cuda_stages"] == 1
    assert sp.split_pipeline.launches == before + 1
    torch.testing.assert_close(got, ((x + 1.0) * 0.5 + 1.0) * 0.5, rtol=2e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# ZeRO-1 on a one-rank NCCL mesh (the reduce-scatter, the gathers and the
# ranks' agreement are held on 2 and 4 gloo ranks by tests/test_torch_zero1.py)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_zero1_sharded_update_kernel_path_equals_plain_path():
    """The sharded update of gemma-7b's smoke config on step 1's reduced
    gradients: ``path="kernel"`` launches the fused AdamW kernel once per
    leaf on the local shard and gives the ``jnp`` path's parameters
    (float32 rtol 2e-5, bfloat16 within one ulp) and moments (rtol 2e-5);
    the moments are card ``DTensor``s with the ZeRO-1 placements."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import train as T
    from repro_torch.models import data_parallel, lm, weights
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    mesh = _card_mesh()
    cfg = get_smoke_config("gemma-7b")
    model = tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    zero = T.zero1_layout(mesh, model)
    state = adamw.init_sharded(weights.leaves(model), zero)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = DataPipeline(cfg, 2, 32, seed=0, device="cuda").batch_for_step(0)
    with data_parallel.use(zero.dg):
        lm.loss_fn(model, batch, cfg).backward()
    params = weights.leaves(model)
    shards = {n: zero.reduce_scatter(p.grad, n) for n, p in params.items()}
    before = fa.fused_adamw.launches
    kp, ks, _ = adamw.update_sharded(params, shards, state, opt, zero, "kernel")
    torch.cuda.synchronize()
    assert fa.fused_adamw.launches == before + len(params)
    jp, js, _ = adamw.update_sharded(params, shards, state, opt, zero, "jnp")
    for n, p in params.items():
        for moments in (ks.m, ks.v):
            assert isinstance(moments[n], DTensor) and moments[n].to_local().is_cuda
            assert moments[n].placements == zero.placements[n]
        rtol = 2.0 ** -7 if p.dtype == torch.bfloat16 else 2e-5
        np.testing.assert_allclose(kp[n].float().cpu().numpy(), jp[n].float().cpu().numpy(),
                                   rtol=rtol, atol=2e-5, err_msg=n)
        for a, b in ((ks.m[n], js.m[n]), (ks.v[n], js.v[n])):
            np.testing.assert_allclose(a.to_local().cpu().numpy(), b.to_local().cpu().numpy(),
                                       rtol=2e-5, atol=1e-9, err_msg=n)


@pytest.mark.cuda
def test_zero1_moe_remat_recompute_on_the_device_thread_sees_the_data_group():
    """olmoe's smoke config (remat on) under the one-rank data group on the
    card: CUDA's autograd engine runs the backward, and each layer's
    recompute, on its device thread, and every ``route`` call there, as in
    the forward, sees the group (a per-thread group would be missing
    there, so the recompute would route with local statistics)."""
    import threading

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import train as T
    from repro_torch.models import data_parallel, lm, mlp
    from repro_torch.models import transformer as tfm
    mesh = _card_mesh()
    cfg = get_smoke_config("olmoe-1b-7b")
    assert cfg.remat
    model = tfm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    dg = T.data_group(mesh)
    batch = DataPipeline(cfg, 2, 32, seed=0, device="cuda").batch_for_step(0)
    caller, calls = threading.current_thread(), []
    real = mlp.route

    def spy(p, xt, c, g=None):
        calls.append((threading.current_thread() is caller, g is dg))
        return real(p, xt, c, g)

    mlp.route = spy
    try:
        with data_parallel.use(dg):
            loss = lm.loss_fn(model, batch, cfg)
            assert len(calls) == cfg.n_layers
            loss.backward()
        torch.cuda.synchronize()
    finally:
        mlp.route = real
    assert len(calls) == 2 * cfg.n_layers, calls
    assert all(saw for _on_caller, saw in calls), calls
    assert not any(on_caller for on_caller, _saw in calls[cfg.n_layers:]), calls


# ---------------------------------------------------------------------------
# Tensor parallelism over "model" on two ranks of one card (the ranks'
# agreement with the reference is held on gloo CPU worlds by
# tests/test_torch_tp*.py); C14 and C15 on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_tp_step_on_two_ranks_of_the_card_matches_the_mesh_free_step(tmp_path):
    """One tensor-parallel step of gemma-7b's smoke config in float32 on a
    (1, 2) mesh, two spawned ranks on ``cuda:0`` in a ``gloo`` group: the
    loss within 2e-5 relative of the mesh-free ``make_train_step``'s, the
    fused AdamW kernel once per leaf on each rank's slices, and the kernel
    path's new slices within 2e-5 relative of the plain path's."""
    _card()
    import pickle

    import torch.multiprocessing as mp
    import tp_scenarios as TP
    mp.start_processes(TP.card_rank, args=(str(tmp_path / "store"), str(tmp_path), 300.0),
                       nprocs=2, start_method="spawn")
    ranks = []
    for r in range(2):
        with open(tmp_path / f"card{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    want = ranks[0]["mesh_free_loss"]
    for res in ranks:
        for path in ("jnp", "kernel"):
            assert res[path]["cuda"]
            np.testing.assert_allclose(res[path]["loss"], want, rtol=2e-5)
        assert res["jnp"]["launches"] == 0
        assert res["kernel"]["launches"] == res["leaves"]
        assert res["kernel_vs_jnp"] < 2e-5, res["kernel_vs_jnp"]


@pytest.mark.cuda
def test_expert_parallel_block_on_two_ranks_of_the_card_matches_the_mesh_free_block(tmp_path):
    """The expert-parallel MoE dispatch (``models.shard_ctx`` installed as
    the reference's ``dryrun.py`` installs it) of smoke olmoe-1b-7b in
    float32 on a (1, 2) mesh, two spawned ranks on ``cuda:0`` in a
    ``gloo`` group, at the default capacity factor (the routing drops):
    each rank's output, aux loss and gradients (its F slices gathered)
    within 2e-5 of the mesh-free block on the permuted tokens."""
    _card()
    import pickle

    import torch.multiprocessing as mp
    import ep_scenarios as EP
    mp.start_processes(EP.card_rank, args=(str(tmp_path / "store"), str(tmp_path), 300.0),
                       nprocs=2, start_method="spawn")
    for r in range(2):
        with open(tmp_path / f"ep{r}.pkl", "rb") as f:
            res = pickle.load(f)
        got, want = res["got"], res["want"]
        assert res["cuda"] and 0 < got["dropped"] < got["routed"], got["dropped"]
        np.testing.assert_allclose(got["out"], want["out"], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=2e-5)
        assert set(got["grads"]) == set(want["grads"])
        for n, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][n], g, rtol=2e-5, atol=2e-5, err_msg=n)


@pytest.mark.cuda
def test_tp_on_four_cards_with_nccl_matches_the_mesh_free_run(tmp_path):
    """On four cards, one rank each in an NCCL group: ``train(mesh=
    make_host_mesh(2, 2))`` of gemma-7b's smoke config in float32 (model
    slices cut again by data, checkpoints gathered to rank 0 by NCCL) gives
    the mesh-free ``train()``'s losses within 2e-5 relative, and a resume
    from its step-2 checkpoint gives step 3's loss and slices bit for bit.
    Skips with fewer than four cards."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    import pickle

    import torch.multiprocessing as mp
    import tp_scenarios as TP
    mp.start_processes(TP.cards_rank, args=(4, str(tmp_path / "store"), str(tmp_path), 300.0),
                       nprocs=4, start_method="spawn")
    ranks = []
    for r in range(4):
        with open(tmp_path / f"cards{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    want = ranks[0]["mesh_free"]
    for res in ranks:
        assert res["backend"] == "nccl"
        np.testing.assert_allclose(res["losses"], want, rtol=2e-5)
        assert res["resumed"] == res["losses"][-1:] and res["params_equal"], res["resumed"]
        assert res["slices"]["layers.mlp.w_in"] == (2, 64, 128)
    assert all(res["losses"] == ranks[0]["losses"] for res in ranks)


@pytest.mark.cuda
@pytest.mark.parametrize("dname", ["uint16", "uint32"])
def test_unsigned_arithmetic_on_the_cuda_executor_wraps(dname):
    """C14 on the card: uint16/uint32 ``add``, ``subtract``, ``multiply``,
    ``mod`` (a zero divisor gives 0), ``square``, ``abs``, ``sign`` and
    ``negative`` on the ``cuda`` executor (the split-pipeline kernel) and on
    ``fused`` (torch's ops, widened where CUDA has none) against int64
    masked to the width, values near the top so that they wrap."""
    _card()
    from repro_torch.core import annotated_numpy as anp
    from repro_torch.core import mozart
    dtype, bits = getattr(torch, dname), (16 if dname == "uint16" else 32)
    hi, n = 1 << bits, 70001
    gen = torch.Generator(device="cuda").manual_seed(bits)
    x64 = torch.cat([torch.randint(hi - 64, hi, (n // 2,), generator=gen, device="cuda"),
                     torch.randint(0, 64, (n - n // 2,), generator=gen, device="cuda")])
    y64 = torch.randint(0, hi, (n,), generator=gen, device="cuda")
    y64[::5] = 0
    mask = hi - 1
    want = {"add": (x64 + y64) & mask, "subtract": (x64 - y64) & mask,
            "multiply": (x64 * y64) & mask,
            "mod": torch.where(y64 == 0, 0, torch.remainder(x64, torch.where(y64 == 0, 1, y64))),
            "square": (x64 * x64) & mask, "abs": x64, "sign": (x64 != 0).long(),
            "negative": (-x64) & mask}
    for executor in ("cuda", "fused"):
        for op, w in want.items():
            with mozart.session(executor=executor, plan_cache=False, autotune=False) as ctx:
                args = (x64.to(dtype),) if op in ("square", "abs", "sign", "negative") \
                    else (x64.to(dtype), y64.to(dtype))
                got = getattr(anp, op)(*args).value
            assert got.dtype == dtype and torch.equal(got.long(), w), (executor, op)
            if executor == "cuda":
                assert ctx.stats["cuda_stages"] == 1, (op, dict(ctx.stats))
                assert ctx.stats.get("cuda_fallback_stages", 0) == 0, (op, dict(ctx.stats))


@pytest.mark.cuda
def test_retry_after_an_out_of_memory_starts_with_the_memory_released():
    """C15 on the card: an attempt holding 1 GiB raises an injected
    ``torch.OutOfMemoryError``; at the retry's start ``memory_allocated``
    is back to its value before the attempt."""
    _card()
    from repro_torch.core.resilience import with_retries
    torch.cuda.empty_cache()
    before, seen = torch.cuda.memory_allocated(), []

    def step():
        if seen:
            seen.append(torch.cuda.memory_allocated())
            return "retried"
        held = torch.ones(1 << 28, device="cuda")
        seen.append(torch.cuda.memory_allocated())
        raise torch.OutOfMemoryError(f"injected with {held.numel() * 4} bytes held")
    assert with_retries(step, retries=1) == "retried"
    assert seen[0] - before >= 1 << 30 and seen[1] == before, (before, seen)

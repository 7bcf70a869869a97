"""Tensor-parallel prefill and decode over ``"model"`` held against the
reference's prefill and decode jitted with ``param_specs`` /
``cache_specs`` shardings (``tp_serve_scenarios.py`` holds the cases, run
by both packages): this file's two-rank world serves gemma-7b,
internlm2-20b (grouped KV heads, whole on every rank) and granite-34b (one
KV head, its ``wk``/``wv`` gathered) on a (1, 2) mesh;
``test_torch_tp_serve_vlm.py`` gemma3-4b and qwen2-vl-2b,
``test_torch_tp_serve_moe.py`` the MoE families and the expert-parallel
MoE, ``test_torch_tp_serve_families.py`` the hybrid and RWKV families and
``test_torch_tp_serve_encdec.py`` the encoder-decoder and a padded
vocabulary on (1, 2); ``test_torch_tp_serve_mesh.py`` and
``test_torch_tp_serve_mesh_inputs.py`` (2, 2), and
``test_torch_tp_serve_wide.py`` (1, 4).  Float32, the smoke configs with
``launch/dryrun.py``'s knobs (``kv_cache_blocks`` the ``"model"`` extent).

Held per case and rank: the prefill logits of the rank's data rows and the
logits of three decode steps fed the reference's greedy tokens within
1e-4 x max|ref logits| (about 10x the 1.14e-5 by which the reference's own
sharded and mesh-free runs differ); each rank's cache pieces after prefill
and after decode within ``TOL`` f32 (2e-5 absolute) of the reference's
cache cut as ``cache_specs`` places it (``weights.cache_piece``), their
local shapes, and the pieces assembled (``weights.cache_assemble``) against
the whole; the same decode steps from the reference's prefill cache
carried across (decode alone); the greedy tokens of ``lm.greedy_generate``
equal to the reference's (the argmaxes of its prefill and decode chain,
which the reference's sharded and mesh-free runs share).
"""

import numpy as np
import pytest
import torch

import tp_serve_scenarios as TS
from test_torch_tp import run_world

LOGIT_RTOL, CACHE_ATOL = 1e-4, 2e-5


def _leaves(tree) -> list:
    return TS._leaves(tree)


def _close_logits(got, want, what):
    bound = LOGIT_RTOL * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max |diff| {err:.3e} > {bound:.3e}"


def _close_cache(got, want, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=CACHE_ATOL, err_msg=f"{what} leaf {i}")


def _mesh(name):
    from repro_torch.launch.mesh import AbstractMesh
    return AbstractMesh(TS.CASES[name][1], TS.AXES)


def _want_piece(ref_cache, name, coord):
    from repro_torch.models import weights
    return weights.cache_to_numpy(weights.cache_piece(ref_cache, TS.torch_cfg(name), _mesh(name),
                                                      coord, "cpu"))


def _rows(a, name, index):
    n = TS.CASES[name][1][0]
    return np.split(np.asarray(a), n)[index]


def check_case(world, name):
    """Every rank's logits, cache pieces and tokens against the
    reference's; the pieces' shapes; the pieces assembled."""
    from repro_torch.models import weights
    ref, ranks = world
    want = ref[name]
    cfg = TS.torch_cfg(name)
    shape = TS.CASES[name][1]
    for r, res in enumerate(ranks):
        got = res[name]
        what = f"{name} rank {r}"
        _close_logits(got["prefill_logits"], _rows(want["prefill_logits"], name, got["rows"]),
                      f"{what} prefill")
        for i, (g, w) in enumerate(zip(got["decode_logits"], want["decode_logits"])):
            _close_logits(g, _rows(w, name, got["rows"]), f"{what} decode step {i + 1}")
        for i, (g, w) in enumerate(zip(got["alone_logits"], want["decode_logits"])):
            _close_logits(g, _rows(w, name, got["rows"]), f"{what} decode alone step {i + 1}")
        for key in ("prefill_cache", "decode_cache"):
            _close_cache(got[key], _want_piece(want[key], name, got["coord"]), f"{what} {key}")
        _close_cache(got["alone_cache"], _want_piece(want["decode_cache"], name, got["coord"]),
                     f"{what} alone_cache")
        assert got["local_shapes"] == [a.shape for a in _leaves(got["prefill_cache"])]
        if "greedy" in want:
            np.testing.assert_array_equal(got["greedy"], _rows(want["greedy"], name, got["rows"]),
                                          err_msg=what)
        else:                            # an encoder-decoder: no greedy loop, as the reference
            assert got["greedy_error"] == "AttributeError", got["greedy_error"]
    for key in ("prefill_cache", "decode_cache"):
        pieces = {res[name]["coord"]: weights.cache_from_numpy(res[name][key], cfg, "cpu")
                  for res in ranks}
        _close_cache(weights.cache_assemble(pieces, cfg, _mesh(name), TS.BATCH, TS.MAX_LEN),
                     want[key], f"{name} {key} assembled")
    kv = [a.shape for a in _leaves(ranks[0][name]["prefill_cache"]) if a.ndim == 6]
    if cfg.attn is not None:             # (L, 1, blk, B_local, Hkv, hd): one block per rank
        n_blk = cfg.kv_cache_blocks
        local = 1 if n_blk % shape[1] == 0 else n_blk
        blk = -(-TS.MAX_LEN // n_blk)
        assert kv and all(s[1:4] == (local, blk, TS.BATCH // shape[0]) for s in kv), kv


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return run_world("dense", tmp_path_factory, TS)


@pytest.mark.parametrize("name", TS.WORLDS["dense"][1])
def test_tensor_parallel_serving_matches_the_reference(dense, name):
    check_case(dense, name)


def test_block_exchange_and_collectives_are_counted(dense):
    """gemma-7b's K and V are a slice by heads (multi-head attention), so
    prefill exchanges blocks all-to-all; internlm2-20b's are whole (grouped
    heads), so prefill sends no K or V; both gather the head's columns in
    prefill and decode's partials."""
    _ref, ranks = dense
    for res in ranks:
        g, i = res["gemma-7b_1x2"], res["internlm2-20b_1x2"]
        assert g["prefill_bytes"]["kv_blocks"] > 0 and "kv_blocks" not in i["prefill_bytes"]
        for got in (g, i):
            assert got["prefill_bytes"]["columns"] > 0 and got["bytes"]["partials"] > 0
        # internlm2's 6 query heads on 2 ranks: split, q gathered in decode
        assert i["bytes"]["qkv_row"] > 0


def test_no_pad_mask_or_per_slot_length_under_a_group():
    """Under a ``"model"`` group (installed here without collectives: each
    refusal comes before any) a pad mask and per-slot lengths raise a
    ``ValueError`` that names them."""
    from repro_torch.models import tensor_parallel
    from repro_torch.models import transformer as tfm
    from repro_torch.models.tensor_parallel import ModelGroup
    cfg = TS.torch_cfg("gemma-7b_1x2")
    params = tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    with torch.no_grad():
        whole = tfm.init_caches(cfg, 2, 8, per_slot=True, device="cpu")
    mg = ModelGroup(group=None, size=2, index=0, order=(0, 1))
    with tensor_parallel.use(mg):
        with pytest.raises(ValueError, match="per-slot"):
            tfm.init_caches(cfg, 2, 8, per_slot=True, device="cpu")
        with pytest.raises(ValueError, match="pad_mask"):
            tfm.prefill(params, cfg, tokens=tokens, pad_mask=torch.ones_like(tokens, dtype=bool))
        with pytest.raises(ValueError, match="per-slot"):
            tfm.decode_step(params, cfg, tokens[:, :1], whole)


def test_serving_takes_the_viewed_parameters():
    """granite-34b's ``wk`` and ``wv`` (one KV head) are gathered on a
    (1, 2) mesh: ``prefill``, ``decode_step`` and ``encode`` given this
    rank's slices of them raise a ``ValueError`` naming
    ``serving_view``, before any collective."""
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import tensor_parallel, weights
    from repro_torch.models import transformer as tfm
    from repro_torch.models.tensor_parallel import ModelGroup
    cfg = TS.torch_cfg("granite-34b_1x2")
    whole = tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    params = weights.model_slices(whole, shd.model_dims(whole, AbstractMesh((1, 2), TS.AXES)),
                                  0, 2)
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    mg = ModelGroup(group=None, size=2, index=0, order=(0, 1))
    with tensor_parallel.use(mg):
        for call in (lambda: tfm.prefill(params, cfg, tokens=tokens),
                     lambda: tfm.decode_step(params, cfg, tokens[:, :1], None),
                     lambda: tfm.encode(params, torch.zeros((2, 4, cfg.d_model)), cfg)):
            with pytest.raises(ValueError, match="serving_view"):
                call()


@pytest.mark.parametrize("arch", ["gemma-7b", "hymba-1.5b", "rwkv6-1.6b", "deepseek-moe-16b"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_cache_pieces_assemble_to_the_whole(arch, shape):
    """``weights.cache_piece`` for every coordinate of the mesh, then
    ``cache_assemble``, gives back the whole decode state exactly; each
    piece has the local shape ``transformer.init_caches`` allocates under
    the groups (``shardings.local_shape``)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    cfg = get_smoke_config(arch).with_runtime(dtype=torch.float32, kv_cache_blocks=shape[1])
    mesh = AbstractMesh(shape, TS.AXES)
    like = tfm.init_caches(cfg, TS.BATCH, TS.MAX_LEN, device="cpu")
    rng = np.random.default_rng(0)
    whole = weights.cache_to_numpy(shd.map_with_path(
        lambda _path, t: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
        .to(t.dtype), like))
    specs = shd.cache_specs(like, mesh, cfg)
    local = [shd.local_shape(tuple(t.shape), sp, mesh)
             for t, sp in zip(_leaves(like), _leaves(specs))]
    coords = [(d, m) for d in range(shape[0]) for m in range(shape[1])]
    pieces = {c: weights.cache_piece(whole, cfg, mesh, c, "cpu") for c in coords}
    for piece in pieces.values():
        assert [tuple(t.shape) for t in _leaves(piece)] == local
    back = weights.cache_assemble(pieces, cfg, mesh, TS.BATCH, TS.MAX_LEN)
    for a, b in zip(_leaves(back), _leaves(whole)):
        np.testing.assert_array_equal(a, b)


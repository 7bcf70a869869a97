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
``test_torch_tp_serve_wide.py`` (1, 4); ``test_torch_tp_serve_masked.py``,
``_masked_families.py`` and ``_masked_mesh.py`` the batchers' masked and
per-slot prefill steps (``tp_serve_scenarios.MASKED``).  Float32, the smoke
configs with ``launch/dryrun.py``'s knobs (``kv_cache_blocks`` the
``"model"`` extent).

Held per case and rank: the prefill logits of the rank's data rows and the
logits of three decode steps fed the reference's greedy tokens within
1e-4 x max|ref logits| (about 10x the 1.14e-5 by which the reference's own
sharded and mesh-free runs differ); each rank's cache pieces after prefill
and after decode within ``TOL`` f32 (2e-5 absolute) of the reference's
cache cut as ``cache_specs`` places it (``weights.cache_piece``), its
``length`` and ``start`` exactly, their local shapes, and the pieces
assembled (``weights.cache_assemble``) against the whole; the same decode
steps from the reference's prefill cache carried across (decode alone; a
masked case's own steps from a cache with one row at capacity); the greedy
tokens of ``lm.greedy_generate`` equal to the reference's (the argmaxes of
its prefill and decode chain, which the reference's sharded and mesh-free
runs share; a masked case's chain of argmaxes).
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
        if b.dtype.kind in "iu":         # length, start
            np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")
        else:
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
        alone = want.get("alone_logits", want["decode_logits"])
        for i, (g, w) in enumerate(zip(got["alone_logits"], alone)):
            _close_logits(g, _rows(w, name, got["rows"]), f"{what} decode alone step {i + 1}")
        for key in ("prefill_cache", "decode_cache"):
            _close_cache(got[key], _want_piece(want[key], name, got["coord"]), f"{what} {key}")
        _close_cache(got["alone_cache"], _want_piece(want.get("alone_cache", want["decode_cache"]),
                                                     name, got["coord"]), f"{what} alone_cache")
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


def _halves(whole, n: int, d: int) -> list:
    """The ``"model"`` rank's halves of a whole per-slot cache, for each
    rank of ``n`` ``"model"`` ranks and ``d`` data ranks: (index, data
    index, its blocks of its rows with ``length`` and ``start`` whole)."""
    from repro_torch.models.attention import KVCache
    out = []
    for j in range(d):
        for i in range(n):
            k, v = (torch.chunk(torch.chunk(t, n, 0)[i], d, 2)[j].clone()
                    for t in (whole.k, whole.v))
            out.append((i, j, KVCache(k, v, whole.length.clone(), whole.start.clone())))
    return out


@pytest.mark.parametrize("data", [1, 2])
def test_per_slot_decode_writes_on_the_block_owner_only(data):
    """Without collectives: each ``"model"`` half (``ModelGroup(group=None,
    size=2, index=i)``, and under ``data`` ranks of a data group, its rows)
    of a whole per-slot cache runs ``cache_update_decode`` twice; stacked,
    the halves equal the whole cache's writes, and every half's ``length``
    the whole's.  Blocks of 12 over capacity 24: row 0 at 11 writes the
    last position of block 0, then the first of block 1; row 1 sits past
    capacity, row 2 at capacity - 1 (then at capacity) and row 3 at 5."""
    from repro_torch.models import attention as attn
    from repro_torch.models import data_parallel, tensor_parallel
    from repro_torch.models.data_parallel import DataGroup
    from repro_torch.models.tensor_parallel import ModelGroup
    gen = torch.Generator().manual_seed(0)
    B, H, D = 4, 2, 3
    whole = attn.KVCache(torch.randn(2, 12, B, H, D, generator=gen),
                         torch.randn(2, 12, B, H, D, generator=gen),
                         torch.tensor([11, 24, 23, 5], dtype=torch.int32),
                         torch.zeros(B, dtype=torch.int32))
    pieces = _halves(whole, 2, data)
    before = whole.k.clone()
    for _ in range(2):
        k_new, v_new = (torch.randn(B, H, 1, D, generator=gen) for _ in range(2))
        whole = attn.cache_update_decode(whole, k_new, v_new)
        moved = []
        for i, j, piece in pieces:
            dg = DataGroup(group=None, size=data, index=j, order=tuple(range(data)))
            mg = ModelGroup(group=None, size=2, index=i, order=(0, 1))
            with data_parallel.use(dg if data > 1 else None), tensor_parallel.use(mg):
                new = attn.cache_update_decode(piece, dg.local_rows(k_new), dg.local_rows(v_new),
                                               mg)
            torch.testing.assert_close(new.length, whole.length, rtol=0, atol=0)
            moved.append((i, j, new))
        pieces = moved
    for t, name in ((whole.k, "k"), (whole.v, "v")):
        stacked = torch.cat([torch.cat([getattr(p, name) for i, j, p in pieces if j == jj], 0)
                             for jj in range(data)], 2)
        torch.testing.assert_close(stacked, t, rtol=0, atol=0)
    assert whole.length.tolist() == [13, 26, 25, 7]
    assert not torch.equal(whole.k[1, 0, 0], before[1, 0, 0])      # row 0 crossed
    torch.testing.assert_close(whole.k[:, :, 1], before[:, :, 1], rtol=0, atol=0)
    assert not torch.equal(whole.k[1, 11, 2], before[1, 11, 2])    # capacity - 1
    torch.testing.assert_close(whole.k[:, :, 2].flatten(0, 1)[:23],
                               before[:, :, 2].flatten(0, 1)[:23], rtol=0, atol=0)


def test_a_block_with_no_valid_key_weighs_nothing():
    """A left pad longer than a block (``start`` 15, blocks of 12): that
    row's partial over block 0 has ``l`` 0, and the partials of both
    halves, combined, equal the whole cache's decode, with no NaN."""
    from repro_torch.models import attention as attn
    gen = torch.Generator().manual_seed(1)
    B, Hkv, D, g = 2, 2, 4, 2
    cache = attn.KVCache(torch.randn(2, 12, B, Hkv, D, generator=gen),
                         torch.randn(2, 12, B, Hkv, D, generator=gen),
                         torch.tensor(20, dtype=torch.int32),
                         torch.tensor([0, 15], dtype=torch.int32))
    q = torch.randn(B, g * Hkv, 1, D, generator=gen)
    want = attn._decode_attention_blocked(q, cache)
    parts = [attn._decode_partials(q, attn.KVCache(cache.k[i:i + 1], cache.v[i:i + 1],
                                                   cache.length, cache.start), first_block=i)
             for i in range(2)]
    m, l, o = (torch.cat(t, 0) for t in zip(*parts))
    assert float(l[0, 1].abs().max()) == 0.0 and float(l[0, 0].min()) > 0
    got = attn._combine_partials(m, l, o, q.dtype)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b", "gemma-7b"])
def test_per_slot_caches_under_the_groups(arch):
    """``init_caches(per_slot=True)`` under a ``"model"`` group (no
    collective): rwkv6-1.6b's state is the one without the flag (no KV
    cache); a KV cache's ``length`` is per-slot and whole, (L, B), every
    other leaf as without the flag."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import tensor_parallel
    from repro_torch.models import transformer as tfm
    from repro_torch.models.tensor_parallel import ModelGroup
    cfg = get_smoke_config(arch).with_runtime(dtype=torch.float32, kv_cache_blocks=2)
    mg = ModelGroup(group=None, size=2, index=1, order=(0, 1))
    with tensor_parallel.use(mg):
        flat = _leaves(tfm.init_caches(cfg, 4, 24, device="meta"))
        slots = _leaves(tfm.init_caches(cfg, 4, 24, per_slot=True, device="meta"))
    L = cfg.n_layers
    want = [(L, 4) if tuple(a.shape) == (L,) else tuple(a.shape) for a in flat]
    assert [tuple(a.shape) for a in slots] == want
    assert (want == [tuple(a.shape) for a in flat]) == (arch == "rwkv6-1.6b")


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


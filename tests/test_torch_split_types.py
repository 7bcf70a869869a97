"""Split types of the PyTorch port against the JAX package's, on the same
numpy arrays: split/merge results, runtime info, type identity and
unification.  Tolerance: exact — splitting and concatenation move values
without arithmetic; reduction merges of two partials are one float32 op on
both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import split_types as jst
from repro_torch.core import split_types as tst


def _info(i):
    return (i.num_elements, i.elem_bytes)


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,axis", [((10,), 0), ((6, 5), 0), ((6, 5), 1),
                                        ((3, 4, 5), 2), ((7, 2), -1)])
def test_array_split_parity(shape, axis):
    a = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ja, ta = _pair(a)
    jt, tt = jst.ArraySplit(shape, axis), tst.ArraySplit(shape, axis)
    assert repr(jt) == repr(tt) and jt.key() == tt.key()
    assert _info(jt.info(ja)) == _info(tt.info(ta))
    n = shape[axis]
    cuts = [(0, n // 3), (n // 3, n - 1), (n - 1, n)]
    jp = [jt.split(ja, s, e) for s, e in cuts]
    tp = [tt.split(ta, s, e) for s, e in cuts]
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    np.testing.assert_array_equal(np.asarray(jt.merge(jp)), tt.merge(tp).numpy())
    np.testing.assert_array_equal(tt.merge(tp).numpy(), a)


@pytest.mark.parametrize("op", ["add", "mul", "max", "min"])
def test_reduce_split_parity(op):
    parts = np.random.RandomState(1).rand(5).astype(np.float32) + 0.5
    jt, tt = jst.ReduceSplit(op), tst.ReduceSplit(op)
    assert repr(jt) == repr(tt) and not tt.splittable
    got = tt.merge([torch.tensor(p) for p in parts])
    want = jt.merge([jnp.float32(p) for p in parts])
    assert got.dtype == torch.float32
    assert float(got) == float(want)
    with pytest.raises(TypeError):
        tt.split(torch.tensor(1.0), 0, 1)


def test_reduce_split_max_keeps_nan():
    tt = tst.ReduceSplit("max")
    got = tt.merge([torch.tensor(1.0), torch.tensor(float("nan")), torch.tensor(2.0)])
    want = jst.ReduceSplit("max").merge([jnp.float32(1.0), jnp.float32(np.nan),
                                          jnp.float32(2.0)])
    assert np.isnan(float(got)) and np.isnan(float(want))


def test_concat_split_parity():
    rs = np.random.RandomState(2)
    pieces = [rs.randn(k, 3).astype(np.float32) for k in (2, 0, 5)]
    jt, tt = jst.ConcatSplit("rows", 0), tst.ConcatSplit("rows", 0)
    assert repr(jt) == repr(tt)
    got = tt.merge([torch.from_numpy(p) for p in pieces])
    want = jt.merge([jnp.asarray(p) for p in pieces])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # pytree pieces merge leaf by leaf
    tree = tt.merge([{"a": torch.ones(2), "b": torch.zeros(2, 1)},
                     {"a": torch.ones(3), "b": torch.zeros(3, 1)}])
    assert tree["a"].shape == (5,) and tree["b"].shape == (5, 1)


def test_pytree_split_parity():
    rs = np.random.RandomState(3)
    tree_np = {"p": rs.randn(8, 2).astype(np.float32),
               "m": rs.randn(8).astype(np.float32)}
    jtree = {k: jnp.asarray(v) for k, v in tree_np.items()}
    ttree = {k: torch.from_numpy(v.copy()) for k, v in tree_np.items()}
    jt = jst.Pytree(0).construct(jtree, {}, {})
    tt = tst.Pytree(0).construct(ttree, {}, {})
    assert isinstance(tt, tst.PytreeSplit) and tt.length == jt.length == 8
    assert _info(tt.info(ttree)) == _info(jt.info(jtree))
    cuts = [(0, 3), (3, 8)]
    tp = [tt.split(ttree, s, e) for s, e in cuts]
    jp = [jt.split(jtree, s, e) for s, e in cuts]
    for t, j in zip(tp, jp):
        for k in tree_np:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    merged = tt.merge(tp)
    for k in tree_np:
        np.testing.assert_array_equal(merged[k].numpy(), tree_np[k])
    # leaves that disagree on the extent fall back to broadcast
    bad = {"p": torch.ones(4), "m": torch.ones(5)}
    assert tst.Pytree(0).construct(bad, {}, {}) == tst.BROADCAST


@pytest.mark.parametrize("cls", ["ScalarSplit", "ConcatSplit", "UnknownSplit",
                                 "ArraySplit", "PytreeSplit", "ReduceSplit"])
def test_empty_merge_raises(cls):
    args = {"ArraySplit": ((3,), 0), "PytreeSplit": ("t", 3, 0),
            "ReduceSplit": ("add",)}.get(cls, ())
    with pytest.raises(ValueError, match="at least one piece"):
        getattr(tst, cls)(*args).merge([])


def _unify_script(mod):
    """The same unification steps on either package; returns what resolves."""
    env = mod.TypeEnv()
    s, t, u = mod.GenericVar("S"), mod.GenericVar("T"), mod.GenericVar("U")
    arr = mod.ArraySplit((4,), 0)
    env.unify(s, t)
    env.unify(t, arr)
    snap = env.snapshot()
    env.unify(u, mod.BROADCAST)
    out = [repr(env.resolve(s)), repr(env.resolve(t)), repr(env.resolve(u))]
    try:
        env.unify(s, mod.ArraySplit((4,), 0))
        out.append("same ok")
        env.unify(s, mod.ArraySplit((5,), 0))
        out.append("no error")
    except mod.UnificationError:
        out.append("mismatch")
    env.restore(snap)
    out.append(isinstance(env.resolve(u), mod.GenericVar))
    out.append(mod.UnknownSplit() == mod.UnknownSplit())
    return out


def test_unification_parity():
    assert _unify_script(tst) == _unify_script(jst)
    assert _unify_script(tst)[3:] == ["same ok", "mismatch", True, False]


@pytest.mark.parametrize("value", [np.zeros((4, 3), np.float32),
                                   np.zeros((5,), np.bool_), 2.0, 3, True])
def test_specs_and_defaults_parity(value):
    jv = jnp.asarray(value) if isinstance(value, np.ndarray) else value
    tv = torch.from_numpy(value) if isinstance(value, np.ndarray) else value
    assert repr(tst.default_split_type(tv)) == repr(jst.default_split_type(jv))
    if isinstance(value, np.ndarray):
        assert repr(tst.Along(0).construct(tv, {}, {})) == \
            repr(jst.Along(0).construct(jv, {}, {}))
    assert tst.nbytes_of(tv) == jst.nbytes_of(jv)
    aval = tst.aval_of(tv)
    assert aval.device.type == "meta"
    assert tuple(aval.shape) == tuple(jst.aval_of(jv).shape)
    assert str(aval.dtype).replace("torch.", "") == str(jst.aval_of(jv).dtype)

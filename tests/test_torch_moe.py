"""The port's Mixture-of-Experts layer (``models/mlp.py``'s MoE half)
against the JAX package's, on the CPU.

Inputs and parameters are drawn with numpy from a seed (every leaf on its
own: the reference's ``init_moe`` draws the shared experts' matrices from
one key) and go through ``repro.models.mlp.moe_block`` and the port's
``moe_block``.  Tolerances: ``TOL`` of ``tests/test_kernels.py`` (float32
rtol = atol = 2e-5, bfloat16 2e-2) on the outputs, the float32 aux loss
rtol 1e-6; routing (``expert_idx``), ranks (``pos``) and ``keep`` exactly,
``pos``/``keep`` also against a numpy oracle of the same semantics (an
assignment's rank among the group's earlier assignments, in flat (token, k)
order, to the same expert); gradients in float32 rtol 1e-4 with atol
1e-6·max|g|, as ``tests/test_torch_models.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jsmoke
from repro.models import mlp as jmlp
from repro.models.config import MoEConfig as JMoE
from repro_torch.configs import registry
from repro_torch.models import mlp as tmlp
from repro_torch.models.config import MoEConfig as TMoE

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(dtype, groups=1, **moe):
    """olmoe's smoke config (d 64, silu, gated) with the given MoE fields."""
    m = dict(n_experts=4, top_k=2, d_expert=32)
    m.update(moe)
    j = jsmoke("olmoe-1b-7b").with_runtime(dtype=JDT[dtype], moe=JMoE(**m), moe_groups=groups)
    t = registry.get_smoke_config("olmoe-1b-7b").with_runtime(dtype=TDT[dtype], moe=TMoE(**m),
                                                               moe_groups=groups)
    return j, t


def _params(cfg, seed):
    """One layer's MoE parameters as float32 numpy arrays, from a seed."""
    m, d = cfg.moe, cfg.d_model
    f, e = m.d_expert, m.n_experts
    r = np.random.RandomState(seed)
    n = lambda *s, scale: (r.randn(*s) * scale).astype(np.float32)
    p = {"router": n(d, e, scale=d ** -0.5), "w_in": n(e, d, f, scale=d ** -0.5),
         "w_gate": n(e, d, f, scale=d ** -0.5), "w_out": n(e, f, d, scale=f ** -0.5)}
    if m.n_shared:
        fs = f * m.n_shared
        p["shared"] = {"w_in": n(d, fs, scale=d ** -0.5), "w_gate": n(d, fs, scale=d ** -0.5),
                       "w_out": n(fs, d, scale=fs ** -0.5)}
    return p


def _both(p, dtype):
    """The numpy parameters on each side: matrices in the model dtype, the
    router float32 (as each package's init makes them)."""
    cast_j = lambda k, a: jnp.asarray(a, jnp.float32 if k == "router" else JDT[dtype])
    cast_t = lambda k, a: torch.from_numpy(a).to(torch.float32 if k == "router" else TDT[dtype])
    jp = {k: ({kk: cast_j(kk, vv) for kk, vv in v.items()} if isinstance(v, dict)
              else cast_j(k, v)) for k, v in p.items()}
    tp = {k: ({kk: cast_t(kk, vv) for kk, vv in v.items()} if isinstance(v, dict)
              else cast_t(k, v)) for k, v in p.items()}
    return jp, tp


def _x(shape, seed, dtype):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _oracle_pos(expert_idx: np.ndarray, capacity: int):
    """Rank of each flat (token, k) assignment among the earlier ones to the
    same expert; kept if the rank is below capacity."""
    flat = expert_idx.reshape(-1)
    seen: dict = {}
    pos = np.empty_like(flat)
    for i, e in enumerate(flat):
        pos[i] = seen.get(int(e), 0)
        seen[int(e)] = pos[i] + 1
    return pos, pos < capacity


def _capacity(cfg, T):
    m = cfg.moe
    return int(max(1, (T // max(cfg.moe_groups, 1) * m.top_k * m.capacity_factor)
                   // m.n_experts))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_jax(dtype, n_shared, groups):
    """(2, 9, 64) tokens, 4 experts top-2: the output within ``TOL``, the
    aux loss, and the assignments the capacity dropped, per group."""
    jcfg, tcfg = _cfgs(dtype, groups, n_shared=n_shared)
    jp, tp = _both(_params(jcfg, seed=n_shared + groups), dtype)
    jx, tx = _x((2, 9, 64), seed=10 + groups, dtype=dtype)
    jout, jaux = jmlp.moe_block(jp, jx, jcfg)
    with tmlp.count_drops() as drops:
        tout, taux = tmlp.moe_block(tp, tx, tcfg)
    assert tout.dtype == TDT[dtype] and taux.dtype == torch.float32
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    _, eidx, _ = tmlp.route(tp, tx.reshape(18, 64), tcfg)
    cap = _capacity(tcfg, 18)
    want_drops = sum(int((~_oracle_pos(g, cap)[1]).sum())
                     for g in eidx.numpy().reshape(groups, -1, 2))
    assert (drops.routed, drops.dropped) == (36, want_drops)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routing_and_ranks_match_jax_and_the_oracle(dtype):
    """``route``: top-k experts equal ``lax.top_k``'s, renormalised gates
    within float32 rounding; ``ranks``: ``pos`` and ``keep`` equal the
    oracle's, at a capacity that drops."""
    jcfg, tcfg = _cfgs(dtype, capacity_factor=0.5)
    jp, tp = _both(_params(jcfg, seed=3), dtype)
    jx, tx = _x((24, 64), seed=4, dtype=dtype)
    probs = jax.nn.softmax(jx.astype(jnp.float32) @ jp["router"], axis=-1)
    jg, je = jax.lax.top_k(probs, 2)
    jg = jg / jnp.maximum(jnp.sum(jg, -1, keepdims=True), 1e-9)
    tg, te, _ = tmlp.route(tp, tx, tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    cap = _capacity(tcfg, 24)
    assert cap == 6
    order, counts, starts, pos, keep = tmlp.ranks(te, 4, cap)
    want_pos, want_keep = _oracle_pos(te.numpy(), cap)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(te.numpy().ravel(), minlength=4))
    assert 0 < int((~keep).sum()) < keep.numel()
    # the reference's dispatch on the same routing gives the port's output
    jout = jmlp._dispatch_one_group(jx, jg.astype(jx.dtype), je, jp, jcfg, cap)
    tout, tkeep = tmlp._dispatch_one_group(tx, tg, te, tp, tcfg, cap)
    assert torch.equal(tkeep, keep)
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL[dtype])


@pytest.mark.parametrize("E,k", [(4, 2), (64, 8)])
def test_decode_sized_group_drops_as_the_reference(E, k):
    """A batch-4 decode step (T = 4): capacity max(1, 4·k·1.25 // E), 2 at
    E = 4, k = 2 and 1 at olmoe's E = 64, k = 8.  Every token leans to
    expert 0, so the capacity drops assignments; the output, aux and drops
    equal the reference's.  At T = 1 nothing is dropped (a token's k
    experts are distinct)."""
    jcfg, tcfg = _cfgs("float32", n_experts=E, top_k=k)
    p = _params(jcfg, seed=5)
    u = np.random.RandomState(6).randn(64).astype(np.float32)
    u /= np.linalg.norm(u)
    p["router"][:, 0] += 6.0 * u
    jp, tp = _both(p, "float32")
    x = np.random.RandomState(7).randn(4, 1, 64).astype(np.float32) + 2.0 * u
    jout, jaux = jmlp.moe_block(jp, jnp.asarray(x), jcfg)
    with tmlp.count_drops() as drops:
        tout, taux = tmlp.moe_block(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL["float32"])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    cap = _capacity(tcfg, 4)
    assert cap == (2 if E == 4 else 1)
    _, eidx, _ = tmlp.route(tp, torch.from_numpy(x).reshape(4, 64), tcfg)
    assert bool((eidx[:, 0] == 0).all())
    assert drops.dropped == int((~_oracle_pos(eidx.numpy(), cap)[1]).sum()) >= 4 - cap
    with tmlp.count_drops() as one:
        alone, _ = tmlp.moe_block(tp, torch.from_numpy(x[:1]), tcfg)
    assert (one.routed, one.dropped) == (k, 0)
    jalone, _ = jmlp.moe_block(jp, jnp.asarray(x[:1]), jcfg)
    np.testing.assert_allclose(alone.numpy(), np.asarray(jalone), **TOL["float32"])


@pytest.mark.parametrize("E,k", [(4, 2), (16, 4), (64, 8)])
def test_tied_rows_route_to_the_lower_experts_as_the_reference(E, k):
    """All-zero rows tie every expert's probability: ``lax.top_k`` takes the
    lower index first, and so must ``route`` (``torch.topk`` does not).  A
    batch of 8 rows, 3 of them zero, float32, capacity factor 1.0: the tied
    rows route to experts 0..k-1 on both sides, the routing of every row is
    equal, and so, since the tied rows take capacity, are the outputs."""
    jcfg, tcfg = _cfgs("float32", n_experts=E, top_k=k, capacity_factor=1.0)
    jp, tp = _both(_params(jcfg, seed=14), "float32")
    x = np.random.RandomState(15).randn(8, 1, 64).astype(np.float32)
    x[[1, 4, 6]] = 0.0
    jx = jnp.asarray(x)
    probs = jax.nn.softmax(jx.reshape(8, 64) @ jp["router"], axis=-1)
    _, je = jax.lax.top_k(probs, k)
    _, te, _ = tmlp.route(tp, torch.from_numpy(x).reshape(8, 64), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te[[1, 4, 6]].tolist() == [list(range(k))] * 3
    jout, jaux = jmlp.moe_block(jp, jx, jcfg)
    tout, taux = tmlp.moe_block(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL["float32"])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_gradients_match_jax(n_shared):
    """d/d(x, every parameter) of sum(out · w) + aux, float32, at a capacity
    factor that drops, against ``jax.grad``."""
    jcfg, tcfg = _cfgs("float32", n_shared=n_shared, capacity_factor=0.75)
    p = _params(jcfg, seed=8)
    x = np.random.RandomState(9).randn(2, 7, 64).astype(np.float32)
    w = np.random.RandomState(10).randn(2, 7, 64).astype(np.float32)

    def jloss(p, x):
        out, aux = jmlp.moe_block(p, x, jcfg)
        return jnp.sum(out * w) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, p),
                                               jnp.asarray(x))
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(a, requires_grad=True), p)
    tx = torch.tensor(x, requires_grad=True)
    out, aux = tmlp.moe_block(tp, tx, tcfg)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    pairs = [("x", tx.grad, jgx)] + [
        (name, leaf.grad, want) for (name, leaf), want in zip(
            jax.tree_util.tree_leaves_with_path(tp), jax.tree_util.tree_leaves(jgp))]
    assert len(pairs) == (8 if n_shared else 5)
    for name, got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=str(name))
    assert float(np.abs(np.asarray(jgp["router"])).max()) > 0


def test_shard_map_request_raises():
    """The expert-parallel branch (``shard_ctx``'s ``_MOE_GROUPS`` and
    ``_RESIDUAL`` set, ``moe_groups`` > 1) splits the sequence over
    ``"model"``: a sequence that does not divide raises, it never quietly
    takes the single-device branch."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import shard_ctx
    _, tcfg = _cfgs("float32", groups=2)
    _, tp = _both(_params(tcfg, seed=11), "float32")
    mesh = AbstractMesh((1, 2), ("data", "model"))
    shard_ctx.set_residual((mesh, (Replicate(), Shard(1))))
    shard_ctx.set_moe_groups((mesh, (Shard(0), Shard(0))))
    try:
        with pytest.raises(ValueError, match="3 positions over 2 ranks"):
            tmlp.moe_block(tp, torch.zeros(2, 3, 64), tcfg)
    finally:
        shard_ctx.clear()


def test_moe_block_runs_on_meta_and_counts_nothing():
    """Abstract evaluation (a cold ``mozart`` capture) runs the block on
    ``meta`` tensors: shapes and dtypes only, and no drops recorded."""
    _, tcfg = _cfgs("bfloat16", n_shared=2)
    _, tp = _both(_params(tcfg, seed=12), "bfloat16")
    tp = jax.tree_util.tree_map(lambda t: t.to("meta"), tp)
    with tmlp.count_drops() as drops:
        out, aux = tmlp.moe_block(tp, torch.empty(3, 5, 64, dtype=torch.bfloat16,
                                                  device="meta"), tcfg)
    assert out.shape == (3, 5, 64) and out.dtype == torch.bfloat16 and out.is_meta
    assert aux.shape == () and drops.routed == 0

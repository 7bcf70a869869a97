"""``models/shard_ctx.py`` of the port against the reference's: the same
names and settings, and ``constrain_*`` as identities (the port's
parallelism is explicit, so a placement hint changes no value) at the
reference's call sites: ``constrain_residual`` at every block
(``_apply_block``), ``constrain_cross_kv`` on an encoder-decoder's cross
K and V, ``constrain_logits`` on each chunk's logits of the chunked
cross-entropy.  With every sharding installed, a mesh-free loss and its
gradients are bit-equal to those without, for a dense, an MoE (one
dispatch group: the expert-parallel branch needs more) and an
encoder-decoder smoke config."""

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.models import shard_ctx as jctx
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import lm, shard_ctx
from repro_torch.models import transformer as tfm
from repro_torch.models import weights

GLOBALS = ("_RESIDUAL", "_CROSS_KV", "_MOE_GROUPS", "_LOGITS")
SETTERS = ("set_residual", "set_cross_kv", "set_moe_groups", "set_logits")
CONSTRAINS = ("constrain_residual", "constrain_cross_kv", "constrain_logits",
              "constrain_moe_groups")
MESH = AbstractMesh((2, 2), ("data", "model"))
#: as the reference's dryrun.py lays them out on a (data, model) mesh
SHARDINGS = {"set_residual": (MESH, (Shard(0), Shard(1))),
             "set_cross_kv": (MESH, (Shard(1), Shard(2))),
             "set_moe_groups": (MESH, (Shard(0), Shard(0))),
             "set_logits": (MESH, (Shard(0), Shard(2)))}


@pytest.fixture(autouse=True)
def _cleared():
    shard_ctx.clear()
    yield
    shard_ctx.clear()


def _install():
    for name, sharding in SHARDINGS.items():
        getattr(shard_ctx, name)(sharding)


def test_names_are_the_reference_s():
    """The four globals, their setters, ``clear`` and the four
    ``constrain_*``: every function the reference's module defines, and no
    other public one."""
    def defined(mod):
        return {n for n, v in vars(mod).items()
                if callable(v) and getattr(v, "__module__", None) == mod.__name__
                and not n.startswith("_")}
    assert defined(shard_ctx) == defined(jctx) == {*SETTERS, "clear", *CONSTRAINS}
    for g in GLOBALS:
        assert getattr(jctx, g) is None and getattr(shard_ctx, g) is None


def test_setters_and_clear():
    _install()
    for g, (name, sharding) in zip(GLOBALS, SHARDINGS.items()):
        assert getattr(shard_ctx, g) is sharding, name
    shard_ctx.clear()
    assert all(getattr(shard_ctx, g) is None for g in GLOBALS)


def test_constrain_returns_its_argument():
    """Installed or not, each ``constrain_*`` returns the tensor itself;
    the rank checks are the reference's (3, 5 and 3 dims; any for the
    MoE groups), and a tensor of another rank passes unchecked."""
    x3, x5, x2 = torch.randn(2, 4, 8), torch.randn(2, 2, 2, 4, 8), torch.randn(4, 8)
    for installed in (False, True):
        if installed:
            _install()
        assert shard_ctx.constrain_residual(x3) is x3
        assert shard_ctx.constrain_logits(x3) is x3
        assert shard_ctx.constrain_cross_kv(x5) is x5
        assert shard_ctx.constrain_moe_groups(x2) is x2
        assert shard_ctx.constrain_residual(x2) is x2
        assert shard_ctx.constrain_cross_kv(x3) is x3


@pytest.mark.parametrize("setter,call,shape", [
    ("set_residual", "constrain_residual", (2, 4, 8)),
    ("set_cross_kv", "constrain_cross_kv", (1, 2, 2, 4, 8)),
    ("set_logits", "constrain_logits", (2, 4, 8))])
def test_a_sharding_that_does_not_fit_is_refused(setter, call, shape):
    """A placement sharding a dim the tensor lacks, or one placement too
    few for the mesh, raises (``with_sharding_constraint`` refuses both)."""
    x = torch.randn(shape)
    getattr(shard_ctx, setter)((MESH, (Shard(len(shape)), Replicate())))
    with pytest.raises(ValueError, match="dims"):
        getattr(shard_ctx, call)(x)
    getattr(shard_ctx, setter)((MESH, (Replicate(),)))
    with pytest.raises(ValueError, match="placements"):
        getattr(shard_ctx, call)(x)


def _loss_and_grads(cfg, model, batch):
    model.zero_grad(set_to_none=True)
    loss = lm.loss_fn(model, batch, cfg, ce_chunk=8)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in weights.leaves(model).items()
                           if p.grad is not None}


@pytest.mark.parametrize("arch", ["gemma-7b", "olmoe-1b-7b", "deepseek-moe-16b",
                                  "seamless-m4t-large-v2"])
def test_call_sites_change_no_value(arch, monkeypatch):
    """Every sharding installed: the loss and every gradient equal the
    uninstalled run's bit for bit; the forward called ``constrain_residual``
    once per block (encoder blocks included), ``constrain_logits`` once per
    CE chunk and again in its recompute in the backward, and
    ``constrain_cross_kv`` on K and V."""
    cfg = get_smoke_config(arch).with_runtime(dtype=torch.float32, remat=False)
    model = tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = DataPipeline(cfg, 2, 32, seed=0, device="cpu").batch_for_step(0)
    want = _loss_and_grads(cfg, model, batch)
    calls = {name: 0 for name in CONSTRAINS}

    def counted(name):
        real = getattr(shard_ctx, name)

        def call(x):
            calls[name] += 1
            out = real(x)
            assert out is x
            return out
        return call
    for name in CONSTRAINS:
        monkeypatch.setattr(shard_ctx, name, counted(name))
    _install()
    got = _loss_and_grads(cfg, model, batch)
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for n, g in want[1].items():
        assert torch.equal(got[1][n], g), n
    blocks = cfg.n_layers + (cfg.n_encoder_layers if cfg.encdec else 0)
    assert calls == {"constrain_residual": blocks, "constrain_logits": 2 * (32 // 8),
                     "constrain_cross_kv": 2 if cfg.encdec else 0,
                     "constrain_moe_groups": 0}

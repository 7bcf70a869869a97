"""ROADMAP C16: ``train(mesh=...)`` over a ``"model"`` extent > 1 draws
each rank's parameter slices straight from the seed, never the whole
model, and a resume draws nothing.

In a two-rank ``gloo`` world on a (1, 2) mesh, smoke gemma-7b and smoke
olmoe-1b-7b in their bfloat16 (``train``'s defaults otherwise) are
initialised up to the optimizer's init (``adamw.init_sharded``, where the
run is stopped) under ``LiveBytes``, which follows every CPU storage an
op makes while it lives.  Up to there a rank holds at most its slices plus
one leaf's float32 draw: the whole leaf at the default
``layers.DRAW_ELEMENTS``, one first-axis piece when pieces are small
(``SMALL_DRAW``).  The whole model (the init before C16) exceeds either
bound.  The slices are bit-equal to ``weights.model_slices`` of the
mesh-free init from the same seed, and a resume from a checkpoint makes no
random draw.  ``weights.init_slices`` is also held to ``model_slices``
in-process for every registry id at (1, 2) and (1, 4).
"""

import os
import sys
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from test_torch_tp import _run_port

ARCHS = ("gemma-7b", "olmoe-1b-7b")
SHAPE, AXES = (1, 2), ("data", "model")
#: ``layers.DRAW_ELEMENTS`` of the pieces case: below every smoke leaf's
#: size, so that a leaf is drawn in several first-axis pieces
SMALL_DRAW = 2048
WORLDS = {"init": (2, ())}
#: bytes beside the parameters that may be alive at the peak: scalars and
#: the small buffers of the ranks' agreement on the step to resume from
SLACK = 1024


class LiveBytes(TorchDispatchMode):
    """The bytes of the CPU storages ops made under the mode that are still
    alive (``live``) and their most (``peak``), and the random draws made."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.draws = 0
        self._seen = weakref.WeakSet()

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in (torch.ops.aten.randn, torch.ops.aten.normal_,
                                   torch.ops.aten.normal, torch.ops.aten.uniform_):
            self.draws += 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                s = t.untyped_storage()
                if s not in self._seen:
                    self._seen.add(s)
                    self.live += s.nbytes()
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(s, self._free, s.nbytes())
        return out


class _AtOptimizer(Exception):
    """Stops ``train`` where it calls the optimizer's init."""


def _until_optimizer(cfg, mesh, **kw) -> dict:
    """``train(cfg, mesh=mesh, ...)`` under ``LiveBytes`` up to
    ``adamw.init_sharded``: the peak and live bytes there, the draws, and
    the rank's parameters it was handed."""
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw
    real, seen = adamw.init_sharded, {}
    tracker = LiveBytes()

    def stop(params, zero):
        seen.update(peak=tracker.peak, live=tracker.live, draws=tracker.draws,
                    params={n: p.detach().clone() for n, p in params.items()})
        raise _AtOptimizer
    adamw.init_sharded = stop
    try:
        with tracker, pytest.raises(_AtOptimizer):
            train(cfg, steps=1, batch=4, seq=32, mesh=mesh, device="cpu", **kw)
    finally:
        adamw.init_sharded = real
    return seen


def _bounds(cfg, mesh) -> dict:
    """This rank's slice bytes, and the float32 bytes of the largest draw
    at the default ``DRAW_ELEMENTS`` (a whole leaf here) and at
    ``SMALL_DRAW`` (one first-axis piece); the whole model's bytes."""
    from repro_torch.launch import shardings as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    from repro_torch.models.layers import DRAW_ELEMENTS
    meta = weights.leaves(tfm.init_model(cfg, None, "meta"))
    dims = shd.model_dims(tfm.init_model(cfg, None, "meta"), mesh)

    def piece(p, most):
        row = max(p[0].numel(), 1) if p.dim() else 1
        return 4 * min(p.numel(), max(most // row, 1) * row)
    return {"slices": sum(p.numel() * p.element_size() // (1 if dims[n] is None else SHAPE[1])
                          for n, p in meta.items()),
            "leaf": max(piece(p, DRAW_ELEMENTS) for p in meta.values()),
            "piece": max(piece(p, SMALL_DRAW) for p in meta.values()),
            "whole": sum(p.numel() * p.element_size() for p in meta.values())}


def _rank_case(arch, out_dir) -> dict:
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    cfg = get_smoke_config(arch)
    mesh = make_mesh(SHAPE, AXES, "cpu")
    zero = T.zero1_layout(mesh, tfm.init_model(cfg, None, "meta"))
    res = {"bounds": _bounds(cfg, mesh)}
    for tag, most in (("leaf", layers.DRAW_ELEMENTS), ("piece", SMALL_DRAW)):
        real, layers.DRAW_ELEMENTS = layers.DRAW_ELEMENTS, most
        try:
            seen = _until_optimizer(cfg, mesh)
            whole = tfm.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
            want = weights.leaves(weights.model_slices(whole, zero.mdims, zero.mg.index,
                                                       zero.mg.size))
        finally:
            layers.DRAW_ELEMENTS = real
        res[tag] = {"peak": seen["peak"], "live": seen["live"], "draws": seen["draws"],
                    "equal": {n: torch.equal(p, want[n]) for n, p in seen["params"].items()},
                    "same_shapes": {n: p.shape == want[n].shape
                                    for n, p in seen["params"].items()}}
    d = os.path.join(out_dir, f"ckpt_{arch}")
    T.train(cfg, steps=0, batch=4, seq=32, mesh=mesh, device="cpu", ckpt_dir=d)
    seen = _until_optimizer(cfg, mesh, ckpt_dir=d)
    res["resume"] = {"draws": seen["draws"], "peak": seen["peak"]}
    return res


def torch_rank(rank: int, world: str, store_path: str, out_dir: str, _ref_path: str,
               timeout_s: float) -> None:
    import pickle
    from datetime import timedelta

    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank,
                            world_size=2, timeout=timedelta(seconds=timeout_s))
    try:
        res = {arch: _rank_case(arch, out_dir) for arch in ARCHS}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("init_slices")
    return _run_port("init", "", tmp, sys.modules[__name__])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("draw", ["leaf", "piece"])
def test_a_rank_never_holds_more_than_its_slices_and_one_draw(ranks, arch, draw):
    """Up to the optimizer's init each rank's live bytes peak at most at its
    slices plus the largest float32 draw, well under the whole model."""
    for r, res in enumerate(ranks):
        b, got = res[arch]["bounds"], res[arch][draw]
        assert b["slices"] + b[draw] + SLACK < b["whole"], b    # the bound has power
        assert got["live"] >= b["slices"], (r, got["live"], b)
        assert got["peak"] <= b["slices"] + b[draw] + SLACK, (r, got["peak"], b)
        assert got["draws"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("draw", ["leaf", "piece"])
def test_slices_are_bit_equal_to_the_mesh_free_init(ranks, arch, draw):
    for r, res in enumerate(ranks):
        got = res[arch][draw]
        assert all(got["same_shapes"].values()), (r, got["same_shapes"])
        assert all(got["equal"].values()), (r, {n for n, e in got["equal"].items() if not e})


@pytest.mark.parametrize("arch", ARCHS)
def test_a_resume_draws_no_init(ranks, arch):
    """Resuming from a checkpoint, a rank allocates its slices and makes no
    random draw before the optimizer's init (the restore fills them)."""
    for r, res in enumerate(ranks):
        got, b = res[arch]["resume"], res[arch]["bounds"]
        assert got["draws"] == 0, (r, got)
        assert got["peak"] <= b["slices"] + SLACK, (r, got, b)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_init_slices_equals_model_slices_for_every_arch(shape):
    """``weights.init_slices`` against ``weights.model_slices`` of the
    whole init for every registry id and every rank, with leaves drawn in
    several pieces (``DRAW_ELEMENTS`` made small)."""
    from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    from repro_torch.models import weights
    real, layers.DRAW_ELEMENTS = layers.DRAW_ELEMENTS, SMALL_DRAW
    try:
        for arch in ARCH_IDS:
            cfg = get_smoke_config(arch)
            dims = shd.model_dims(tfm.init_model(cfg, None, "meta"),
                                  AbstractMesh(shape, AXES))
            assert any(d is not None for d in dims.values()), arch
            whole = tfm.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
            for index in range(shape[1]):
                want = weights.leaves(weights.model_slices(whole, dims, index, shape[1]))
                got = weights.leaves(weights.init_slices(
                    cfg, torch.Generator().manual_seed(3), "cpu", dims, index, shape[1]))
                assert got.keys() == want.keys()
                for n, p in got.items():
                    assert p.dtype == want[n].dtype and torch.equal(p, want[n]), \
                        (arch, index, n)
    finally:
        layers.DRAW_ELEMENTS = real

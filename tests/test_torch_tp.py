"""Tensor parallelism over ``"model"`` in ``train(mesh=...)`` held against
the reference's ``train(mesh=...)`` on the same mesh shape
(``tp_scenarios.py`` holds the cases, run by both packages): this file's
two-rank world trains gemma-7b, internlm2-20b (grouped KV heads: gathered),
granite-34b (one KV head split mid-head: gathered), gemma3-4b (qk-norm) and
qwen2-vl-2b (embedding inputs) on a (1, 2) mesh, and resumes and faults
gemma-7b's run; ``test_torch_tp_families.py`` runs the other families on
(1, 2), ``test_torch_tp_mesh.py`` the (2, 2) and (1, 4) meshes.  All in
float32 at lr 1e-2; the reference runs in one subprocess per world with
forced host devices and Auto-axis meshes, the port in a ``gloo`` world of
spawned ranks from the reference's initial parameters.

Tolerances, set from the readings on the CPU: the three losses within 2e-5
relative (observed: within 3.0e-6, rwkv6-1.6b's, the family whose
reference moves 4.7e-6 between its own meshes; every other within 1.3e-6);
the final parameters within 1.5e-3 absolute, every leaf having moved more
than ten times that (observed: within 1.21e-3, rwkv6-1.6b's, the others
within 4.5e-4, against a smallest movement of 1.64e-2; Adam's
normalisation lifts float32 rounding to about 1e-3 where a gradient is near
0), and a leaf without gradient, which only weight decay moves, within
1e-6; every rank's whole parameters equal rank 0's exactly; the parameters'
and the moments' local shapes equal the reference's shard shapes.  Resume
and a retried one-rank fault are exact.

The split-or-gather table (``models.tensor_parallel.plan``) is asserted
here for every registry id at (1, 2), (1, 4) and (16, 16).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import tp_scenarios as TP
from test_torch_sharded import GROUP_TIMEOUT_S, REPO, TESTS, WORLD_TIMEOUT_S

LOSS_RTOL, PARAM_ATOL, DECAY_ATOL = 2e-5, 1.5e-3, 1e-6


def _run_jax(world: str, tmp, mod) -> str:
    out = tmp / f"jax_{world}.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={mod.WORLDS[world][0]}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), TESTS])
    proc = subprocess.run([sys.executable, os.path.abspath(mod.__file__), world, str(out)],
                          env=env, capture_output=True, text=True, timeout=WORLD_TIMEOUT_S)
    assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr}"
    return out


def _run_port(world: str, ref_path, tmp, mod) -> list[dict]:
    import time

    import torch.multiprocessing as mp
    size = mod.WORLDS[world][0]
    d = tmp / f"port_{world}"
    d.mkdir()
    ctx = mp.start_processes(
        mod.torch_rank, args=(world, str(d / "store"), str(d), str(ref_path), GROUP_TIMEOUT_S),
        nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} world still running after {WORLD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out = []
    for r in range(size):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def run_world(world: str, tmp_path_factory, mod=TP):
    """``mod``'s (a scenarios module: ``WORLDS``, ``torch_rank``, run as a
    script for the reference) world: the reference's results and every
    rank's."""
    tmp = tmp_path_factory.mktemp(f"{mod.__name__}_{world}")
    ref_path = _run_jax(world, tmp, mod)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return ref, _run_port(world, ref_path, tmp, mod)


def check_case(world, name):
    """Losses, whole final parameters and both kinds of shard shape against
    the reference's; every rank alike."""
    ref, ranks = world
    want, got = ref[name], ranks[0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert set(got["params"]) == set(want["params"])
    for n, v in want["params"].items():
        atol = DECAY_ATOL if n in TP.DECAY_ONLY.get(name, ()) else PARAM_ATOL
        moved = np.abs(v - want["init"][n]).max()
        assert moved > 10 * atol, (n, moved)                # the tolerance has power
        np.testing.assert_allclose(got["params"][n], v, rtol=0, atol=atol, err_msg=n)
    assert got["param_shards"] == want["param_shards"]
    assert got["moment_shards"] == want["moment_shards"]
    for r, other in enumerate(ranks[1:], 1):         # SPMD: every rank alike
        assert other[name]["losses"] == got["losses"], r
        for n, v in got["params"].items():
            np.testing.assert_array_equal(other[name]["params"][n], v, err_msg=f"{n} rank {r}")


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return run_world("dense", tmp_path_factory)


@pytest.mark.parametrize("name", TP.WORLDS["dense"][1])
def test_model_parallel_training_matches_the_reference(dense, name):
    check_case(dense, name)


def test_local_shapes_are_model_slices(dense):
    """Rank 1's parameters are its ``"model"`` slices (half of each leaf
    ``param_specs`` shards) and its moments those slices: on (1, 2) nothing
    is cut by data."""
    ref, ranks = dense
    name = TP.RESUME_CASE
    got = ranks[1][name]
    for n, shape in ref[name]["param_shards"].items():
        whole = ref[name]["params"][n].shape
        assert got["param_shards"][n] == shape == got["moment_shards"][n]
        cut = [d for d, (a, b) in enumerate(zip(whole, shape)) if a != b]
        assert all(whole[d] == 2 * shape[d] for d in cut), (n, whole, shape)
    assert got["param_shards"]["layers.mlp.w_in"] == (2, 64, 128)


def test_resume_is_exact(dense):
    """A copy of the step-2 checkpoint of the three-step run, resumed: step
    3's loss and the final parameters equal the uninterrupted run's."""
    _ref, ranks = dense
    for res in ranks:
        assert res["resume"] == {"n_losses": 1, "loss_equal": True, "params_equal": True}


def test_one_rank_step_fault_makes_every_rank_retry(dense):
    """Rank 1's second step raises after its last collective: both ranks of
    the (1, 2) mesh (one "model" line, no data group) count one retry and
    the run equals the one without the fault."""
    _ref, ranks = dense
    for res in ranks:
        assert res["fault"] == {"retries": 1, "losses_equal": True, "params_equal": True}


# -- the split-or-gather table -------------------------------------------------

#: (arch, mesh) -> the leaves gathered, with the start of the rule; every
#: other leaf param_specs shards over "model" splits the compute
GATHERED = {
    ("hymba-1.5b", (1, 2)): {"layers.attn.wq": "mid-head", "layers.attn.wk": "mid-head",
                             "layers.attn.wv": "mid-head", "layers.attn.wo": "mid-head",
                             "layers.ssm.in_proj": "the x/z halves"},
    ("internlm2-20b", (1, 2)): {"layers.attn.wk": "grouped", "layers.attn.wv": "grouped"},
    ("granite-34b", (1, 2)): {"layers.attn.wk": "mid-head", "layers.attn.wv": "mid-head"},
    ("granite-34b", (1, 4)): {"layers.attn.wk": "mid-head", "layers.attn.wv": "mid-head"},
    ("hymba-1.5b", (16, 16)): {"layers.attn.wq": "mid-head", "layers.attn.wk": "mid-head",
                               "layers.attn.wv": "mid-head", "layers.attn.wo": "mid-head"},
    ("granite-34b", (16, 16)): {"layers.attn.wk": "mid-head", "layers.attn.wv": "mid-head"},
}


def _plan(arch, shape, smoke):
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import tensor_parallel
    from repro_torch.models import transformer as tfm
    cfg = (get_smoke_config if smoke else get_config)(arch)
    mesh = AbstractMesh(shape, ("data", "model"))
    dims = shd.model_dims(tfm.init_model(cfg, None, "meta"), mesh)
    return cfg, tensor_parallel.plan(cfg, mesh), dims


def _expected_kind(name, cfg, n):
    """The table's rule, restated: attention and RWKV's time mix split by
    heads where the heads divide (K and V only for multi-head attention),
    Hymba's ``in_proj`` is gathered (a slice takes one of its x/z halves),
    everything else splits."""
    path = name.split(".")
    if "attn" in path or "cross" in path:
        a = cfg.attn
        if a.n_heads % n:
            return "gather"
        if path[-1] in ("wq", "wo"):
            return "split"
        return "split" if a.n_kv_heads == a.n_heads else "gather"
    if "rwkv" in path and path[-1] not in ("w_ck", "w_cv"):
        return "gather" if (cfg.d_model // cfg.rwkv.head_dim) % n else "split"
    return "gather" if path[-1] == "in_proj" else "split"


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (16, 16)])
@pytest.mark.parametrize("arch", TP.ARCHS)
def test_split_or_gather_table_covers_every_model_sharded_leaf(arch, shape):
    """For every registry id (the smoke configs at (1, 2) and (1, 4), the
    published ones at (16, 16) on an ``AbstractMesh``): the table names
    exactly the leaves ``param_specs`` shards over ``"model"``, with their
    dim, and its kind follows the rule; the reference quirks are named
    (granite's one KV head and hymba's 25 query heads split mid-head)."""
    cfg, table, dims = _plan(arch, shape, smoke=shape != (16, 16))
    assert set(table) == {n for n, d in dims.items() if d is not None}
    n = shape[1]
    for name, rule in table.items():
        assert rule.dim == dims[name]
        assert rule.kind == _expected_kind(name, cfg, n), (name, rule)
    want = GATHERED.get((arch, shape))
    if want is not None:
        for name, word in want.items():
            assert table[name].kind == "gather" and table[name].why.startswith(word), \
                (name, table[name])
    if arch in ("gemma-7b", "olmoe-1b-7b", "deepseek-moe-16b", "seamless-m4t-large-v2") \
            and shape != (1, 4):
        assert all(r.kind == "split" for r in table.values()), table

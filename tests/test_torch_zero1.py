"""ZeRO-1 data-parallel ``train(mesh=...)`` held against the reference's
``train(mesh=...)`` on the same mesh shape (``zero1_scenarios.py`` holds
the cases, run by both packages): gemma-7b's smoke config on (2, 1) and
(4, 1), a (pod, data) mesh of (2, 2, 1), three rows on two ranks (rows
replicated), olmoe's with ``moe_groups`` 1 (tokens gathered: global
routing and capacity) and 2 (each rank's rows a whole group), qwen2-vl's
(embedding inputs, M-RoPE positions), and a masked batch; all in
float32.  The reference runs in one subprocess per
device count with forced host devices and Auto-axis meshes; the port in a
``gloo`` world of spawned ranks, from the reference's initial parameters.

Both packages train at lr 1e-2 (``zero1_scenarios.LR``), so that every
leaf moves by more than ten times the parameter tolerance (checked:
``_check_case``), and a leaf or a shard left unupdated, updated on the
wrong slice or from part of the batch's gradient fails.  Tolerances: the
three losses within 1e-3 relative, the final parameters within 1e-3
absolute, and a leaf without gradient, which only weight decay moves
(``zero1_scenarios.DECAY_ONLY``), within 1e-6 (observed on the CPU: losses
within 1.8e-7 relative, parameters within 2.6e-4 absolute against a
smallest leaf movement of 1.65e-2, qwen2-vl's ``embed`` within 3.7e-9 of
its 1.27e-4 movement; the packages differ by float32 rounding, matmul and
reduction orders, which Adam's normalisation lifts to about 1e-4 where a
gradient is near 0; no MoE capacity decision differed); every rank's
values equal rank 0's exactly; the
moments' local shapes equal the reference's shard shapes.  Resume and a
retried one-rank fault are exact.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import zero1_scenarios as Z
from test_torch_sharded import GROUP_TIMEOUT_S, REPO, TESTS, WORLD_TIMEOUT_S

LOSS_RTOL, PARAM_ATOL, DECAY_ATOL = 1e-3, 1e-3, 1e-6


def _run_jax(n_devices: int, tmp) -> dict:
    out = tmp / f"jax{n_devices}.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), TESTS])
    proc = subprocess.run([sys.executable, os.path.join(TESTS, "zero1_scenarios.py"),
                           str(n_devices), str(out)],
                          env=env, capture_output=True, text=True, timeout=WORLD_TIMEOUT_S)
    assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr}"
    return out


def _run_port(world: int, ref_path, tmp) -> list[dict]:
    import time

    import torch.multiprocessing as mp
    d = tmp / f"port{world}"
    d.mkdir()
    ctx = mp.start_processes(
        Z.torch_rank, args=(world, str(d / "store"), str(d), str(ref_path), GROUP_TIMEOUT_S),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world}-rank world still running after "
                                   f"{WORLD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    out = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _world(n, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"zero1_{n}")
    ref_path = _run_jax(n, tmp)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return ref, _run_port(n, ref_path, tmp)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _world(2, tmp_path_factory)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _world(4, tmp_path_factory)


def _check_case(world, name):
    ref, ranks = world
    want, got = ref[name], ranks[0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert set(got["params"]) == set(want["params"])
    for n, v in want["params"].items():
        atol = DECAY_ATOL if n in Z.DECAY_ONLY.get(name, ()) else PARAM_ATOL
        moved = np.abs(v - ref[name]["init"][n]).max()
        assert moved > 10 * atol, (n, moved)                # the tolerance has power
        np.testing.assert_allclose(got["params"][n], v, rtol=0, atol=atol, err_msg=n)
    assert got["moment_shards"] == want["moment_shards"]
    for r, other in enumerate(ranks[1:], 1):         # SPMD: every rank alike
        assert other[name]["losses"] == got["losses"], r
        for n, v in got["params"].items():
            np.testing.assert_array_equal(other[name]["params"][n], v, err_msg=f"{n} rank {r}")
        assert other[name]["moment_shards"] == got["moment_shards"]


@pytest.mark.parametrize("name", Z.WORLDS[2])
def test_two_rank_training_matches_the_reference(two, name):
    _check_case(two, name)


@pytest.mark.parametrize("name", Z.WORLDS[4])
def test_four_rank_training_matches_the_reference(four, name):
    _check_case(four, name)


@pytest.mark.parametrize("world", ["two", "four"])
def test_moments_are_dtensors_with_zero1_placements(world, request):
    """Every moment a ``DTensor`` sharded over the data axes on the dim the
    reference's ZeRO-1 shard cuts (its shard shape against the leaf's):
    ``Shard(d)`` on each data mesh dim (the pod and the data dims of the
    (2, 2, 1) mesh), ``Replicate()`` on "model"."""
    ref, ranks = request.getfixturevalue(world)
    for name in Z.WORLDS[2 if world == "two" else 4]:
        n_data = len(Z.CASES[name][1]) - 1
        for leaf, pl in ranks[0][name]["placements"].items():
            full = ref[name]["params"][leaf].shape
            cut = [d for d, (a, b) in enumerate(zip(full, ref[name]["moment_shards"][leaf]))
                   if a != b]
            assert len(cut) == 1, (name, leaf)     # every smoke leaf has a divisible dim
            assert pl == (f"S({cut[0]})",) * n_data + ("R",), (name, leaf, pl)


def test_masked_batch_uses_the_global_denominator(two):
    """Masks keep 5, 20, 33 and 24 tokens of the four rows: a rank's mean
    over its own rows is not the global one, and the loss and the gradient
    norm equal the reference's on the whole batch (rtol 1e-5) only with the
    global ``sum(mask)``.  The updated parameters are held to the training
    tolerance: Adam's first step divides each gradient by its own size, so
    an element whose gradient is near 0 moves by up to about 1e-4 between
    float32 roundings."""
    ref, ranks = two
    want = ref["masked"]
    for res in ranks:
        got = res["masked"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
        for n, v in want["params"].items():
            np.testing.assert_allclose(got["params"][n], v, rtol=0, atol=PARAM_ATOL, err_msg=n)


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_statistics_and_capacity_are_global(two, groups):
    """Under the two-rank data group ``moe_block`` gives every rank its rows
    of the whole batch's output, the whole batch's aux loss, and gradients
    that sum to the whole batch's: gathered tokens (``moe_groups`` 1) and
    all-reduced statistics (2)."""
    _ref, ranks = two
    for res in ranks:
        errs = res["moe_statistics"][f"groups{groups}"]
        assert errs["out"] < 1e-5 and errs["aux"] < 1e-6, errs
        for k, v in errs.items():
            if k.startswith("grad/"):
                assert v < 1e-5, (k, v)


def test_global_norm_counts_replicated_leaves_once(two):
    _ref, ranks = two
    for res in ranks:
        g = res["global_norm"]
        assert g["dims"] == {"a": 0, "b": None, "c": 1}      # (8, 3), (3,), (3, 6)
        np.testing.assert_allclose(g["norm"], g["want"], rtol=1e-6)


def test_recompute_on_another_thread_sees_the_data_group(two):
    """The backward on a thread of its own, as CUDA runs it: remat's
    recompute of each MoE layer sees the data group and routes every rank's
    tokens, as the forward did, and the gradients equal the calling
    thread's backward's."""
    _ref, ranks = two
    for res in ranks:
        got = res["backward_thread"]
        assert got["remat"] and got["errors"] == [], got
        assert got["route_tokens"] == [Z.BATCH * Z.SEQ] * (2 * got["n_layers"]), got
        assert got["grads_equal"], got


def test_checkpoint_gathers_moments_to_the_writer_host(two):
    """A save's moments: whole host tensors on the writer (rank 0), equal to
    the wholes the shards came from; nothing on the other rank."""
    _ref, ranks = two
    assert ranks[0]["checkpoint_moments"] == {"none": False, "dims": {"a": 0, "b": None},
                                              "equal": True}
    assert ranks[1]["checkpoint_moments"] == {"none": True}


def test_resume_is_exact(two):
    """A copy of the step-2 checkpoint of the three-step run, resumed: step
    3's loss and the final parameters equal the uninterrupted run's."""
    _ref, ranks = two
    for res in ranks:
        assert res["resume"] == {"n_losses": 1, "loss_equal": True, "params_equal": True}


def test_one_rank_step_fault_makes_every_rank_retry(two):
    """Rank 1's second step raises after its last collective: both ranks
    count one retry and the run equals the one without the fault."""
    _ref, ranks = two
    for res in ranks:
        assert res["fault"] == {"retries": 1, "losses_equal": True, "params_equal": True}


def test_one_rank_programming_error_raises_on_every_rank(two):
    """Rank 1's second step raises a ``ValueError``: nobody retries, rank 1
    raises it and rank 0 a ``StepFailure``, and neither waits forever."""
    _ref, ranks = two
    assert [res["fatal"] for res in ranks] == ["StepFailure", "ValueError"]


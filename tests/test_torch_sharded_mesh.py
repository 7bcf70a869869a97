"""The ``sharded`` executor on eight and four ranks, held against the JAX
package: elementwise + reduce on an 8-rank mesh, the multi-pod
``("pod", "data")`` mesh on 2 x 4, every reduction on 8 ranks, the mesh
helpers, the output's sharding on 4 (every rank holds a (16,) shard), and
elastic restore onto a 4-rank mesh.  The harness and tolerances are
``test_torch_sharded.py``'s.
"""

import numpy as np
import pytest

import sharded_scenarios as S
from test_torch_sharded import (REDUCE_IDS, check_case, check_reduction, run_jax_side,
                                run_port_world)


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded8")
    return run_jax_side(8, tmp), run_port_world(8, tmp)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded4")
    return run_jax_side(4, tmp), run_port_world(4, tmp)


def test_sharded_elementwise_and_reduce(eight):
    want, ranks = eight
    check_case(ranks, want, ("elementwise_and_reduce",))
    got = ranks[0]["elementwise_and_reduce"]
    expect = np.log1p(np.arange(4096.0)) * 3
    np.testing.assert_allclose(got["values"]["b"], expect, rtol=1e-5)
    assert np.isclose(got["values"]["s"], expect.sum(), rtol=1e-5)
    assert got["stats"]["sharded_stages"] == 1


def test_sharded_multipod_axes(eight):
    """Splits spread over BOTH the pod and data axes (one flattened group,
    shards in the reference's row-major order)."""
    want, ranks = eight
    check_case(ranks, want, ("multipod_axes",))
    got = ranks[0]["multipod_axes"]["values"]
    expect = np.exp(np.arange(1024.0) / 128.0) + 1
    np.testing.assert_allclose(got["y"], expect, rtol=1e-5)
    assert np.isclose(got["s"], expect.sum(), rtol=1e-6)


@pytest.mark.parametrize("name,dtype", S.REDUCE_CASES, ids=REDUCE_IDS)
def test_sharded_reduction_on_eight_ranks(eight, name, dtype):
    """Eight partials per reduction: the mul fold's shard order and every
    all-reduce, as on two ranks."""
    check_reduction(eight, name, dtype)


@pytest.mark.parametrize("mesh", ["host_8x1", "host_2x4", "host_16x1", "host_3x5", "pod_data"])
def test_mesh_helpers_like_jax(eight, mesh):
    """``make_host_mesh`` clamps to the group as the reference clamps to the
    devices; ``data_axes_of``, ``dp_extent`` and ``tp_extent`` agree."""
    want, ranks = eight
    for res in ranks:
        assert res["mesh_helpers"]["meshes"][mesh] == want["mesh_helpers"]["meshes"][mesh]


def test_sharded_output_sharding_matches_split_axis(four):
    """matvec over rows on 4 ranks: every rank's local shard is (16,), as
    every addressable shard of the reference's global array."""
    want, ranks = four
    check_case(ranks, want, ("output_sharding",))
    assert want["output_sharding"]["local_shapes"] == [(16,)]
    for res in ranks:
        assert res["output_sharding"]["local_shapes"] == [(16,)]
    m = np.random.RandomState(0).randn(64, 8).astype(np.float32)
    np.testing.assert_allclose(ranks[0]["output_sharding"]["values"]["z"],
                               np.exp(m @ np.ones(8)), rtol=1e-4)


@pytest.mark.parametrize("leaf", ["w", "b"])
def test_elastic_checkpoint_restore_across_meshes(four, leaf):
    """Save on one layout, restore onto a 4-rank mesh: ``w`` sharded by rows
    ((2, 8) per rank), ``b`` replicated; the values equal on every rank."""
    want, ranks = four
    w = want["elastic_restore"]
    tree = {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
            "b": np.arange(8.0, dtype=np.float32)}
    np.testing.assert_array_equal(w["values"][leaf], tree[leaf])
    for res in ranks:
        got = res["elastic_restore"]
        np.testing.assert_array_equal(got["values"][leaf], tree[leaf])
        assert got["local_shapes"][leaf] == w["local_shapes"][leaf]
        assert got["n_shards"][leaf] == w["n_shards"][leaf] == 4

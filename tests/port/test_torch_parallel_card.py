"""The parallel layer on the card at world size 1 (NCCL, a world of one
process), against the unsharded paths: the NN merges equal to K2, big
cloud's ring equal to its gather, the sharded converge equal to the driver
bit for bit, the edge-sharded PCG within float32 round-off of the unsharded
solve (both sum with index_add_'s atomics).  Skips without a card;
``chip_smoke.py`` phase 13 runs the same paths at full width."""

import numpy as np
import pytest
import torch

import icp_tpu_torch as icp
from icp_tpu_torch import parallel as par


@pytest.fixture
def mesh(cuda_device, monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    mesh = par.make_mesh()
    yield mesh
    torch.distributed.destroy_process_group()


def _cloud(rng, n, dim=3):
    return torch.tensor(rng.uniform(-20, 20, (n, dim)), dtype=torch.float32, device="cuda")


@pytest.mark.cuda
def test_nn_merges_equal_k2(mesh):
    rng = np.random.default_rng(0)
    q, t = _cloud(rng, 1000), _cloud(rng, 4096)
    mask = torch.tensor(rng.uniform(size=4096) > 0.1, device="cuda")
    want = icp.ops.pallas_nn.nearest_neighbors_pallas(q, t, mask)
    for got in (par.sharded_nearest_neighbors(q, t, mask, mesh),
                par.ring_nearest_neighbors(q, t, mask, mesh)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_big_cloud_ring_equals_gather(mesh):
    rng = np.random.default_rng(1)
    a = _cloud(rng, 2048)
    b = a + torch.tensor([0.3, -0.2, 0.1], device="cuda")
    ones = torch.ones(2048, dtype=torch.bool, device="cuda")
    runs = [par.big_cloud_converge(a, ones, b, ones, icp.identity(3), mesh, max_iterations=10,
                                   solver="svd", target_mode=mode) for mode in ("gather", "ring")]
    (tf_g, it_g, nn_g), (tf_r, it_r, nn_r) = runs
    assert it_g == it_r == 10
    assert torch.equal(tf_g.translation, tf_r.translation) and torch.equal(nn_g, nn_r)
    assert float((tf_g.translation.cpu() - torch.tensor([0.3, -0.2, 0.1])).abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shard_points", [False, True])
def test_sharded_converge_equals_driver(mesh, shard_points):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-20, 20, (300, 2))
    a = icp.stack([icp.from_points(pts, capacity=320)] * 16)
    b = icp.stack([icp.from_points(pts + [0.4, -0.1], capacity=320)] * 16)
    guess = icp.identity(2, (16,))
    method = icp.from_method("trimmed", 2)
    cfg = icp.DriverConfig(max_iterations=30, angle_tolerance=1e-4, translation_tolerance=1e-4)
    want, _ = icp.converge(method, a, b, guess, cfg)
    fn = par.make_sharded_converge_fn(method, cfg, mesh, shard_points=shard_points)
    got, _ = fn(*par.shard_batch((a, b, guess), mesh, shard_points))
    assert torch.equal(got.iteration_count, want.iteration_count)
    assert torch.equal(got.transform.rotation, want.transform.rotation)
    assert torch.equal(got.transform.translation, want.transform.translation)


@pytest.mark.cuda
def test_edge_sharded_pcg_matches_unsharded(mesh, scan_dir):
    graph = icp.io.read_g2o(f"{scan_dir}/manhattan/m600.g2o")
    want, want_costs = icp.pose_graph.optimize(graph, iterations=5, solver="pcg")
    got, got_costs = icp.pose_graph.optimize(icp.pose_graph.shard_over_edges(graph, mesh),
                                             iterations=5, solver="pcg")
    assert float((got.poses.translation - want.poses.translation).abs().max()) < 1e-3
    # index_add_'s float32 atomics sum in any order, in either solve: the
    # costs agree to the float32 bound of a sum of E terms, E * eps.
    rtol = graph.num_edges * torch.finfo(torch.float32).eps
    torch.testing.assert_close(got_costs, want_costs, rtol=rtol, atol=0)

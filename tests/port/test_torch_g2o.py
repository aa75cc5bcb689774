"""``icp_tpu_torch.io.read_g2o`` / ``write_g2o`` against the JAX package's,
float64 on the CPU: every field equal on the three bundled graphs (m600,
m3500, sphere2500), the written text byte-equal, sparse vertex ids remapped
the same way, the identity-information rule, and the errors."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import icp_tpu_torch as T
from icp_tpu.io import g2o as jg2o
from icp_tpu_torch import convert
from icp_tpu_torch.io import g2o

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GRAPHS = {name: os.path.join(REPO, "ex_data", "manhattan", f"{name}.g2o")
          for name in ("m600", "m3500", "sphere2500")}


def _assert_fields_equal(got, jgraph):
    want = dataclasses.asdict(jgraph)
    for key, value in convert.pose_graph_to_numpy(got).items():
        if isinstance(value, dict):
            for k in value:
                np.testing.assert_array_equal(value[k], np.asarray(want[key][k]), err_msg=key)
        elif value is None:
            assert want[key] is None, key
        else:
            np.testing.assert_array_equal(value, np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_read_and_write_match_jax(name, tmp_path):
    got = g2o.read_g2o(GRAPHS[name], device="cpu")
    jgraph = jg2o.read_g2o(GRAPHS[name])
    assert got.poses.dtype == torch.float64 and got.edges_ij.dtype == torch.int32
    assert got.sqrt_information is not None  # the bundled graphs carry information
    _assert_fields_equal(got, jgraph)
    ours, theirs = tmp_path / "port.g2o", tmp_path / "jax.g2o"
    g2o.write_g2o(str(ours), got)
    jg2o.write_g2o(str(theirs), jgraph)
    assert ours.read_bytes() == theirs.read_bytes()
    # The round trip keeps the graph (weights fold into the information).
    again = g2o.read_g2o(str(ours), device="cpu")
    np.testing.assert_allclose(again.poses.translation.numpy(), got.poses.translation.numpy(),
                               atol=1e-8)


def test_sparse_ids_identity_information_and_weights(tmp_path):
    lines = [
        "# a comment", "VERTEX_SE2 30 1 0 0.5", "VERTEX_SE2 10 0 0 0", "FIX 10",
        "VERTEX_SE2 20 0.5 0.2 0.1",
        "EDGE_SE2 10 20 0.5 0.2 0.1 1 0 0 1 0 1",
        "EDGE_SE2 20 30 0.5 -0.2 0.4 1 0 0 1 0 1",
        "EDGE_SE2 30 10 -1 0 -0.5 1 0 0 1 0 1",
    ]
    got = g2o.read_g2o(lines, device="cpu")
    jgraph = jg2o.read_g2o(lines)
    assert got.sqrt_information is None and jgraph.sqrt_information is None
    _assert_fields_equal(got, jgraph)
    assert got.edges_ij.tolist() == [[0, 1], [1, 2], [2, 0]]
    # Scalar weights fold into the exported information, as in JAX.
    weighted = dataclasses.replace(got, weights=torch.tensor([1.0, 2.0, 3.0],
                                                             dtype=torch.float64))
    ours, theirs = tmp_path / "port.g2o", tmp_path / "jax.g2o"
    g2o.write_g2o(str(ours), weighted)
    jg2o.write_g2o(str(theirs), dataclasses.replace(
        jgraph, weights=np.array([1.0, 2.0, 3.0])))
    assert ours.read_bytes() == theirs.read_bytes()
    assert "EDGE_SE2 1 2 0.5 -0.2 0.4 2 0 0 2 0 2" in ours.read_text()
    f32 = g2o.read_g2o(lines, dtype=torch.float32, device="cpu")
    assert f32.poses.dtype == torch.float32 and f32.weights.dtype == torch.float32


@pytest.mark.parametrize("lines, match", [
    (["VERTEX_SE2 0 0 0 0", "VERTEX_SE3:QUAT 1 0 0 0 0 0 0 1"], "mixed"),
    (["VERTEX_SE2 0 0 0 0", "EDGE_SE2 0 0 1 2 3"], "3 \\+ 6"),
    (["EDGE_SE2 0 1 0 0 0 1 0 0 1 0 1"], "no SE2/SE3 vertices"),
])
def test_read_errors_match_jax(lines, match):
    for read in (jg2o.read_g2o, lambda x: g2o.read_g2o(x, device="cpu")):
        with pytest.raises(ValueError, match=match):
            read(lines)


def _default_device_calls():
    fields = convert.pose_graph_to_numpy(g2o.read_g2o(GRAPHS["m600"], device="cpu"))
    return {
        "read_g2o": lambda: T.io.read_g2o(GRAPHS["m600"]),
        "pose_graph_from_numpy": lambda: convert.pose_graph_from_numpy(fields),
    }


@pytest.mark.parametrize("name", ["read_g2o", "pose_graph_from_numpy"])
def test_entry_points_raise_without_a_card(name):
    """``read_g2o`` and ``pose_graph_from_numpy`` put the graph on the card
    unless ``device="cpu"``; with no card that raises (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present (test_entry_points_default_to_the_card covers it)")
    with pytest.raises((AssertionError, RuntimeError)):
        _default_device_calls()[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["read_g2o", "pose_graph_from_numpy"])
def test_entry_points_default_to_the_card(cuda_device, name):
    graph = _default_device_calls()[name]()
    assert graph.poses.translation.device == cuda_device
    assert graph.edges_ij.device == cuda_device and graph.poses.dtype == torch.float32

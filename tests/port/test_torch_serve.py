"""``icp_tpu_torch.serve.BatchingRegistrar`` on the CPU device: the nine
behaviours of the JAX package's ``tests/test_serve.py`` (single and
concurrent requests, oversized and mismatched requests refused alone,
closing, a cancelled future, capacity buckets, load shedding, an injected
converge), and a served pose equal to the JAX package's server and to a
direct batched ``converge`` of the same pair (float64, 1e-9).  The
``cuda`` twin serves on the card in float32: every future resolves, each
result equal to a direct ``converge`` of its padded batch lane."""

import threading

import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu.serve import BatchingRegistrar as JaxRegistrar
from icp_tpu_torch.serve import BatchingRegistrar, ServerOverloaded

EXACT = dict(max_iterations=30, angle_tolerance=1e-4, translation_tolerance=1e-4)


def make_pair(rng, shift):
    a = rng.uniform(-20, 20, (48, 2))
    return a, a + shift


def _server(method=None, config=None, **kw):
    kw.setdefault("dtype", np.float64)
    return BatchingRegistrar(
        method or T.from_method("trimmed", 2, T.Config(overlap_rate=1.0)),
        config or T.DriverConfig(**EXACT), device="cpu", **kw)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_single_request(rng):
    a, b = make_pair(rng, np.array([1.5, -0.5]))
    with _server(capacity=64, max_batch_size=8) as server:
        result = server.register(a, b, timeout=120)
    np.testing.assert_allclose(result.translation, [1.5, -0.5], atol=1e-3)
    assert result.iterations > 0 and result.rotation.shape == (2, 2)


def test_concurrent_clients_batched(rng):
    """Many threads submit different pairs; every client gets its answer."""
    shifts = [np.array([0.5 * k, -0.25 * k]) for k in range(12)]
    pairs = [make_pair(rng, s) for s in shifts]
    server = _server(capacity=64, max_batch_size=8, max_delay=0.05)
    results = [None] * len(pairs)

    def client(k):
        results[k] = server.register(*pairs[k], timeout=300)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(len(pairs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    server.close()
    for k, s in enumerate(shifts):
        np.testing.assert_allclose(results[k].translation, s, atol=1e-3)


def test_oversized_cloud_rejected(rng):
    server = _server(config=T.DriverConfig(max_iterations=5), capacity=32)
    big = rng.uniform(-5, 5, (100, 2))
    with pytest.raises(ValueError, match="exceeds server capacity"):
        server.submit(big, big)
    server.close()


def test_submit_after_close_raises(rng):
    server = _server(config=T.DriverConfig(max_iterations=5), capacity=32)
    a, b = make_pair(rng, np.array([0.1, 0.1]))
    server.register(a[:20], b[:20], timeout=120)
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(a[:20], b[:20])


def test_cancelled_future_does_not_kill_worker(rng):
    server = _server(config=T.DriverConfig(max_iterations=10, angle_tolerance=1e-3,
                                           translation_tolerance=1e-2),
                     capacity=64, max_batch_size=4, max_delay=0.2)
    a, b = make_pair(rng, np.array([0.4, 0.2]))
    doomed = server.submit(a, b)
    assert doomed.cancel()  # queued, not yet running
    result = server.register(a, b, timeout=300)
    server.close()
    np.testing.assert_allclose(result.translation, [0.4, 0.2], atol=1e-2)


def test_dimension_mismatch_rejected_per_request(rng):
    server = _server(config=T.DriverConfig(max_iterations=5), capacity=64)
    bad3d = rng.uniform(-5, 5, (10, 3))
    with pytest.raises(ValueError, match="dimension mismatch"):
        server.submit(bad3d, bad3d)
    server.close()


def test_capacity_buckets(rng):
    """Requests pad to the smallest bucket that fits; both buckets serve."""
    calls = []
    method = T.from_method("trimmed", 2, T.Config(overlap_rate=1.0))
    inner = T.make_converge_fn(method, T.DriverConfig(**dict(EXACT, max_iterations=20)))

    def spy(src, tgt, guess):
        calls.append(src.capacity)
        return inner(src, tgt, guess)

    small, big = rng.uniform(-5, 5, (20, 2)), rng.uniform(-5, 5, (100, 2))
    with _server(method, capacity=(32, 128), max_batch_size=4, converge_fn=spy) as server:
        r_small = server.register(small, small + [0.1, 0.0], timeout=120)
        r_big = server.register(big, big + [0.0, 0.2], timeout=120)
    np.testing.assert_allclose(r_small.translation, [0.1, 0.0], atol=1e-3)
    np.testing.assert_allclose(r_big.translation, [0.0, 0.2], atol=1e-3)
    assert calls == [32, 128]


def test_bounded_queue_sheds_load(rng):
    server = _server(config=T.DriverConfig(max_iterations=5, angle_tolerance=1e-4,
                                           translation_tolerance=1e-4),
                     capacity=32, max_batch_size=2, max_pending=1)
    a = rng.uniform(-5, 5, (16, 2))
    shed, futures = 0, []
    try:
        for _ in range(200):
            try:
                futures.append(server.submit(a, a))
            except ServerOverloaded:
                shed += 1
    finally:
        for f in futures:
            f.result(timeout=120)
        server.close()
    assert shed > 0


def test_injected_converge_fn_and_failing_batch(rng):
    """``converge_fn`` is honoured; a batch that raises resolves its futures
    with the exception, and the worker serves the next batch."""
    calls = []
    method = T.from_method("trimmed", 2, T.Config(overlap_rate=1.0))
    inner = T.make_converge_fn(method, T.DriverConfig(**dict(EXACT, max_iterations=10)))

    def spy(src, tgt, guess):
        calls.append(tuple(src.points.shape))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return inner(src, tgt, guess)

    a = rng.uniform(-5, 5, (16, 2))
    with _server(method, capacity=32, max_batch_size=2, converge_fn=spy) as server:
        with pytest.raises(RuntimeError, match="boom"):
            server.register(a, a + [0.05, 0.0], timeout=120)
        result = server.register(a, a + [0.05, 0.0], timeout=120)
    assert calls == [(2, 32, 2), (2, 32, 2)]
    np.testing.assert_allclose(result.translation, [0.05, 0.0], atol=1e-3)


def test_served_pose_matches_jax_server_and_direct_converge(scan_dir):
    """scan1 under a seeded guess: the served pose equals the JAX package's
    server and a direct converge of the padded batch lane."""
    a = T.io.parse_lidar_scan_array(f"{scan_dir}/scan1/first.csv")
    b = T.io.parse_lidar_scan_array(f"{scan_dir}/scan1/second.csv")
    cfg = dict(max_iterations=50, angle_tolerance=0.1 * np.pi / 180, translation_tolerance=0.01)
    guess = T.from_angle_2d(0.03, [0.1, -0.05], device="cpu")
    method = T.from_method("trimmed", 2, T.Config(overlap_rate=0.9))
    with _server(method, T.DriverConfig(**cfg), capacity=1024, max_batch_size=4) as server:
        got = server.register(a, b, guess=guess, timeout=300)
    jguess = J.geometry.from_angle_2d(np.float64(0.03), np.array([0.1, -0.05]))
    with JaxRegistrar(J.from_method("trimmed", 2, J.Config(overlap_rate=0.9)),
                      J.DriverConfig(**cfg), capacity=1024, max_batch_size=4,
                      dtype=np.float64) as jserver:
        want = jserver.register(a, b, guess=jguess, timeout=300)
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.translation, want.translation, atol=1e-9)
    np.testing.assert_allclose(got.rotation, want.rotation, atol=1e-9)
    src, tgt = (T.stack([T.from_points(p, capacity=1024, device="cpu")] * 4) for p in (a, b))
    direct, _ = T.converge(method, src, tgt,
                           T.RigidTransform(guess.rotation.expand(4, 2, 2),
                                            guess.translation.expand(4, 2)),
                           T.DriverConfig(**cfg))
    np.testing.assert_allclose(got.translation, direct.transform.translation[0].numpy(),
                               atol=1e-12)


def test_cuda_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        BatchingRegistrar(T.from_method("trimmed", 2), T.DriverConfig(max_iterations=5))


@pytest.mark.cuda
def test_serving_on_card_matches_direct_converge(cuda_device, scan_dir):
    a = T.io.parse_lidar_scan_array(f"{scan_dir}/scan1/first.csv")
    b = T.io.parse_lidar_scan_array(f"{scan_dir}/scan1/second.csv")
    cfg = T.DriverConfig(max_iterations=50, angle_tolerance=0.1 * np.pi / 180,
                         translation_tolerance=0.01)
    method = T.from_method("trimmed", 2, T.Config(overlap_rate=0.9))
    rng = np.random.default_rng(3)
    shifts = rng.uniform(-0.2, 0.2, (16, 2)).astype(np.float32)
    with BatchingRegistrar(method, cfg, capacity=1024, max_batch_size=16, max_delay=0.05,
                           device=cuda_device) as server:
        futures = [server.submit(a + s, b) for s in shifts]
        results = [f.result(timeout=300) for f in futures]
    src = T.stack([T.from_points(a + s, capacity=1024, dtype=torch.float32, device=cuda_device)
                   for s in shifts])
    tgt = T.stack([T.from_points(b, capacity=1024, dtype=torch.float32, device=cuda_device)] * 16)
    direct, _ = T.converge(method, src, tgt,
                           T.identity(2, (16,), dtype=torch.float32, device=cuda_device), cfg)
    want = direct.transform.translation.cpu().numpy()
    for r, w in zip(results, want):
        np.testing.assert_allclose(r.translation, w, atol=1e-5)

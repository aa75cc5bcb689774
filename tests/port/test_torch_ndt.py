"""NDT: ``icp_tpu_torch.ops.ndt``, ``methods/ndt`` and
``converge_ndt_multiscale`` against the JAX package in float64 on the CPU.

Exact: map keys, counts, validity and overflow, lookup hits and slots
(``dense`` against ``sorted``, and each against JAX), iteration counts.
Within 1e-9: means and covariances (rtol), poses (atol) and costs (rtol).
Inputs are seeded clouds of up to ~300 points and the in-repo scan1 pair;
``converge_ndt_multiscale(coarse_init=True)`` starts from the global
initializer of ``ops/coarse``, as in JAX.
The ``cuda``-marked twins build maps and run p2d and d2d on the card in
float32 against the CPU float64 run.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp_tpu as J
import icp_tpu_torch as T
from icp_tpu.multiscale import converge_ndt_multiscale as j_ndt_multiscale
from icp_tpu.ops import ndt as jndt
from icp_tpu_torch import convert
from icp_tpu_torch.multiscale import converge_ndt_multiscale
from icp_tpu_torch.ops import ndt

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = dict(max_iterations=50, angle_tolerance=0.1 * np.pi / 180, translation_tolerance=0.01)
SCAN1_NDT = dict(cell_size=0.5, cells=1024)
EXACT = ("keys", "valid", "counts", "overflowed", "cell_size", "offset")


def _jax_converge(method, source, target, guess, config):
    """``icp_tpu.converge`` under one ``jax.jit`` (compiles faster than
    its eager entry)."""
    return jax.jit(lambda s, t, g: J.converge(method, s, t, g, config))(source, target, guess)


def _room(dim, seed, n=50, noise=0.01):
    """Points along walls (2D) or on three planes (3D)."""
    rng = np.random.default_rng(seed)
    if dim == 2:
        ts = np.linspace(0.0, 1.0, n)
        segs = [((-5, -4), (5, -4)), ((5, -4), (5, 4)), ((5, 4), (-5, 4)), ((-5, 4), (-5, -4)),
                ((-1, -1), (2, -1)), ((2, -1), (2, 2))]
        pts = np.concatenate([np.stack([x0 + (x1 - x0) * ts, y0 + (y1 - y0) * ts], -1)
                              for (x0, y0), (x1, y1) in segs])
    else:
        u = lambda lo, hi: rng.uniform(lo, hi, n)  # noqa: E731
        pts = np.concatenate([np.stack([u(-4, 4), u(-4, 4), np.zeros(n)], -1),
                              np.stack([u(-4, 4), np.full(n, -4.0), u(0, 3)], -1),
                              np.stack([np.full(n, 4.0), u(-4, 4), u(0, 3)], -1)])
    return pts + rng.normal(0, noise, pts.shape)


def _assert_maps_equal(got: ndt.NdtMap, want):
    for name in ndt.NdtMap._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9, err_msg=name)


def _map_case(dim, case):
    """(points, mask, cell_size, capacity, min_points) of a build case."""
    rng = np.random.default_rng(dim * 7 + len(case))
    pts = rng.uniform(-6, 6, (240, dim))
    mask = np.ones(240, dtype=bool)
    cell, cap, min_points = 1.5, 256, 4
    if case == "masked":
        mask = rng.uniform(size=240) > 0.3
    elif case == "overflow":
        cap = 16
    elif case == "far":  # cell-anchored moments ~300 m out
        pts = pts + 300.0
    elif case == "mid_invalid":  # an underpopulated cell between full ones
        pts[:, 0] = np.where(pts[:, 0] > 0, pts[:, 0], 0.3 * pts[:, 0])
        pts[:2] = [[-3.4] + [0.1] * (dim - 1), [-3.3] + [0.2] * (dim - 1)]
        min_points = 3
    elif case == "empty":
        mask[:] = False
    return pts, mask, cell, cap, min_points


@pytest.mark.parametrize("case", ["plain", "masked", "overflow", "far", "mid_invalid", "empty"])
@pytest.mark.parametrize("dim", [2, 3])
def test_build_map_matches_jax(dim, case):
    pts, mask, cell, cap, min_points = _map_case(dim, case)
    got = ndt.build_ndt_map(torch.from_numpy(pts), torch.from_numpy(mask), cell, cap,
                            min_points=min_points)
    want = jax.jit(jndt.build_ndt_map, static_argnums=(2, 3, 5))(
        jnp.asarray(pts), jnp.asarray(mask), cell, cap, None, min_points)
    _assert_maps_equal(got, want)
    assert bool(got.overflowed) == (case == "overflow")
    keys = got.keys.numpy().astype(np.int64)
    assert np.all(np.diff(keys) >= 0)


@pytest.mark.parametrize("dim", [2, 3])
def test_overlapping_batched_maps_match_jax(dim):
    """The 2^D shifted grids of a B = 2 batch: every field, every shape."""
    pts = np.stack([_room(dim, 1, 30), _room(dim, 2, 30)])
    mask = np.ones(pts.shape[:-1], dtype=bool)
    mask[1, -7:] = False
    got = ndt.build_overlapping_ndt_maps(torch.from_numpy(pts), torch.from_numpy(mask), 1.0, 128)
    want = jax.jit(jndt.build_overlapping_ndt_maps, static_argnums=(2, 3))(
        jnp.asarray(pts), jnp.asarray(mask), 1.0, 128)
    assert got.keys.shape == (2 ** dim, 2, 128)
    _assert_maps_equal(got, want)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_lookups_match_jax_and_each_other(dim, batched):
    """On the JAX package's maps, carried over by ``convert``: each lookup
    equals its JAX counterpart exactly, and ``sorted`` and ``dense`` give
    the same hits, slots and statistics (misses: zeros from ``dense``)."""
    rng = np.random.default_rng(dim + 2 * batched)
    pts = rng.uniform(-6, 6, (2, 300, dim)) if batched else rng.uniform(-6, 6, (300, dim))
    q = rng.uniform(-8, 8, pts.shape[:-2] + (120, dim))
    jmaps = jax.jit(jndt.build_overlapping_ndt_maps, static_argnums=(2, 3, 4))(
        jnp.asarray(pts), jnp.ones(pts.shape[:-1], bool), 1.5, 128, 2)
    maps = convert.ndt_map_from_numpy(jmaps._asdict(), device="cpu")
    tq = torch.from_numpy(q).expand(maps.keys.shape[:-1] + q.shape[-2:])
    jq = jnp.broadcast_to(jnp.asarray(q), tq.shape)
    dense = ndt.lookup_cells_dense(tq, maps, include_covs=True)
    srt = ndt.lookup_cells(tq, maps, include_covs=True)
    jdense = jax.jit(functools.partial(jndt.lookup_cells_dense, include_covs=True))(jq, jmaps)
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[len(tq.shape) - 2:]), jmaps)
    jsorted = jax.jit(jax.vmap(functools.partial(jndt.lookup_cells, include_covs=True)))(
        jq.reshape((-1,) + jq.shape[-2:]), flat)
    hit = srt[2]
    assert torch.equal(dense[2], hit) and hit.any() and not hit.all()
    for got, want in ((dense, jdense), (srt, jsorted)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).reshape(g.shape))
    for i in (0, 1, 3, 4):
        assert torch.equal(dense[i][hit], srt[i][hit])
    assert (dense[0][~hit] == 0).all()


@pytest.mark.parametrize("dim", [2, 3])
def test_inverse_small_spd_matches_jax(dim):
    rng = np.random.default_rng(dim)
    m = rng.normal(size=(40, dim, dim))
    spd = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(dim)
    got = ndt.inverse_small_spd(torch.from_numpy(spd)).numpy()
    np.testing.assert_allclose(got, np.asarray(jndt.inverse_small_spd(jnp.asarray(spd))),
                               rtol=1e-12)
    np.testing.assert_allclose(got @ spd, np.broadcast_to(np.eye(dim), spd.shape), atol=1e-9)
    with pytest.raises(ValueError):
        ndt.inverse_small_spd(torch.eye(4, dtype=torch.float64))


@functools.cache
def _scan1():
    return (T.io.parse_lidar_scan_array(f"{REPO}/ex_data/scan1/first.csv"),
            T.io.parse_lidar_scan_array(f"{REPO}/ex_data/scan1/second.csv"))


def _sides(a, b, rot, trans):
    jg = J.RigidTransform(jnp.asarray(rot), jnp.asarray(trans))
    lead = jg.batch_shape
    js, jt = (J.from_points(p, dtype=np.float64) for p in (a, b))
    js, jt = (J.PointCloud(jnp.broadcast_to(c.points, (*lead, *c.points.shape)),
                           jnp.full(lead, c.count)) for c in (js, jt))
    port = tuple(convert.cloud_from_numpy(np.asarray(c.points), np.asarray(c.count), device="cpu")
                 for c in (js, jt))
    return (js, jt, jg), port + (convert.transform_from_numpy(rot, trans, device="cpu"),)


def _assert_results_equal(tres, jres):
    np.testing.assert_array_equal(tres.iteration_count.numpy(), np.asarray(jres.iteration_count))
    np.testing.assert_allclose(tres.cost.numpy(), np.asarray(jres.cost), rtol=1e-9)
    for got, want in ((tres.transform.rotation, jres.transform.rotation),
                      (tres.transform.translation, jres.transform.translation)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9)


@pytest.mark.parametrize("variant", ["p2d", "d2d"])
def test_scan1_ndt_matches_jax(variant):
    """scan1 from the identity under the bench driver config.  d2d runs
    ``with_precomputed`` on maps the JAX package built, carried over by
    ``convert.ndt_map_from_numpy``; the port's own maps equal them."""
    a, b = _scan1()
    (js, jt, jg), (ts, tt, tg) = _sides(a, b, np.eye(2), np.zeros(2))
    cfg = dict(SCAN1_NDT, variant=variant)
    jm, tm = J.from_method("ndt", 2, J.Config(**cfg)), T.from_method("ndt", 2, T.Config(**cfg))
    if variant == "p2d":
        jres, jstate = _jax_converge(jm, js, jt, jg, J.DriverConfig(**BENCH))
        tres, tstate = T.converge(tm, ts, tt, tg, T.DriverConfig(**BENCH))
    else:
        ja, jb = jax.jit(jm.precompute)(js), jax.jit(jm.precompute)(jt)
        ta, tb = (convert.ndt_map_from_numpy(m._asdict(), device="cpu") for m in (ja, jb))
        _assert_maps_equal(tm.precompute(ts), ja)
        jres, jstate = _jax_converge(jm.with_precomputed(ja, jb), js, jt, jg,
                                     J.DriverConfig(**BENCH))
        tres, tstate = T.converge(tm.with_precomputed(ta, tb), ts, tt, tg, T.DriverConfig(**BENCH))
    _assert_results_equal(tres, jres)
    np.testing.assert_allclose(tstate.match_cost.numpy(), np.asarray(jstate.match_cost),
                               rtol=1e-9)
    assert not bool(tstate.maps.overflowed.any())
    assert T.get_matches(tstate) is None


@pytest.mark.parametrize("variant", ["p2d", "d2d"])
@pytest.mark.parametrize("dim", [2, 3])
def test_ndt_batched_equals_single_and_sorted(dim, variant):
    """B = 4 lanes against single-lane runs; ``sorted`` against ``dense``."""
    a = _room(dim, 5, 40 if dim == 2 else 60)
    angle = 0.06
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]]) if dim == 2 else np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    b = a @ rot.T + 0.1
    cells = 256 if dim == 2 else 512
    cfg = T.DriverConfig(max_iterations=30, angle_tolerance=1e-4, translation_tolerance=1e-4)
    shifts = torch.tensor(np.random.default_rng(dim).uniform(-0.1, 0.1, (4, dim)))
    guess = T.RigidTransform(torch.eye(dim, dtype=torch.float64).expand(4, dim, dim), shifts)
    src, tgt = (T.stack([T.from_points(p, device="cpu")] * 4) for p in (a, b))
    res = {}
    for lookup in ("dense", "sorted"):
        method = T.from_method("ndt", dim, T.Config(cells=cells, lookup=lookup, variant=variant))
        res[lookup], _ = T.converge(method, src, tgt, guess, cfg)
    _assert_results_equal(res["sorted"], res["dense"])
    method = T.from_method("ndt", dim, T.Config(cells=cells, variant=variant))
    for lane in range(4):
        one, _ = T.converge(method, T.from_points(a, device="cpu"), T.from_points(b, device="cpu"),
                            T.RigidTransform(guess.rotation[lane], shifts[lane]), cfg)
        assert int(one.iteration_count) == int(res["dense"].iteration_count[lane])
        np.testing.assert_allclose(res["dense"].transform.translation[lane].numpy(),
                                   one.transform.translation.numpy(), atol=1e-12)


def test_ndt_multiscale_matches_jax():
    """The cell-size schedule 8x -> 2x -> 1x with a 6-iteration coarse cap,
    two lanes, on a 2D room cloud."""
    a = _room(2, 8, 60)
    b = a @ np.array([[np.cos(0.1), -np.sin(0.1)], [np.sin(0.1), np.cos(0.1)]]).T + [0.3, -0.2]
    (js, jt, jg), (ts, tt, tg) = _sides(a, b, np.eye(2)[None].repeat(2, 0),
                                         np.array([[0.0, 0.0], [0.1, 0.05]]))
    kw = dict(dim=2, scales=(2.0, 8.0), coarse_max_iterations=6)
    ms_cfg = dict(cell_size=0.5, cells=512)
    jres = jax.jit(lambda s, t, g: j_ndt_multiscale(
        s, t, g, J.DriverConfig(**BENCH), ndt_config=J.Config(**ms_cfg), **kw)[0])(js, jt, jg)
    tres, tstate = converge_ndt_multiscale(ts, tt, tg, T.DriverConfig(**BENCH),
                                           ndt_config=T.Config(**ms_cfg), **kw)
    _assert_results_equal(tres, jres)
    assert float(tstate.maps.cell_size.max()) == 0.5


def test_ndt_multiscale_schedule_order():
    """Scales run largest first, each on clouds decimated by its rounded
    factor and capped at ``coarse_max_iterations``; scales <= 1 are skipped;
    the fine level runs the caller's config."""
    from icp_tpu_torch.multiscale import _capped, decimate

    a = _room(2, 9, 40)
    b = a + [0.2, -0.1]
    src, tgt = T.from_points(a, device="cpu"), T.from_points(b, device="cpu")
    cfg = T.DriverConfig(**BENCH)
    base = dict(cell_size=0.5, cells=256, overlap=0)
    got, _ = converge_ndt_multiscale(src, tgt, T.identity(2, device="cpu"), cfg,
                                     ndt_config=T.Config(**base), scales=(1.0, 2.0, 8.0),
                                     coarse_max_iterations=3)
    current = T.identity(2, device="cpu")
    for scale in (8.0, 2.0):
        method = T.from_method("ndt", 2, T.Config(**dict(base, cell_size=0.5 * scale)))
        f = int(scale)
        level, _ = T.converge(method, decimate(src, f), decimate(tgt, f), current,
                              _capped(cfg, 3))
        current = level.transform
    want, _ = T.converge(T.from_method("ndt", 2, T.Config(**base)), src, tgt, current, cfg)
    assert int(got.iteration_count) == int(want.iteration_count)
    assert torch.equal(got.transform.translation, want.transform.translation)


def test_ndt_multiscale_coarse_init_raises():
    """``coarse_init=True`` against JAX: the global initializer replaces the
    guess (here 2 rad off, far outside NDT's basin) and the schedule
    converges from it as the JAX package does, two lanes, 2D room."""
    a = _room(2, 1, 60)
    b = a @ np.array([[np.cos(2.0), -np.sin(2.0)], [np.sin(2.0), np.cos(2.0)]]).T + [0.5, -0.3]
    (js, jt, jg), (ts, tt, tg) = _sides(a, b, np.eye(2)[None].repeat(2, 0),
                                         np.array([[0.0, 0.0], [3.0, 1.0]]))
    kw = dict(dim=2, scales=(4.0,), coarse_max_iterations=6, coarse_init=True)
    ms_cfg = dict(cell_size=0.5, cells=512)
    jres = jax.jit(lambda s, t, g: j_ndt_multiscale(
        s, t, g, J.DriverConfig(**BENCH), ndt_config=J.Config(**ms_cfg), **kw)[0])(js, jt, jg)
    tres, _ = converge_ndt_multiscale(ts, tt, tg, T.DriverConfig(**BENCH),
                                      ndt_config=T.Config(**ms_cfg), **kw)
    _assert_results_equal(tres, jres)
    # Both lanes start from the same coarse guess, whatever their own guess.
    torch.testing.assert_close(tres.transform.translation[0], tres.transform.translation[1])
    angle = float(torch.atan2(tres.transform.rotation[0, 1, 0], tres.transform.rotation[0, 0, 0]))
    assert abs(angle - 2.0) < 0.02


def test_ndt_config_validated():
    for bad in (dict(lookup="hash"), dict(variant="p2p")):
        with pytest.raises(ValueError):
            T.from_method("ndt", 2, T.Config(**bad))
    with pytest.raises(ValueError, match="source's precomputed maps"):
        T.from_method("ndt", 2, T.Config(variant="d2d")).with_precomputed(None, None)
    with pytest.raises(KeyError):
        convert.ndt_map_from_numpy({"keys": np.zeros(3)}, device="cpu")


# --- on the card -----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_map_build_and_lookups_on_card(cuda_device, dim):
    """Keys, counts, validity and overflow equal the CPU float64 build;
    means to float32 rounding; ``dense`` and ``sorted`` lookups equal."""
    pts, mask, cell, cap, min_points = _map_case(dim, "masked")
    pts = pts.astype(np.float32)
    on_card = ndt.build_overlapping_ndt_maps(torch.tensor(pts, device=cuda_device),
                                             torch.tensor(mask, device=cuda_device), cell, cap)
    cpu = ndt.build_overlapping_ndt_maps(torch.from_numpy(pts.astype(np.float64)),
                                         torch.from_numpy(mask), cell, cap)
    for name in ("keys", "valid", "counts", "overflowed"):
        got = getattr(on_card, name).cpu()
        assert torch.equal(got, getattr(cpu, name).to(got.dtype)), name
    np.testing.assert_allclose(on_card.means.cpu().numpy(), cpu.means.numpy(), atol=1e-5)
    q = torch.tensor(np.random.default_rng(0).uniform(-7, 7, (2 ** dim, 500, dim)),
                     dtype=torch.float32, device=cuda_device)
    dense, srt = ndt.lookup_cells_dense(q, on_card), ndt.lookup_cells(q, on_card)
    hit = srt[2]
    assert torch.equal(dense[2], hit) and torch.equal(dense[3][hit], srt[3][hit])
    assert torch.equal(dense[0][hit], srt[0][hit]) and torch.equal(dense[1][hit], srt[1][hit])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["p2d", "d2d"])
def test_scan1_ndt_on_card_agrees_with_cpu(cuda_device, variant):
    """Eight lanes of scan1 under the bench's hard guesses, float32 on the
    card against float64 on the CPU: translation within 2e-3 m, except on
    lanes whose pose float32 does not determine to the gate.  Such a lane
    also misses on the CPU in float32, from its guess or with the guess
    angle 1 ulp either side (``chip_smoke.py`` phase 8e)."""
    a, b = _scan1()
    rng = np.random.default_rng(1)
    ang = rng.uniform(-0.15, 0.15, 256)[::32]
    sh = rng.uniform(-0.6, 0.6, (256, 2))[::32]
    method = T.from_method("ndt", 2, T.Config(variant=variant, **SCAN1_NDT))

    def run(dev, dtype, lanes, ulps=0):
        src, tgt = (T.stack([T.from_points(p, capacity=1024, dtype=dtype, device=dev)]
                            * len(lanes)) for p in (a, b))
        angle = torch.tensor(ang[lanes], dtype=dtype, device=dev)
        if ulps:
            angle = torch.nextafter(angle, torch.full_like(angle, ulps * float("inf")))
        guess = T.from_angle_2d(angle, torch.tensor(sh[lanes], dtype=dtype, device=dev))
        out, _ = T.converge(method, src, tgt, guess, T.DriverConfig(**BENCH))
        return out.transform.translation.double().cpu()

    every = np.arange(8)
    want = run(torch.device("cpu"), torch.float64, every)
    dt = torch.linalg.vector_norm(run(cuda_device, torch.float32, every) - want, dim=-1)
    missed = dt > 2e-3
    if missed.any():
        lanes = every[missed.numpy()]
        dt32 = torch.stack([torch.linalg.vector_norm(
            run(torch.device("cpu"), torch.float32, lanes, u) - want[missed], dim=-1)
            for u in (0, 1, -1)])
        assert (dt32.max(0).values > 2e-3).all(), (dt, dt32)

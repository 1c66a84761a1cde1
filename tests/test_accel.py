"""Cluster builder: native == numpy, structure invariants, coverage
(every primitive in exactly one cluster), a380-scale build time."""
import numpy as np
import pytest

from raytrace.accel import build_clusters_bvh


def _random_aabbs(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    half = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    return centers - half, centers + half


@pytest.mark.parametrize("native", [True, False])
def test_build_invariants(native):
    lo, hi = _random_aabbs(500)
    cp, cl, ch = build_clusters_bvh(lo, hi, leaf_target=16, native=native)
    # every primitive appears in exactly one cluster (no duplication)
    prims = cp[cp >= 0]
    assert prims.size == 500
    assert (np.sort(prims) == np.arange(500)).all()
    # cluster AABBs contain their primitives
    for ci in range(cp.shape[0]):
        p = cp[ci][cp[ci] >= 0]
        if p.size == 0:
            continue
        assert (lo[p] >= cl[ci] - 1e-5).all()
        assert (hi[p] <= ch[ci] + 1e-5).all()
    # balanced: every cluster within leaf_target
    sizes = (cp >= 0).sum(axis=1)
    assert sizes.max() <= 16


def test_native_matches_numpy():
    """Same leaf membership in the same DFS emit order (partition SETS
    are deterministic for distinct centroid keys; in-cluster order is
    partition-internal, so rows compare as sorted sets)."""
    lo, hi = _random_aabbs(300, seed=3)
    cpn, cln, chn = build_clusters_bvh(lo, hi, leaf_target=16, native=True)
    cpp, clp, chp = build_clusters_bvh(lo, hi, leaf_target=16, native=False)
    assert cpn.shape == cpp.shape
    np.testing.assert_array_equal(np.sort(cpn, axis=1), np.sort(cpp, axis=1))
    np.testing.assert_allclose(cln, clp, rtol=1e-6)
    np.testing.assert_allclose(chn, chp, rtol=1e-6)


def test_scales_to_a380_size():
    lo, hi = _random_aabbs(127_749, seed=7)
    import time

    t0 = time.time()
    cp, cl, ch = build_clusters_bvh(lo, hi, leaf_target=64)
    dt = time.time() - t0
    prims = cp[cp >= 0]
    assert np.unique(prims).size == 127_749 == prims.size
    assert dt < 5.0, f"native build too slow: {dt:.1f}s"

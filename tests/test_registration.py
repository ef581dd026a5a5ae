"""Registration tests: NN vs scipy, ICP/RANSAC pose recovery, pose graph.

SURVEY.md section 6: correctness of the grid-hash/brute NN vs scipy
cKDTree; ICP recovery of known perturbations; pose-graph convergence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slr.geom.se3 import so3_exp, se3_compose, se3_inverse
from slr.registration import (
    nearest_neighbors, grid_normals, icp_point_to_plane,
    fpfh_features, ransac_align, pose_graph_optimize, voxel_downsample,
)


def _bumpy_cloud(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-100, 100, (n, 2))
    z = 500 + 20 * np.sin(xy[:, 0] / 25.0) * np.cos(xy[:, 1] / 30.0) \
        + 8 * np.sin(xy[:, 1] / 12.0)
    return jnp.asarray(np.column_stack([xy, z]), jnp.float32)


def test_nearest_neighbors_vs_scipy():
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(1)
    tgt = rng.uniform(-50, 50, (3000, 3)).astype(np.float32)
    qry = rng.uniform(-50, 50, (500, 3)).astype(np.float32)
    idx, d2 = nearest_neighbors(jnp.asarray(qry), jnp.asarray(tgt), tile=512)
    tree = cKDTree(tgt)
    d_ref, i_ref = tree.query(qry)
    np.testing.assert_array_equal(np.asarray(idx), i_ref)
    # the |q|^2+|t|^2-2qt expansion loses ~1e-3 to f32 cancellation
    np.testing.assert_allclose(np.sqrt(np.asarray(d2)), d_ref, rtol=1e-3, atol=5e-3)


def test_nearest_neighbors_respects_valid_mask():
    tgt = jnp.asarray([[0.0, 0, 0], [10, 0, 0]], jnp.float32)
    qry = jnp.asarray([[1.0, 0, 0]], jnp.float32)
    valid = jnp.asarray([False, True])
    idx, d2 = nearest_neighbors(qry, tgt, valid, tile=2)
    assert int(idx[0]) == 1


def test_grid_normals_plane():
    H, W = 32, 32
    v, u = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                        jnp.arange(W, dtype=jnp.float32), indexing="ij")
    # plane z = 500 + 0.5x  -> normal ~ (-0.5, 0, 1)/|.| flipped toward cam
    pts = jnp.stack([u, v, 500.0 + 0.5 * u], axis=-1)
    n = grid_normals(pts)
    expected = np.array([-0.5, 0, 1.0]) / np.linalg.norm([-0.5, 0, 1.0])
    expected = -expected  # oriented toward origin (camera)
    inner = n[5:-5, 5:-5]
    err = jnp.linalg.norm(inner - jnp.asarray(expected, jnp.float32), axis=-1)
    assert float(jnp.max(err)) < 1e-3


def test_icp_recovers_small_pose():
    src = _bumpy_cloud(4000)
    rv = jnp.asarray([0.01, -0.02, 0.015], jnp.float32)
    R_true = so3_exp(rv)
    t_true = jnp.asarray([3.0, -2.0, 4.0], jnp.float32)
    tgt = src @ R_true.T + t_true
    # target normals from analytic neighborhood (use grid proxy: refit via
    # local plane with jax NN would be heavy; use the surface derivative)
    x, y = tgt[:, 0], tgt[:, 1]
    # numerical normals via nearest neighbors on target: use grid_normals on
    # a rasterized version is overkill; approximate with analytic normals of
    # the underlying surface transformed by R (valid for the test's smooth
    # surface)
    gx = 20 * np.cos(np.asarray(src[:, 0]) / 25.0) / 25.0 * np.cos(np.asarray(src[:, 1]) / 30.0)
    gy = -20 * np.sin(np.asarray(src[:, 0]) / 25.0) * np.sin(np.asarray(src[:, 1]) / 30.0) / 30.0 \
        + 8 * np.cos(np.asarray(src[:, 1]) / 12.0) / 12.0
    n0 = np.column_stack([-gx, -gy, np.ones_like(gx)])
    n0 /= np.linalg.norm(n0, axis=1, keepdims=True)
    n_tgt = jnp.asarray(n0, jnp.float32) @ R_true.T

    res = icp_point_to_plane(src, tgt, n_tgt, iters=15, max_corr_dist=20.0,
                             nn_tile=1024)
    np.testing.assert_allclose(np.asarray(res.R), np.asarray(R_true), atol=2e-3)
    np.testing.assert_allclose(np.asarray(res.t), np.asarray(t_true), atol=0.5)
    assert float(res.rms) < 0.2


def test_fpfh_ransac_coarse_alignment():
    src = _bumpy_cloud(1500, seed=3)
    rv = jnp.asarray([0.05, 0.1, 0.4], jnp.float32)   # big in-plane rotation
    R_true = so3_exp(rv)
    t_true = jnp.asarray([30.0, -25.0, 15.0], jnp.float32)
    tgt = src @ R_true.T + t_true

    def normals_of(p, Rm=None):
        gx = 20 * np.cos(np.asarray(src[:, 0]) / 25.0) / 25.0 * np.cos(np.asarray(src[:, 1]) / 30.0)
        gy = -20 * np.sin(np.asarray(src[:, 0]) / 25.0) * np.sin(np.asarray(src[:, 1]) / 30.0) / 30.0 \
            + 8 * np.cos(np.asarray(src[:, 1]) / 12.0) / 12.0
        n0 = np.column_stack([-gx, -gy, np.ones_like(gx)])
        n0 /= np.linalg.norm(n0, axis=1, keepdims=True)
        n = jnp.asarray(n0, jnp.float32)
        return n if Rm is None else n @ Rm.T

    f_src = fpfh_features(src, normals_of(src), k=12)
    f_tgt = fpfh_features(tgt, normals_of(tgt, R_true), k=12)
    R, t, inl = ransac_align(src, f_src, tgt, f_tgt, n_iters=512,
                             inlier_dist=3.0)
    # coarse: within a few degrees / units, enough for ICP to take over
    rot_err = np.degrees(
        np.arccos(np.clip((np.trace(np.asarray(R).T @ np.asarray(R_true)) - 1) / 2, -1, 1))
    )
    assert rot_err < 5.0, rot_err
    assert float(jnp.linalg.norm(t - t_true)) < 10.0


def test_pose_graph_closes_loop():
    rng = np.random.default_rng(5)
    S = 6
    # ground-truth poses around a loop
    R_true, t_true = [jnp.eye(3)], [jnp.zeros(3)]
    for s in range(1, S):
        rv = jnp.asarray(rng.uniform(-0.2, 0.2, 3), jnp.float32)
        tv = jnp.asarray(rng.uniform(-20, 20, 3), jnp.float32)
        R, t = se3_compose(R_true[-1], t_true[-1], so3_exp(rv), tv)
        R_true.append(R); t_true.append(t)
    R_true, t_true = jnp.stack(R_true), jnp.stack(t_true)

    edges = [(s, s + 1) for s in range(S - 1)] + [(S - 1, 0), (0, 2)]
    ei = jnp.asarray([e[0] for e in edges])
    ej = jnp.asarray([e[1] for e in edges])
    Zr, Zt = [], []
    for (i, j) in edges:
        Ri_inv, ti_inv = se3_inverse(R_true[i], t_true[i])
        Rz, tz = se3_compose(Ri_inv, ti_inv, R_true[j], t_true[j])
        # measurement noise
        nr = so3_exp(jnp.asarray(rng.normal(0, 0.002, 3), jnp.float32))
        Zr.append(Rz @ nr)
        Zt.append(tz + jnp.asarray(rng.normal(0, 0.05, 3), jnp.float32))
    Zr, Zt = jnp.stack(Zr), jnp.stack(Zt)

    # init: odometry accumulation (drifts), then optimize
    R0, t0 = [jnp.eye(3)], [jnp.zeros(3)]
    for s in range(S - 1):
        R, t = se3_compose(R0[-1], t0[-1], Zr[s], Zt[s])
        R0.append(R); t0.append(t)
    res = pose_graph_optimize(jnp.stack(R0), jnp.stack(t0), ei, ej, Zr, Zt,
                              iters=10)
    # rms is in mm-equivalent rows (rotation rows scaled by rot_scale=300
    # mm/rad): injected noise is 0.05 mm trans + 0.002 rad * 300 = 0.6 mm
    # rot per edge, so the converged residual floor sits near ~0.5 mm
    assert float(res.rms) < 1.0
    # poses near truth (gauge: pose0 anchored at identity = truth)
    err_t = jnp.linalg.norm(res.t - t_true, axis=1)
    assert float(jnp.max(err_t)) < 1.0, np.asarray(err_t)


def test_voxel_downsample_matches_numpy():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-10, 10, (2000, 3)).astype(np.float32)
    valid = rng.uniform(size=2000) > 0.1
    vs = 2.5
    out_pts, out_valid, _, n_vox = voxel_downsample(
        jnp.asarray(pts), jnp.asarray(valid), vs, capacity=1024
    )
    # numpy reference
    ids = np.floor(pts[valid] / vs).astype(np.int64)
    uniq, inv = np.unique(ids, axis=0, return_inverse=True)
    ref_means = np.zeros((len(uniq), 3))
    np.add.at(ref_means, inv, pts[valid])
    counts = np.bincount(inv)
    ref_means /= counts[:, None]
    assert int(n_vox) == len(uniq)
    got = np.asarray(out_pts)[np.asarray(out_valid)]
    got_sorted = got[np.lexsort(got.T)]
    ref_sorted = ref_means[np.lexsort(ref_means.T)]
    np.testing.assert_allclose(got_sorted, ref_sorted, atol=1e-4)


def test_voxel_hash_nn_vs_scipy():
    """Voxel-hash NN (SURVEY.md section 9): exact within one voxel radius,
    checked against scipy cKDTree."""
    from scipy.spatial import cKDTree
    from slr.registration.voxel import build_voxel_hash, voxel_hash_nn

    rng = np.random.default_rng(11)
    tgt = rng.uniform(-40, 40, (3000, 3)).astype(np.float32)
    qry = (tgt[:400] + rng.normal(0, 0.5, (400, 3))).astype(np.float32)
    vs = 4.0
    table, row_ids, lo = build_voxel_hash(
        jnp.asarray(tgt), jnp.ones(3000, bool), vs, bucket_cap=16
    )
    idx, d2 = voxel_hash_nn(jnp.asarray(qry), jnp.asarray(tgt), table,
                            row_ids, lo, vs, bucket_cap=16)
    tree = cKDTree(tgt)
    d_ref, i_ref = tree.query(qry)
    found = np.asarray(idx) >= 0
    assert found.mean() > 0.99
    # wherever the true NN is within one voxel AND its bucket didn't
    # overflow, the result is exact; accept tiny mismatch from overflow
    agree = (np.asarray(idx) == i_ref) | (
        np.abs(np.sqrt(np.asarray(d2)) - d_ref) < 1e-3
    )
    assert agree[found].mean() > 0.97, agree[found].mean()


def test_voxel_packing_wide_scene_no_alias():
    """Scenes wider than the 1024-voxel packing window must DROP the
    out-of-window points, never wrap them onto another voxel (the old
    fixed +-512 packing aliased them silently)."""
    from slr.registration.voxel import (
        build_voxel_hash, voxel_downsample, voxel_hash_nn,
    )

    vs = 1.0
    near = np.array([[0.5, 0.5, 0.5], [0.6, 0.5, 0.5]], np.float32)
    # 2048 voxels away: under the old packing (2048 & 0x3FF == 0) this
    # aliased exactly onto the near cluster's voxel
    far = near + np.array([2048.0, 0.0, 0.0], np.float32)
    pts = jnp.asarray(np.concatenate([near, far]))
    val = jnp.ones(4, bool)
    out_pts, out_val, _, n_vox = voxel_downsample(pts, val, vs, capacity=16)
    got = np.asarray(out_pts)[np.asarray(out_val)]
    assert got.shape[0] == 1                       # near voxel only
    np.testing.assert_allclose(got[0], near.mean(axis=0), atol=1e-5)
    assert int(n_vox) == 1

    table, row_ids, lo = build_voxel_hash(jnp.asarray(near),
                                          jnp.ones(2, bool), vs)
    idx, d2 = voxel_hash_nn(jnp.asarray(far), jnp.asarray(near), table,
                            row_ids, lo, vs)
    assert (np.asarray(idx) == -1).all()           # no phantom NN match


# ---------------------------------------------------------------------------
# Outlier filters (slr/registration/filters.py) vs scipy oracle
# ---------------------------------------------------------------------------

def test_knn_mean_distance_vs_scipy():
    from scipy.spatial import cKDTree
    from slr.registration import knn_mean_distance

    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 50, (800, 3)).astype(np.float32)
    valid = np.ones(800, bool)
    k = 6
    # voxel > typical 6-NN distance (~6.1 here) so the true k-NN live in
    # the 27-neighborhood; cap 32 >> expected voxel occupancy (~4)
    vox = 8.0
    md = np.asarray(knn_mean_distance(jnp.asarray(pts), jnp.asarray(valid),
                                      vox, k=k, chunk=256, bucket_cap=32))
    d, _ = cKDTree(pts).query(pts, k=k + 1)  # includes self at col 0
    md_ref = d[:, 1:].mean(1)
    # exact wherever the k-th true NN is within the documented voxel
    # reach; elsewhere (sparse corners) the estimate only overestimates
    guaranteed = d[:, k] < vox
    assert guaranteed.mean() > 0.85
    np.testing.assert_allclose(md[guaranteed], md_ref[guaranteed],
                               rtol=2e-4, atol=1e-4)
    assert np.all(md[~guaranteed] >= md_ref[~guaranteed] - 1e-4)


def test_statistical_outlier_removal_plants():
    from slr.registration import statistical_outlier_removal

    rng = np.random.default_rng(12)
    # dense plane patch + 20 far-flung outliers
    g = np.linspace(0, 40, 40)
    xx, yy = np.meshgrid(g, g)
    # jittered grid: a perfect lattice has ~zero k-NN variance and SOR
    # would legitimately clip its edge rows
    plane = np.stack([xx + 0.25 * rng.normal(size=xx.shape),
                      yy + 0.25 * rng.normal(size=xx.shape),
                      0.02 * rng.normal(size=xx.shape)], -1)
    plane = plane.reshape(-1, 3).astype(np.float32)
    outl = rng.uniform(-200, 200, (20, 3)).astype(np.float32)
    outl[:, 2] += 500.0  # far off the plane
    pts = np.concatenate([plane, outl])
    valid = np.ones(len(pts), bool)
    keep = np.asarray(statistical_outlier_removal(
        jnp.asarray(pts), jnp.asarray(valid), 4.0, k=6, std_ratio=2.0,
        chunk=512))
    assert keep[:len(plane)].mean() > 0.93     # plane survives
    assert keep[len(plane):].sum() == 0        # all planted outliers gone


def test_radius_outlier_removal_counts():
    from scipy.spatial import cKDTree
    from slr.registration import radius_outlier_removal

    rng = np.random.default_rng(13)
    pts = rng.uniform(0, 30, (600, 3)).astype(np.float32)
    valid = np.ones(600, bool)
    r, mn = 3.0, 5
    keep = np.asarray(radius_outlier_removal(
        jnp.asarray(pts), jnp.asarray(valid), r, min_neighbors=mn,
        chunk=256))
    counts = np.array([len(cKDTree(pts).query_ball_point(p, r)) - 1
                       for p in pts])
    np.testing.assert_array_equal(keep, counts >= mn)


def test_filters_respect_valid_mask():
    from slr.registration import statistical_outlier_removal

    rng = np.random.default_rng(14)
    pts = rng.uniform(0, 10, (300, 3)).astype(np.float32)
    valid = rng.uniform(size=300) > 0.3
    keep = np.asarray(statistical_outlier_removal(
        jnp.asarray(pts), jnp.asarray(valid), 5.0, k=4, chunk=128))
    assert not np.any(keep & ~valid)


def test_voxel_hash_nn_matches_ckdtree_64k():
    """The voxel-hash NN (the KD-tree replacement, SURVEY section 9) must
    return the true nearest neighbour wherever bucket occupancy permits
    exactness — verified against scipy cKDTree at 64k points (VERDICT r3
    next #6)."""
    from scipy.spatial import cKDTree

    from slr.registration.voxel import build_voxel_hash, voxel_hash_nn

    rng = np.random.default_rng(11)
    # density chosen so ~1 point per voxel: buckets never overflow
    # and the lookup is exact within one voxel edge
    pts = rng.uniform(0, 400, (65536, 3)).astype(np.float32)
    qry = rng.uniform(10, 390, (65536, 3)).astype(np.float32)
    voxel = 10.0
    tgt = jnp.asarray(pts)
    table, row_ids, lo = build_voxel_hash(
        tgt, jnp.ones((len(pts),), bool), voxel)
    idx, d2 = voxel_hash_nn(jnp.asarray(qry), tgt, table, row_ids, lo,
                            voxel)
    idx, d2 = np.asarray(idx), np.asarray(d2)

    tree = cKDTree(pts)
    d_ref, i_ref = tree.query(qry)
    # exact wherever the true NN is within one voxel edge
    in_range = d_ref < voxel
    assert in_range.mean() > 0.98
    agree = idx[in_range] == i_ref[in_range]
    assert agree.mean() > 0.9999, agree.mean()
    np.testing.assert_allclose(np.sqrt(d2[in_range][agree]),
                               d_ref[in_range][agree], rtol=1e-4)


@pytest.mark.slow
def test_icp_voxel_nn_matches_exact_64k():
    """icp_point_to_plane's large-N voxel-hash route ("auto" above 24k^2
    pairs) must recover the same pose as the exact-NN oracle."""
    from slr.registration import icp_point_to_plane
    from slr.geom.se3 import so3_exp

    rng = np.random.default_rng(12)
    n = 65536
    xy = rng.uniform(-150, 150, (n, 2))
    z = (500 + 20 * np.sin(xy[:, 0] / 25.0) * np.cos(xy[:, 1] / 30.0)
         + 8 * np.sin(xy[:, 1] / 12.0))
    src_np = np.column_stack([xy, z]).astype(np.float32)
    src = jnp.asarray(src_np)
    R_true = so3_exp(jnp.asarray([0.01, -0.02, 0.015], jnp.float32))
    t_true = jnp.asarray([3.0, -2.0, 4.0], jnp.float32)
    tgt = src @ R_true.T + t_true
    gx = (20 * np.cos(src_np[:, 0] / 25.0) / 25.0
          * np.cos(src_np[:, 1] / 30.0))
    gy = (-20 * np.sin(src_np[:, 0] / 25.0) * np.sin(src_np[:, 1] / 30.0)
          / 30.0 + 8 * np.cos(src_np[:, 1] / 12.0) / 12.0)
    n0 = np.column_stack([-gx, -gy, np.ones_like(gx)])
    n0 /= np.linalg.norm(n0, axis=1, keepdims=True)
    n_tgt = jnp.asarray(n0, jnp.float32) @ R_true.T

    # subsample for the exact oracle (64k^2 exact on CPU is minutes)
    sub = jnp.asarray(rng.choice(n, 8192, replace=False))
    res_exact = icp_point_to_plane(src[sub], tgt, n_tgt, iters=12,
                                   max_corr_dist=15.0, nn_method="exact")
    res_vox = icp_point_to_plane(src, tgt, n_tgt, iters=12,
                                 max_corr_dist=15.0, nn_method="auto")
    # the auto route must actually have taken the voxel path
    assert 65536 * 65536 > 24000 ** 2
    R_err = float(jnp.abs(res_vox.R - R_true).max())
    t_err = float(jnp.abs(res_vox.t - t_true).max())
    assert R_err < 5e-3 and t_err < 0.3, (R_err, t_err)
    # pose parity with the exact oracle
    assert float(jnp.abs(res_vox.R - res_exact.R).max()) < 5e-3
    assert float(jnp.abs(res_vox.t - res_exact.t).max()) < 0.3


def _voxel_nn(qry, tgt, valid, vs, cap=32):
    from slr.registration.voxel import build_voxel_hash, voxel_hash_nn

    table, row_ids, lo = build_voxel_hash(
        jnp.asarray(tgt), jnp.asarray(valid), vs, bucket_cap=cap)
    idx, d2 = voxel_hash_nn(jnp.asarray(qry), jnp.asarray(tgt), table,
                            row_ids, lo, vs, bucket_cap=cap)
    return np.asarray(idx), np.asarray(d2)


@pytest.mark.parametrize("case", ["small", "large", "valid_mask",
                                  "duplicates"])
def test_voxel_nn_vs_ckdtree(case):
    """The large-cloud ICP route (voxel hash, "auto" above ~24k^2 pairs)
    is exact against scipy's cKDTree wherever the true NN lies within
    one voxel edge, honours the target valid mask, and resolves
    duplicate targets to one of the tied indices."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(["small", "large", "valid_mask",
                                 "duplicates"].index(case))
    n = {"small": 500, "large": 20000}.get(case, 4000)
    tgt = rng.uniform(-80, 80, (n, 3)).astype(np.float32)
    valid = np.ones(n, bool)
    if case == "valid_mask":
        valid = rng.random(n) > 0.5
    if case == "duplicates":
        tgt[n // 2:] = tgt[:n - n // 2]          # every point twice
    keep = np.nonzero(valid)[0]
    qry = (tgt[rng.choice(keep, 1500)]
           + rng.normal(0, 2.0, (1500, 3))).astype(np.float32)
    vs = 6.0
    idx, d2 = _voxel_nn(qry, tgt, valid, vs)
    d_ref, i_ref = cKDTree(tgt[keep]).query(qry)
    i_ref = keep[i_ref]
    within = d_ref <= vs
    assert within.mean() > 0.9                   # scene sanity
    np.testing.assert_allclose(np.sqrt(d2[within]), d_ref[within],
                               rtol=1e-4, atol=1e-4)
    assert valid[idx[within]].all()
    same = np.all(tgt[idx[within]] == tgt[i_ref[within]], axis=1)
    assert same.mean() > 0.999, same.mean()


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_icp_auto_nn_rule_is_backend_free(monkeypatch, backend):
    """"auto" resolves from the pair count alone: exact up to 24k^2
    source*target pairs, voxel hash above — the same rule on every
    backend."""
    import jax as _jax
    from slr.registration import icp

    monkeypatch.setattr(_jax, "default_backend", lambda: backend)
    assert icp._resolve_nn_method("auto", 4096, 4096) == "exact"
    assert icp._resolve_nn_method("auto", 24_000, 24_000) == "exact"
    assert icp._resolve_nn_method("auto", 65_536, 65_536) == "voxel"
    assert icp._resolve_nn_method("exact", 65_536, 65_536) == "exact"

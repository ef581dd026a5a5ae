"""Chessboard corner detection + sub-pixel refinement + grid ordering.

The image-based front end of camera calibration (SURVEY.md component 9;
the role of cv::findChessboardCorners + cornerSubPix in the reference,
with cv2 kept as the parity oracle in tests only).

Device/host split: the dense work (Gaussian smoothing, Hessian saddle
response, non-max suppression, windowed gradient-orthogonality sub-pixel
refinement) is jitted JAX over the whole image / all corners at once; the
tiny combinatorial step (ordering ~54 detected points into a cols x rows
grid via a hull-quad homography) is host-side numpy — same division the
reference makes between per-pixel loops and control logic.

Corner model: chessboard X-junctions are saddle points of the smoothed
intensity, so the detector peaks ``Ixy^2 - Ixx*Iyy`` (positive iff the
Hessian is indefinite), which is edge-free by construction: a straight
edge has one zero principal curvature and scores ~0.

Sub-pixel model (same normal equations cv2.cornerSubPix solves): around a
saddle q every gradient g(p) is orthogonal to (p - q), so q solves
``(sum w g g^T) q = sum w g g^T p`` over a window; iterate re-centering.

Assumes the full board is visible in the image (cv2 requires the same).
"""

from __future__ import annotations

from functools import partial
from itertools import combinations

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------- dense part

def _smooth(img, sigma: float):
    r = int(np.ceil(3.0 * sigma))
    x = jnp.arange(-r, r + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    k = k / jnp.sum(k)
    dn = ("NCHW", "OIHW", "NCHW")
    out = img[None, None]
    out = jax.lax.conv_general_dilated(
        out, k.reshape(1, 1, 1, -1), (1, 1), [(0, 0), (r, r)],
        dimension_numbers=dn)
    out = jax.lax.conv_general_dilated(
        out, k.reshape(1, 1, -1, 1), (1, 1), [(r, r), (0, 0)],
        dimension_numbers=dn)
    return out[0, 0]


def chess_corner_response(img, sigma: float = 2.0):
    """Saddle-point response Ixy^2 - Ixx*Iyy of the smoothed image."""
    g = _smooth(img, sigma)
    pad = jnp.pad(g, 1, mode="edge")
    Ixx = pad[1:-1, 2:] - 2.0 * g + pad[1:-1, :-2]
    Iyy = pad[2:, 1:-1] - 2.0 * g + pad[:-2, 1:-1]
    Ixy = 0.25 * (pad[2:, 2:] - pad[2:, :-2] - pad[:-2, 2:] + pad[:-2, :-2])
    return jnp.maximum(Ixy * Ixy - Ixx * Iyy, 0.0)


@partial(jax.jit, static_argnames=("k", "nms_radius", "sigma"))
def corner_candidates(img, k: int, nms_radius: int = 5, sigma: float = 2.0):
    """Top-k saddle peaks after non-max suppression.

    Returns (xy (k,2) float32, score (k,)); low-score rows are filler
    (score ~0) for images with fewer true corners than k.
    """
    resp = chess_corner_response(img, sigma)
    m = jax.lax.reduce_window(
        resp, -jnp.inf, jax.lax.max,
        (2 * nms_radius + 1, 2 * nms_radius + 1), (1, 1), "SAME")
    peaks = jnp.where((resp == m) & (resp > 0.05 * jnp.max(resp)), resp, 0.0)
    # top-k per row, then over the rows' winners: the same k peaks as one
    # top_k over the flattened image, which XLA:GPU cannot compile at
    # camera resolution without exhausting host memory
    row_val, row_col = jax.lax.top_k(peaks, k)            # (H, k)
    score, j = jax.lax.top_k(row_val.reshape(-1), k)
    y = (j // k).astype(jnp.float32)
    x = row_col.reshape(-1)[j].astype(jnp.float32)
    return jnp.stack([x, y], axis=-1), score


@partial(jax.jit, static_argnames=("win", "iters", "sigma"))
def refine_subpix(img, pts, win: int = 5, iters: int = 4,
                  sigma: float = 1.0):
    """Gradient-orthogonality sub-pixel refinement of corner estimates.

    pts (N,2) in (x, y); window is (2*win+1)^2 with Gaussian weighting.
    """
    g = _smooth(img, sigma)
    pad = jnp.pad(g, 1, mode="edge")
    gx = 0.5 * (pad[1:-1, 2:] - pad[1:-1, :-2])
    gy = 0.5 * (pad[2:, 1:-1] - pad[:-2, 1:-1])
    H, W = img.shape
    off = jnp.arange(-win, win + 1, dtype=jnp.float32)
    oy, ox = jnp.meshgrid(off, off, indexing="ij")
    wgt = jnp.exp(-(ox ** 2 + oy ** 2) / (2.0 * (0.6 * win) ** 2))

    def one(q0):
        def step(q, _):
            cx = jnp.clip(jnp.round(q[0]).astype(jnp.int32), win, W - win - 1)
            cy = jnp.clip(jnp.round(q[1]).astype(jnp.int32), win, H - win - 1)
            sz = (2 * win + 1, 2 * win + 1)
            px = jax.lax.dynamic_slice(gx, (cy - win, cx - win), sz)
            py = jax.lax.dynamic_slice(gy, (cy - win, cx - win), sz)
            Xc = cx.astype(jnp.float32) + ox
            Yc = cy.astype(jnp.float32) + oy
            a = jnp.sum(wgt * px * px)
            b = jnp.sum(wgt * px * py)
            c = jnp.sum(wgt * py * py)
            bx = jnp.sum(wgt * (px * px * Xc + px * py * Yc))
            by = jnp.sum(wgt * (px * py * Xc + py * py * Yc))
            det = a * c - b * b
            det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
            qx = (c * bx - b * by) / det
            qy = (a * by - b * bx) / det
            q_new = jnp.stack([qx, qy])
            # clamp the step: a bad window cannot fling the corner away
            q_new = jnp.clip(q_new, q - win, q + win)
            return q_new, None

        q, _ = jax.lax.scan(step, q0, None, length=iters)
        return q

    return jax.vmap(one)(pts.astype(jnp.float32))


# ------------------------------------------------- device-side ordering (r5)

def _h_apply_j(H, p):
    """Apply homography H (3,3) to points p (..., 2) — jnp."""
    w = H[2, 0] * p[..., 0] + H[2, 1] * p[..., 1] + H[2, 2]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    x = (H[0, 0] * p[..., 0] + H[0, 1] * p[..., 1] + H[0, 2]) / w
    y = (H[1, 0] * p[..., 0] + H[1, 1] * p[..., 1] + H[1, 2]) / w
    return jnp.stack([x, y], axis=-1)


def _h_from_quad(src, dst):
    """Exact homography src (4,2) -> dst (4,2) via the 8x8 linear system
    with h22 = 1 (fine for board views: the plane never passes through
    the camera centre, so h22 stays away from 0)."""
    rows = []
    rhs = []
    for i in range(4):
        sx, sy = src[i, 0], src[i, 1]
        dx, dy = dst[i, 0], dst[i, 1]
        rows.append(jnp.stack([sx, sy, 1.0, 0.0, 0.0, 0.0,
                               -dx * sx, -dx * sy]))
        rhs.append(dx)
        rows.append(jnp.stack([0.0, 0.0, 0.0, sx, sy, 1.0,
                               -dy * sx, -dy * sy]))
        rhs.append(dy)
    A = jnp.stack(rows)
    b = jnp.stack(rhs)
    h = jnp.linalg.solve(A + 1e-9 * jnp.eye(8), b)
    return jnp.concatenate([h, jnp.ones(1)]).reshape(3, 3)


def _h_dlt_j(src, dst, w):
    """Weighted least-squares homography src -> dst (normalized DLT,
    jnp SVD). w (N,) zero-masks unused rows."""
    ws = jnp.maximum(jnp.sum(w), 1.0)

    def normalize(p):
        c = jnp.sum(p * w[:, None], 0) / ws
        s = jnp.sqrt(2.0) / jnp.maximum(
            jnp.sum(jnp.linalg.norm(p - c, axis=1) * w) / ws, 1e-9)
        return (p - c) * s, c, s

    sn, cs, ss = normalize(src)
    dn, cd, sd = normalize(dst)
    N = src.shape[0]
    A = jnp.zeros((2 * N, 9))
    A = A.at[0::2, 0:2].set(sn)
    A = A.at[0::2, 2].set(1.0)
    A = A.at[0::2, 6:8].set(-dn[:, 0:1] * sn)
    A = A.at[0::2, 8].set(-dn[:, 0])
    A = A.at[1::2, 3:5].set(sn)
    A = A.at[1::2, 5].set(1.0)
    A = A.at[1::2, 6:8].set(-dn[:, 1:2] * sn)
    A = A.at[1::2, 8].set(-dn[:, 1])
    A = A * jnp.repeat(w, 2)[:, None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=False)
    Hn = vt[-1].reshape(3, 3)
    Ts = jnp.array([[ss, 0, -ss * cs[0]], [0, ss, -ss * cs[1]], [0, 0, 1.0]])
    Td = jnp.array([[sd, 0, -sd * cd[0]], [0, sd, -sd * cd[1]], [0, 0, 1.0]])
    H = jnp.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def _extreme_quad(pts, valid):
    """Convex quad of extreme detections, cyclic order — the device
    replacement for scipy ConvexHull + max-area combination search:
    p0/p1 span the farthest valid pair from the two sides of the
    centroid's farthest point; p2/p3 are the extreme points on either
    side of the p0-p1 line. For a perspective-projected rectangle these
    are exactly the four board corners."""
    big = jnp.float32(1e12)
    pen = jnp.where(valid, 0.0, -big)
    c = jnp.sum(jnp.where(valid[:, None], pts, 0.0), 0) / jnp.maximum(
        jnp.sum(valid), 1.0)
    d_c = jnp.linalg.norm(pts - c, axis=1) + pen
    p0 = pts[jnp.argmax(d_c)]
    d0 = jnp.linalg.norm(pts - p0, axis=1) + pen
    p1 = pts[jnp.argmax(d0)]
    e = p1 - p0
    cross = (pts[:, 0] - p0[0]) * e[1] - (pts[:, 1] - p0[1]) * e[0]
    p2 = pts[jnp.argmax(jnp.where(valid, cross, -big))]
    p3 = pts[jnp.argmax(jnp.where(valid, -cross, -big))]
    quad = jnp.stack([p0, p2, p1, p3])          # cyclic around the line
    return quad


@partial(jax.jit, static_argnames=("cols", "rows"))
def order_corner_grid_device(pts, valid, cols: int, rows: int):
    """Device-side grid ordering (VERDICT r4 stretch #8): the scipy
    ConvexHull + per-assignment python loop of ``order_corner_grid``
    replaced by fixed-capacity jitted math — extreme-quad selection, the
    8 hull->grid assignments evaluated as a batch of exact 4-point
    homographies (orientation-filtered by Jacobian sign), NN matching,
    and a weighted-DLT refit on all matches.

    pts (K, 2) with ``valid`` masking filler rows. Returns
    (ordered (cols*rows, 2), rms, ok) — ok False when no orientation-
    preserving assignment matches every grid node to a distinct
    detection (caller falls back to the host path)."""
    K = pts.shape[0]
    N = cols * rows
    ideal = jnp.asarray(
        [[0, 0], [cols - 1, 0], [cols - 1, rows - 1], [0, rows - 1]],
        jnp.float32)
    jj, ii = jnp.meshgrid(jnp.arange(cols, dtype=jnp.float32),
                          jnp.arange(rows, dtype=jnp.float32))
    grid = jnp.stack([jj.ravel(), ii.ravel()], axis=-1)       # (N,2)
    quad = _extreme_quad(pts, valid)
    centre = jnp.asarray([[(cols - 1) / 2.0, (rows - 1) / 2.0]],
                         jnp.float32)

    def assignment(a):
        flip, shift = a // 4, a % 4
        q = jnp.where(flip == 1, quad[::-1], quad)
        q = jnp.roll(q, shift, axis=0)
        H = _h_from_quad(ideal, q)
        eps = 0.1
        dx = (_h_apply_j(H, centre + jnp.asarray([eps, 0.0]))
              - _h_apply_j(H, centre - jnp.asarray([eps, 0.0])))[0]
        dy = (_h_apply_j(H, centre + jnp.asarray([0.0, eps]))
              - _h_apply_j(H, centre - jnp.asarray([0.0, eps])))[0]
        jac = dx[0] * dy[1] - dx[1] * dy[0]
        pred = _h_apply_j(H, grid)                            # (N,2)
        d = jnp.linalg.norm(pred[:, None] - pts[None], axis=-1)
        d = jnp.where(valid[None, :], d, jnp.inf)
        nn = jnp.argmin(d, axis=1)
        dist = jnp.min(d, axis=1)
        distinct = jnp.sum(
            jnp.zeros(K).at[nn].add(1.0) > 0.5) == N
        res = jnp.mean(dist) + jnp.where(distinct, 0.0, 1e6) \
            + jnp.where(jac > 0, 0.0, 1e9)
        return res, nn

    res_all, nn_all = jax.vmap(assignment)(jnp.arange(8))
    best = jnp.argmin(res_all)
    nn = nn_all[best]
    ok = res_all[best] < 1e6
    # refit on all matches for a tighter prediction, then rematch
    H = _h_dlt_j(grid, pts[nn], jnp.ones(N))
    pred = _h_apply_j(H, grid)
    d = jnp.linalg.norm(pred[:, None] - pts[None], axis=-1)
    d = jnp.where(valid[None, :], d, jnp.inf)
    nn = jnp.argmin(d, axis=1)
    dist = jnp.min(d, axis=1)
    ok = ok & (jnp.sum(jnp.zeros(K).at[nn].add(1.0) > 0.5) == N)
    return pts[nn], jnp.sqrt(jnp.mean(dist ** 2)), ok


@partial(jax.jit, static_argnames=("cols", "rows"))
def _fix_checker_orientation_device(img, ordered, cols: int, rows: int):
    """Device version of the 180-degree tie-break (cell (0,0) is LIGHT)."""
    jj, ii = jnp.meshgrid(jnp.arange(cols, dtype=jnp.float32),
                          jnp.arange(rows, dtype=jnp.float32))
    grid = jnp.stack([jj.ravel(), ii.ravel()], axis=-1)
    H = _h_dlt_j(grid, ordered, jnp.ones(grid.shape[0]))
    probe = _h_apply_j(H, jnp.asarray(
        [[0.5, 0.5], [cols - 1.5, rows - 1.5]], jnp.float32))
    h, w = img.shape
    xy = jnp.clip(jnp.round(probe).astype(jnp.int32), 0,
                  jnp.asarray([w - 1, h - 1]))
    i0 = img[xy[0, 1], xy[0, 0]]
    i1 = img[xy[1, 1], xy[1, 0]]
    return jnp.where(i0 < i1, ordered[::-1], ordered)


# ------------------------------------------------------------- ordering part

def _dlt_homography(src, dst):
    """Least-squares homography src -> dst (numpy, normalized DLT)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)

    def normalize(p):
        c = p.mean(0)
        s = np.sqrt(2.0) / max(np.linalg.norm(p - c, axis=1).mean(), 1e-9)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        return (p - c) * s, T

    sn, Ts = normalize(src)
    dn, Td = normalize(dst)
    n = len(src)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:2] = sn
    A[0::2, 2] = 1
    A[0::2, 6:8] = -dn[:, 0:1] * sn
    A[0::2, 8] = -dn[:, 0]
    A[1::2, 3:5] = sn
    A[1::2, 5] = 1
    A[1::2, 6:8] = -dn[:, 1:2] * sn
    A[1::2, 8] = -dn[:, 1]
    _, _, vt = np.linalg.svd(A)
    Hn = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def _apply_h(H, p):
    q = np.c_[p, np.ones(len(p))] @ H.T
    return q[:, :2] / q[:, 2:3]


def _hull_quad(pts):
    """4 extreme points of the detected cloud, in convex (cyclic) order."""
    from scipy.spatial import ConvexHull

    hull = ConvexHull(pts)
    hv = hull.vertices  # ccw
    if len(hv) == 4:
        return hv
    best, best_area = None, -1.0
    for comb in combinations(range(len(hv)), 4):
        q = pts[hv[list(comb)]]
        # shoelace area of the cyclic quad (hull order preserved)
        x, y = q[:, 0], q[:, 1]
        area = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
        if area > best_area:
            best_area, best = area, hv[list(comb)]
    return np.asarray(best)


def order_corner_grid(pts, cols: int, rows: int):
    """Order detected corner candidates into the cols x rows grid.

    pts (K,2) numpy, K >= cols*rows (extra spurious candidates allowed).
    Tries the 8 assignments of the detected hull quad to the ideal grid
    quad (4 cyclic shifts x 2 orientations), keeps the homography whose
    grid prediction NN-matches the detections best, then refits on all
    matches. Returns (ordered (cols*rows, 2), rms residual in px).
    """
    pts = np.asarray(pts, np.float64)
    quad_idx = _hull_quad(pts)
    quad = pts[quad_idx]
    ideal_quad = np.array(
        [[0, 0], [cols - 1, 0], [cols - 1, rows - 1], [0, rows - 1]],
        np.float64)
    jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
    grid = np.c_[jj.ravel(), ii.ravel()].astype(np.float64)

    def match(H):
        pred = _apply_h(H, grid)
        d = np.linalg.norm(pred[:, None] - pts[None], axis=-1)
        nn = d.argmin(1)
        return nn, d[np.arange(len(grid)), nn]

    centre = np.array([[(cols - 1) / 2.0, (rows - 1) / 2.0]])
    eps = 0.1

    def jac_det(H):
        dx = _apply_h(H, centre + [eps, 0]) - _apply_h(H, centre - [eps, 0])
        dy = _apply_h(H, centre + [0, eps]) - _apply_h(H, centre - [0, eps])
        return dx[0, 0] * dy[0, 1] - dx[0, 1] * dy[0, 0]

    best = None
    for flip in (1, -1):
        for shift in range(4):
            q = quad[::flip]
            q = np.roll(q, shift, axis=0)
            H = _dlt_homography(ideal_quad, q)
            # a mirror assignment fits a homography exactly as well as the
            # true one (reflections are homographies) but flips the plane's
            # handedness; a really-projected board face never does.
            # Convention: board x cross y points along the outward normal,
            # so the image-space Jacobian determinant is positive.
            if jac_det(H) <= 0:
                continue
            nn, dist = match(H)
            res = np.mean(dist)
            # a valid assignment matches each grid node to a distinct point
            if len(np.unique(nn)) != len(grid):
                res += 1e6
            if best is None or res < best[0]:
                best = (res, nn)
    if best is None:
        raise ValueError("chessboard grid ordering failed: no orientation-"
                         "preserving hull assignment")
    _, nn = best
    # refit on all matches for a tighter prediction, then rematch
    H = _dlt_homography(grid, pts[nn])
    nn, dist = match(H)
    if len(np.unique(nn)) != len(grid):
        raise ValueError("chessboard grid ordering failed: ambiguous match")
    return pts[nn].astype(np.float32), float(np.sqrt((dist ** 2).mean()))


def _fix_checker_orientation(img_np, ordered, cols: int, rows: int):
    """Resolve the 180-degree grid ambiguity with the checker colors.

    Convention (matches slr.synth.board): the square on the (+x, +y) side
    of corner (0, 0) — board cell (0, 0) — is LIGHT. The grid itself is
    symmetric under 180-degree rotation, so geometry alone cannot pick
    the origin; the cell colors break the tie (the same trick cv2 uses).
    """
    H = _dlt_homography(
        np.c_[np.meshgrid(np.arange(cols), np.arange(rows))[0].ravel(),
              np.meshgrid(np.arange(cols), np.arange(rows))[1].ravel()],
        ordered)
    probe = _apply_h(H, np.array([[0.5, 0.5],
                                  [cols - 1.5, rows - 1.5]], np.float64))
    h, w = img_np.shape
    xy = np.clip(np.round(probe).astype(int), 0, [w - 1, h - 1])
    i0 = img_np[xy[0, 1], xy[0, 0]]
    i1 = img_np[xy[1, 1], xy[1, 0]]
    if i0 < i1:          # origin cell must be the lighter one
        return ordered[::-1]
    return ordered


def detect_chessboard(img, cols: int, rows: int, extra: int = 12,
                      sigma: float = 2.0, win: int = 5):
    """Full detection: saddle peaks -> grid ordering -> sub-pixel refine.

    Returns (corners (cols*rows, 2) float32 in cv2 ordering (row-major,
    x first), grid-fit rms). Raises ValueError if no coherent grid found.
    """
    img = jnp.asarray(img, jnp.float32)
    K = cols * rows
    cand, score = corner_candidates(img, K + extra, sigma=sigma)

    # --- device-first path (r5, VERDICT r4 stretch #8): extreme-quad +
    # batched-assignment ordering + orientation fix + refinement with no
    # per-view python loops; the host combinatorial path below stays as
    # the fallback for degenerate detections (ok=False)
    kth_d = jnp.sort(score)[::-1][K - 1]
    valid_d = (score > 0) & (score >= 0.5 * kth_d)
    ordered_d, rms_d, ok_d = order_corner_grid_device(
        cand, valid_d, cols, rows)
    if bool(ok_d) and float(rms_d) < 3.0:
        ordered_d = _fix_checker_orientation_device(
            img, ordered_d, cols, rows)
        refined = refine_subpix(img, ordered_d, win=win)
        return np.asarray(refined), float(rms_d)

    cand_np = np.asarray(cand)
    score_np = np.asarray(score)
    live = score_np > 0
    if live.sum() < K:
        raise ValueError(
            f"found only {int(live.sum())} corner candidates, need {K}")
    # X-junction saddles score several times higher than the T-junction
    # saddles at the squares/margin boundary; filtering relative to the
    # K-th strongest keeps the hull quad on the true corner grid. Fall
    # back to looser candidate sets if the strict one fails.
    kth = np.sort(score_np[live])[::-1][K - 1]
    subsets = [
        cand_np[live & (score_np >= 0.5 * kth)],
        cand_np[np.argsort(score_np)[::-1][:K]],
        cand_np[live],
    ]
    err = None
    for sub in subsets:
        if len(sub) < K:
            continue
        try:
            ordered, grid_rms = order_corner_grid(sub, cols, rows)
        except ValueError as e:
            err = e
            continue
        ordered = _fix_checker_orientation(np.asarray(img), ordered,
                                           cols, rows)
        refined = refine_subpix(img, jnp.asarray(ordered), win=win)
        return np.asarray(refined), grid_rms
    raise err if err is not None else ValueError("grid ordering failed")

"""Real multi-process distributed execution (SURVEY.md §3.2/§7 comm
backend; VERDICT r2 missing #1).

Spawns 2 (and 4) OS processes, each owning 2 virtual CPU devices, joined
into one jax.distributed job through slr.dist.init_distributed (the
product bring-up path). The workers build the process-spanning
pixel_tile x map_block mesh via make_mesh, run sharded_unwrap (ppermute
halo exchange across the process boundary) and distributed_bundle_adjust
(cross-process psum of the Schur-reduced pose system), and assemble
results with multihost_utils. The test asserts every process produced
the identical result and that it matches the single-process oracle.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

WORKER = str(Path(__file__).parent / "mp_worker.py")
REPO = str(Path(__file__).parent.parent)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clean_env():
    env = dict(os.environ)
    # CPU processes only: no worker may claim an accelerator
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_NUM_CPU_DEVICES", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env

def _run_job(nproc: int, tmp_path) -> list:
    port = _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(nproc), str(port),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)
    ]
    outs = []
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode())
        assert p.returncode == 0, f"proc {i} failed:\n{outs[-1][-3000:]}"
    return [np.load(tmp_path / f"proc{i}.npz") for i in range(nproc)]


def _oracle_ba():
    """Same synthetic BA problem as the worker (seed-locked), solved with
    the single-device reference path."""
    import jax.numpy as jnp
    from slr.dist.ba import bundle_adjust_reference
    from slr.geom.se3 import so3_exp

    r = np.random.default_rng(7)
    S, L, K = 4, 256, 3
    R_true = [np.eye(3, dtype=np.float32)]
    t_true = [np.zeros(3, np.float32)]
    for _ in range(1, S):
        R_true.append(np.asarray(
            so3_exp(jnp.asarray(r.uniform(-0.3, 0.3, 3), jnp.float32))))
        t_true.append(r.uniform(-50, 50, 3).astype(np.float32))
    R_true, t_true = np.stack(R_true), np.stack(t_true)
    X_true = r.uniform(-100, 100, (L, 3)).astype(np.float32)
    obs_s = r.integers(0, S, (L, K)).astype(np.int32)
    p_obs = np.einsum(
        "lkji,lkj->lki", R_true[obs_s],
        X_true[:, None, :] - t_true[obs_s]).astype(np.float32)
    p_obs += r.normal(0, 0.01, p_obs.shape).astype(np.float32)
    obs_w = np.ones((L, K), np.float32)
    noise = np.stack([np.asarray(so3_exp(jnp.asarray(v, jnp.float32)))
                      for v in r.normal(0, 0.02, (S, 3))])
    R0 = np.einsum("sij,sjk->sik", R_true, noise).astype(np.float32)
    t0 = (t_true + r.normal(0, 2.0, (S, 3))).astype(np.float32)
    X0 = (X_true + r.normal(0, 2.0, (L, 3))).astype(np.float32)
    res = bundle_adjust_reference(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X0),
        jnp.asarray(obs_s), jnp.asarray(p_obs), jnp.asarray(obs_w), iters=8)
    return np.asarray(res.R), np.asarray(res.t), R_true, t_true


def _oracle_unwrap():
    """Same unwrap problem as the worker; full-image single-device path
    (sharded_unwrap with per-iteration halos is exact against it)."""
    import jax.numpy as jnp
    from slr.codec.unwrap import spatial_quality_unwrap

    rng = np.random.default_rng(0)
    H, W = 64, 96
    Phi = (np.linspace(0, 40, W)[None, :]
           + 0.05 * rng.normal(size=(H, W))).astype(np.float32)
    bad = np.zeros((H, W), bool)
    bad[rng.integers(1, H - 1, 40), rng.integers(1, W - 1, 40)] = True
    q = np.where(bad, 0.05, 1.0).astype(np.float32)
    Phi_n = np.where(bad, Phi + 2 * np.pi * 2, Phi).astype(np.float32)
    mask = np.ones((H, W), bool)
    return np.asarray(spatial_quality_unwrap(
        jnp.asarray(Phi_n), jnp.asarray(q), jnp.asarray(mask), iters=6))


@pytest.mark.parametrize("nproc", [2, 4])
@pytest.mark.slow
def test_multiprocess_distributed(nproc, tmp_path):
    results = _run_job(nproc, tmp_path)
    assert all(int(r["n_dev"]) == nproc * 2 for r in results)

    # every process observed the identical replicated result
    for r in results[1:]:
        np.testing.assert_array_equal(r["unwrap"], results[0]["unwrap"])
        np.testing.assert_array_equal(r["R"], results[0]["R"])
        np.testing.assert_array_equal(r["t"], results[0]["t"])
        np.testing.assert_array_equal(r["token"], results[0]["token"])

    # cross-process halo unwrap == single-device full-image reference
    np.testing.assert_allclose(results[0]["unwrap"], _oracle_unwrap(),
                               atol=1e-5)

    # cross-process Schur BA == single-device oracle, and it converged
    R_ref, t_ref, R_true, t_true = _oracle_ba()
    np.testing.assert_allclose(results[0]["R"], R_ref, atol=2e-3)
    np.testing.assert_allclose(results[0]["t"], t_ref, atol=2e-2)
    assert float(results[0]["rms"]) < 0.05

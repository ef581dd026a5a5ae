"""Multi-process worker for tests/test_multiprocess.py.

Each OS process owns ``local_devices`` virtual CPU devices; together the
processes form one jax.distributed job (Gloo collectives across process
boundaries) — the real multi-host bring-up seam of SURVEY.md §3.2/§7
("Distributed communication backend"), executed for real instead of
simulated inside one process.

The worker runs the two cross-host stages of the engine on the
process-spanning mesh:
  - sharded_unwrap (pixel_tile halo exchange via ppermute), and
  - distributed_bundle_adjust (one psum of the Schur-reduced pose system
    per GN iteration over map_block),
assembles the sharded result with multihost_utils
(global_array_to_host_local_array + process_allgather), and writes its
view to ``outdir/proc{pid}.npz`` for the test to compare across
processes and against the single-process oracle.

Invoked as:  python tests/mp_worker.py <pid> <nproc> <port> <outdir>
with env JAX_PLATFORMS=cpu (the workers are CPU processes only).
"""

import sys

import jax

LOCAL_DEVICES = 2


def main():
    pid, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", LOCAL_DEVICES)

    # the product bring-up path (slr.dist.mesh), not a test-local stub
    from slr.dist import init_distributed, make_mesh

    init_distributed(coordinator=f"localhost:{port}",
                     num_processes=nproc, process_id=pid)

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from slr.dist.ba import distributed_bundle_adjust
    from slr.dist.sharded import sharded_unwrap

    n_dev = len(jax.devices())
    assert n_dev == nproc * LOCAL_DEVICES, (n_dev, nproc)
    # both mesh axes span the process boundary
    mesh = make_mesh(pixel_tiles=n_dev // 2, map_blocks=2)

    def put(full, spec):
        """Replicated host array -> global sharded jax.Array (each process
        materializes only its addressable shards)."""
        return jax.make_array_from_callback(
            full.shape, NamedSharding(mesh, spec), lambda idx: full[idx])

    # --- stage 1: pixel-tile-sharded quality unwrap (halo ppermute) ---
    rng = np.random.default_rng(0)
    H, W = 64, 96
    Phi = (np.linspace(0, 40, W)[None, :]
           + 0.05 * rng.normal(size=(H, W))).astype(np.float32)
    bad = np.zeros((H, W), bool)
    bad[rng.integers(1, H - 1, 40), rng.integers(1, W - 1, 40)] = True
    q = np.where(bad, 0.05, 1.0).astype(np.float32)
    Phi_n = np.where(bad, Phi + 2 * np.pi * 2, Phi).astype(np.float32)
    mask = np.ones((H, W), bool)

    out = sharded_unwrap(
        put(Phi_n, P("pixel_tile")), put(q, P("pixel_tile")),
        put(mask, P("pixel_tile")), mesh, iters=6)
    # assemble: reshard the pixel_tile-sharded global array to replicated
    # (cross-process all-gather under the hood) and read the local copy
    unwrap_full = np.asarray(multihost_utils.global_array_to_host_local_array(
        out, mesh, P()))
    assert unwrap_full.shape == (H, W), unwrap_full.shape
    # per-process scalar allgather (host coordination utility, SURVEY §7)
    checksums = np.asarray(multihost_utils.process_allgather(
        jnp.asarray([float(np.sum(unwrap_full))])))
    assert checksums.shape[0] == nproc

    # --- stage 2: distributed Schur BA over map_block ---
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

    res = distributed_bundle_adjust(
        put(R0, P()), put(t0, P()), put(X0, P("map_block")),
        put(obs_s, P("map_block")), put(p_obs, P("map_block")),
        put(obs_w, P("map_block")), mesh, iters=8)
    # pose block is replicated: every process holds full copies
    R_out = np.asarray(jax.device_get(res.R.addressable_data(0)))
    t_out = np.asarray(jax.device_get(res.t.addressable_data(0)))
    rms = float(jax.device_get(res.rms.addressable_data(0)))

    # host-0 gating check rides along (observability contract)
    token = multihost_utils.broadcast_one_to_all(
        jnp.asarray([12345.0 + nproc]))

    np.savez(f"{outdir}/proc{pid}.npz",
             unwrap=unwrap_full, R=R_out, t=t_out, rms=rms,
             token=np.asarray(token), n_dev=n_dev,
             checksums=checksums.ravel())
    print(f"proc {pid}/{nproc}: ok (devices={n_dev}, ba_rms={rms:.5f})",
          flush=True)


if __name__ == "__main__":
    main()

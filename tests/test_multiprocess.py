"""Multi-PROCESS test tier (SURVEY.md §4; VERDICT r2 ask #5).

The reference tests its MPI layer with ``mpiexec -n 2`` on localhost; the
JAX equivalent launches 2 OS processes, each with 4 virtual CPU
devices, bootstraps them into one 8-device job via
``poms_tpu.parallel.bootstrap.initialize`` (jax.distributed under the
hood), and runs a sharded halo-exchange step over a mesh that SPANS THE
PROCESS BOUNDARY — collectives cross processes, not just devices.

This file is both the pytest entry (parent) and the worker script:
``python tests/test_multiprocess.py worker <pid> <port>``.
"""
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow  # excluded from the default fast selection

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _worker(process_id: int, port: int) -> None:
    sys.path.insert(0, REPO)
    from poms_tpu.parallel import bootstrap

    bootstrap.initialize(coordinator=f"localhost:{port}", num_processes=2,
                         process_id=process_id, platform="cpu",
                         local_devices=4)
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from poms_tpu.ops.spmv import spmv_banded_jnp
    from poms_tpu.parallel.halo import HaloSpec, dist_norm2, dist_spmv

    info = bootstrap.process_info()
    assert info["num_processes"] == 2, info
    assert info["global_devices"] == 8, info

    names = ("ax0", "ax1")
    mesh_shape = (4, 2)
    mesh = jax.make_mesh(mesh_shape, names)
    npts, pads = (32, 16), (2, 2)
    n_loc = tuple(npts[a] // mesh_shape[a] for a in range(2))
    spec = HaloSpec.build(names, mesh_shape, n_loc, pads, (False, False))

    # identical operands on both processes (seeded host RNG)
    rng = np.random.default_rng(7)
    w = tuple(2 * p + 1 for p in pads)
    band = rng.standard_normal(w + npts) / 10.0
    x = rng.standard_normal(npts)

    # serial oracle, computed redundantly on each process
    x_pad = np.pad(x, [(p, p) for p in pads])
    y_ref = np.asarray(spmv_banded_jnp(jnp.asarray(band),
                                       jnp.asarray(x_pad), npts, pads))
    ref_norm = float(np.linalg.norm(y_ref))

    band_spec = P(None, None, *names)
    grid_spec = P(*names)
    band_g = jax.device_put(jnp.asarray(band),
                            NamedSharding(mesh, band_spec))
    x_g = jax.device_put(jnp.asarray(x), NamedSharding(mesh, grid_spec))

    def body(band_loc, x_loc):
        y_loc = dist_spmv(band_loc, x_loc, spec)
        return y_loc, dist_norm2(y_loc, spec)

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(band_spec, grid_spec),
                              out_specs=(grid_spec, P())))
    y_g, norm_g = f(band_g, x_g)
    jax.block_until_ready(y_g)
    err = abs(float(norm_g) - ref_norm) / ref_norm
    assert err < 1e-13, (float(norm_g), ref_norm)
    print(f"MPOK pid={process_id} norm={float(norm_g):.12e} err={err:.2e}",
          flush=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_step():
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", str(i),
         str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, errtxt = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, errtxt))
    for rc, out, errtxt in outs:
        assert rc == 0, f"worker failed rc={rc}\n{out}\n{errtxt[-2000:]}"
        assert "MPOK" in out, out


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "worker":
        _worker(int(sys.argv[2]), int(sys.argv[3]))
    else:
        raise SystemExit("usage: test_multiprocess.py worker <pid> <port>")

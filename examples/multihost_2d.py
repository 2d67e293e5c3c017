"""Config-5 protocol: multi-host distributed solve (BASELINE.json:5).

One process per host; every process runs this same script.  On GPU
hosts, name the coordinator, the process count and each process's index
(see poms_tpu/parallel/bootstrap.py):

    JAX_COORDINATOR=host0:12345 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \
        python examples/multihost_2d.py

On the CPU test tier (the reference's ``mpiexec -n 2`` analogue — two OS
processes, 4 virtual devices each, collectives crossing the process
boundary):

    JAX_COORDINATOR=localhost:12355 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \
        python examples/multihost_2d.py --cpu &
    JAX_COORDINATOR=localhost:12355 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=1 \
        python examples/multihost_2d.py --cpu

Each process owns only its addressable shards; `jax.device_put` with a
NamedSharding builds the global arrays from host-replicated inputs, and
the replicated residual norm is readable on every process.
"""
import sys

from poms_tpu.parallel import bootstrap

if "--cpu" in sys.argv:
    bootstrap.initialize(platform="cpu", local_devices=4)
else:
    bootstrap.initialize()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_enable_x64", True)

from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from poms_tpu.mg.cycles import CycleConfig  # noqa: E402
from poms_tpu.mg.smoother import SmootherConfig  # noqa: E402
from poms_tpu.models.poisson import poisson_problem  # noqa: E402
from poms_tpu.parallel.dist import DistributedMG  # noqa: E402


def main():
    info = bootstrap.process_info()
    if info["process_id"] == 0:
        print(f"processes={info['num_processes']} "
              f"global_devices={info['global_devices']}")
    ndev = jax.device_count()
    mesh_shape = (max(1, ndev // 2), min(2, ndev))
    dtype = jnp.float64
    prob = poisson_problem(2, (16 * mesh_shape[0], 16 * mesh_shape[1]),
                           degree=2, dtype=dtype)
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0))
    mg = DistributedMG(prob, num_levels=2, mesh_shape=mesh_shape, cfg=cfg)
    sharding = NamedSharding(mg.mesh, P(*mg.names))
    b_glob = jax.device_put(mg._pad_global(prob.b.interior), sharding)
    x_glob = jnp.zeros_like(b_glob)
    rn_prev = None
    for it in range(10):
        x_glob, rn = mg.step(x_glob, b_glob)
        rn = float(rn)            # replicated scalar: readable everywhere
        if info["process_id"] == 0:
            rho = f"  rho={rn / rn_prev:.3f}" if rn_prev else ""
            print(f"cycle {it + 1:2d}  |r| = {rn:.3e}{rho}")
        rn_prev = rn
    if info["process_id"] == 0:
        print("OK" if rn < 1e-6 * float(jnp.linalg.norm(prob.b.interior))
              else "NOT CONVERGED (increase cycles)")


if __name__ == "__main__":
    main()

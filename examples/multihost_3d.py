"""Config-5: multi-host 3D V-cycle with W-cycle and FMG variants
(BASELINE.json configs[4] — "multi-host pod-slice 3D V-cycle, W-cycle and
FMG variants"; VERDICT r4 missing/weak #6).

One process per host; every process runs this same script.  On GPU
hosts, name the coordinator, the process count and each process's index
(see poms_tpu/parallel/bootstrap.py):

    JAX_COORDINATOR=host0:12345 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \
        python examples/multihost_3d.py [--wcycle] [--fmg]

On the CPU test tier (the reference's ``mpiexec -n 2`` analogue — two OS
processes, 4 virtual devices each, collectives crossing the process
boundary):

    JAX_COORDINATOR=localhost:12356 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \
        python examples/multihost_3d.py --cpu --wcycle --fmg &
    JAX_COORDINATOR=localhost:12356 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=1 \
        python examples/multihost_3d.py --cpu --wcycle --fmg

Flags select the legs: default runs the V-cycle; ``--wcycle`` adds a
γ=2 leg; ``--fmg`` adds a full-multigrid start (nested iteration from
the coarsest level) followed by V-cycles.  All legs use the same sharded
hierarchy (distributed transfers + agglomerated tail).
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


def run_leg(tag, prob, mesh_shape, gamma, use_fmg, cycles, head):
    cfg = CycleConfig(nu1=1, nu2=1, gamma=gamma,
                      smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0))
    mg = DistributedMG(prob, num_levels=3, mesh_shape=mesh_shape, cfg=cfg)
    sharding = NamedSharding(mg.mesh, P(*mg.names))
    b_glob = jax.device_put(mg._pad_global(prob.b.interior), sharding)
    if use_fmg:
        x_glob, rn = mg.fmg_step(b_glob)
        if head:
            print(f"[{tag}] FMG start  |r| = {float(rn):.3e}")
    else:
        x_glob = jnp.zeros_like(b_glob)
    rn_prev = None
    for it in range(cycles):
        x_glob, rn = mg.step(x_glob, b_glob)
        rn = float(rn)            # replicated scalar: readable everywhere
        if head:
            rho = f"  rho={rn / rn_prev:.3f}" if rn_prev else ""
            print(f"[{tag}] cycle {it + 1:2d}  |r| = {rn:.3e}{rho}")
        rn_prev = rn
    ok = rn < 1e-6 * float(jnp.linalg.norm(prob.b.interior))
    if head:
        print(f"[{tag}] " + ("OK" if ok else "NOT CONVERGED "
                             "(increase cycles)"))
    return ok


def main():
    info = bootstrap.process_info()
    head = info["process_id"] == 0
    if head:
        print(f"processes={info['num_processes']} "
              f"global_devices={info['global_devices']}")
    ndev = jax.device_count()
    # 3D mesh over the grid axes (pad with 1s when few devices)
    if ndev >= 8:
        mesh_shape = (2, 2, ndev // 4)
    elif ndev >= 4:
        mesh_shape = (2, 2, 1)
    else:
        mesh_shape = (ndev, 1, 1)
    dtype = jnp.float64
    n_el = tuple(8 * max(1, m) for m in mesh_shape)
    prob = poisson_problem(3, n_el, degree=2, dtype=dtype)
    legs = [("vcycle", 1, False, 10)]
    if "--wcycle" in sys.argv:
        legs.append(("wcycle", 2, False, 8))
    if "--fmg" in sys.argv:
        legs.append(("fmg+v", 1, True, 6))
    all_ok = True
    for tag, gamma, use_fmg, cycles in legs:
        all_ok &= run_leg(tag, prob, mesh_shape, gamma, use_fmg, cycles,
                          head)
    if head:
        print("ALL LEGS OK" if all_ok else "SOME LEG DID NOT CONVERGE")


if __name__ == "__main__":
    main()

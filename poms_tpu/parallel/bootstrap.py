"""Multi-process bootstrap (BASELINE.json:5 "N >= 2 hosts").

Replacement for the reference's ``mpiexec -n N`` + ``MPI.Init`` launch path
(SURVEY.md §3.5): every process runs the same program and calls
:func:`initialize` once before touching devices; afterwards
``jax.devices()`` is the GLOBAL device list, and the `shard_map` code in
:mod:`poms_tpu.parallel` is unchanged, with XLA routing collectives
through NCCL (NVLink within a host, the network across hosts).

Launch recipes
--------------
GPU hosts, one process per host (or per card), each told the coordinator,
the process count and its own index — nothing is auto-detected::

    JAX_COORDINATOR=host0:12345 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \
        python solve.py        # on host 0; calls bootstrap.initialize()
    JAX_COORDINATOR=host0:12345 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=1 \
        python solve.py        # on host 1

CPU multi-process tier (tier (a') of the test strategy — SURVEY.md §4:
multi-PROCESS on one machine, the moral equivalent of the reference's
``mpiexec -n 2`` localhost tests)::

    JAX_COORDINATOR=localhost:12345 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=0 \
        python worker.py &
    JAX_COORDINATOR=localhost:12345 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=1 \
        python worker.py

where worker.py calls ``bootstrap.initialize(platform="cpu",
local_devices=4)`` — see tests/test_multiprocess.py for the worked example
(it IS the runnable config-5 protocol, minus real hosts).
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["initialize", "is_initialized", "process_info"]

_initialized = False


def is_initialized() -> bool:
    return _initialized


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               platform: Optional[str] = None,
               local_devices: Optional[int] = None) -> None:
    """Bootstrap this process into the multi-host job.

    MUST run before any other JAX call (device creation pins the backend).
    All arguments fall back to environment variables
    (``JAX_COORDINATOR`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``);
    whatever is still missing is left to `jax.distributed.initialize`,
    which fails on a GPU host that names no coordinator.

    ``platform="cpu"`` + ``local_devices=k`` selects the CPU test tier:
    k virtual devices per process via ``xla_force_host_platform_device_count``
    (must be set before the backend initializes — hence "call this first").
    """
    global _initialized
    if _initialized:
        return
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if local_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={local_devices}"
            ).strip()

    import jax

    if platform is not None:
        # the config update holds even where the environment already
        # names another platform
        jax.config.update("jax_platforms", platform)

    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _initialized = True


def process_info():
    """(process_id, num_processes, local/global device counts) after init."""
    import jax

    return {"process_id": jax.process_index(),
            "num_processes": jax.process_count(),
            "local_devices": jax.local_device_count(),
            "global_devices": jax.device_count()}

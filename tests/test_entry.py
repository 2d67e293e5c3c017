"""Run the entry points of __graft_entry__.py in-suite.

``dryrun_multichip`` once diverged from the tested path (no x64 in the
calling process).  Running the exact entry functions here keeps them
pinned to the suite.
"""
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import __graft_entry__ as entrymod  # noqa: E402


@pytest.mark.slow
def test_dryrun_multichip_8dev():
    """The exact function the driver runs, on the 8-virtual-device mesh."""
    entrymod.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_without_preexisting_x64(monkeypatch):
    """dryrun must enable x64 ITSELF (the driver process never sets it)."""
    # simulate the driver: x64 off on entry
    jax.config.update("jax_enable_x64", False)
    try:
        entrymod.dryrun_multichip(4)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_entry_compiles():
    fn, args = entrymod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    x, rn = out
    assert float(rn) >= 0.0


def test_factor_mesh():
    assert entrymod._factor_mesh(8, 3) in ((2, 2, 2),)
    assert entrymod._factor_mesh(4, 2) == (2, 2)
    assert entrymod._factor_mesh(6, 3) in ((3, 2, 1), (2, 3, 1))
    for n in (1, 2, 3, 5, 7, 8, 12):
        for d in (1, 2, 3):
            dims = entrymod._factor_mesh(n, d)
            assert len(dims) == d
            prod = 1
            for m in dims:
                prod *= m
            assert prod == n

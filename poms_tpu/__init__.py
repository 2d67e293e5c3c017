"""poms_tpu — a JAX sparse linear-algebra and geometric-multigrid framework.

Built from scratch on JAX/XLA with the capability surface of the
reference library ``pyccel/poms`` (see SURVEY.md; the reference checkout was
unavailable — provenance tags [B]/[recall] in SURVEY.md §0 apply):

- tensor-product B-spline stencil operators stored banded ("DIA-of-offsets"),
  with CSR/COO/BSR interchange                      [SURVEY §2 C1–C4]
- stencil SpMV (shifted multiply-adds fused by XLA) [SURVEY §2 C5]
- SpGEMM for Galerkin coarse-operator assembly RAP  [SURVEY §2 C6]
- weighted-Jacobi / Gauss–Seidel (incl. red-black) smoothers [C7]
- B-spline restriction/prolongation transfer kernels [C8]
- coarsest-grid direct (Cholesky/LU) solve          [C11]
- V/W/FMG multigrid cycles on 1D/2D/3D Poisson      [C12, C13]
- domain decomposition over a `jax.sharding.Mesh` with per-dim `ppermute`
  halo exchange and `psum` reductions (the JAX equivalent of the
  reference's MPI Cartesian topology)               [SURVEY §2 C9–C10, §5.7/8]

Layout:
  core/     stencil spaces, vectors (halo-padded), banded matrices
  sparse/   CSR/COO containers, interchange, SpGEMM
  ops/      compute kernels: banded SpMV, smoother passes, transfers, EFTs
  parallel/ mesh construction, halo exchange, distributed cycles
  mg/       hierarchy construction (RAP), smoothers, V/W/FMG cycle drivers
  models/   problem definitions: B-spline Poisson assembly 1D/2D/3D
  oracle/   slow, obviously-correct CPU/scipy reference implementation
  bench/    roofline harness (achieved GB/s, nnz/s vs the card's peak)
  utils/    configs, structured convergence logging, checkpointing
"""

# JAX traces of the deep composite programs here (multigrid cycles inside
# lax.while_loop solves) can exceed CPython's default 1000-frame recursion
# limit.  Raising the limit at import is the standard JAX remedy.
# SIDE EFFECT: this mutates
# process-wide interpreter state (a runaway recursion at depth 20000 can
# overflow the C stack before RecursionError fires); opt out with
# POMS_TPU_NO_RECURSION_BUMP=1 and raise the limit yourself around the
# solver entry points if your traces need it.
import os as _os
import sys as _sys

if not _os.environ.get("POMS_TPU_NO_RECURSION_BUMP"):
    _sys.setrecursionlimit(max(_sys.getrecursionlimit(), 20000))


__version__ = "0.1.0"

from poms_tpu.core.space import StencilVectorSpace
from poms_tpu.core.vector import StencilVector
from poms_tpu.core.matrix import StencilMatrix

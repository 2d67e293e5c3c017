"""Multigrid hierarchy construction: spaces, transfers, Galerkin RAP.

SURVEY.md §3.3: per level, build the dyadically-coarsened spline space, the
knot-insertion prolongation P (and R = Pᵀ — Galerkin convention), and the
coarse operator A_{l+1} = R·A_l·P via SpGEMM (our host CSR SpGEMM,
:mod:`poms_tpu.sparse.spgemm`).  Because the dyadic spline spaces are
*nested* and P is the exact embedding, the Galerkin coarse operator equals
the directly re-assembled coarse stiffness — tested in tests/test_mg.py —
and the band width stays (2p+1)^d at every level.

Transfers are stored twice: as host CSR (setup-time RAP) and as per-axis
:class:`TransferBand` gathers (device-side application on the cycle's hot
path — SURVEY.md §7.0).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from poms_tpu.core.matrix import StencilMatrix
from poms_tpu.core.space import StencilVectorSpace
from poms_tpu.models.bspline import prolongation_interior_1d
from poms_tpu.models.poisson import PoissonProblem
from poms_tpu.ops.cholesky import DenseCholesky, factor_dense_cholesky
from poms_tpu.ops.transfer import TransferBand, bands_from_dense
from poms_tpu.sparse.csr import CsrMatrix
from poms_tpu.sparse.spgemm import rap

__all__ = ["Level", "build_hierarchy", "galerkin_coarse_operator"]


@jax.tree_util.register_pytree_node_class
@dataclass
class Level:
    """One multigrid level.  ``restrict``/``prolong`` map to/from the next
    coarser level and are None on the coarsest, where ``chol`` is set."""
    A: StencilMatrix
    restrict: Optional[Tuple[TransferBand, ...]]
    prolong: Optional[Tuple[TransferBand, ...]]
    chol: Optional[DenseCholesky]

    def tree_flatten(self):
        return (self.A, self.restrict, self.prolong, self.chol), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def galerkin_coarse_operator(A: StencilMatrix, P1s, coarse_npts,
                             coarse_pads) -> StencilMatrix:
    """A_c = Pᵀ A P with tensor-product P = ⊗ P1s (host SpGEMM, setup-time)."""
    import scipy.sparse as sps

    P_sp = None
    for P1 in P1s:
        m = sps.csr_matrix(np.asarray(P1))
        P_sp = m if P_sp is None else sps.kron(P_sp, m, format="csr")
    P = CsrMatrix.from_scipy(P_sp)
    R = CsrMatrix.from_scipy(P_sp.T.tocsr())
    A_csr = CsrMatrix.from_scipy(A.tocsr())
    Ac = rap(R, A_csr, P)
    coarse_space = StencilVectorSpace(
        npts=tuple(coarse_npts), pads=tuple(coarse_pads),
        periodic=A.space.periodic, dtype=A.space.dtype)
    rows = np.repeat(np.arange(Ac.shape[0]), Ac.row_lengths())
    tol = 1e-12 * float(np.abs(Ac.data).max()) if Ac.nnz else 0.0
    return StencilMatrix.from_coo(coarse_space, rows, Ac.indices, Ac.data,
                                  tol=tol)


def _tensor_coarse_operator(splines, P1s, dim, degree, space_dtype,
                            periodic) -> tuple:
    """Galerkin RAP exploiting the Kronecker-sum structure of the Poisson
    operator:  Pᵀ(Σ_a ⊗K/M)P = Σ_a ⊗(P1ᵀ K P1 / P1ᵀ M P1)  since P = ⊗P1.

    Runs d small *dense* 1D triple products instead of a d-D SpGEMM — O(n²)
    host work vs the CSR path's O(nnz·fanout) memory blowup at 3D scale.
    Returns the coarse per-dim (K_band, M_band) list; exactness vs the CSR
    SpGEMM path is asserted in tests/test_transfer.py.
    """
    import numpy as np

    coarse_1d = []
    for s_pair, P1 in zip(splines, P1s):
        K_band, M_band = s_pair
        n = K_band.shape[0]
        p = degree
        # dense 1D matrices from bands
        def dense(Bb):
            D = np.zeros((n, n))
            for i in range(n):
                for off in range(2 * p + 1):
                    j = i + off - p
                    if 0 <= j < n:
                        D[i, j] = Bb[i, off]
            return D
        Kc = P1.T @ dense(K_band) @ P1
        Mc = P1.T @ dense(M_band) @ P1
        nc = P1.shape[1]
        # band extraction (coarse band width stays 2p+1 by nestedness)
        Kcb = np.zeros((nc, 2 * p + 1))
        Mcb = np.zeros((nc, 2 * p + 1))
        for off in range(2 * p + 1):
            d_off = off - p
            i = np.arange(max(0, -d_off), min(nc, nc - d_off))
            Kcb[i, off] = Kc[i, i + d_off]
            Mcb[i, off] = Mc[i, i + d_off]
        # verify nothing fell outside the band
        scale = max(abs(Kc).max(), 1.0)
        mask = np.abs(np.triu(Kc, p + 1)) + np.abs(np.tril(Kc, -(p + 1)))
        if mask.max() > 1e-10 * scale:
            raise AssertionError("coarse 1D operator escaped the band")
        coarse_1d.append((Kcb, Mcb))
    return coarse_1d


def _kron_operator_from_1d(bands_1d, space):
    """Kronecker-sum operator Σ_a ⊗(K/M) from per-dim (K, M) band pairs."""
    from poms_tpu.core.kron import KroneckerSumOperator

    d = len(bands_1d)
    Ks = [b[0] for b in bands_1d]
    Ms = [b[1] for b in bands_1d]
    # share band objects across terms so the apply can reuse partials
    Kj = [jnp.asarray(K, space.dtype) for K in Ks]
    Mj = [jnp.asarray(M, space.dtype) for M in Ms]
    terms = [[Kj[b] if b == a else Mj[b] for b in range(d)] for a in range(d)]
    return KroneckerSumOperator(space, terms)


def build_hierarchy(problem: PoissonProblem, num_levels: int,
                    method: str = "auto", operator: str = "banded"):
    """Levels finest→coarsest for a tensor-product B-spline Poisson problem.

    Each coarsening halves n_el per dim (requires divisibility).  The
    coarsest level gets a dense Cholesky factorization (SURVEY.md §2 C11).

    ``method``: how coarse operators are assembled —
      'spgemm' — general Galerkin RAP via host CSR SpGEMM (C6 path);
      'tensor' — dense 1D RAPs composed through the Kronecker-sum
                 structure (identical result for these problems, scales to
                 3D grids where the d-D SpGEMM expansion would not);
      'auto'   — 'tensor' when the fine grid exceeds ~10⁶ rows.

    ``operator``: per-level operator format —
      'banded' — general StencilMatrix (default; banded SpMV);
      'kron'   — structure-exploiting KroneckerSumOperator (O(n) memory,
                 ~3× less SpMV traffic; forces method='tensor').
    """
    import jax.numpy as jnp
    import numpy as np

    from poms_tpu.models.poisson import _kron_sum_band

    p = problem.degree
    d = problem.dim
    n_el = problem.n_el
    A = problem.A
    if operator == "kron":
        method = "tensor"
        A = _kron_operator_from_1d([(s.K, s.M) for s in problem.splines],
                                   A.space)
    if method == "auto":
        method = "tensor" if A.space.size > 1_000_000 else "spgemm"
    bands_1d = [(s.K, s.M) for s in problem.splines]
    levels = []
    for lev in range(num_levels - 1):
        if any(ne % 2 or ne < 2 for ne in n_el):
            raise ValueError(
                f"cannot coarsen n_el={n_el} at level {lev}: need even >= 2 "
                f"(asked for {num_levels} levels)")
        n_el_c = tuple(ne // 2 for ne in n_el)
        if any(nec + p - 2 < 1 for nec in n_el_c):
            raise ValueError(f"coarse space empty at level {lev + 1}")
        P1s = [prolongation_interior_1d(nec, p) for nec in n_el_c]
        prolong = tuple(bands_from_dense(P1, A.space.dtype) for P1 in P1s)
        restrict = tuple(bands_from_dense(P1.T, A.space.dtype) for P1 in P1s)
        coarse_npts = tuple(nec + p - 2 for nec in n_el_c)
        if method == "tensor":
            bands_1d = _tensor_coarse_operator(
                bands_1d, P1s, d, p, A.space.dtype, A.space.periodic)
            coarse_space = StencilVectorSpace(
                npts=coarse_npts, pads=(p,) * d, periodic=A.space.periodic,
                dtype=A.space.dtype)

            if operator == "kron":
                A_c = _kron_operator_from_1d(bands_1d, coarse_space)
            else:
                class _S:  # adapter for _kron_sum_band's (K, M) attributes
                    def __init__(self, K, M):
                        self.K, self.M = K, M

                band_c = _kron_sum_band([_S(K, M) for K, M in bands_1d])
                A_c = StencilMatrix.from_band(coarse_space, band_c)
        else:
            A_c = galerkin_coarse_operator(A, P1s, coarse_npts, (p,) * d)
        levels.append(Level(A=A, restrict=restrict, prolong=prolong, chol=None))
        A, n_el = A_c, n_el_c
    levels.append(Level(A=A, restrict=None, prolong=None,
                        chol=factor_dense_cholesky(A)))
    return levels

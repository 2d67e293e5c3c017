"""Two-float (double-word f32) arithmetic for high-precision residuals.

SURVEY.md §7.2.1 names this the #1 risk item: the headline tolerance
(‖r‖ ≤ 1e-10, BASELINE.json:2) needs ~>40 mantissa bits, f32 has 24, and
the system was first built for hardware without fast f64.  This module
implements the standard error-free-transformation (EFT) toolbox —
Dekker/Knuth two_sum / two_prod and double-word add/mul (Joldes, Muller &
Popescu, "Tight and rigorous error bounds for basic building blocks of
double-word arithmetic", ACM TOMS 2017) — on f32 pairs ``(hi, lo)`` with
``hi + lo`` representing a ~48-bit-mantissa value (|lo| ≤ ulp(hi)/2).

All functions are elementwise jnp code that compiles to plain f32
arithmetic (no f64 anywhere).  XLA fma contraction is a measured
HAZARD for EFTs, not a help — see the compiler-safety note below: the
toolbox is written in the contraction-immune exact-partial-products form
so any contraction the compiler applies is value-preserving.

The headline use is :func:`residual_kron_df`: r = b − A·x for a
Kronecker-sum operator with everything carried in double-word f32 —
the fast path for the defect-correction outer loop (mg/mixed.py).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

__all__ = ["split_f64", "merge_f64", "two_sum", "two_prod", "dw_add",
           "dw_mul", "dw_neg", "residual_kron_df", "dw_norm2", "dw_dot",
           "dw_sum_tree", "dw_dot_stack"]

_SPLIT = jnp.float32(4097.0)  # Dekker split constant for f32: 2^12 + 1


# COMPILER-SAFETY DESIGN NOTE (measured failure this round).  Under jit,
# XLA:CPU's fusion emitter duplicates cheap producers into consumer
# fusions and LLVM then CONTRACTS mul+add/sub into fma.  For classic
# Dekker two_prod this is fatal: a consumer computing ``s − a·b`` gets
# fma(−a, b, s), which subtracts the EXACT product instead of the rounded
# one — the residue is double-counted (measured: zl = 2e + t, a hard
# ~1e-7·‖r‖ floor on the twofloat residual, while the same code was exact
# eagerly).  jax.lax.optimization_barrier does NOT survive XLA:CPU's
# pipeline (stripped before codegen — verified in the optimized HLO), so
# barriers cannot protect an EFT here.  The robust fix used below: every
# multiply in the toolbox is an EXACT product (both operands split to
# ≤12 significand bits, or an error term whose rounding is harmless), so
# any fma contraction is value-preserving by construction, and sums are
# protected only by the (float-semantics-preserving) HLO pipeline, which
# does not reassociate.  Pinned by tests/test_twofloat.py::
# test_eft_exact_under_jit_with_broadcast, whose checks also pass when run
# on an H100 through XLA:GPU.
#
# A second hazard is XLA:GPU's own: it drops a convert pair f64 → f32 →
# f64 as "excess precision", so the textbook split lo = f32(x − f64(f32 x))
# is 0 under jit on the card.  That lost b's low word (a dw solve then
# converged to f32(b), and its residual read up to 5× below the true one
# at 64³) and rounded α to f32 in dw-PCG.  split_f64 therefore rounds on
# the bit pattern, and no function here converts a narrowed value back.


def split_f64(x) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split an f64 array into a double-word f32 pair.

    hi = x rounded to 24 significant bits; lo = f32(x − hi).
    |x − (hi+lo)| ≤ 2⁻⁴⁹|x| and |lo| ≤ ulp(hi)/2: a double-word f32
    carries ~49 mantissa bits, so the bottom ~4 bits of an f64 are dropped
    — far below the 1e-10 target.  (Values below f32's normal range lose
    up to 2⁻¹⁴⁹ more.)

    hi is rounded on x's bit pattern (add half of the lowest kept bit, then
    clear the 29 bits below it), never as ``f64(f32(x))``: XLA:GPU removes
    that convert pair as excess precision, which makes ``x − hi`` zero and
    loses lo entirely (module note).  x − hi is exact in f64.
    """
    import jax

    bits = jax.lax.bitcast_convert_type(x, jnp.uint64)
    hi64 = jax.lax.bitcast_convert_type(
        (bits + jnp.uint64(0x10000000)) & jnp.uint64(0xFFFFFFFFE0000000),
        jnp.float64)
    return hi64.astype(jnp.float32), (x - hi64).astype(jnp.float32)


def merge_f64(hi, lo):
    """(hi, lo) → f64 (for verification / the final correction only)."""
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


# jitted split for setup-time use on large arrays (one compile per shape,
# not one per jax.jit(...) wrapper per call)
import jax as _jax  # noqa: E402  (placed here to keep the top imports light)

split_f64_jit = _jax.jit(split_f64)


def two_sum(a, b):
    """Knuth two_sum: s + e == a + b exactly (6 flops, branch-free).

    Safety (module note above): rewrites like ``(a + b) − a → b`` would be
    fatal to an EFT, but XLA's HLO pipeline preserves float semantics and
    does not reassociate additions; the only observed hazard is LLVM fma
    *contraction* of mul+add, which two_sum contains none of.  Exactness
    under jit is pinned by tests/test_twofloat.py::
    test_eft_exact_under_jit_with_broadcast.
    """
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _fast_two_sum(a, b):
    """Dekker fast_two_sum (requires |a| >= |b|): s + e == a + b."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split_bits(a):
    """Exact 12|12-bit split of f32 via mantissa masking.

    Replaces Dekker's arithmetic split ``ca − (ca − a)`` (which an
    fma-contracting backend can collapse, destroying the split — module
    note) with bit operations no float-algebra pass can touch: ah keeps the
    top 12 significand bits, al = a − ah is exact (same-exponent subtract)
    and carries the remaining ≤12 bits, so all cross products are exact in
    f32's 24-bit significand — the same invariant Dekker's split provides.
    """
    import jax

    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    ah = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFF000),
                                      jnp.float32)
    return ah, a - ah


def two_prod(a, b):
    """two_prod: p + e == a·b exactly — contraction-immune form.

    Never materializes the full-width product ``a·b`` (whose recompute +
    fma-contraction is the failure mode in the module note).  Instead the
    four EXACT partial products of the 12|12-bit splits are summed with an
    error-free two_sum cascade; every multiply in the graph is exactly
    representable, so fma contraction anywhere is value-preserving.
    ``p`` may differ from rnd(a·b) by one ulp (double rounding in the
    cascade); (p, e) is still an exact decomposition of a·b, which is the
    invariant every consumer needs.
    """
    ah, al = _split_bits(a)
    bh, bl = _split_bits(b)
    hh = ah * bh        # all four: ≤24 significand bits — exact in f32
    hl = ah * bl
    lh = al * bh
    ll = al * bl
    s1, e1 = two_sum(hl, lh)
    s2, e2 = two_sum(hh, s1)
    s3, e3 = two_sum(s2, ll)
    return _fast_two_sum(s3, (e1 + e2) + e3)


def dw_add(xh, xl, yh, yl):
    """Double-word + double-word (AccurateDWPlusDW, ~2 ulp_dw)."""
    sh, sl = two_sum(xh, yh)
    th, tl = two_sum(xl, yl)
    c = sl + th
    vh, vl = _fast_two_sum(sh, c)
    w = tl + vl
    return _fast_two_sum(vh, w)


def dw_mul(xh, xl, yh, yl):
    """Double-word × double-word (DWTimesDW, ~5 ulp_dw)."""
    ph, pl = two_prod(xh, yh)
    t = xh * yl + xl * yh
    return _fast_two_sum(ph, pl + t)


def dw_mul_fd(a, xh, xl):
    """f32 × double-word."""
    ph, pl = two_prod(a, xh)
    return _fast_two_sum(ph, pl + a * xl)


def dw_neg(xh, xl):
    return -xh, -xl


def _apply_band_1d_axis_df(b1h, b1l, xh, xl, axis: int, pad: int,
                           periodic: bool = False):
    """Double-word twin of core/kron.py::apply_band_1d_axis:
    y[..., i, ...] = Σ_t band1[i, t] · x_pad[..., i + t, ...]."""
    n = xh.shape[axis]
    nd = xh.ndim
    pw = [(pad, pad) if b == axis else (0, 0) for b in range(nd)]
    mode = "wrap" if periodic else "constant"
    xph = jnp.pad(xh, pw, mode=mode)
    xpl = jnp.pad(xl, pw, mode=mode)
    oh = ol = None
    for t in range(2 * pad + 1):
        sl = tuple(slice(t, t + n) if b == axis else slice(None)
                   for b in range(nd))
        bshape = [1] * nd
        bshape[axis] = n
        ch = b1h[:, t].reshape(bshape)
        cl = b1l[:, t].reshape(bshape)
        th, tl = dw_mul(ch, cl, xph[sl], xpl[sl])
        if oh is None:
            oh, ol = th, tl
        else:
            oh, ol = dw_add(oh, ol, th, tl)
    return oh, ol


def residual_kron_df(terms_df: Sequence[Sequence[Tuple]], bh, bl, xh, xl,
                     pads, labels=None,
                     periodic=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """r = b − (Σ_r ⊗_a B_r^(a))·x in double-word f32.

    ``terms_df``: per term, per axis, (band_hi, band_lo) f32 pairs of shape
    (n_a, 2p_a+1) (split from the f64 bands at setup).  ``bh/bl``, ``xh/xl``:
    double-word RHS and iterate.  Mirrors the shared-partial-product
    application of core/kron.py but in ~48-bit precision — the structure
    sharing is identical, so the flop count is the Kronecker O(n·Σ(2p+1))
    times the ~10× double-word overhead.

    ``labels``: optional precomputed sharing structure, labels[a][r] (see
    KroneckerSumOperator._band_labels).  Pass it whenever ``terms_df`` are
    jit TRACERS — the id()-based fallback below is only sound on concrete
    arrays that stay alive (tracer ids lose sharing silently).
    """
    d = xh.ndim
    if labels is None:
        # shared partials keyed by (axis-label history) — same scheme as
        # core/kron.py::_apply_interior, identity on the stored hi arrays
        labels = []
        for a in range(d):
            seen = {}
            row = []
            for term in terms_df:
                key = id(term[a][0])
                if key not in seen:
                    seen[key] = len(seen)
                row.append(seen[key])
            labels.append(row)
    partials = {r: (xh, xl) for r in range(len(terms_df))}
    hist = {r: () for r in range(len(terms_df))}
    for a in range(d - 1, -1, -1):
        cache = {}
        for r, term in enumerate(terms_df):
            key = hist[r] + (labels[a][r],)
            if key not in cache:
                ph, plo = partials[r]
                cache[key] = _apply_band_1d_axis_df(
                    term[a][0], term[a][1], ph, plo, a, pads[a],
                    periodic[a] if periodic is not None else False)
            partials[r] = cache[key]
            hist[r] = key
    axh = axl = None
    for r in partials:
        ph, plo = partials[r]
        if axh is None:
            axh, axl = ph, plo
        else:
            axh, axl = dw_add(axh, axl, ph, plo)
    return dw_add(bh, bl, -axh, -axl)


def _dw_sum_tree_last(sh, sl):
    """Pairwise-tree sum along the LAST axis of (…, n) dw arrays → (…,) f64.

    The tree pairs the FIRST HALF against the SECOND HALF each step:
    contiguous slices, so each level is a plain vector add — an even/odd
    ``[0::2]`` pairing forces a strided relayout per level.  Log-depth
    keeps the error ~ulp_dw · log n; the f64 cast at the end is O(1)
    scalar work.
    """
    while sh.shape[-1] > 1:
        m = sh.shape[-1]
        half = (m + 1) // 2
        pad = half * 2 - m
        if pad:
            pw = [(0, 0)] * (sh.ndim - 1) + [(0, pad)]
            sh = jnp.pad(sh, pw)
            sl = jnp.pad(sl, pw)
        sh, sl = dw_add(sh[..., :half], sl[..., :half],
                        sh[..., half:], sl[..., half:])
    return (sh[..., 0].astype(jnp.float64)
            + sl[..., 0].astype(jnp.float64))


def dw_sum_tree(sh, sl):
    """Flat double-word pairwise-tree sum → ONE f64 scalar (see
    :func:`_dw_sum_tree_last` for the contiguous-halves rationale)."""
    return _dw_sum_tree_last(sh.reshape(-1), sl.reshape(-1))


def dw_dot_stack(pairs):
    """k double-word dots in ONE batched tree → (k,) f64.

    ``pairs``: sequence of (xh, xl, yh, yl) same-shape arrays.  Each tree
    level of :func:`dw_sum_tree` is latency- (not bandwidth-) bound on the
    small end — log₂(2M) ≈ 21 dependent vector ops at 128³ — so k separate
    dots cost k·tree while the stacked (k, n) tree costs ~one (the
    per-level work grows k×, the level count doesn't).  Used by the PCG
    step to fuse the ρ_new and β dots.
    """
    ph = [None] * len(pairs)
    pl = [None] * len(pairs)
    for i, (xh, xl, yh, yl) in enumerate(pairs):
        ph[i], pl[i] = dw_mul(xh.reshape(-1), xl.reshape(-1),
                              yh.reshape(-1), yl.reshape(-1))
    return _dw_sum_tree_last(jnp.stack(ph), jnp.stack(pl))


def dw_dot(xh, xl, yh, yl):
    """⟨x, y⟩ of two double-word arrays, accumulated in double-word, then
    returned as ONE f64 scalar (O(1) emulated work — scalars are free)."""
    sh, sl = dw_mul(xh.reshape(-1), xl.reshape(-1),
                    yh.reshape(-1), yl.reshape(-1))
    return dw_sum_tree(sh, sl)


def dw_norm2(xh, xl):
    """‖x‖₂ of a double-word array, accumulated in double-word (squares
    via dw_mul, summed with the :func:`dw_sum_tree` cascade)."""
    fh = xh.reshape(-1)
    fl = xl.reshape(-1)
    sh, sl = dw_mul(fh, fl, fh, fl)
    return jnp.sqrt(dw_sum_tree(sh, sl))

"""Double-word f32 (EFT) arithmetic vs f64 ground truth (SURVEY.md §7.2.1).

These run on CPU with x64 enabled so f64 is exact ground truth; the point
of the module is that the same code is pure f32 arithmetic.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from poms_tpu.ops import twofloat as tf


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.float64)


def test_split_merge_accuracy():
    """Double-word f32 carries ~49 mantissa bits (2⁻⁴⁹ ≈ 1.8e-15 rel)."""
    x = _rand((100,), 0)
    hi, lo = tf.split_f64(x)
    assert hi.dtype == jnp.float32 and lo.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(tf.merge_f64(hi, lo)),
                               np.asarray(x), rtol=2e-15, atol=0)


@pytest.mark.parametrize("decades", [(-3, 3), (-20, 30)])
def test_split_exact_under_jit(decades):
    """The jitted split carries x to 2⁻⁴⁹ with a normalised low word, over
    a wide range of magnitudes, ties and exponent carries included."""
    import jax

    rng = np.random.default_rng(11)
    mag = 10.0 ** rng.integers(*decades, 4000)
    x = np.concatenate([rng.standard_normal(4000) * mag,
                        [0.0, 2.0 - 2.0 ** -30, 1.0 + 2.0 ** -24,
                         -(1.0 + 2.0 ** -24)]])
    hi, lo = jax.jit(tf.split_f64)(jnp.asarray(x))
    hi, lo = np.asarray(hi), np.asarray(lo)
    err = np.abs(x - (hi.astype(np.float64) + lo.astype(np.float64)))
    assert (err <= 2.0 ** -49 * np.abs(x)).all()
    assert (np.abs(lo) <= np.spacing(np.abs(hi)) / 2).all()


def test_split_never_widens_a_narrowed_value():
    """XLA:GPU folds a convert pair f64 → f32 → f64 into the identity, so
    a split that subtracts ``f64(f32(x))`` from x gets lo = 0 there.  The
    split must not widen anything back to f64."""
    import jax

    jaxpr = jax.make_jaxpr(tf.split_f64)(_rand((8,), 0))
    widen = [e for e in jaxpr.jaxpr.eqns
             if e.primitive.name == "convert_element_type"
             and e.params["new_dtype"] == jnp.float64]
    assert not widen, widen


def test_two_sum_exact():
    a = jnp.asarray(np.float32(1.0))
    b = jnp.asarray(np.float32(1e-8))
    s, e = tf.two_sum(a, b)
    # s + e must equal a + b exactly (verify in f64)
    assert float(s.astype(jnp.float64) + e.astype(jnp.float64)) == \
        float(a.astype(jnp.float64) + b.astype(jnp.float64))
    assert float(e) != 0.0  # the low part captured the rounding error


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    b = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    p, e = tf.two_prod(a, b)
    exact = a.astype(jnp.float64) * b.astype(jnp.float64)
    got = p.astype(jnp.float64) + e.astype(jnp.float64)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))


def test_dw_add_mul_accuracy():
    x = _rand((500,), 2)
    y = _rand((500,), 3)
    xh, xl = tf.split_f64(x)
    yh, yl = tf.split_f64(y)
    sh, sl = tf.dw_add(xh, xl, yh, yl)
    # error bound: split of each input (≤2⁻⁴⁹·|x|) + AccurateDWPlusDW
    # (≤3·2⁻⁴⁸·|s|) — an rtol on the (cancelling) sum alone is too strict
    bound = (2.0 ** -49 * np.asarray(jnp.abs(x) + jnp.abs(y))
             + 3 * 2.0 ** -48 * np.asarray(jnp.abs(x + y)) + 1e-300)
    err = np.abs(np.asarray(tf.merge_f64(sh, sl)) - np.asarray(x + y))
    assert (err <= bound).all(), float((err / bound).max())
    ph, plo = tf.dw_mul(xh, xl, yh, yl)
    np.testing.assert_allclose(np.asarray(tf.merge_f64(ph, plo)),
                               np.asarray(x * y), rtol=1e-13, atol=1e-16)


@pytest.mark.parametrize("dim,n_el,degree", [(1, 32, 3), (2, 12, 2),
                                             (3, 6, 2)])
def test_residual_kron_df_matches_f64(dim, n_el, degree):
    """Double-word Kronecker residual ≈ f64 residual to ~1e-13 relative —
    i.e. ~5 orders below the 1e-10 target (the f32-only residual would sit
    at ~1e-7)."""
    from poms_tpu.models.poisson import poisson_problem
    from poms_tpu.core.vector import StencilVector

    prob = poisson_problem(dim, n_el, degree=degree, operator="kron")
    A = prob.A
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(prob.space.npts), jnp.float64)
    xv = StencilVector.from_interior(prob.space, x)
    r64 = prob.b.interior - A.dot(xv).interior

    terms_df = [[tf.split_f64(B.astype(jnp.float64)) for B in term]
                for term in A.terms]
    bh, bl = tf.split_f64(prob.b.interior)
    xh, xl = tf.split_f64(x)
    rh, rl = tf.residual_kron_df(terms_df, bh, bl, xh, xl, prob.space.pads)
    r_df = tf.merge_f64(rh, rl)
    scale = float(jnp.max(jnp.abs(r64))) + 1e-30
    err = float(jnp.max(jnp.abs(r_df - r64))) / scale
    assert err < 1e-12, err


def test_dw_norm2_accuracy():
    x = _rand((1000,), 5, scale=1e-5)
    xh, xl = tf.split_f64(x)
    got = float(tf.dw_norm2(xh, xl))
    ref = float(jnp.linalg.norm(x))
    assert abs(got - ref) / ref < 1e-12


def test_eft_exact_under_jit_with_broadcast():
    """Regression (round 3): XLA:CPU fusion + LLVM fma-contraction broke
    Dekker two_prod when a broadcast fed the graph — consumers recomputed
    the full-width product and contracted ``s − a·b`` into fma, double-
    counting the residue (zl = 2e + t; ~1e-7 floor on dw residuals).  The
    contraction-immune two_prod (exact partial products + two_sum
    cascade) must stay exact INSIDE jit, with in-graph broadcasting."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from poms_tpu.ops.twofloat import dw_add, dw_mul, split_f64, two_prod

    rng = np.random.default_rng(3)
    c64 = jnp.asarray(rng.standard_normal((8, 1)))
    x64 = jnp.asarray(rng.standard_normal((8, 16)))
    C = split_f64(c64)
    X = split_f64(x64)
    tru = c64.astype(jnp.float64) * x64.astype(jnp.float64)

    zh, zl = jax.jit(lambda C, X: dw_mul(*C, *X))(C, X)
    err = jnp.max(jnp.abs(zh.astype(jnp.float64) + zl.astype(jnp.float64)
                          - tru))
    assert float(err) < 1e-13 * float(jnp.max(jnp.abs(tru))), float(err)

    # two_prod exact decomposition under jit (broadcast operands)
    a = C[0]
    b = X[0]
    p, e = jax.jit(two_prod)(a, b)
    exact = a.astype(jnp.float64) * b.astype(jnp.float64)
    d = jnp.max(jnp.abs(p.astype(jnp.float64) + e.astype(jnp.float64)
                        - exact))
    assert float(d) == 0.0, float(d)

    # chained mul+add (the contraction loop shape) stays dw-accurate
    y64 = jnp.asarray(rng.standard_normal((8, 16)))
    Y = split_f64(y64)

    def comp(C, X, Y):
        t = dw_mul(*C, *X)
        return dw_add(*t, *Y)

    zh2, zl2 = jax.jit(comp)(C, X, Y)
    tru2 = tru + y64.astype(jnp.float64)
    err2 = jnp.max(jnp.abs(zh2.astype(jnp.float64)
                           + zl2.astype(jnp.float64) - tru2))
    assert float(err2) < 1e-13 * float(jnp.max(jnp.abs(tru2))), float(err2)

"""Compensated (double-float) reduction oracles (SURVEY hard-part 5).

The f32 path needs f64-grade dot products for the CG tolerance
contract (reference elasticity.c:504-507). dot2 must match an f64 dot of
the same f32 values to ~f32 eps relative error even on ill-conditioned
(heavy-cancellation) inputs where a naive f32 dot loses every digit.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ceedpetscsolid_tpu.utils.precise import dot2, dot2_pair, norm2


def _illconditioned(n, rng, cond=1e8):
    """Vectors whose dot has condition ~cond (huge cancellation)."""
    a = rng.normal(size=n) * np.logspace(0, np.log10(cond) / 2, n)
    b = rng.normal(size=n) * np.logspace(np.log10(cond) / 2, 0, n)
    # force near-cancellation: make the true dot tiny vs sum |a_i b_i|
    a2, b2 = np.copy(a), np.copy(b)
    half = n // 2
    a2[half:] = a[:half][::-1] if half * 2 == n else a2[half:]
    b2[half:] = (-b[:half] * a[:half] / a2[half:][::-1])[::-1] \
        if half * 2 == n else b2[half:]
    return a2.astype(np.float32), b2.astype(np.float32)


def test_dot2_matches_f64_on_cancellation():
    rng = np.random.default_rng(0)
    n = 10_000
    a32, b32 = _illconditioned(n, rng)
    exact = np.dot(a32.astype(np.float64), b32.astype(np.float64))
    scale = np.dot(np.abs(a32.astype(np.float64)),
                   np.abs(b32.astype(np.float64)))
    naive = float(np.float32(
        jnp.vdot(jnp.asarray(a32, jnp.float32), jnp.asarray(b32, jnp.float32))
    ))
    got = float(dot2(jnp.asarray(a32, jnp.float32),
                     jnp.asarray(b32, jnp.float32)))
    # dot2 error bounded by ~eps * |exact| + tiny * scale; the naive dot is
    # far off on this input (guards that the test is actually hard)
    assert abs(got - exact) <= 1e-6 * abs(exact) + 1e-12 * scale
    assert abs(naive - exact) > 10 * abs(got - exact) or naive == exact


def test_dot2_non_power_of_two_and_shapes():
    rng = np.random.default_rng(1)
    for n in (1, 2, 3, 1000, 4097):
        a = rng.normal(size=n).astype(np.float32)
        b = rng.normal(size=n).astype(np.float32)
        exact = np.dot(a.astype(np.float64), b.astype(np.float64))
        got = float(dot2(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - exact) <= 1e-6 * max(abs(exact), 1e-3)
    # matrix input flattens
    m = rng.normal(size=(3, 7)).astype(np.float32)
    assert np.isclose(float(dot2(jnp.asarray(m), jnp.asarray(m))),
                      np.dot(m.reshape(-1).astype(np.float64),
                             m.reshape(-1).astype(np.float64)), rtol=1e-6)


def test_dot2_pair_and_norm_and_f64_passthrough():
    rng = np.random.default_rng(2)
    a = rng.normal(size=257).astype(np.float32)
    hi, lo = dot2_pair(jnp.asarray(a), jnp.asarray(a))
    assert np.isclose(float(hi) + float(lo),
                      np.dot(a.astype(np.float64), a.astype(np.float64)),
                      rtol=1e-6)
    assert np.isclose(float(norm2(jnp.asarray(a))),
                      np.linalg.norm(a.astype(np.float64)), rtol=1e-6)
    # f64 path short-circuits to vdot (tests run with x64 enabled)
    a64 = jnp.asarray(rng.normal(size=100))
    assert a64.dtype == jnp.float64
    assert np.isclose(float(dot2(a64, a64)), float(jnp.vdot(a64, a64)))


def test_dot2_inside_jit():
    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.normal(size=1000).astype(np.float32))
    f = jax.jit(lambda x, y: dot2(x, y))
    assert np.isclose(float(f(a, a)), float(dot2(a, a)), rtol=1e-7)

"""CG stagnation-guard regression: an f32 CG whose tolerance sits below
the attainable floor must not spin toward maxiter=10000 inside ONE XLA
execution, which the host cannot interrupt.

The guard must terminate a stagnating solve promptly WITHOUT touching
healthy solves."""

import jax
import jax.numpy as jnp
import numpy as np

from ceedpetscsolid_tpu.solve.cg import pcg


def _spd(n, seed=0, cond=1e3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.geomspace(1.0, cond, n)
    return Q @ np.diag(lam) @ Q.T


def test_stall_guard_bounds_unattainable_solve():
    """Model of the f32 failure mode: the operator apply carries a
    tiny NON-SYMMETRIC perturbation (reduced-precision/roundoff noise), so
    the recursive CG residual plateaus at the noise floor instead of
    decaying — without the guard the solve spins to maxiter; with it, it
    stops within ~stall_its of the floor."""
    A = jnp.asarray(_spd(200, cond=30))
    N = jnp.asarray(np.random.default_rng(3).normal(size=(200, 200)))
    apply = lambda x: A @ x + 1e-9 * (N @ x)           # noqa: E731
    b = jnp.asarray(np.random.default_rng(1).normal(size=200))
    res = pcg(apply, b, rtol=1e-300, atol=0.0, maxiter=50_000)
    # the recursive residual keeps creeping below the true-residual
    # noise floor (f64 hides the plateau far longer than f32 hardware
    # does), but the guard still ends the solve in O(100) iterations
    # instead of the full 50k (observed: ~810); the absolute program
    # bound in production is ksp_max_it
    assert int(res.iters) < 1200, int(res.iters)
    x = np.asarray(res.x)
    r = np.asarray(b) - np.asarray(A) @ x
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-7


def test_stall_guard_does_not_touch_healthy_solves():
    A = jnp.asarray(_spd(200))
    b = jnp.asarray(np.random.default_rng(2).normal(size=200))
    res = pcg(lambda x: A @ x, b, rtol=1e-12, maxiter=50_000)
    assert bool(res.converged)
    x = np.asarray(res.x)
    r = np.asarray(b) - np.asarray(A) @ x
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 1e-10

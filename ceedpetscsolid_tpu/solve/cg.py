"""Matrix-free preconditioned conjugate gradients.

The KSPCG analog with KSP_NORM_NATURAL and rtol 1e-10 defaults
(reference elasticity.c:504-507): convergence is monitored in the natural
norm sqrt(r . M^{-1} r). Runs entirely inside jit as a lax.while_loop; the
reduction dot-products are the only collectives when sharded (psum via
jnp.vdot under shard_map).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..utils.precise import dot2


class CGResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray          # int32
    rnorm: jnp.ndarray          # final natural norm
    converged: jnp.ndarray      # bool


# Compensated (double-float) dot: f64-grade reduction scalars on the f32
# path (SURVEY hard-part 5); plain vdot on f64 inputs.
_dot = dot2


def pcg(
    A: Callable,
    b: jnp.ndarray,
    M_inv: Callable | None = None,
    x0: jnp.ndarray | None = None,
    rtol: float = 1e-10,
    atol: float = 1e-50,
    maxiter: int = 10_000,
    stall_its: int = 60,
    monitor: bool = False,
) -> CGResult:
    """Solve A x = b with preconditioner M_inv (defaults to identity).

    stall_its: abandon the solve once the natural norm has not improved
    for this many consecutive iterations — the f32 attainable-accuracy
    stagnation guard. Without it a solve whose target tolerance sits
    below the f32 noise floor spins to `maxiter` INSIDE one device
    program: thousands of wasted iterations in a single XLA execution
    that the host cannot interrupt. PETSc's KSP reports
    DIVERGED_DTOL/stagnation similarly rather than looping forever."""
    if M_inv is None:
        M_inv = lambda r: r  # noqa: E731
    x = jnp.zeros_like(b) if x0 is None else x0

    r = b - A(x)
    z = M_inv(r)
    rz = _dot(r, z)
    norm0 = jnp.sqrt(jnp.abs(rz))
    tol = jnp.maximum(rtol * norm0, atol)

    def cond(state):
        x, r, z, p, rz, it, ok, anchor, since = state
        return (ok & (jnp.sqrt(jnp.abs(rz)) > tol) & (it < maxiter)
                & (since < stall_its))

    def body(state):
        x, r, z, p, rz, it, ok, anchor, since = state
        Ap = A(p)
        pAp = _dot(p, Ap)
        # KSP_DIVERGED_INDEFINITE_MAT analog: a Newton linearization can be
        # indefinite far from the solution; bail instead of looping to
        # maxiter on garbage (the outer Newton divergence check handles it)
        good = pAp > 0
        alpha = jnp.where(good, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = _dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rn = jnp.sqrt(jnp.abs(rz_new))
        if monitor:
            # -ksp_monitor analog (natural norm, like KSP_NORM_NATURAL)
            jax.debug.print("  {it} KSP Residual norm {rn}",
                            it=it + 1, rn=rn)
        # windowed stagnation: the norm must drop 5% below the anchor
        # within stall_its iterations or the solve is abandoned — a mere
        # "new best by 0.1%" criterion is evaded for thousands of
        # iterations by the slow recursive-residual decay of a noisy
        # (reduced-precision) operator
        improved = rn < 0.95 * anchor
        anchor = jnp.where(improved, rn, anchor)
        since = jnp.where(improved, 0, since + 1)
        return (x, r, z, p, rz_new, it + 1, good, anchor, since)

    z0 = z
    state = (x, r, z, r * 0 + z, rz, jnp.int32(0), jnp.bool_(True),
             norm0, jnp.int32(0))
    x, r, z, p, rz, it, ok, anchor, since = jax.lax.while_loop(
        cond, body, state)
    rnorm = jnp.sqrt(jnp.abs(rz))
    # Indefinite bail on the FIRST iteration returns x = 0 — a zero Newton
    # step that stalls the outer solve. Fall back to the preconditioned
    # steepest-descent direction M^{-1} b (the line search scales it), so
    # Newton keeps making progress through indefinite-tangent states
    # (e.g. the first-increment BC-jump state of finite-strain twists).
    x = jnp.where((it == 0) & ~ok, z0, x)
    return CGResult(x=x, iters=it, rnorm=rnorm, converged=ok & (rnorm <= tol))


def chebyshev(
    A: Callable,
    b: jnp.ndarray,
    diag_inv: jnp.ndarray,
    lam_min: jnp.ndarray,
    lam_max: jnp.ndarray,
    iters: int,
    x0: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Fixed-iteration Chebyshev smoothing for D^{-1}A on [lam_min, lam_max].

    The KSPCHEBYSHEV smoother analog (reference elasticity.c:538-552) with
    Jacobi (diagonal) preconditioning. A fixed polynomial in A, so it is a
    LINEAR operation in b -- safe inside an outer CG preconditioner.
    Standard three-term recurrence (Saad, Iterative Methods, alg. 12.1).
    """
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma1 = theta / delta
    rho = 1.0 / sigma1

    r = b if x0 is None else b - A(x0)      # x0 = 0 needs no apply
    d = (diag_inv * r) / theta
    x = d if x0 is None else x0 + d
    for _ in range(iters - 1):
        r = b - A(x)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * (diag_inv * r)
        rho = rho_new
        x = x + d
    return x


def lanczos_extreme_eigs(A: Callable, diag_inv: jnp.ndarray,
                         r: jnp.ndarray, iters: int = 10, dot=_dot):
    """(lmin, lmax) of D^{-1}A from `iters` preconditioned CG steps on the
    right-hand side r: the CG coefficients define the Lanczos tridiagonal
    (standard KSPCG eigenvalue estimation). A rolled loop: one traced copy
    of A instead of `iters`, which keeps the compiled setup program small.
    `dot` is the (possibly distributed) inner product."""
    def step(i, s):
        r, z, p, rz, alphas, betas = s
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        r = r - alpha * Ap
        z = diag_inv * r
        rz_new = dot(r, z)
        beta = rz_new / rz
        return (r, z, z + beta * p, rz_new, alphas.at[i].set(alpha),
                betas.at[i].set(beta))

    z = diag_inv * r
    rz = dot(r, z)
    coef = jnp.zeros(iters, rz.dtype)
    *_, alphas, betas = jax.lax.fori_loop(
        0, iters, step, (r, z, z, rz, coef, coef))
    diag = 1.0 / alphas
    diag = diag.at[1:].add(betas[:-1] / alphas[:-1])
    off = jnp.sqrt(jnp.abs(betas[:-1])) / alphas[:-1]
    T = jnp.diag(diag) + jnp.diag(off, 1) + jnp.diag(off, -1)
    eigs = jnp.linalg.eigvalsh(T)
    return eigs[0], eigs[-1]


def estimate_extreme_eigs(
    A: Callable,
    diag_inv: jnp.ndarray,
    shape,
    dtype,
    iters: int = 10,
    key=None,
    transform=(0.0, 0.1, 0.0, 1.1),
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Estimate eigenvalue bounds of D^{-1}A by a few CG/Lanczos steps with a
    'noisy' right-hand side, then apply the PETSc-style transform
    (a*lmin + b*lmax, c*lmin + d*lmax) with the reference's (0, 0.1, 0, 1.1)
    (elasticity.c:540: KSPChebyshevEstEigSet 0,0.1,0,1.1).

    Returns (lam_min_bound, lam_max_bound) for the Chebyshev interval.
    """
    a, bb, c, d = transform
    if key is None:
        key = jax.random.PRNGKey(0)
    rhs = jax.random.uniform(key, shape, dtype=dtype) - 0.5
    lmin, lmax = lanczos_extreme_eigs(A, diag_inv, rhs, iters)
    return a * lmin + bb * lmax, c * lmin + d * lmax

"""Double-float (compensated) reductions for the f32 path.

SURVEY hard-part 5: f32 compute/storage, but the CG/Newton reduction
scalars need f64-grade accuracy to honor the reference's tolerance
contract (CG natural-norm rtol 1e-10, elasticity.c:504-507).
A naive f32 dot over ~1e6 entries carries O(log n * u) rounding from the
XLA tree reduce PLUS cancellation amplification when r.z is small against
|r||z| -- which is exactly the late-CG regime. This module implements the
Ogita-Rump-Oishi Dot2 algorithm (error ~ u^2 * cond, i.e. f64-equivalent
for any realistic vector) out of pure f32 ops:

  * TwoProd via Dekker splitting (XLA exposes no scalar FMA primitive);
  * error-free TwoSum accumulation folded through a power-of-two tree
    reduction, carrying a (hi, lo) double-float pair per lane.

Cost: ~20 flops/element over 2 passes -- noise next to one operator apply
(hundreds of flops/DoF), and entirely fused by XLA.

On f64 inputs all entry points degrade to plain jnp ops: f64 is already
the reference precision.
"""

from __future__ import annotations

import os
from contextlib import nullcontext

import jax
import jax.numpy as jnp


def accurate_matmuls():
    """Context manager for the accuracy-critical compute paths: Newton
    residual, outer Krylov matvec, geometry qdata, forcing,
    energy/diagnostics.

    XLA's DEFAULT f32 matmul precision on a GPU is TF32 on the tensor cores
    (10-bit mantissa, eps ~1e-3). For FEM residuals that is not cosmetic:
    the basis-contraction GEMMs of a near-equilibrium state cancel to a
    small fraction of their operand magnitudes, so rounding noise of that
    size can dominate the true residual. HIGHEST runs f32 matmuls in IEEE
    f32 (off the tensor cores); chip_smoke.py phase D checks both on the
    card. The preconditioner paths (smoothers, transfers, diagonals, eig
    probes) keep the fast default: their error only perturbs the Newton
    direction, which the accurate-residual outer loop corrects (the
    inexact-Newton forcing-term argument). f64 GEMMs are unaffected.

    Override with CPSTPU_RESIDUAL_PRECISION=default|high|highest.
    """
    mode = os.environ.get("CPSTPU_RESIDUAL_PRECISION", "highest")
    if mode == "default":
        return nullcontext()
    return jax.default_matmul_precision(mode)

# Dekker splitter for binary32: 2^ceil(24/2) + 1. A plain Python float
# (weak type) so importing this module does NOT touch the backend: creating
# a jnp array at import time would initialize a platform before callers
# (tests, dryrun_multichip) can choose one.
_SPLIT_F32 = 4097.0


def _two_sum(a, b):
    """Error-free transformation: a + b = s + e exactly (Knuth, branch-free)."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _split(a):
    c = _SPLIT_F32 * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Error-free transformation: a * b = p + e exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _df_add(h1, l1, h2, l2):
    """Double-float addition with renormalization."""
    s, e = _two_sum(h1, h2)
    e = e + (l1 + l2)
    hi, lo = _two_sum(s, e)
    return hi, lo


def _df_tree_sum(hi, lo):
    """Sum a (hi, lo) double-float array pairwise down to one pair.

    Shapes are static under jit, so the log2(n) halving loop unrolls into
    ~22 fused vector ops for a 3M-entry vector.
    """
    n = hi.shape[0]
    p = 1
    while p < n:
        p *= 2
    if p != n:
        pad = p - n
        hi = jnp.concatenate([hi, jnp.zeros(pad, hi.dtype)])
        lo = jnp.concatenate([lo, jnp.zeros(pad, lo.dtype)])
    while p > 1:
        half = p // 2
        hi, lo = _df_add(hi[:half], lo[:half], hi[half:p], lo[half:p])
        p = half
    return hi[0], lo[0]


def dot2(a, b):
    """Compensated dot product: correctly-rounded-grade f32 result.

    Returns a plain scalar of the input dtype. f64 inputs short-circuit to
    jnp.vdot (already at reference precision on CPU).
    """
    a = a.reshape(-1)
    b = b.reshape(-1)
    if a.dtype != jnp.float32:
        return jnp.vdot(a, b)
    p, e = _two_prod(a, b)
    hi, lo = _df_tree_sum(p, e)
    return hi + lo


def dot2_pair(a, b):
    """Like dot2 but returns the raw (hi, lo) pair -- for distributed psum
    of the two components before the final add (parallel/dist.ddot)."""
    a = a.reshape(-1)
    b = b.reshape(-1)
    if a.dtype != jnp.float32:
        d = jnp.vdot(a, b)
        return d, jnp.zeros_like(d)
    p, e = _two_prod(a, b)
    return _df_tree_sum(p, e)


def norm2(a):
    """Compensated 2-norm."""
    return jnp.sqrt(jnp.abs(dot2(a, a)))

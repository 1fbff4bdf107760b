"""Global sum-factorized operator application on box-mesh lattices.

On a canonical box mesh the degree-p node lattice is a dense tensor grid
(Nz, Ny, Nx) and the quadrature points form their own dense tensor grid
(Qz, Qy, Qx) = (ez*Q, ey*Q, ex*Q). The whole B@G restriction-plus-gradient
pipeline of the CeedOperator decomposition (reference
src/setuplibceed.c:529-542) then collapses into per-axis GLOBAL banded
matrices: the direction-d reference gradient at every quadrature point of
every element is

    du_d = (Bz^{interp|grad} (x) By (x) Bx) u        (grad on axis d)

where each 1D factor B_axis is an (N_axis, e_axis*Q) matrix whose column
(a, q) holds the 1D shape values/derivatives of element a's window
[p*a, p*a+p] at its q-th quadrature point. Element interface nodes appear
in two adjacent windows; the TRANSPOSE of the same matrix therefore
performs the owner-sum scatter automatically, so the E-vector
(gather/pad/scatter of ops/lattice.py, and the index arrays of
ops/restriction.py) never exists at all.

This is the endpoint of the restriction design: the hot path is 16 dense
GEMMs over full-lattice arrays (8 forward, 8 adjoint, with the shared
interp passes factored), every contraction dim >= N_axis ~ 100, and zero
scatter/gather/transpose traffic. The banded matrices are applied DENSE:
the extra multiply-by-zero flops (N_axis/P per output) trade against the
memory traffic of any indexed alternative. Whether that trade pays on a
GPU has not been measured yet.

Physics planes and qdata live in GLOBAL-QUADRATURE layout (Qz, Qy, Qx)
instead of element-major (nelem, Q3); `qdata_to_global` / `plane_to_elem`
convert at setup / Jacobian-refresh time for the element-layout consumers
(diagonal assembly, p=1 element matrices).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..models.base import Mat3


def _banded(b1_mat: np.ndarray, nelem: int, degree: int) -> np.ndarray:
    """(Q, P) per-element 1D matrix -> (N, nelem*Q) global banded matrix.

    out[p*a + r, a*Q + q] = b1_mat[q, r]; interface nodes (r = 0 and r = p
    of adjacent windows) get entries from both, making the transpose the
    owner-sum fold."""
    Q, P = b1_mat.shape
    p = degree
    assert P == p + 1
    N = p * nelem + 1
    out = np.zeros((N, nelem * Q))
    for a in range(nelem):
        out[p * a: p * a + P, a * Q: (a + 1) * Q] = b1_mat.T
    return out


class SpectralLattice:
    """Sum-factorized gradient / divergence-transpose on a box lattice.

    The six global matrices (interp + grad per axis) travel as a jit
    argument tuple (`matrices()`), mirroring the (Kg, KgT) convention of
    the element-GEMM paths, so they are jit inputs rather than HLO
    constants.
    """

    def __init__(self, dims, degree: int, basis, dtype):
        ex, ey, ez = (int(d) for d in dims)
        p = int(degree)
        Q = basis.Q
        self.dims = (ex, ey, ez)
        self.p = p
        self.Q = Q
        self.nelem = ex * ey * ez
        self.Q3 = Q ** 3
        self.Nx, self.Ny, self.Nz = p * ex + 1, p * ey + 1, p * ez + 1
        self.Qx, self.Qy, self.Qz = ex * Q, ey * Q, ez * Q
        self.num_nodes = self.Nx * self.Ny * self.Nz
        self.num_quad = self.Qx * self.Qy * self.Qz
        B = np.asarray(basis.b1.B, np.float64)
        D = np.asarray(basis.b1.D, np.float64)
        self._mats = tuple(
            jnp.asarray(_banded(m, e, p), dtype)
            for e, ms in ((ex, (B, D)), (ey, (B, D)), (ez, (B, D)))
            for m in ms
        )

    def matrices(self):
        """(BxI, BxG, ByI, ByG, BzI, BzG) as framework-dtype jnp arrays."""
        return self._mats

    # ------------------------------------------------------------------
    def grad(self, u: jnp.ndarray, mats) -> Mat3:
        """(ncomp, num_nodes) -> Mat3 of (Qz, Qy, Qx) reference-gradient
        planes du[c, d]. 8 global GEMMs (interp passes shared)."""
        BxI, BxG, ByI, ByG, BzI, BzG = mats
        C = u.shape[0]
        a = u.reshape(C, self.Nz, self.Ny, self.Nx)
        txI = jnp.einsum("czyx,xq->czyq", a, BxI)
        txG = jnp.einsum("czyx,xq->czyq", a, BxG)
        tyII = jnp.einsum("czyx,yr->czrx", txI, ByI)
        tyGI = jnp.einsum("czyx,yr->czrx", txI, ByG)
        tyIG = jnp.einsum("czyx,yr->czrx", txG, ByI)
        du_z = jnp.einsum("czyx,zs->csyx", tyII, BzG)
        du_y = jnp.einsum("czyx,zs->csyx", tyGI, BzI)
        du_x = jnp.einsum("czyx,zs->csyx", tyIG, BzI)
        by_dir = (du_x, du_y, du_z)
        return Mat3([by_dir[d][c] for c in range(3) for d in range(3)])

    def grad_T(self, dv: Mat3, mats) -> jnp.ndarray:
        """Adjoint of `grad`: Mat3 of (Qz, Qy, Qx) weighted test-gradient
        planes -> (3, num_nodes) owner-summed nodal vector."""
        BxI, BxG, ByI, ByG, BzI, BzG = mats
        wx = jnp.stack([dv.m[3 * c + 0] for c in range(3)])
        wy = jnp.stack([dv.m[3 * c + 1] for c in range(3)])
        wz = jnp.stack([dv.m[3 * c + 2] for c in range(3)])
        ax = jnp.einsum("csyx,zs->czyx", wx, BzI)
        ay = jnp.einsum("csyx,zs->czyx", wy, BzI)
        az = jnp.einsum("csyx,zs->czyx", wz, BzG)
        bx = jnp.einsum("czrx,yr->czyx", ax, ByI)
        byz = (jnp.einsum("czrx,yr->czyx", ay, ByG)
               + jnp.einsum("czrx,yr->czyx", az, ByI))
        v = (jnp.einsum("czyq,xq->czyx", bx, BxG)
             + jnp.einsum("czyq,xq->czyx", byz, BxI))
        return v.reshape(3, self.num_nodes)

    # ------------------------------------------------------------------
    # Layout converters (setup / Jacobian-refresh time only)
    # ------------------------------------------------------------------
    def qdata_to_global(self, qdata: jnp.ndarray) -> jnp.ndarray:
        """(k, nelem, Q3) element-major -> (k, Qz, Qy, Qx) global-quad."""
        k = qdata.shape[0]
        ex, ey, ez = self.dims
        Q = self.Q
        t = qdata.reshape(k, ez, ey, ex, Q, Q, Q)
        return t.transpose(0, 1, 4, 2, 5, 3, 6).reshape(
            k, self.Qz, self.Qy, self.Qx)

    def plane_to_elem(self, x: jnp.ndarray) -> jnp.ndarray:
        """(Qz, Qy, Qx) global-quad -> (nelem, Q3) element-major."""
        ex, ey, ez = self.dims
        Q = self.Q
        t = x.reshape(ez, Q, ey, Q, ex, Q)
        return t.transpose(0, 2, 4, 1, 3, 5).reshape(self.nelem, self.Q3)

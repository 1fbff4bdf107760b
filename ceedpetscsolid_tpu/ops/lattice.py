"""Index-free element restriction for structured (box) meshes.

On a canonical box mesh the degree-p node lattice is a tensor grid of shape
(Nz, Ny, Nx) with Nd = p*ed + 1, and element e = (a, b, c) owns the lattice
window [p*a, p*a+p] x [p*b, ...] x [p*c, ...]. The L-vector <-> E-vector
gather/scatter then needs NO index arrays at all:

* gather  = per-axis "unfold": a reshape of the window bodies plus one
  strided slice for the shared tail plane, concatenated;
* scatter = the exact adjoint "fold": reshape-concat of the bodies plus one
  strided-index add of the interior tail planes per axis.

Everything is static slices / reshapes / concats — pure bulk memory moves
that XLA fuses. All internal passes are COMPONENT-MAJOR: the minor axis is
the lattice x axis, never the 3-wide component axis.

This replaces the row-gather restriction (ops/structured.py) on box
meshes, where no per-row index gather is needed at all. This is the
structured-mesh analog of CeedElemRestriction (reference
src/setuplibceed.c:194-240) specialized to DMPlexCreateBoxMesh-generated
grids (reference src/setupdm.c:49-55). Exodus/unstructured meshes keep the
general entity-row path.

Interface-compatible with ops/restriction.Restriction (gather / scatter_add
on (ncomp, ...) arrays), with the element-local column order being PLAIN
LATTICE order (x fastest) — callers must build the gradient GEMM matrices
with an identity `col_lattice`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class LatticeRestriction:
    """Gather/scatter between lattice-numbered L-vectors and E-vectors.

    Requires the FE space's node numbering to be lattice order
    (node (i, j, k) -> i + Nx*(j + Ny*k)) and the mesh's element order to be
    lattice order (element (a, b, c) -> a + ex*(b + ey*c)); both hold for
    `mesh.fespace.build_fespace` on canonical box meshes.
    """

    def __init__(self, dims, degree: int):
        ex, ey, ez = (int(d) for d in dims)
        p = int(degree)
        self.dims = (ex, ey, ez)
        self.p = p
        self.P = p + 1
        self.P3 = self.P ** 3
        self.nelem = ex * ey * ez
        self.Nx, self.Ny, self.Nz = p * ex + 1, p * ey + 1, p * ez + 1
        self.num_nodes = self.Nx * self.Ny * self.Nz

    # ------------------------------------------------------------------
    def gather(self, u: jnp.ndarray) -> jnp.ndarray:
        """(ncomp, num_nodes) -> (ncomp, nelem, P3), lattice-order columns.

        Component-major unfold: every pass keeps the x axis minor."""
        p, P = self.p, self.P
        ex, ey, ez = self.dims
        C = u.shape[0]
        a = u.reshape(C, self.Nz, self.Ny, self.Nx)
        # x: -> (C, Nz, Ny, ex, P)
        body = a[:, :, :, : ex * p].reshape(C, self.Nz, self.Ny, ex, p)
        tail = a[:, :, :, p::p]                       # (C, Nz, Ny, ex)
        a = jnp.concatenate([body, tail[..., None]], axis=4)
        # y: -> (C, Nz, ey, P, ex, P)
        body = a[:, :, : ey * p].reshape(C, self.Nz, ey, p, ex, P)
        tail = a[:, :, p::p]                          # (C, Nz, ey, ex, P)
        a = jnp.concatenate([body, tail[:, :, :, None]], axis=3)
        # z: -> (C, ez, P, ey, P, ex, P)
        body = a[:, : ez * p].reshape(C, ez, p, ey, P, ex, P)
        tail = a[:, p::p]                             # (C, ez, ey, P, ex, P)
        a = jnp.concatenate([body, tail[:, :, None]], axis=2)
        # element-major (ez, ey, ex), local (k, j, i) with i fastest
        a = a.transpose(0, 1, 3, 5, 2, 4, 6)
        return a.reshape(C, self.nelem, self.P3)

    def scatter_add(self, ve: jnp.ndarray) -> jnp.ndarray:
        """(ncomp, nelem, P3) -> (ncomp, num_nodes): adjoint of `gather`
        (owner-sum over the shared tail planes). Bitwise deterministic:
        per axis one body-reshape concat + one strided-index add of the
        interior tail planes (body-then-tail order at interface nodes)."""
        p, P = self.p, self.P
        ex, ey, ez = self.dims
        C = ve.shape[0]
        a = ve.reshape(C, ez, ey, ex, P, P, P).transpose(0, 1, 4, 2, 5, 3, 6)
        # z fold: (C, ez, P, ey, P, ex, P) -> (C, Nz, ey, P, ex, P)
        body = a[:, :, :p].reshape(C, ez * p, ey, P, ex, P)
        z = jnp.concatenate([body, a[:, -1:, p]], axis=1)
        z = z.at[:, p: ez * p: p].add(a[:, :-1, p])
        # y fold: -> (C, Nz, Ny, ex, P)
        body = z[:, :, :, :p].reshape(C, self.Nz, ey * p, ex, P)
        y = jnp.concatenate([body, z[:, :, -1:, p]], axis=2)
        y = y.at[:, :, p: ey * p: p].add(z[:, :, :-1, p])
        # x fold: -> (C, Nz, Ny, Nx)
        body = y[:, :, :, :, :p].reshape(C, self.Nz, self.Ny, ex * p)
        x = jnp.concatenate([body, y[:, :, :, -1:, p]], axis=3)
        x = x.at[:, :, :, p: ex * p: p].add(y[:, :, :, :-1, p])
        return x.reshape(C, self.num_nodes)

    def multiplicity(self) -> jnp.ndarray:
        ones = jnp.ones((1, self.nelem, self.P3), dtype=jnp.float32)
        return self.scatter_add(ones)[0]

    # -- pytree protocol: fully static, no array children ------------------
    def tree_flatten(self):
        return (), (self.dims, self.p)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1])


jax.tree_util.register_pytree_node(
    LatticeRestriction,
    lambda r: r.tree_flatten(),
    LatticeRestriction.tree_unflatten,
)

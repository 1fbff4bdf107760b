"""Matrix-free FEM operator pipeline (the CeedOperator analog).

An operator application is the fused E-vector pipeline
    gather (G) -> basis grad (B) -> pointwise physics (D) -> B^T -> scatter (G^T)
exactly the A = G^T B^T D B G decomposition of the reference
(SURVEY L2; reference src/setuplibceed.c:529-542), jit-compiled as one XLA
computation so gather/contractions/pointwise physics all fuse.

Layout: all nodal fields are COMPONENT-MAJOR (ncomp, num_nodes), element
fields are (ncomp, nelem, P3), and quadrature tensors are (3, 3, nelem, Q3)
planes — long axes minor-most (see models/base.py).

Geometric qdata (10, nelem, Q3) is computed once from the trilinear
coordinate basis (reference src/setuplibceed.c:388-389) and shared by
residual, Jacobian, energy and diagnostic operators of every multigrid
level (all levels use the fine level's quadrature, src/setuplibceed.c:757).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.fespace import FESpace
from ..models.base import Mat3
from . import geometry
from .basis import Basis3D
from .lattice import LatticeRestriction
from .restriction import Restriction
from .spectral import SpectralLattice
from .structured import (
    StructuredMaps,
    StructuredRestriction,
    grad_gemm_matrices,
    grad_gemm_matrices_cm,
)


def default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def element_diagonal(jacobian_qf: Callable, phys, basis: Basis3D, qdata,
                     stash, dtype) -> jnp.ndarray:
    """(3, nelem, P3) element-level operator diagonal:
    diag[c,e,p] = sum_q sum_{d1,d2} Bg[d1,q,p] K[c,d1,c,d2] Bg[d2,q,p]
    with K's (c, :, c, :) slices extracted by 9 unit-gradient applications
    of the qfunction, run as one rolled map (the qfunction is traced once,
    not 9 times, which keeps the compiled setup program small)."""
    # BB[q, p, d1, d2] = Bg[d1, q, p] * Bg[d2, q, p]
    BB = jnp.einsum("aqp,bqp->qpab", basis.grad, basis.grad)
    nelem, Q3 = qdata.shape[1], qdata.shape[2]

    def unit(k):
        c2, d2 = k // 3, k % 3
        du = jnp.broadcast_to(
            (jnp.arange(9) == k).astype(dtype).reshape(3, 3, 1, 1),
            (3, 3, nelem, Q3))
        ddv = jacobian_qf(du, qdata, stash, phys)          # (3,3,e,q)
        Krow = jnp.take(ddv, c2, axis=0)                   # K[c2,d1,c2,d2]
        return jnp.einsum("qpa,aeq->ep", jnp.take(BB, d2, axis=3), Krow)

    contrib = jax.lax.map(unit, jnp.arange(9))             # (9, e, P3)
    return contrib.reshape(3, 3, nelem, basis.P3).sum(axis=1)


@dataclass
class LevelOps:
    """Per-level operator data: restriction + solution basis.

    For multigrid, every level applies physics at the FINE level's
    quadrature points using the shared fine qdata (and, for nonlinear
    models, the fine residual's stashed gradu), via a P_level -> Q_fine
    basis (reference src/setuplibceed.c:756-757, 782, 829-839).

    NATIVE-QUADRATURE alternative (a departure from the reference): coarse
    PRECONDITIONER levels may instead integrate at their own Gauss rule
    Q_l = degree_l + 1 — 15x fewer quadrature points at p=1 under a p=4
    fine level. The linearization state
    (stashed gradu, a polynomial fully determined by its fine-Gauss
    values) is re-interpolated EXACTLY onto the level rule
    (`stash_interp`), so no extra state is carried. The V-cycle stays a
    fixed linear operation; only the (rediscretized-per-level, like the
    reference's) level operators change by a quadrature-consistency
    term. nat_* fields are None on the fine level.
    """

    space: FESpace
    restr: Restriction
    basis: Basis3D          # P_level -> Q_fine (Gauss)
    srestr: StructuredRestriction | None = None
    sgrad: tuple | None = None          # (Kg, KgT) single-GEMM gradient op
    lattice: bool = False   # box mesh: index-free component-major restriction
    spectral: SpectralLattice | None = None  # box mesh: global GEMM pipeline
    nat_basis: Basis3D | None = None    # P_level -> Q_level (Gauss)
    nat_sgrad: tuple | None = None      # gradient GEMM op at Q_level
    stash_interp: jnp.ndarray | None = None  # (Q3_fine, Q3_level) exact


class OperatorFactory:
    """Builds jit-ready closures for one problem configuration."""

    def __init__(
        self,
        spaces: list[FESpace],          # one per MG level, coarse -> fine
        qextra: int = 0,
        dtype=None,
        q1d: int | None = None,
        use_spectral: bool = True,
    ):
        """q1d overrides the quadrature size — used by the reduced-integration
        pressure operator of hyperFSIncomp (Q = 1 + qextra,
        src/setuplibceed.c:406).

        Hot-path selection: box (lattice) meshes use the global
        sum-factorized GEMM pipeline (ops/spectral.py) unless
        use_spectral=False; unstructured meshes use the entity-row
        single-GEMM path (ops/structured.py)."""
        self.dtype = dtype or default_dtype()
        fine = spaces[-1]
        self.fine_degree = fine.degree
        self.Q1d = q1d if q1d is not None else fine.degree + 1 + qextra  # setuplibceed.c:252
        is_lattice = fine.lattice_dims is not None
        self.use_spectral = is_lattice and use_spectral
        self.Q3 = self.Q1d ** 3
        nelem = fine.conn.shape[0]
        self.nelem = nelem
        self.levels = []
        for s in spaces:
            basis = Basis3D.create(s.degree + 1, self.Q1d, "gauss", self.dtype)
            lattice = s.lattice_dims is not None
            if lattice:
                # box mesh: index-free structured restriction; element-local
                # columns in plain lattice order (identity col_lattice)
                lr = LatticeRestriction(s.lattice_dims, s.degree)
                col = np.arange((s.degree + 1) ** 3)
                restr, srestr = lr, lr
            else:
                smaps = StructuredMaps(s)
                col = smaps.col_lattice
                restr = Restriction(s.conn, s.num_nodes,
                                    node_ranges=s.entity_node_ranges())
                srestr = StructuredRestriction(smaps)
            spectral = None
            if lattice and self.use_spectral:
                spectral = SpectralLattice(s.lattice_dims, s.degree, basis,
                                           self.dtype)
                sgrad = spectral.matrices()
            elif lattice:
                # component-batched GEMM on the (3, e, P3) lattice E-vector
                sgrad = grad_gemm_matrices_cm(basis, col, self.dtype)
            else:
                sgrad = grad_gemm_matrices(basis, col, self.dtype)
            lvl = LevelOps(
                space=s, restr=restr, basis=basis, srestr=srestr,
                sgrad=sgrad, lattice=lattice, spectral=spectral,
            )
            if s.degree != fine.degree and q1d is None:
                # native-quadrature preconditioner machinery for coarse
                # levels (not built for the reduced-integration pressure
                # factory, whose Q is already minimal)
                Qn = s.degree + 1 + qextra
                nb = Basis3D.create(s.degree + 1, Qn, "gauss", self.dtype)
                lvl.nat_basis = nb
                if lattice:
                    lvl.nat_sgrad = grad_gemm_matrices_cm(nb, col, self.dtype)
                else:
                    lvl.nat_sgrad = grad_gemm_matrices(nb, col, self.dtype)
                from .quadrature import gauss
                from .basis import lagrange_matrices, _kron3
                fq = gauss(self.Q1d)[0]
                lq = gauss(Qn)[0]
                B1, _ = lagrange_matrices(fq, lq)      # (Qn, Q1d) exact
                lvl.stash_interp = jnp.asarray(
                    _kron3(B1, B1, B1).T, self.dtype)  # (Q3f, Q3n)
            self.levels.append(lvl)
        self.fine = self.levels[-1]
        mesh = fine.mesh
        # coordinate (vertex) restriction: trilinear geometry basis 2 -> Q
        self.coord_restr = Restriction(mesh.connectivity.astype(np.int32),
                                       mesh.num_vertices)
        self.coord_basis = Basis3D.create(2, self.Q1d, "gauss", self.dtype)
        self.vertex_coords = jnp.asarray(mesh.vertices.T, dtype=self.dtype)

    # ------------------------------------------------------------------
    def compute_qdata(self) -> jnp.ndarray:
        """(10, nelem, Q3) geometric factors; computed once at setup."""
        xe = self.coord_restr.gather(self.vertex_coords)       # (3, nelem, 8)
        dxdX = self.coord_basis.apply_grad(xe)                 # (3,3,e,Q3)
        return geometry.setup_geo(dxdX, self.coord_basis.qweights)

    def compute_qdata_native(self, level: int) -> jnp.ndarray:
        """(10, nelem, Q3_level) geometric factors at the level's OWN
        Gauss rule (native-quadrature preconditioner levels)."""
        nb = self.levels[level].nat_basis
        cb = Basis3D.create(2, nb.Q, "gauss", self.dtype)
        xe = self.coord_restr.gather(self.vertex_coords)
        dxdX = cb.apply_grad(xe)
        return geometry.setup_geo(dxdX, cb.qweights)

    def stash_to_native(self, stash, level: int):
        """Fine-quadrature stash (any structured-path layout) -> Mat3 of
        (nelem, Q3_level) gradu planes via the EXACT fine-Gauss ->
        level-Gauss interpolation (gradu components are per-direction
        polynomials of degree <= p, determined by their p+1 Gauss values).
        """
        M = self.levels[level].stash_interp
        sv = self.stash_view(stash)
        if sv is None:
            return None
        return Mat3([p @ M for p in sv.m])

    def make_jacobian_native(self, jacobian_planes: Callable, phys,
                             level: int) -> Callable:
        """(v, qdata_nat, stash_nat, srestr_level, nat_sgrad) -> J_l@v with
        the level integrated at its own quadrature (see LevelOps)."""
        lvl = self.levels[level]
        nb = lvl.nat_basis
        Q3 = nb.Q3
        P3 = nb.P3
        nelem = self.nelem
        if lvl.lattice:
            def japply_cm(v, qdata, stash, sr, sk):
                Kg3, Kg3T = sk
                ue = sr.gather(v)
                due = (ue.reshape(3 * nelem, P3) @ Kg3).reshape(
                    3, nelem, 3 * Q3)
                ddu = Mat3([due[c, :, d * Q3:(d + 1) * Q3]
                            for c in range(3) for d in range(3)])
                ddv = jacobian_planes(ddu, qdata, stash, phys)
                dv3 = jnp.stack(
                    [jnp.concatenate(ddv.m[3 * c:3 * c + 3], axis=1)
                     for c in range(3)])
                ve = (dv3.reshape(3 * nelem, 3 * Q3) @ Kg3T).reshape(
                    3, nelem, P3)
                return sr.scatter_add(ve)

            return japply_cm

        def japply(v, qdata, stash, sr, sk):
            Kg, KgT = sk
            due = sr.gather_rows(v.T) @ Kg
            ddu = Mat3([due[:, k * Q3:(k + 1) * Q3] for k in range(9)])
            ddv = jacobian_planes(ddu, qdata, stash, phys)
            ve = jnp.concatenate(ddv.m, axis=1) @ KgT
            return sr.scatter_rows(ve).T

        return japply

    def quad_coords(self) -> jnp.ndarray:
        """(3, nelem, Q3) physical coordinates of quadrature points."""
        xe = self.coord_restr.gather(self.vertex_coords)
        return self.coord_basis.apply_interp(xe)

    def struct_qdata(self, qdata) -> jnp.ndarray:
        """qdata as consumed by the structured apply path: global-quadrature
        layout for the spectral pipeline, the plain array otherwise."""
        if self.use_spectral:
            return self.fine.spectral.qdata_to_global(qdata)
        return qdata

    def stash_view(self, stash):
        """Expose a structured-path stash as Mat3 of (nelem, Q3) planes for
        the unstructured consumers (diagonal, p=1 element matrices)."""
        if (self.use_spectral and isinstance(stash, Mat3)
                and stash.m[0].ndim == 3):
            sp = self.fine.spectral
            return Mat3([sp.plane_to_elem(p) for p in stash.m])
        return stash

    # ------------------------------------------------------------------
    def make_residual(self, residual_qf: Callable, phys) -> Callable:
        """(u (3, nnodes), qdata, restr) -> (residual L-vector, stash or None).

        The Restriction travels as an argument (it is a pytree) so its large
        index arrays are jit inputs, not HLO constants.
        """
        basis = self.fine.basis

        def apply(u, qdata, restr):
            ue = restr.gather(u)
            du = basis.apply_grad(ue)
            dv, stash = residual_qf(du, qdata, phys)
            ve = basis.apply_grad_T(dv)
            return restr.scatter_add(ve), stash

        return apply

    def make_jacobian(self, jacobian_qf: Callable, phys, level: int = -1) -> Callable:
        """(du, qdata, stash, restr) -> J@du L-vector at `level`."""
        basis = self.levels[level].basis

        def apply(du, qdata, stash, restr):
            due = restr.gather(du)
            ddu = basis.apply_grad(due)
            ddv = jacobian_qf(ddu, qdata, stash, phys)
            ve = basis.apply_grad_T(ddv)
            return restr.scatter_add(ve)

        return apply

    # ------------------------------------------------------------------
    # Structured single-GEMM pipeline (ops/structured.py): the production
    # hot path. The qfunction operates on Mat3 views of the GEMM output
    # columns — no (c, d, e, q) tensors are ever materialized.
    # ------------------------------------------------------------------
    def make_residual_structured(self, residual_planes: Callable, phys) -> Callable:
        """(u (3, nnodes), qdata_s, srestr, (Kg, KgT)) -> (residual, stash).

        qdata_s is `struct_qdata(qdata)`; the stash is a Mat3 of planes (use
        `stash_view` for the (nelem, Q3) element layout).
        """
        Q3 = self.fine.basis.Q3
        nelem = self.nelem
        P3 = self.fine.basis.P3
        lattice = self.fine.lattice
        if self.use_spectral:
            sp = self.fine.spectral

            def apply_spectral(u, qdata_g, sr, mats):
                du = sp.grad(u, mats)
                dv, stash = residual_planes(du, qdata_g, phys)
                return sp.grad_T(dv, mats), stash

            return apply_spectral

        if lattice:
            def apply_cm(u, qdata, sr, sk):
                """Component-batched: (3e, P3) @ (P3, 3Q3), planes as
                views of the c-block/d-column slices (3x fewer GEMM flops
                than the interleaved factorization)."""
                Kg3, Kg3T = sk
                ue = sr.gather(u)                          # (3, e, P3)
                due = (ue.reshape(3 * nelem, P3) @ Kg3).reshape(
                    3, nelem, 3 * Q3)
                du = Mat3([due[c, :, d * Q3:(d + 1) * Q3]
                           for c in range(3) for d in range(3)])
                dv, stash = residual_planes(du, qdata, phys)
                dv3 = jnp.stack(
                    [jnp.concatenate(dv.m[3 * c:3 * c + 3], axis=1)
                     for c in range(3)])                   # (3, e, 3Q3)
                ve = (dv3.reshape(3 * nelem, 3 * Q3) @ Kg3T).reshape(
                    3, nelem, P3)
                return sr.scatter_add(ve), stash

            return apply_cm

        def apply(u, qdata, sr, sk):
            Kg, KgT = sk
            due = sr.gather_rows(u.T) @ Kg                 # (e, 9*Q3)
            du = Mat3([due[:, k * Q3:(k + 1) * Q3] for k in range(9)])
            dv, stash = residual_planes(du, qdata, phys)
            ve = jnp.concatenate(dv.m, axis=1) @ KgT       # (e, P3*3)
            return sr.scatter_rows(ve).T, stash

        return apply

    def make_jacobian_structured(self, jacobian_planes: Callable, phys,
                                 level: int = -1) -> Callable:
        """(v, qdata_s, stash, srestr_level, (Kg, KgT)_level) -> J@v."""
        Q3 = self.levels[level].basis.Q3
        P3 = self.levels[level].basis.P3
        nelem = self.nelem
        lattice = self.levels[level].lattice
        if self.use_spectral:
            sp = self.levels[level].spectral

            def japply_spectral(v, qdata_g, stash, sr, mats):
                ddu = sp.grad(v, mats)
                ddv = jacobian_planes(ddu, qdata_g, stash, phys)
                return sp.grad_T(ddv, mats)

            return japply_spectral

        if lattice:
            def japply_cm(v, qdata, stash, sr, sk):
                Kg3, Kg3T = sk
                ue = sr.gather(v)
                due = (ue.reshape(3 * nelem, P3) @ Kg3).reshape(
                    3, nelem, 3 * Q3)
                ddu = Mat3([due[c, :, d * Q3:(d + 1) * Q3]
                            for c in range(3) for d in range(3)])
                ddv = jacobian_planes(ddu, qdata, stash, phys)
                dv3 = jnp.stack(
                    [jnp.concatenate(ddv.m[3 * c:3 * c + 3], axis=1)
                     for c in range(3)])
                ve = (dv3.reshape(3 * nelem, 3 * Q3) @ Kg3T).reshape(
                    3, nelem, P3)
                return sr.scatter_add(ve)

            return japply_cm

        def apply(v, qdata, stash, sr, sk):
            Kg, KgT = sk
            due = sr.gather_rows(v.T) @ Kg
            ddu = Mat3([due[:, k * Q3:(k + 1) * Q3] for k in range(9)])
            ddv = jacobian_planes(ddu, qdata, stash, phys)
            ve = jnp.concatenate(ddv.m, axis=1) @ KgT
            return sr.scatter_rows(ve).T

        return apply

    def make_energy(self, energy_qf: Callable, phys) -> Callable:
        """u -> total strain energy (scalar).

        The reference applies a 1-component operator and sums the nodal
        E-vector (src/matops.c:247-296); by partition of unity that equals
        the direct quadrature sum done here.
        """
        basis = self.fine.basis

        def apply(u, qdata, restr):
            ue = restr.gather(u)
            du = basis.apply_grad(ue)
            return jnp.sum(energy_qf(du, qdata, phys))

        return apply

    def make_diagnostic(self, diagnostic_qf: Callable, phys) -> Callable:
        """u (3, nnodes) -> (nnodes, 8) multiplicity-averaged diagnostics.

        Collocation P -> P Gauss-Lobatto basis (src/setuplibceed.c:347),
        scatter-add then divide by multiplicity (src/misc.c:258-291).
        """
        P = self.fine_degree + 1
        coll = Basis3D.create(P, P, "gauss_lobatto", self.dtype)

        def apply(u, restr, qd_coll, mult):
            ue = restr.gather(u)                  # values at GLL lattice
            du = coll.apply_grad(ue)
            diag = diagnostic_qf(ue, du, qd_coll, phys)   # (8, nelem, P3)
            acc = restr.scatter_add(diag)
            return (acc / mult).T                 # (nnodes, 8)

        return apply

    def diagnostic_setup(self):
        """(qd_coll, mult) arrays for make_diagnostic (collocation geometry
        at GLL points, src/setuplibceed.c:347, and nodal multiplicity)."""
        restr = self.fine.restr
        P = self.fine_degree + 1
        coll_coord = Basis3D.create(2, P, "gauss_lobatto", self.dtype)
        xe = self.coord_restr.gather(self.vertex_coords)
        dxdX = coll_coord.apply_grad(xe)
        # qweights are irrelevant for diagnostics (wdetJ unused); pass ones
        qd_coll = geometry.setup_geo(dxdX, jnp.ones(P ** 3, self.dtype))
        mult = restr.scatter_add(
            jnp.ones((1, restr.nelem, restr.P3), self.dtype)
        )
        return qd_coll, mult

    # ------------------------------------------------------------------
    def make_prolongation(self, coarse_level: int, fine_level: int):
        """Returns (prolong, restrict) closures between two levels.

        Prolongation: gather coarse -> GLL interp P_c -> P_f -> scatter-add
        to fine -> multiply by 1/multiplicity (reference src/matops.c:115-157,
        basis at src/setuplibceed.c:798-803). Restriction is the transpose
        (src/matops.c:160-203).
        """
        c, f = self.levels[coarse_level], self.levels[fine_level]
        Pc, Pf = c.space.degree + 1, f.space.degree + 1
        c2f = Basis3D.create(Pc, Pf, "gauss_lobatto", self.dtype)

        def prolong(uc, restr_c, restr_f, inv_mult):
            ue = restr_c.gather(uc)
            fe = c2f.apply_interp(ue)
            return restr_f.scatter_add(fe) * inv_mult

        def restrict(uf, restr_c, restr_f, inv_mult):
            fe = restr_f.gather(uf * inv_mult)
            ce = c2f.apply_interp_T(fe)
            return restr_c.scatter_add(ce)

        return prolong, restrict

    def fine_inv_multiplicity(self, fine_level: int = -1):
        f = self.levels[fine_level]
        mult = f.restr.scatter_add(
            jnp.ones((1, f.restr.nelem, f.restr.P3), self.dtype)
        )
        return 1.0 / mult

    # ------------------------------------------------------------------
    def make_diagonal(self, jacobian_qf: Callable, phys, level: int = -1,
                      native: bool = False) -> Callable:
        """Assembled operator diagonal at `level` (E1d): the
        CeedOperatorLinearAssembleDiagonal analog (src/matops.c:206-244),
        `element_diagonal` scatter-added. native=True builds it for the level's own quadrature (qdata/stash
        arguments must then be the nat_* arrays).
        """
        basis = (self.levels[level].nat_basis if native
                 else self.levels[level].basis)

        def apply(qdata, stash, restr):
            return restr.scatter_add(element_diagonal(
                jacobian_qf, phys, basis, qdata, stash, self.dtype))

        return apply

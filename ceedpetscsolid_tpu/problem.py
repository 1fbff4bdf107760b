"""Problem orchestration: the framework's `main` (reference elasticity.c:45-924).

Wires mesh -> FE spaces (one per multigrid level) -> operators -> BCs ->
forcing -> solver stack, and exposes solve / postprocessing entry points.
"""

from __future__ import annotations

import math
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .mesh.box import box_mesh
from .mesh.fespace import FESpace, build_fespace
from .models import Physics, get_model, mms
from .models.boundary import BoundaryConditions
from .models.forcing import assemble_forcing
from .ops.operator import OperatorFactory, default_dtype
from .ops.assembly import CSRAssembler, make_element_matrices
from .solve.amg import AMGPreconditioner
from .solve.cg import estimate_extreme_eigs, pcg
from .solve.newton import NewtonOptions, NewtonResult, newton_solve
from .solve.pmg import MGLevel, make_vcycle
from .utils.precise import accurate_matmuls, dot2, norm2
from .utils.timing import GLOBAL_LOG


@dataclass
class Config:
    """CLI-equivalent options (reference src/cloptions.c:26-285)."""

    problem: str = "linElas"
    degree: int = 3
    qextra: int = 0
    nu: float = 0.3
    E: float = 1.0
    mesh_file: str | None = None
    box_faces: Sequence[int] = (3, 3, 3)
    box_lower: Sequence[float] = (0.0, 0.0, 0.0)
    box_upper: Sequence[float] = (1.0, 1.0, 1.0)
    forcing: str = "none"                       # none | constant | mms
    forcing_vec: Sequence[float] = (0.0, -1.0, 0.0)
    bc_clamp: Sequence[int] = ()
    bc_clamp_translate: dict = field(default_factory=dict)   # face -> (tx,ty,tz)
    bc_clamp_rotate: dict = field(default_factory=dict)      # face -> (kx,ky,kz,theta/pi)
    num_increments: int | None = None           # default 1 (linear) else 10
    multigrid: str = "logarithmic"              # logarithmic | uniform | none
    nu_smoother: float = 0.0
    test_mode: bool = False
    # Preconditioner-level quadrature: "native" integrates each coarse
    # p-MG level at its own Gauss rule Q_l = degree_l + 1 (15x fewer
    # qpoints at p=1 under a p=4 fine level; the stashed gradu is
    # re-interpolated EXACTLY onto the level rule); "fine" shares the
    # fine level's quadrature/qdata/stash like the reference
    # (src/setuplibceed.c:756-757). The fine operator (CG matvec +
    # residual) is identical either way — this only changes the
    # preconditioner's level operators.
    level_quadrature: str = "native"
    # units (cloptions.c:237-282)
    units_meter: float = 1.0
    units_second: float = 1.0
    units_kilogram: float = 1.0
    # solver knobs
    ksp_rtol: float | None = 1e-10
    ksp_max_it: int = 10_000
    # per-iteration KSP residual trace (-ksp_monitor; the reference gets
    # it free from PETSc) — printed via jax.debug from inside the CG loop
    ksp_monitor: bool = False
    smooth_its: int = 3                         # PCMGSetNumberSmooth(3)
    coarse_solve: str = "amg"                   # amg (GAMG analog) | chebyshev
    coarse_cheb_its: int = 30                   # chebyshev coarse fallback
    newton: NewtonOptions = field(default_factory=NewtonOptions)
    # failed-increment retries with halved load delta (0 = reference
    # behavior: break the continuation loop on divergence)
    substep_retries: int = 4
    # Matmul precision INSIDE the preconditioner (V-cycle smoothers,
    # transfers, level applies, AMG cycle): "accurate" wraps the whole
    # V-cycle in accurate_matmuls (IEEE f32 GEMMs); "fast" leaves it at the
    # XLA default (TF32 tensor-core GEMMs for f32 on a GPU). The OUTER CG
    # matvec/residual always stays accurate — that is what bounds the
    # attainable residual; M only needs to stay a fixed SPD operator, which
    # it is at either precision (the same traced cycle is applied every
    # iteration). Which default is faster to a converged solve has not been
    # measured on a GPU yet.
    pc_precision: str = "fast"
    # Stop the load-continuation loop once this load fraction is reached
    # (None = run all increments). Lets expensive oracle runs (CPU f64 at
    # degree 4) produce a comparable state at a partial load.
    stop_at_load: float | None = None
    # Preconditioner refresh cadence: rebuild the AMG hierarchy values and
    # the per-level Chebyshev diagonals/eigen-bounds every pc_lag Newton
    # iterations (1 = reference per-Jacobian cadence, misc.c:151-183).
    # CG always applies the FRESH Jacobian — a lagged preconditioner only
    # affects CG iteration counts, never the converged answer.
    pc_lag: int = 1

    def __post_init__(self):
        if self.test_mode:
            self.forcing = "mms"                # cloptions.c:185-187
        if self.num_increments is None:
            self.num_increments = 1 if self.problem == "linElas" else 10
        if self.problem in ("hyperFS", "hyperFSIncomp") and self.forcing == "constant":
            raise ValueError(
                "Cannot use constant forcing and finite strain formulation"
            )  # cloptions.c:89-93

    @property
    def pascal(self) -> float:
        return self.units_kilogram / (self.units_meter * self.units_second**2)

    def level_degrees(self) -> list[int]:
        """Multigrid level schedule (cloptions.c:196-225), coarse -> fine."""
        p = self.degree
        if self.multigrid == "logarithmic":
            n = int(math.ceil(math.log2(p))) + 1 if p > 1 else 1
            degs = [2**i for i in range(max(n - 1, 0))] + ([p] if n > 1 else [])
            return degs if degs else [p]
        if self.multigrid == "uniform":
            return list(range(1, p + 1))
        if self.multigrid == "none":
            return [p]
        raise ValueError(f"unknown multigrid type {self.multigrid!r}")


def _flatwrap(apply_cm):
    """Adapt a component-major (3, nn) -> (3, nn) operator apply to the
    flat node-major (3N,) vectors the AMG cycle works on."""
    def fn(xf):
        return apply_cm(xf.reshape(-1, 3).T).T.reshape(-1)
    return fn


class ElasticityProblem:
    """Owns mesh, spaces, operators, BCs, forcing, and the solve loop."""

    def __init__(self, config: Config, mesh=None):
        self.config = config
        self.dtype = default_dtype()
        t0 = time.perf_counter()

        # --- mesh ("DM and Vector Setup" stage, elasticity.c:128-131) ----
        with GLOBAL_LOG.stage("DM and Vector Setup"):
            if mesh is None:
                if config.mesh_file:
                    from .mesh.exodus import read_exodus
                    from .mesh.reorder import reorder_mesh

                    # BFS element + first-use vertex locality reordering
                    # (the partitioner-quality role of DMPlexDistribute,
                    # setupdm.c:57-64): contiguous element blocks become
                    # spatially compact, shrinking gather spread and
                    # partition halos. Box meshes keep lattice order (the
                    # index-free restriction of ops/lattice.py needs it).
                    mesh = reorder_mesh(read_exodus(config.mesh_file))
                else:
                    mesh = box_mesh(config.box_faces, config.box_lower,
                                    config.box_upper)
            self.mesh = mesh

            # --- FE spaces per level (coarse -> fine) --------------------
            self.level_degrees = config.level_degrees()
            self.spaces: list[FESpace] = [
                build_fespace(mesh, d) for d in self.level_degrees
            ]
            self.fine_space = self.spaces[-1]

        # --- operators ("Operator Setup" stage, the libCEED Setup analog,
        # elasticity.c:230-233) -------------------------------------------
        self._setup_stage = GLOBAL_LOG.stage("Operator Setup")
        self._setup_stage.__enter__()
        self.factory = OperatorFactory(self.spaces, qextra=config.qextra,
                                       dtype=self.dtype)
        with accurate_matmuls():     # geometry factors feed every operator
            self.qdata = self.factory.compute_qdata()
        self.model = get_model(config.problem)
        self.phys = Physics(nu=config.nu, E=config.E * config.pascal)
        self.phys_smoother = (
            Physics(nu=config.nu_smoother, E=config.E * config.pascal)
            if config.nu_smoother
            else None
        )

        # --- boundary conditions ----------------------------------------
        fes = self.fine_space
        self.bcs = BoundaryConditions(num_nodes=fes.num_nodes)
        if config.test_mode or config.forcing == "mms":
            # MMS BCs on the whole boundary (setupdm.c:160-180)
            self.bcs.add_mms(fes.all_boundary_nodes())
        else:
            for face in config.bc_clamp:
                cmax = np.zeros(7)
                cmax[:3] = config.bc_clamp_translate.get(face, (0, 0, 0))
                rot = np.asarray(config.bc_clamp_rotate.get(face, (0, 0, 0, 0)),
                                 dtype=np.float64)
                norm = float(np.linalg.norm(rot[:3]))
                if abs(norm) < 1e-16:
                    norm = 1.0
                cmax[3:6] = rot[:3] / norm        # cloptions.c:124-131
                cmax[6] = rot[3]
                self.bcs.add_clamp(fes.face_set_nodes(face), cmax)
        # component-major (3, nnodes) device layout throughout the solver
        mask_np = self.bcs.mask().T
        self.bc_mask = jnp.asarray(mask_np)
        self.free_mask = jnp.asarray(~mask_np)
        self._coords = fes.coords

        # --- forcing -----------------------------------------------------
        with accurate_matmuls():
            self.F = assemble_forcing(
                self.factory, self.qdata, config.forcing,
                phys=self.phys, forcing_vec=config.forcing_vec,
            )
        # forcing is zero at constrained DOFs (they are not solved for)
        self.F = jnp.where(self.bc_mask, 0.0, self.F)

        # --- jitted kernels ---------------------------------------------
        self.composite = bool(getattr(self.model, "composite", False))
        if self.composite:
            # Reduced-integration pressure operator (hyperFSIncomp):
            # own P->1 basis and Q=1 qdata (src/setuplibceed.c:404-506)
            self.pfactory = OperatorFactory(
                self.spaces, qextra=config.qextra, dtype=self.dtype,
                q1d=1 + config.qextra,
            )
            # share restriction objects (identical index maps) with the
            # full-quadrature factory so only one copy travels through jit
            for plvl, flvl in zip(self.pfactory.levels, self.factory.levels):
                plvl.restr = flvl.restr
                plvl.srestr = flvl.srestr
            self.pfactory.coord_restr = self.factory.coord_restr
            with accurate_matmuls():
                self.qdata_p = self.pfactory.compute_qdata()
            nlev = len(self.spaces)
            res_mu = self.factory.make_residual_structured(
                self.model.residual_planes, self.phys
            )
            res_p = self.pfactory.make_residual_structured(
                self.model.pressure_residual_planes, self.phys
            )
            jac_mu = [
                self.factory.make_jacobian_structured(
                    self.model.jacobian_planes, self.phys, level=l)
                for l in range(nlev)
            ]
            jac_p = [
                self.pfactory.make_jacobian_structured(
                    self.model.pressure_jacobian_planes, self.phys, level=l)
                for l in range(nlev)
            ]

            def _raw_residual(u, big):
                sr, sk = big["srestrs"][-1], big["sgrads"][-1]
                r1, s1 = res_mu(u, big["qdata_s"], sr, sk)
                r2, s2 = res_p(u, big["qdata_p_s"], sr, big["sgrads_p"][-1])
                return r1 + r2, (s1, s2)

            def _raw_jacobian(v, big, stash, level=-1):
                sr = big["srestrs"][level]
                return jac_mu[level](
                    v, big["qdata_s"], stash[0], sr, big["sgrads"][level]
                ) + jac_p[level](
                    v, big["qdata_p_s"], stash[1], sr, big["sgrads_p"][level]
                )

            self._raw_residual = _raw_residual
            self._raw_jacobian = _raw_jacobian
        else:
            nlev = len(self.spaces)
            res_one = self.factory.make_residual_structured(
                self.model.residual_planes, self.phys
            )
            jac_lvls = [
                self.factory.make_jacobian_structured(
                    self.model.jacobian_planes, self.phys, level=l)
                for l in range(nlev)
            ]

            def _raw_residual(u, big):
                return res_one(u, big["qdata_s"], big["srestrs"][-1],
                               big["sgrads"][-1])

            def _raw_jacobian(v, big, stash, level=-1):
                return jac_lvls[level](v, big["qdata_s"], stash,
                                       big["srestrs"][level],
                                       big["sgrads"][level])

            self._raw_residual = _raw_residual
            self._raw_jacobian = _raw_jacobian

        # --- native-quadrature preconditioner levels ----------------------
        # (Config.level_quadrature == "native"; see ops/operator.LevelOps)
        nlev = len(self.spaces)
        self._use_native_levels = (
            config.level_quadrature == "native" and nlev > 1
        )
        if self._use_native_levels:
            jp = self.model.jacobian_planes
            self._jac_nat = [
                self.factory.make_jacobian_native(jp, self.phys, level=l)
                for l in range(nlev - 1)
            ]
            with accurate_matmuls():
                self._qdata_nat = tuple(
                    self.factory.compute_qdata_native(l)
                    for l in range(nlev - 1)
                )
            self._nat_sgrads = tuple(
                self.factory.levels[l].nat_sgrad for l in range(nlev - 1)
            )

            def raw_jacobian_native(v, big, stash, stash_nat, level):
                """Level apply at the level's own quadrature. stash_nat is
                the pre-interpolated gradu (computed once per solve trace,
                so the while-loop body carries it as an invariant)."""
                jv = self._jac_nat[level](
                    v, big["qdata_nat"][level], stash_nat,
                    big["srestrs"][level], big["nat_sgrads"][level])
                if self.composite:
                    # reduced-integration pressure term is already at its
                    # minimal quadrature; reuse the existing level path
                    jv = jv + jac_p[level](
                        v, big["qdata_p_s"], stash[1],
                        big["srestrs"][level], big["sgrads_p"][level])
                return jv

            self._raw_jacobian_native = raw_jacobian_native

            def stash_nat_for(stash, level):
                sm = stash[0] if self.composite else stash
                return self.factory.stash_to_native(sm, level)

            self._stash_nat_for = stash_nat_for

        energy_fn = self.factory.make_energy(self.model.energy_qf, self.phys)

        def energy_impl(u, big):
            with accurate_matmuls():
                return energy_fn(u, big["qdata"], big["restrs"][-1])

        self._energy_j = jax.jit(energy_impl)
        self._diagnostic = None
        # Everything O(nelem)/O(nnodes) travels through jit as arguments in
        # this pytree, not as baked HLO constants (which would bloat every
        # compiled program by the mesh size).
        self._big = {
            "qdata": self.qdata,
            # structured-path view (global-quadrature layout on boxes)
            "qdata_s": self.factory.struct_qdata(self.qdata),
            "restrs": tuple(l.restr for l in self.factory.levels),
            "srestrs": tuple(l.srestr for l in self.factory.levels),
            "sgrads": tuple(l.sgrad for l in self.factory.levels),
        }
        if self.composite:
            # element layout for diagonal/p=1-assembly consumers; structured
            # (spectral global-quad) layout for the hot residual/Jacobian
            self._big["qdata_p"] = self.qdata_p
            self._big["qdata_p_s"] = self.pfactory.struct_qdata(self.qdata_p)
            self._big["sgrads_p"] = tuple(
                l.sgrad for l in self.pfactory.levels
            )
        if self._use_native_levels:
            self._big["qdata_nat"] = self._qdata_nat
            self._big["nat_sgrads"] = self._nat_sgrads
        self.setup_time = time.perf_counter() - t0
        self._setup_stage.__exit__(None, None, None)
        with GLOBAL_LOG.stage("SNES Setup"):
            self._build_solver()

    # ------------------------------------------------------------------
    # Public kernel wrappers (old signatures; big arrays threaded inside)
    def _nonlinear_residual(self, u, bc_vals, F):
        return self._nl_res_j(u, bc_vals, F, self._big)

    def _jacobian_action(self, v, stash):
        return self._jac_act_j(v, stash, self._big)

    def _linear_solve(self, G, stash, refresh=True, rtol=None):
        if refresh or (self._use_amg and "amg" not in self._big):
            self._refresh_amg(stash)
        pc = self._pc_setup(stash, refresh=refresh)
        # rtol rides as a traced scalar so Eisenstat-Walker forcing terms
        # (solve/newton.py) don't retrigger compilation per Newton step
        rt = jnp.asarray(self.config.ksp_rtol if rtol is None else rtol,
                         jnp.float32)
        return self._lin_solve_j(G, stash, self._big, pc, rt)

    def _pc_setup(self, stash, refresh=True):
        """Preconditioner data (level diagonals + Chebyshev eigenvalue
        bounds), refreshed once per Jacobian like the reference's
        KSPChebyshevEstEig (elasticity.c:539-545) — NOT inside the solve.
        For linear models the Jacobian never changes, so it is computed
        exactly once; refresh=False (pc_lag cadence) reuses the last one."""
        if self._pc_cache is not None and \
                (not self.model.nonlinear or not refresh):
            return self._pc_cache
        pc = self._pc_setup_j(stash, self._big)
        self._pc_cache = pc
        return pc

    def _energy(self, u, qdata=None):
        return self._energy_j(u, self._big)

    # ------------------------------------------------------------------
    def bc_values(self, load_increment: float) -> jnp.ndarray:
        v = self.bcs.values(self._coords, load_increment)
        return jnp.asarray(v.T, self.dtype)          # (3, nnodes)

    def insert_bc(self, u: jnp.ndarray, bc_vals: jnp.ndarray) -> jnp.ndarray:
        """DMPlexInsertBoundaryValues analog (matops.c:70-73)."""
        return jnp.where(self.bc_mask, bc_vals, u)

    # ------------------------------------------------------------------
    def _build_solver(self):
        cfg = self.config

        def nonlinear_residual_impl(u, bc_vals, F, big):
            """G(u) = R(u with BCs inserted) - F, zeroed at constrained DOFs
            (FormResidual_Ceed, matops.c:63-79). Traced under full-f32
            matmul precision: the residual sets the Newton convergence
            floor (see utils/precise.accurate_matmuls)."""
            with accurate_matmuls():
                mask = big["mask"]
                u_in = jnp.where(mask, bc_vals, u)
                r, stash = self._raw_residual(u_in, big)
                return jnp.where(mask, 0.0, r - F), stash

        def jacobian_action_impl(v, stash, big):
            """Zero-BC linearized action (ApplyJacobian_Ceed, matops.c:98-112).

            Full-f32 matmul precision: this is the OUTER Krylov matvec —
            CG's attainable residual stalls at ~(matvec noise x cond), so a
            reduced-precision default GEMM caps the linear solve and Newton
            grinds. Smoother/transfer applies inside the V-cycle stay at the
            fast default: they only shape the preconditioner."""
            with accurate_matmuls():
                mask = big["mask"]
                v_in = jnp.where(mask, 0.0, v)
                jv = self._raw_jacobian(v_in, big, stash)
                return jnp.where(mask, 0.0, jv)

        self._nl_res_j = jax.jit(nonlinear_residual_impl)
        self._jac_act_j = jax.jit(jacobian_action_impl)
        self._big["mask"] = self.bc_mask

        def fused_ls_impl(u, G, d, bc_vals, F, big):
            """CP line search (1 secant step, matching newton._line_search
            and the distributed driver) + domain-error backtracking + the
            next residual + policy norms, fused into ONE device program:
            one host synchronisation per Newton iteration instead of ~6."""
            g0 = dot2(G, d)
            G1, _ = nonlinear_residual_impl(u + d, bc_vals, F, big)
            g1 = dot2(G1, d)
            lam_raw = g0 / (g0 - g1)
            ok = (jnp.isfinite(lam_raw) & (lam_raw > 1e-8)
                  & (lam_raw < 1e2))
            lam = jnp.where(ok, lam_raw, jnp.ones_like(lam_raw))
            G2, stash2 = nonlinear_residual_impl(u + lam * d, bc_vals, F,
                                                 big)
            rn = norm2(G2)

            def bt_cond(s):
                lam_, G_, st_, rn_, t = s
                return (~jnp.isfinite(rn_)) & (t < 12)

            def bt_body(s):
                lam_, G_, st_, rn_, t = s
                lam2 = lam_ * 0.5
                G3, st3 = nonlinear_residual_impl(u + lam2 * d, bc_vals, F,
                                                  big)
                return (lam2, G3, st3, norm2(G3), t + 1)

            lam, G2, stash2, rn, _ = jax.lax.while_loop(
                bt_cond, bt_body, (lam, G2, stash2, rn, jnp.int32(0)))
            u_new = u + lam * d
            scalars = jnp.stack([rn, norm2(lam * d), norm2(u_new),
                                 lam.astype(rn.dtype)])
            return u_new, G2, stash2, scalars

        self._ls_j = jax.jit(fused_ls_impl)

        # Smoother physics for diagonal assembly (-nu_smoother swap,
        # matops.c:215-232)
        diag_phys = self.phys_smoother or self.phys
        nlev = len(self.spaces)

        def _nat_level(l):
            ln = l % nlev
            return self._use_native_levels and ln < nlev - 1

        diag_mu = [
            self.factory.make_diagonal(self.model.jacobian_qf, diag_phys,
                                       level=l, native=_nat_level(l))
            for l in range(nlev)
        ]
        if self.composite:
            diag_p = [
                self.pfactory.make_diagonal(
                    self.model.pressure_jacobian_qf, diag_phys, level=l
                )
                for l in range(nlev)
            ]

        def level_diag(l, stash, big):
            sv = self.factory.stash_view
            s_mu = stash[0] if self.composite else stash
            if _nat_level(l):
                qd, st = (big["qdata_nat"][l % nlev],
                          self._stash_nat_for(stash, l % nlev))
            else:
                qd, st = big["qdata"], sv(s_mu)
            d = diag_mu[l](qd, st, big["restrs"][l])
            if self.composite:
                d = d + diag_p[l](big["qdata_p"],
                                  self.pfactory.stash_view(stash[1]),
                                  big["restrs"][l])
            return d

        # --- AMG coarse machinery (E3e/E3f): assembled p=1 + native SA ---
        self._use_amg = (
            cfg.coarse_solve == "amg" and cfg.multigrid != "none"
        )
        if self._use_amg:
            # top_mf: level-0 matvecs run through the matrix-free p=1
            # operator (dense GEMMs) instead of sparse ELL gathers;
            # the assembled level-0 matrix never leaves the host
            self._amg = AMGPreconditioner(self.dtype, top_mf=True)
            nat0 = _nat_level(0)
            em_mu = make_element_matrices(
                self.model.jacobian_qf, self.phys,
                (self.factory.levels[0].nat_basis if nat0
                 else self.factory.levels[0].basis), self.dtype,
            )

            def _mu_qdata_stash(stash, big):
                """p=1 element-matrix inputs — at the native level-0
                quadrature when enabled (8 qpts/elem instead of Q_fine^3)."""
                if nat0:
                    return big["qdata_nat"][0], self._stash_nat_for(stash, 0)
                s_mu = stash[0] if self.composite else stash
                return big["qdata"], self.factory.stash_view(s_mu)

            if self.composite:
                em_p = make_element_matrices(
                    self.model.pressure_jacobian_qf, self.phys,
                    self.pfactory.levels[0].basis, self.dtype,
                )
                def elem_mats_composite(stash, big):
                    # full precision: an asymmetric (rounding-noise) coarse
                    # matrix makes the AMG V-cycle a non-SPD M for CG
                    with accurate_matmuls():
                        qd, st = _mu_qdata_stash(stash, big)
                        return em_mu(qd, st) + em_p(
                            big["qdata_p"],
                            self.pfactory.stash_view(stash[1]))

                self._elem_mats0 = jax.jit(elem_mats_composite)
                _elem_mats_impl = elem_mats_composite
            else:
                def elem_mats_single(stash, big):
                    with accurate_matmuls():
                        qd, st = _mu_qdata_stash(stash, big)
                        return em_mu(qd, st)

                self._elem_mats0 = jax.jit(elem_mats_single)
                _elem_mats_impl = elem_mats_single
            space0 = self.spaces[0]
            self._assembler0 = CSRAssembler(
                space0.conn, space0.num_nodes,
                np.asarray(self._level_mask(space0)),
            )
            def emvals_impl(stash, big, inv_dev):
                # element matrices + CSR slot-reduction in ONE device
                # program; only the (nnz,) value vector crosses d2h
                em = _elem_mats_impl(stash, big)
                return jax.ops.segment_sum(
                    em.reshape(-1), inv_dev,
                    num_segments=self._assembler0._nnz)

            self._emvals0 = jax.jit(emvals_impl)

            def amg_apply(b, coarse_data, top_mv=None):
                """(3, nn0) residual -> AMG V-cycle result (node-major flat
                inside). top_mv: flat level-0 matvec (the matrix-free p=1
                operator closed over the current stash; see
                AMGPreconditioner.apply)."""
                xf = self._amg.apply(b.T.reshape(-1), coarse_data,
                                     top_matvec=top_mv)
                return xf.reshape(-1, 3).T

            self._amg_apply = amg_apply

        def refresh_amg(stash):
            """FormJacobian analog (misc.c:151-183): assemble the p=1
            matrix analytically and refresh the native AMG hierarchy."""
            if not self._use_amg:
                return
            if self._amg.handle is not None and not self.model.nonlinear:
                return          # linear problem: hierarchy never changes
            asm = self._assembler0
            if asm._inv_dev is None:
                import jax.numpy as _jnp
                asm._inv_dev = _jnp.asarray(asm._inv.astype(np.int32))
            vals = self._emvals0(stash, self._big, asm._inv_dev)
            A = asm.from_values(np.asarray(vals))
            self._amg.setup(A)
            self._big["amg"] = self._amg.data

        self._refresh_amg = refresh_amg

        self._pc_cache = None
        use_mg = cfg.multigrid != "none" and len(self.spaces) > 1
        if not use_mg:
            use_amg_pc = self._use_amg and cfg.multigrid != "none"

            def jacobi_setup(stash, big):
                with accurate_matmuls():
                    mask = big["mask"]
                    d = jnp.where(mask, 1.0, level_diag(-1, stash, big))
                    return (1.0 / d,)

            def linear_solve_jacobi(G, stash, big, pc, rtol):
                """Jacobi CG (elasticity.c:515-518), or AMG-preconditioned
                CG at degree 1 (PCGAMG, elasticity.c:519-521).

                Precision scope: the OUTER CG matvec runs at full-f32 matmul
                precision — it bounds the attainable linear residual. The
                preconditioner only needs to stay one fixed (near-)SPD
                operator, which the same traced cycle at the fast default
                is; cfg.pc_precision selects its precision."""
                mask = big["mask"]
                (diag_inv,) = pc

                def raw_apply(v):
                    v_in = jnp.where(mask, 0.0, v)
                    return jnp.where(mask, 0.0,
                                     self._raw_jacobian(v_in, big, stash))

                def A(v):
                    with accurate_matmuls():
                        return raw_apply(v)

                pc_ctx = (accurate_matmuls
                          if cfg.pc_precision == "accurate" else nullcontext)
                if use_amg_pc:
                    def M(r):
                        with pc_ctx():
                            return jnp.where(mask, 0.0, self._amg_apply(
                                r, big["amg"], top_mv=_flatwrap(raw_apply)))
                else:
                    M = lambda r: diag_inv * r                     # noqa: E731
                # NOT wrapped in accurate_matmuls: A/M carry their own
                # precision scopes (an active outer context would override
                # the fast pc_precision inside M); pcg itself has no
                # matmuls, its reductions are compensated dot2
                res = pcg(A, -G, M_inv=M, rtol=rtol,
                          maxiter=cfg.ksp_max_it, monitor=cfg.ksp_monitor)
                return res.x, res.iters

            self._pc_setup_j = jax.jit(jacobi_setup)
            self._lin_solve_j = jax.jit(linear_solve_jacobi)
            return

        # ---- p-multigrid preconditioned CG (elasticity.c:524-590) -------
        self._big["level_masks"] = tuple(
            self._level_mask(s) for s in self.spaces
        )
        self._big["inv_mult"] = tuple(
            self.factory.fine_inv_multiplicity(l) for l in range(1, nlev)
        )
        transfers = [
            self.factory.make_prolongation(l - 1, l) for l in range(1, nlev)
        ]

        def build_mg_levels(stash, big):
            mg_levels = []
            # native-level stashes interpolated ONCE per trace: every
            # smoother apply inside the CG while-loop then carries them as
            # loop invariants instead of re-interpolating per iteration
            stash_nats = [
                self._stash_nat_for(stash, l) if _nat_level(l) else None
                for l in range(nlev - 1)
            ]
            for l in range(nlev):
                lm = big["level_masks"][l]

                if _nat_level(l):
                    def lvl_apply(v, stash_, l=l, lm=lm, sn=stash_nats[l]):
                        v = jnp.where(lm, 0.0, v)
                        jv = self._raw_jacobian_native(v, big, stash_, sn, l)
                        return jnp.where(lm, 0.0, jv)
                else:
                    def lvl_apply(v, stash_, l=l, lm=lm):
                        v = jnp.where(lm, 0.0, v)
                        jv = self._raw_jacobian(v, big, stash_, level=l)
                        return jnp.where(lm, 0.0, jv)

                if l == 0:
                    prolong = restrict = None
                else:
                    pro, res = transfers[l - 1]
                    rc, rf = big["restrs"][l - 1], big["restrs"][l]
                    im = big["inv_mult"][l - 1]
                    prolong = lambda uc, pro=pro, rc=rc, rf=rf, im=im: pro(
                        uc, rc, rf, im)
                    restrict = lambda uf, res=res, rc=rc, rf=rf, im=im: res(
                        uf, rc, rf, im)
                mg_levels.append(
                    MGLevel(apply=lvl_apply, mask=lm, prolong=prolong,
                            restrict=restrict)
                )
            return mg_levels

        def mg_setup(stash, big):
            """Per-level diagonals + Chebyshev bounds: the KSPChebyshevEstEig
            analog (elasticity.c:539-545), run once per Jacobian refresh."""
            with accurate_matmuls():
                mg_levels = build_mg_levels(stash, big)
                diag_invs = []
                bounds = []
                for l in range(nlev):
                    d = jnp.where(big["level_masks"][l], 1.0,
                                  level_diag(l, stash, big))
                    dinv = 1.0 / d
                    diag_invs.append(dinv)
                    lo, hi = estimate_extreme_eigs(
                        lambda v, l=l: mg_levels[l].apply(v, stash),
                        dinv, d.shape, d.dtype,
                    )
                    bounds.append((lo, hi))
                return tuple(diag_invs), tuple(bounds)

        def linear_solve_mg(G, stash, big, pc, rtol):
            """p-MG-preconditioned CG.

            Precision scope: the OUTER CG matvec runs at full-f32 matmul
            precision — reduced-precision GEMM noise there corrupts the
            Krylov directions and caps the attainable residual (see
            utils/precise.accurate_matmuls). The V-cycle interior
            (smoothers, transfers, AMG coarse) only shapes the
            preconditioner — cfg.pc_precision selects whether it runs at
            the fast XLA default or full f32."""
            diag_invs, bounds = pc
            mg_levels = build_mg_levels(stash, big)
            if self._use_amg:
                top_mv = _flatwrap(lambda v: mg_levels[0].apply(v, stash))
                coarse_apply = lambda b0, cd: self._amg_apply(  # noqa: E731
                    b0, cd, top_mv=top_mv)
            else:
                coarse_apply = None
            vcycle = make_vcycle(mg_levels, smooth_its=cfg.smooth_its,
                                 coarse_cheb_its=cfg.coarse_cheb_its,
                                 coarse_apply=coarse_apply)
            coarse_data = big.get("amg") if self._use_amg else None

            def A(v):
                with accurate_matmuls():
                    return mg_levels[-1].apply(v, stash)

            pc_ctx = (accurate_matmuls
                      if cfg.pc_precision == "accurate" else nullcontext)

            def M(r):
                with pc_ctx():
                    return vcycle(r, stash, list(diag_invs),
                                  list(bounds), coarse_data)

            # NOT wrapped in accurate_matmuls: A/M carry their own
            # precision scopes (an active outer context would override the
            # fast pc_precision inside M); pcg itself has no matmuls, its
            # reductions are compensated dot2
            res = pcg(A, -G, M_inv=M, rtol=rtol,
                      maxiter=cfg.ksp_max_it, monitor=cfg.ksp_monitor)
            return res.x, res.iters

        self._pc_setup_j = jax.jit(mg_setup)
        self._lin_solve_j = jax.jit(linear_solve_mg)
        # profiling hook (scripts/profile_solve.py): per-piece attribution
        # of the CG iteration without duplicating the closure wiring
        self._build_mg_levels = build_mg_levels

    def _level_mask(self, space: FESpace) -> jnp.ndarray:
        """Constrained-DOF mask for a level's space (same BC face sets)."""
        cfg = self.config
        bcs = BoundaryConditions(num_nodes=space.num_nodes)
        if cfg.test_mode or cfg.forcing == "mms":
            bcs.add_mms(space.all_boundary_nodes())
        else:
            for face in cfg.bc_clamp:
                bcs.add_clamp(space.face_set_nodes(face), np.zeros(7))
        return jnp.asarray(bcs.mask().T)             # (3, nnodes)

    # ------------------------------------------------------------------
    def solve(self, monitor=None, u0=None, start_load: float = 0.0,
              floor_atol0: float = 0.0) -> "SolveInfo":
        """Load-increment continuation loop (elasticity.c:636-673).

        u0/start_load/floor_atol0 resume the continuation from a
        checkpointed state (a capability the reference lacks, SURVEY §5):
        a long run can be split across processes, or restarted from its
        last converged increment."""
        with GLOBAL_LOG.stage("SNES Solve"):
            return self._solve_impl(monitor, u0=u0, start_load=start_load,
                                    floor_atol0=floor_atol0)

    def _solve_impl(self, monitor=None, u0=None, start_load: float = 0.0,
                    floor_atol0: float = 0.0) -> "SolveInfo":
        cfg = self.config
        u = (jnp.zeros((3, self.fine_space.num_nodes), self.dtype)
             if u0 is None else jnp.asarray(u0, self.dtype))
        total_snes = total_ksp = 0
        rnorm = 0.0
        t0 = time.perf_counter()
        last = None
        load_done = float(start_load)
        floor_atol = float(floor_atol0)

        def run_newton(load, u0):
            bc_vals = self.bc_values(load)
            F = self.F * load
            nstep = [0]

            def residual(uu):
                return self._nonlinear_residual(uu, bc_vals, F)

            def linear_solve(uu, G, stash, eta=None):
                refresh = (nstep[0] % max(cfg.pc_lag, 1)) == 0
                nstep[0] += 1
                # Eisenstat-Walker forcing: never looser than the clamp in
                # newton_solve, never tighter than the configured ksp_rtol
                rtol = None if eta is None else max(cfg.ksp_rtol, eta)
                return self._linear_solve(G, stash, refresh=refresh,
                                          rtol=rtol)

            def fused_ls(uu, G, d):
                return self._ls_j(uu, G, d, bc_vals, F, self._big)

            return newton_solve(residual, linear_solve, u0, cfg.newton,
                                floor_atol=floor_atol, fused_ls=fused_ls)

        for inc in range(1, cfg.num_increments + 1):
            target = inc / cfg.num_increments
            if cfg.stop_at_load is not None and \
                    target > cfg.stop_at_load + 1e-12:
                break
            # Adaptive sub-stepping: where the reference simply breaks the
            # continuation on divergence (elasticity.c:668-672), a failed
            # increment here retries from the last converged state with a
            # halved load delta (classic continuation practice; rescues the
            # artificial first-increment BC-jump state where the hyperFS
            # tangent is indefinite — see NewtonOptions.stall_rtol).
            delta = target - load_done
            fails = 0
            while load_done < target - 1e-12:
                load = min(target, load_done + delta)
                try:
                    res: NewtonResult = run_newton(load, u)
                except FloatingPointError:
                    # non-finite data reached a host-side factorization
                    # (AMG coarse): treat like a diverged increment
                    res = NewtonResult(u, 0, 0, float("nan"), False,
                                       "diverged (non-finite)")
                total_snes += res.iters
                total_ksp += res.linear_iters
                rnorm = res.rnorm
                last = res
                if monitor is not None:
                    monitor(inc, load, res)
                if res.converged:
                    u = res.u
                    load_done = load
                    # the attainable absolute floor observed so far: lets
                    # sub-stepped increments (tiny entry residual) accept
                    # stagnation at the hardware noise floor
                    floor_atol = max(floor_atol, res.rnorm)
                else:
                    fails += 1
                    delta *= 0.5
                    if fails > cfg.substep_retries:
                        break
            if load_done < target - 1e-12:
                break  # elasticity.c:668-672 (after sub-step retries)
        solve_time = time.perf_counter() - t0
        u_out = self.insert_bc(u, self.bc_values(max(load_done, 1e-30)))
        return SolveInfo(
            u=u_out,
            snes_iters=total_snes,
            ksp_iters=total_ksp,
            rnorm=rnorm,
            converged=bool(last.converged) if last else True,
            reason=last.reason if last else "",
            solve_time=solve_time,
            dofs=3 * self.fine_space.num_nodes,
        )

    # ------------------------------------------------------------------
    # Postprocessing (L6)
    # ------------------------------------------------------------------
    def mms_error(self, u: jnp.ndarray) -> float:
        """Relative L2 error vs MMS true solution over the WHOLE vector,
        boundary DOFs included, matching the reference's norm of U - U*
        (elasticity.c:800-804; true solution at nodes, setuplibceed.c:592-643).
        `u` must carry the inserted boundary values (SolveInfo.u does)."""
        u_star = mms.true_solution(jnp.asarray(self._coords, self.dtype)).T
        return float(jnp.linalg.norm(u - u_star) / jnp.linalg.norm(u_star))

    def strain_energy(self, u: jnp.ndarray) -> float:
        """Total strain energy (matops.c:247-296)."""
        return float(self._energy(u, self.qdata))

    def diagnostics(self, u: jnp.ndarray) -> jnp.ndarray:
        """(nnodes, 8) nodal diagnostic fields (misc.c:217-311)."""
        if self._diagnostic is None:
            fn = self.factory.make_diagnostic(self.model.diagnostic_qf, self.phys)
            with accurate_matmuls():
                self._diag_setup = self.factory.diagnostic_setup()

            def diag_impl(u, restr, qd_coll, mult):
                with accurate_matmuls():
                    return fn(u, restr, qd_coll, mult)

            self._diagnostic = jax.jit(diag_impl)
        qd_coll, mult = self._diag_setup
        return self._diagnostic(u, self._big["restrs"][-1], qd_coll, mult)


@dataclass
class SolveInfo:
    u: jnp.ndarray
    snes_iters: int
    ksp_iters: int
    rnorm: float
    converged: bool
    reason: str
    solve_time: float
    dofs: int

    @property
    def mdofs_per_sec(self) -> float:
        """1e-6 * dofs * ksp_iters / time (elasticity.c:763-764)."""
        if self.solve_time == 0:
            return 0.0
        return 1e-6 * self.dofs * self.ksp_iters / self.solve_time

"""Distributed Newton driver over a 1-D device mesh.

Mirrors the serial solve path of problem.py but executes every operator
application under shard_map with halo exchange (parallel/dist.py), the
SPMD analog of the reference's rank-per-subdomain MPI execution
(SURVEY "Parallelism strategies"). One Newton iteration — residual, CG with
Jacobi or full p-multigrid(+replicated AMG coarse) preconditioning,
critical-point line search, update — is a single jitted SPMD computation:
the "training step" of this framework.

Preconditioner data (level diagonals + Chebyshev eigenvalue bounds) is a
SEPARATE sharded computation run once per Jacobian refresh and fed to the
step as arguments — the KSPChebyshevEstEig cadence of the serial path
(problem.py _pc_setup; reference elasticity.c:539-545) — so linear models
estimate eigenvalues exactly once instead of every Newton step.

Every mesh-sized array travels as a jit argument (sharded pytrees), so
compiled modules stay small and shapes stay static across Newton steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import dist, mg as dmg, slab as slab_mod
from ..models.base import Mat3
from ..ops.operator import element_diagonal
from ..ops.structured import grad_gemm_matrices
from ..solve.cg import chebyshev
from ..solve.newton import NewtonOptions, NewtonPolicy
from ..utils.precise import accurate_matmuls
from .dist import AXIS, ShardArrays
from .partition import (
    SpacePartition,
    gather_owned_to_global,
    partition_space,
    scatter_global_to_owned,
)


@dataclass
class DistributedProblem:
    """Distributes an ElasticityProblem over ndev devices.

    use_mg: p-multigrid-preconditioned CG inside the SPMD step (requires the
    problem to be configured with multigrid != 'none'); composite models
    (hyperFSIncomp) get the same distributed p-MG as single-operator ones.
    """

    problem: "ElasticityProblem"  # noqa: F821
    ndev: int
    devices: list | None = None
    use_mg: bool | None = None
    use_slab: bool | None = None   # None = auto: spectral slab fold on boxes

    def __post_init__(self):
        prob = self.problem
        fes = prob.fine_space
        if self.use_mg is None:
            self.use_mg = (
                prob.config.multigrid != "none" and len(prob.spaces) > 1
            )
        # Box meshes: slab-partitioned spectral fold for the fine-level
        # residual / Krylov matvec / finest smoother (parallel/slab.py) —
        # the serial spectral hot path run per shard. Elements then follow
        # the slab-aligned blocks; otherwise the interior-first reorder of
        # partition_space drives the halo/compute overlap of split_rows.
        self.slab = None
        if self.use_slab is not False:
            self.slab = slab_mod.SlabSpectral.build(prob, self.ndev)
        if self.use_slab is True and self.slab is None:
            raise ValueError("use_slab=True requires a box mesh with the "
                             "spectral fine path and ndev <= ez")
        if self.slab is not None:
            self.part = partition_space(fes.conn, fes.num_nodes, self.ndev,
                                        elem_gid=self.slab.elem_gid)
        else:
            self.part = partition_space(fes.conn, fes.num_nodes, self.ndev)
        self.sa = ShardArrays.from_partition(self.part)
        self.model = prob.model
        self.phys = prob.phys
        self.dtype = prob.dtype

        devs = self.devices or jax.devices()[: self.ndev]
        if len(devs) != self.ndev:
            raise ValueError(
                f"need {self.ndev} devices for ndev={self.ndev}, "
                f"have {len(devs)} (set xla_force_host_platform_device_count)"
            )
        self.mesh = Mesh(np.array(devs), (AXIS,))

        # qdata (10, nelem, Q3) -> (ndev, 10, nelem_max, Q3), zero padding
        qd = np.asarray(prob.qdata)
        self.qdata_sh = self._shard(self._pad_qdata(qd))
        self.composite = prob.composite
        if self.composite:
            # reduced-integration pressure operator data (Q=1 qdata +
            # per-level P->1 gradient GEMMs, src/setuplibceed.c:404-506)
            self.qdata_p_sh = self._shard(
                self._pad_qdata(np.asarray(prob.qdata_p)))
        else:
            self.qdata_p_sh = None

        self.mask_sh = self._shard(
            scatter_global_to_owned(self.part, np.asarray(prob.bc_mask))
        )
        self.F_sh = self._shard(
            scatter_global_to_owned(self.part, np.asarray(prob.F))
        )

        if self.use_mg:
            self.levels = dmg.build_dist_levels(prob, self.part, self.ndev)
            self.level_arrays = tuple(
                {"sa": l.sa, "mask": l.mask, "owned_gid": l.owned_gid,
                 "inv_mult": self._inv_mult(l, i)}
                for i, l in enumerate(self.levels)
            )
            # AMG coarse hierarchy: assembled once host-side at u=0 state;
            # refreshed by refresh_amg() per Newton step for nonlinear runs
            self._amg = None
        self._build_step()

    def _inv_mult(self, lvl: dmg.DistLevel, l: int):
        """Owned-layout inverse node multiplicity for prolongation scaling
        (misc.c:115-143) — pure mesh data, computed host-side once."""
        if l == 0:
            return None
        space = self.problem.spaces[l]
        mult = np.bincount(space.conn.reshape(-1),
                           minlength=space.num_nodes).astype(np.float64)
        mult[mult == 0] = 1.0
        inv = np.broadcast_to(1.0 / mult, (3, space.num_nodes))
        arr = scatter_global_to_owned(self._level_part(l), inv)
        return jnp.asarray(arr.astype(self.dtype))

    def _level_part(self, l: int) -> SpacePartition:
        if not hasattr(self, "_level_parts"):
            self._level_parts = {}
        if l not in self._level_parts:
            space = self.problem.spaces[l]
            if l == len(self.problem.spaces) - 1:
                self._level_parts[l] = self.part
            else:
                # same element order as the fine partition: element-indexed
                # data (qdata, gradu stash) is shared across levels
                self._level_parts[l] = partition_space(
                    space.conn, space.num_nodes, self.ndev,
                    elem_gid=self.part.elem_gid)
        return self._level_parts[l]

    def _pad_qdata(self, qd):
        """(nq, nelem, Q3) global qdata -> (ndev, nq, nelem_max, Q3) in the
        shard-local (interior-first) element order; padded elements carry
        zero qdata and contribute nothing."""
        nq, nelem, Q3 = qd.shape
        part = self.part
        out = np.zeros((part.ndev, nq, part.nelem_max, Q3), qd.dtype)
        for s in range(part.ndev):
            gids = part.elem_gid[s]
            valid = gids >= 0
            out[s][:, valid] = qd[:, gids[valid]]
        return out

    # -- host-side converters ------------------------------------------
    def _shard(self, arr: np.ndarray) -> jnp.ndarray:
        """Host (ndev, ...) array -> device array sharded on its leading
        axis, each shard copied straight to its own device (never first
        materialised whole on device 0)."""
        return jax.device_put(np.asarray(arr),
                              NamedSharding(self.mesh, P(AXIS)))

    def to_owned(self, u_global: np.ndarray) -> jnp.ndarray:
        return self._shard(
            scatter_global_to_owned(self.part, np.asarray(u_global)))

    def to_global(self, owned) -> np.ndarray:
        return gather_owned_to_global(self.part, np.asarray(owned))

    # ------------------------------------------------------------------
    def refresh_amg(self, u_owned, load: float):
        """FormJacobian analog (misc.c:151-183), SPMD edition: the stash and
        the p=1 element matrices are computed ON DEVICE in a sharded step;
        only the small (nelem, 24, 24) element-matrix blocks come to the
        host, where the fixed-pattern CSR is assembled and the native AMG
        hierarchy refreshed (the coarse matrix is replicated, like the
        reference's effectively-global GAMG coarse solve)."""
        from ..ops.assembly import CSRAssembler
        from ..solve.amg import AMGPreconditioner

        prob = self.problem
        space0 = prob.spaces[0]
        if self._amg is None:
            self._assembler0 = CSRAssembler(
                space0.conn, space0.num_nodes,
                np.asarray(prob._level_mask(space0)),
            )
            self._amg = AMGPreconditioner(self.dtype)
        bc = self.to_owned(prob.bcs.values(
            prob._coords, load).T.astype(np.asarray(u_owned).dtype))
        em_sh = np.asarray(self._emats(u_owned, bc, self.F_sh * load,
                                       self.mask_sh, self.qdata_sh,
                                       self.qdata_p_sh, self.sa))
        nd = em_sh.shape[-1]
        gids = self.part.elem_gid.reshape(-1)
        valid = gids >= 0
        em = np.empty((int(valid.sum()), nd, nd), em_sh.dtype)
        em[gids[valid]] = em_sh.reshape(-1, nd, nd)[valid]  # global order
        self._amg.setup(self._assembler0.assemble(em))
        return self._amg.data

    # ------------------------------------------------------------------
    def _build_step(self):
        sa = self.sa
        prob = self.problem
        model = self.model
        phys = self.phys
        cfg = prob.config
        ksp_rtol = cfg.ksp_rtol or 1e-10
        ksp_max_it = min(cfg.ksp_max_it, 10_000)
        fine_basis = prob.factory.fine.basis
        use_mg = self.use_mg
        composite = self.composite
        Q3f = fine_basis.Q3

        # Per-level single-GEMM gradient operators in PLAIN LATTICE column
        # order (the shard-local conn is lattice-ordered): the same
        # structured hot path as the serial pipeline (ops/structured.py),
        # run per shard like the reference's per-rank CeedOperators
        # (src/matops.c:26-60). Device arrays travel as step args.
        if use_mg:
            levels_static = self.levels
            nlev = len(levels_static)
            bases = [l.basis for l in levels_static]
        else:
            nlev = 1
            bases = [fine_basis]
        self._sgrads = tuple(
            grad_gemm_matrices(b, np.arange(b.P3), self.dtype) for b in bases
        )
        if composite:
            pbases = [prob.pfactory.levels[l].basis for l in
                      (range(nlev) if use_mg else [len(prob.spaces) - 1])]
            Q3p_ = pbases[-1].Q3                   # = (1 + qextra)^3
            self.sgrads_p = tuple(
                grad_gemm_matrices(b, np.arange(b.P3), self.dtype)
                for b in pbases
            )
        else:
            self.sgrads_p = None

        def split_rows(owned, sa_, body):
            """Halo-overlapped rows pipeline (ApplyLocalCeedOp analog,
            matops.c:26-60): the ghost all_to_all is issued first, the
            INTERIOR element batch ([0, n_elem_int) — owned-only
            connectivity on every shard, partition.partition_space) computes
            from the owned block while the exchange is in flight, and the
            boundary batch runs after g2l_finish. body(rows, esl) ->
            (ve_rows, aux); aux (the gradu stash) is re-concatenated in
            element order."""
            k = sa_.n_elem_int
            ow, recv = dist.g2l_start(owned, sa_)
            conn = dist._blk(sa_.conn_local)
            veA, auxA = body(dist.node_rows(ow, conn[:k]), slice(0, k))
            local = dist.g2l_finish(ow, recv, sa_)
            veB, auxB = body(dist.node_rows(local, conn[k:]),
                             slice(k, None))
            accB = jax.ops.segment_sum(
                veB.reshape(-1, 3), conn[k:].reshape(-1),
                num_segments=sa_.n_local).T
            out = dist.l2g_add(accB, sa_)
            accA = jax.ops.segment_sum(
                veA.reshape(-1, 3), conn[:k].reshape(-1),
                num_segments=sa_.n_owned_max).T
            out = out + accA[None]
            aux = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b], axis=0), auxA, auxB)
            return out, aux

        def residual_body(qd, qdp, sk, skp):
            """Single-GEMM residual rows kernel (+ composite pressure term,
            which shares the gathered rows)."""
            Kg, KgT = sk

            def body(rows, esl):
                due = rows @ Kg
                du = Mat3([due[:, i * Q3f:(i + 1) * Q3f] for i in range(9)])
                dv, stash = model.residual_planes(du, qd[:, esl], phys)
                ve = jnp.concatenate(dv.m, axis=1) @ KgT
                if composite:
                    Kgp, KgTp = skp
                    duep = rows @ Kgp
                    dup = Mat3([duep[:, i * Q3p_:(i + 1) * Q3p_]
                                for i in range(9)])
                    dvp, stash_p = model.pressure_residual_planes(
                        dup, qdp[:, esl], phys)
                    ve = ve + jnp.concatenate(dvp.m, axis=1) @ KgTp
                    return ve, (stash, stash_p)
                return ve, stash

            return body

        def jacobian_body(qd, qdp, stash, sk, skp):
            Kg, KgT = sk

            def body(rows, esl):
                st = jax.tree_util.tree_map(
                    lambda x: x[esl], stash[0] if composite else stash)
                due = rows @ Kg
                ddu = Mat3([due[:, i * Q3f:(i + 1) * Q3f] for i in range(9)])
                ddv = model.jacobian_planes(ddu, qd[:, esl], st, phys)
                ve = jnp.concatenate(ddv.m, axis=1) @ KgT
                if composite:
                    Kgp, KgTp = skp
                    stp = jax.tree_util.tree_map(lambda x: x[esl], stash[1])
                    duep = rows @ Kgp
                    ddup = Mat3([duep[:, i * Q3p_:(i + 1) * Q3p_]
                                 for i in range(9)])
                    ddvp = model.pressure_jacobian_planes(
                        ddup, qdp[:, esl], stp, phys)
                    ve = ve + jnp.concatenate(ddvp.m, axis=1) @ KgTp
                return ve, None

            return body

        # --- slab-spectral fine pipeline (box meshes, parallel/slab.py) --
        slab = self.slab
        if slab is not None:
            ssp, ssp_p = slab.sp, slab.sp_p
            sNP, sNyNx = slab.NP, slab.NyNx

            s_ndev = self.ndev

            def slab_unpack(slabd, smats2):
                qdl = slabd["qd"][0]
                qdpl = slabd["qdp"][0] if composite else None
                isf = slabd["isf"][0, 0]
                toff = slabd["toff"][0, 0]
                smats, smats_p = smats2
                return qdl, qdpl, isf, toff, smats, smats_p

            # slab halo: the slab interface is ONE node plane, so the
            # general all_to_all ghost machinery is replaced by a neighbor
            # ppermute of that plane (slab_mod.halo_fwd/halo_adj); ndev == 1
            # is a statically comm-free specialization.
            def slab_residual(u_in, sa_, slabd, smats2):
                qdl, qdpl, isf, toff, smats, smats_p = slab_unpack(
                    slabd, smats2)
                ll = slab_mod.halo_fwd(dist._blk(u_in), isf, toff, s_ndev,
                                       dist.AXIS, sNP, sNyNx)
                du = ssp.grad(ll, smats)
                dv, stash = model.residual_planes(du, qdl, phys)
                v = ssp.grad_T(dv, smats)
                if composite:
                    dup = ssp_p.grad(ll, smats_p)
                    dvp, stash_p = model.pressure_residual_planes(
                        dup, qdpl, phys)
                    v = v + ssp_p.grad_T(dvp, smats_p)
                    stash = (stash, stash_p)
                out = slab_mod.halo_adj(v, isf, toff, s_ndev, dist.AXIS,
                                        sNP, sNyNx, sa_.n_owned_max)
                return out[None], stash

            def slab_jacobian(v_in, sa_, stash, slabd, smats2):
                qdl, qdpl, isf, toff, smats, smats_p = slab_unpack(
                    slabd, smats2)
                ll = slab_mod.halo_fwd(dist._blk(v_in), isf, toff, s_ndev,
                                       dist.AXIS, sNP, sNyNx)
                ddu = ssp.grad(ll, smats)
                st = stash[0] if composite else stash
                ddv = model.jacobian_planes(ddu, qdl, st, phys)
                w = ssp.grad_T(ddv, smats)
                if composite:
                    ddup = ssp_p.grad(ll, smats_p)
                    ddvp = model.pressure_jacobian_planes(
                        ddup, qdpl, stash[1], phys)
                    w = w + ssp_p.grad_T(ddvp, smats_p)
                out = slab_mod.halo_adj(w, isf, toff, s_ndev, dist.AXIS,
                                        sNP, sNyNx, sa_.n_owned_max)
                return out[None]

        def stash_to_elem(stash):
            """Native (slab: global-quad planes) stash -> element-major
            Mat3 planes for the row-path level applies / diagonals /
            element matrices (layout converters of ops/spectral.py)."""
            if slab is None or stash is None:
                return stash
            if composite:
                mu, p_ = stash
                return (
                    jax.tree_util.tree_map(ssp.plane_to_elem, mu),
                    jax.tree_util.tree_map(ssp_p.plane_to_elem, p_),
                )
            return jax.tree_util.tree_map(ssp.plane_to_elem, stash)

        def elem_diagonal(qdata, stash, basis, jac_qf):
            return element_diagonal(jac_qf, phys, basis, qdata, stash,
                                    self.dtype)

        # --- shared in-shard building blocks -----------------------------
        def full_residual(u, bc_vals, F, mask, qd, qdp, sa_, sgrads, sgrads_p,
                          slabd, smats2):
            # full-f32 matmul precision: the residual sets the Newton
            # convergence floor (utils/precise.accurate_matmuls)
            with accurate_matmuls():
                u_in = jnp.where(mask, bc_vals, u)
                if slab is not None:
                    r, stash = slab_residual(u_in, sa_, slabd, smats2)
                else:
                    body = residual_body(qd, qdp, sgrads[-1],
                                         sgrads_p[-1] if composite else None)
                    r, stash = split_rows(u_in, sa_, body)
                return jnp.where(mask, 0.0, r - F), stash

        def fine_jac_apply(v, stash, mask, qd, qdp, sa_, sgrads, sgrads_p,
                           slabd, smats2):
            # outer Krylov matvec: full-f32 precision (the CG attainable
            # residual stalls at matvec-noise x cond with reduced-precision
            # GEMMs); smoother-level applies stay at the fast default
            with accurate_matmuls():
                v_in = jnp.where(mask, 0.0, v)
                if slab is not None:
                    jv = slab_jacobian(v_in, sa_, stash, slabd, smats2)
                else:
                    body = jacobian_body(qd, qdp, stash, sgrads[-1],
                                         sgrads_p[-1] if composite else None)
                    jv, _ = split_rows(v_in, sa_, body)
                return jnp.where(mask, 0.0, jv)

        def make_level_applies(stash_e, qd, qdp, lvls, sgrads, sgrads_p,
                               stash_native=None, slabd=None, smats2=None):
            def make_lvl_apply(l):
                if slab is not None and l == nlev - 1:
                    def A(v, lv=lvls[l]):
                        v_in = jnp.where(dist._blk(lv["mask"]), 0.0,
                                         dist._blk(v))[None]
                        jv = slab_jacobian(v_in, lv["sa"], stash_native,
                                           slabd, smats2)
                        return jnp.where(lv["mask"], 0.0, jv)

                    return A
                body = jacobian_body(qd, qdp, stash_e, sgrads[l],
                                     sgrads_p[l] if composite else None)

                def A(v, lv=lvls[l]):
                    v_in = jnp.where(dist._blk(lv["mask"]), 0.0,
                                     dist._blk(v))[None]
                    jv, _ = split_rows(v_in, lv["sa"], body)
                    return jnp.where(lv["mask"], 0.0, jv)

                return A

            return [make_lvl_apply(l) for l in range(nlev)]

        def level_diag(l, stash, qd, qdp, lv):
            basis = bases[l]
            if composite:
                diag_e = elem_diagonal(qd, stash[0], basis, model.jacobian_qf)
                diag_e = diag_e + elem_diagonal(
                    qdp, stash[1], pbases[l], model.pressure_jacobian_qf)
            else:
                diag_e = elem_diagonal(qd, stash, basis, model.jacobian_qf)
            dacc = dist.scatter_elements(diag_e, lv["sa"])
            diag = dist.l2g_add(dacc, lv["sa"])
            diag = jnp.where(lv["mask"], 1.0, diag)
            diag = jnp.where(diag == 0.0, 1.0, diag)
            return diag

        # --- preconditioner setup: separate sharded computation ----------
        # (per-Jacobian cadence; cached across Newton steps for linear
        # models by the host loop — mirrors problem.py _pc_setup)
        def pc_body(u, bc_vals, F, mask, qdata, qdata_p, sa_, lvls,
                    sgrads, sgrads_p, slabd, smats2):
            qd = qdata[0]
            qdp = qdata_p[0] if composite else None
            _, stash = full_residual(u, bc_vals, F, mask, qd, qdp, sa_,
                                     sgrads, sgrads_p, slabd, smats2)
            stash_e = stash_to_elem(stash)
            if not use_mg:
                lv = {"sa": sa_, "mask": mask}
                diag = level_diag(0, stash_e, qd, qdp, lv)
                return (1.0 / diag,)
            lvl_apply = make_level_applies(stash_e, qd, qdp, lvls,
                                           sgrads, sgrads_p,
                                           stash_native=stash,
                                           slabd=slabd, smats2=smats2)
            dinvs, bounds = [], []
            for l in range(nlev):
                lv = lvls[l]
                diag = level_diag(l, stash_e, qd, qdp, lv)
                dinv = 1.0 / diag
                dinvs.append(dinv)
                valid = (~dist._blk(lv["mask"]))[None] & \
                    dist._blk(lv["sa"].owned_valid)[None, None, :]
                lo, hi = dmg.estimate_eigs_dist(
                    lvl_apply[l], dinv, diag.shape, diag.dtype, valid=valid,
                )
                bounds.append((lo, hi))
            return tuple(dinvs), tuple(bounds)

        # --- the Newton step ---------------------------------------------
        def body(u, bc_vals, F, mask, qdata, qdata_p, sa_, lvls, amg_data,
                 sgrads, sgrads_p, pc, slabd, smats2):
            qd = qdata[0]
            qdp = qdata_p[0] if composite else None
            msk = mask

            def residual(uo):
                return full_residual(uo, bc_vals, F, msk, qd, qdp, sa_,
                                     sgrads, sgrads_p, slabd, smats2)

            G, stash = residual(u)

            def jac_apply(v):
                return fine_jac_apply(v, stash, msk, qd, qdp, sa_,
                                      sgrads, sgrads_p, slabd, smats2)

            if not use_mg:
                (dinv,) = pc
                M = lambda r: dinv * r            # noqa: E731
            else:
                dinvs, bounds = pc
                lvl_apply = make_level_applies(
                    stash_to_elem(stash), qd, qdp, lvls, sgrads, sgrads_p,
                    stash_native=stash, slabd=slabd, smats2=smats2)

                def prolong_l(l, uc):
                    c2f = levels_static[l].c2f
                    local_c = dist.g2l(uc, lvls[l - 1]["sa"])
                    ue = dist.gather_elements(local_c, lvls[l - 1]["sa"])
                    fe = c2f.apply_interp(ue)
                    acc = dist.scatter_elements(fe, lvls[l]["sa"])
                    out = dist.l2g_add(acc, lvls[l]["sa"]) * lvls[l]["inv_mult"]
                    return jnp.where(lvls[l]["mask"], 0.0, out)

                def restrict_l(l, uf):
                    c2f = levels_static[l].c2f
                    local_f = dist.g2l(uf * lvls[l]["inv_mult"], lvls[l]["sa"])
                    fe = dist.gather_elements(local_f, lvls[l]["sa"])
                    ce = c2f.apply_interp_T(fe)
                    acc = dist.scatter_elements(ce, lvls[l - 1]["sa"])
                    out = dist.l2g_add(acc, lvls[l - 1]["sa"])
                    return jnp.where(lvls[l - 1]["mask"], 0.0, out)

                def coarse_solve(b0):
                    if amg_data is None:
                        return chebyshev(
                            lvl_apply[0], b0, dinvs[0],
                            bounds[0][0], bounds[0][1], 30,
                        )
                    g = dmg.owned_to_replicated_global(
                        b0, lvls[0]["owned_gid"],
                        levels_static[0].num_nodes,
                    )
                    xf = self._amg.apply(g.T.reshape(-1), amg_data)
                    xg = xf.reshape(-1, 3).T
                    out = dmg.replicated_global_to_owned(
                        xg, lvls[0]["owned_gid"]
                    )
                    return jnp.where(lvls[0]["mask"], 0.0, out)

                def vcycle(bf):
                    bs = [None] * nlev
                    xs = [None] * nlev
                    bs[-1] = bf
                    for l in range(nlev - 1, 0, -1):
                        xs[l] = chebyshev(
                            lvl_apply[l], bs[l], dinvs[l],
                            bounds[l][0], bounds[l][1], cfg.smooth_its,
                        )
                        r = bs[l] - lvl_apply[l](xs[l])
                        bs[l - 1] = restrict_l(l, r)
                    xs[0] = coarse_solve(bs[0])
                    for l in range(1, nlev):
                        x = xs[l] + prolong_l(l, xs[l - 1])
                        r = bs[l] - lvl_apply[l](x)
                        dx = chebyshev(
                            lvl_apply[l], r, dinvs[l],
                            bounds[l][0], bounds[l][1], cfg.smooth_its,
                        )
                        xs[l] = x + dx
                    return xs[-1]

                M = vcycle

            # --- PCG (natural norm, distributed dots) ------------------
            b = -G
            x = jnp.zeros_like(b)
            r = b
            z = M(r)
            rz = dist.ddot(r, z)
            tol = jnp.sqrt(jnp.abs(rz)) * ksp_rtol

            def cond(s):
                x, r, z, p, rz, it, ok, anchor, since = s
                # windowed stagnation guard (mirrors solve/cg.py): an f32
                # solve whose tolerance sits below the attainable floor
                # must not spin to ksp_max_it inside one device program
                return (ok & (jnp.sqrt(jnp.abs(rz)) > tol)
                        & (it < ksp_max_it) & (since < 60))

            def bodyf(s):
                x, r, z, p, rz, it, ok, anchor, since = s
                Ap = jac_apply(p)
                pAp = dist.ddot(p, Ap)
                good = pAp > 0        # KSP_DIVERGED_INDEFINITE_MAT analog
                alpha = jnp.where(good, rz / pAp, 0.0)
                x = x + alpha * p
                r = r - alpha * Ap
                z = M(r)
                rz2 = dist.ddot(r, z)
                p = z + (rz2 / rz) * p
                rn = jnp.sqrt(jnp.abs(rz2))
                improved = rn < 0.95 * anchor
                anchor = jnp.where(improved, rn, anchor)
                since = jnp.where(improved, 0, since + 1)
                return (x, r, z, p, rz2, it + 1, good, anchor, since)

            z0 = z
            x, r, z, p, rz, iters, _ok, _b, _s = jax.lax.while_loop(
                cond, bodyf,
                (x, r, z, z, rz, jnp.int32(0), jnp.bool_(True),
                 jnp.sqrt(jnp.abs(rz)), jnp.int32(0))
            )
            # first-iteration indefinite bail -> preconditioned
            # steepest-descent fallback (see solve/cg.py)
            d = jnp.where((iters == 0) & ~_ok, z0, x)

            # --- critical-point line search (1 secant step) ------------
            g0 = dist.ddot(G, d)
            G1, _ = residual(u + d)
            g1 = dist.ddot(G1, d)
            lam_raw = g0 / (g0 - g1)
            ok = jnp.isfinite(lam_raw) & (lam_raw > 1e-8) & (lam_raw < 1e2)
            lam = jnp.where(ok, lam_raw, 1.0)

            # Domain-error backtracking (same policy as solve/newton.py):
            # halve lam until the residual is finite (hyperFS needs J > 0)
            G_new, _ = residual(u + lam * d)
            rnorm0_new = dist.dnorm(G_new)

            def bt_cond(s):
                lam_, rn_, tries = s
                return (~jnp.isfinite(rn_)) & (tries < 8)

            def bt_body(s):
                lam_, rn_, tries = s
                lam2 = lam_ * 0.5
                Gt, _ = residual(u + lam2 * d)
                return (lam2, dist.dnorm(Gt), tries + 1)

            lam, rnorm, _ = jax.lax.while_loop(
                bt_cond, bt_body, (lam, rnorm0_new, jnp.int32(0))
            )
            u_new = u + lam * d
            rnorm_in = dist.dnorm(G)
            step_norm = jnp.abs(lam) * dist.dnorm(d)
            unorm = dist.dnorm(u_new)
            return u_new, rnorm_in, rnorm, iters, step_norm, unorm

        spec = P(AXIS)
        lvls_spec = spec if self.use_mg else None
        qdp_spec = spec if composite else None
        sgp_spec = P() if composite else None
        pc_spec = (spec,) if not use_mg else (
            tuple(spec for _ in range(nlev)),
            tuple((P(), P()) for _ in range(nlev)),
        )
        in_specs = (spec, spec, spec, spec, spec, qdp_spec, spec, lvls_spec,
                    P(), P(), sgp_spec)
        # slab-spectral device data: qdata planes + first-shard flag travel
        # sharded; the banded GEMM matrices are replicated
        if slab is not None:
            self._slabd = {"qd": slab.qd_planes, "isf": slab.is_first,
                           "toff": slab.toff}
            if composite:
                self._slabd["qdp"] = slab.qdp_planes
            self._smats2 = (slab.sp.matrices(),
                            slab.sp_p.matrices() if composite else ())
        else:
            self._slabd = {}
            self._smats2 = ((), ())
        slab_specs = (spec, P())

        def _accurate(fn):
            """Trace the whole SPMD computation at full-f32 matmul
            precision: PCG needs SYMMETRIC A and M, and reduced-precision
            GEMM noise breaks the symmetry of every operator apply inside
            the V-cycle (see utils/precise.accurate_matmuls)."""
            def wrapped(*args):
                with accurate_matmuls():
                    return fn(*args)
            return wrapped

        self._pc_sm = jax.jit(
            jax.shard_map(
                _accurate(pc_body),
                mesh=self.mesh,
                in_specs=in_specs[:8] + (P(), sgp_spec) + slab_specs,
                out_specs=pc_spec,
            )
        )
        self._step = jax.jit(
            jax.shard_map(
                _accurate(body),
                mesh=self.mesh,
                in_specs=in_specs + (pc_spec,) + slab_specs,
                out_specs=(spec, P(), P(), P(), P(), P()),
            )
        )

        # --- standalone sharded residual apply (benchmark surface) -------
        def resid_only_body(u, bc_vals, F, mask, qdata, qdata_p, sa_, sk,
                            skp, slabd, smats2):
            r, _ = full_residual(u, bc_vals, F, mask, qdata[0],
                                 qdata_p[0] if composite else None,
                                 sa_, (sk,), (skp,), slabd, smats2)
            return r

        self._resid_sm = jax.jit(
            jax.shard_map(
                _accurate(resid_only_body),
                mesh=self.mesh,
                in_specs=(spec, spec, spec, spec, spec, qdp_spec, spec,
                          P(), sgp_spec) + slab_specs,
                out_specs=spec,
            )
        )

        # --- sharded p=1 element-matrix step (AMG numeric refresh) -------
        if use_mg:
            from ..ops.assembly import make_element_matrices

            em_mu = make_element_matrices(
                model.jacobian_qf, phys, bases[0], self.dtype)
            em_p = make_element_matrices(
                model.pressure_jacobian_qf, phys, pbases[0], self.dtype
            ) if composite else None

            def emats_body(u, bc_vals, F, mask, qdata, qdata_p, sa_, sk, skp,
                           slabd, smats2):
                _, stash = full_residual(u, bc_vals, F, mask, qdata[0],
                                         qdata_p[0] if composite else None,
                                         sa_, (sk,), (skp,), slabd, smats2)
                stash = stash_to_elem(stash)
                if composite:
                    em = em_mu(qdata[0], stash[0])
                    em = em + em_p(qdata_p[0], stash[1])
                else:
                    em = em_mu(qdata[0], stash)
                return em[None]

            emats_sm = jax.jit(
                jax.shard_map(
                    _accurate(emats_body),
                    mesh=self.mesh,
                    in_specs=(spec, spec, spec, spec, spec, qdp_spec, spec,
                              P(), sgp_spec) + slab_specs,
                    out_specs=spec,
                )
            )
            # the stash is computed with the FINE-level gradient pipeline
            # (qdata lives at the fine quadrature); only the element-matrix
            # contraction uses the p=1 basis
            self._emats = lambda *a: emats_sm(
                *a, self._sgrads[-1],
                self.sgrads_p[-1] if composite else None,
                self._slabd, self._smats2)

    # ------------------------------------------------------------------
    def residual_apply(self, u_owned, load_increment: float = 1.0):
        """BC-inserted nonlinear residual as ONE sharded computation — the
        per-shard analog of the serial fine apply, for benchmarking the
        distributed hot path against serial throughput at equal
        elements/shard (reference: identical per-rank CeedOperators,
        src/matops.c:26-60)."""
        prob = self.problem
        bc = self.to_owned(prob.bcs.values(
            prob._coords, load_increment
        ).T.astype(np.asarray(u_owned).dtype))
        F = self.F_sh * load_increment
        return self._resid_sm(
            u_owned, bc, F, self.mask_sh, self.qdata_sh, self.qdata_p_sh,
            self.sa, self._sgrads[-1],
            self.sgrads_p[-1] if self.composite else None,
            self._slabd, self._smats2)

    def pc_setup(self, u_owned, load_increment: float):
        """Sharded preconditioner refresh (diagonals + Chebyshev bounds) —
        run once per Jacobian like the serial _pc_setup."""
        prob = self.problem
        bc = self.to_owned(prob.bcs.values(
            prob._coords, load_increment
        ).T.astype(np.asarray(u_owned).dtype))
        F = self.F_sh * load_increment
        lvls = self.level_arrays if self.use_mg else None
        return self._pc_sm(u_owned, bc, F, self.mask_sh, self.qdata_sh,
                           self.qdata_p_sh, self.sa, lvls,
                           self._sgrads, self.sgrads_p,
                           self._slabd, self._smats2)

    def newton_step(self, u_owned, load_increment: float, amg_data=None,
                    pc=None):
        prob = self.problem
        if pc is None:
            pc = self.pc_setup(u_owned, load_increment)
        bc = self.to_owned(prob.bcs.values(
            prob._coords, load_increment
        ).T.astype(np.asarray(u_owned).dtype))
        F = self.F_sh * load_increment
        lvls = self.level_arrays if self.use_mg else None
        return self._step(u_owned, bc, F, self.mask_sh, self.qdata_sh,
                          self.qdata_p_sh, self.sa, lvls, amg_data,
                          self._sgrads, self.sgrads_p, pc,
                          self._slabd, self._smats2)

    def solve(self, num_increments=None, max_newton=50, rtol=1e-8):
        """Full load-continuation solve; returns (u_global, info dict).
        Convergence policy shared with the serial driver
        (solve/newton.py NewtonPolicy)."""
        cfg = self.problem.config
        n_inc = num_increments or cfg.num_increments
        u = self.to_owned(np.zeros((3, self.problem.fine_space.num_nodes)))
        total_ksp = 0
        total_newton = 0
        rnorm = None
        amg_data = None
        pc = None
        converged = True
        reason = ""
        floor_atol = 0.0
        opts = NewtonOptions(rtol=rtol, max_it=max_newton)
        for inc in range(1, n_inc + 1):
            load = inc / n_inc
            policy = None
            converged, reason = False, "max_it"
            pc_lag = max(getattr(cfg, "pc_lag", 1), 1)
            for k in range(max_newton):
                nonlinear = self.model.nonlinear
                refresh = nonlinear and (k % pc_lag == 0)
                if self.use_mg and (refresh or amg_data is None):
                    # FormJacobian analog: refresh the replicated AMG coarse
                    # hierarchy from the on-device stash; linear problems
                    # assemble exactly once (problem.py does the same).
                    try:
                        amg_data = self.refresh_amg(u, load)
                    except FloatingPointError:
                        # BC jump pushed the state outside the constitutive
                        # domain (NaN stash): report divergence like the
                        # serial loop (solve/newton.py entry guard)
                        converged, reason = False, "diverged"
                        rnorm = float("nan")
                        break
                if refresh or pc is None:
                    pc = self.pc_setup(u, load)
                u, rnorm_in, rnorm, iters, step_norm, unorm = \
                    self.newton_step(u, load, amg_data=amg_data, pc=pc)
                total_ksp += int(iters)
                total_newton += 1
                if policy is None:
                    policy = NewtonPolicy(opts, max(float(rnorm_in), 1e-300),
                                          floor_atol=floor_atol)
                verdict = policy.check(float(rnorm), step=float(step_norm),
                                       unorm=float(unorm))
                if verdict is not None:
                    converged, reason = verdict
                    break
            else:
                if policy is not None:
                    converged, reason = policy.finalize(float(rnorm))
            if converged:
                floor_atol = max(floor_atol, float(rnorm))
            if not converged and reason == "diverged":
                break  # elasticity.c:668-672
        u_np = self.to_global(u)                       # (3, num_nodes)
        bc_vals = self.problem.bcs.values(self.problem._coords, 1.0).T
        mask = np.asarray(self.problem.bc_mask)
        u_np = np.where(mask, bc_vals, u_np)
        return u_np, {
            "newton_iters": total_newton,
            "ksp_iters": total_ksp,
            "rnorm": float(rnorm),
            "converged": converged,
            "reason": reason,
        }

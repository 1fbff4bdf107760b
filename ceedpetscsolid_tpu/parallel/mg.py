"""Distributed p-multigrid machinery for the SPMD Newton step.

Per multigrid level this builds the same static partition data as the fine
level (same element blocks, per-level node ownership + halo maps), plus the
prolongation/restriction pipelines and BC masks, so the full
p-MG-preconditioned CG runs inside one shard_map computation — every
operator application, transfer, and smoother crossing the device mesh
exactly like the reference's per-apply MPI halo exchanges
(reference src/matops.c:33/57, 115-203).

The AMG coarse solve operates on the (small) assembled p=1 system
REPLICATED across shards: the coarse residual is all_gathered to the global
node ordering, one V-cycle runs identically on every shard, and each shard
keeps its owned slice — the analog of PETSc's (also effectively global)
coarse GAMG solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.basis import Basis3D
from . import dist
from .dist import AXIS, ShardArrays
from ..solve.cg import lanczos_extreme_eigs
from .partition import partition_space, scatter_global_to_owned


@dataclass
class DistLevel:
    """Static per-level distributed data (device arrays, ndev-leading)."""

    sa: ShardArrays
    mask: jnp.ndarray            # (ndev, 3, n_owned_max) bool
    basis: Basis3D               # P_level -> Q_fine
    c2f: Basis3D | None          # GLL interp from previous (coarser) level
    inv_mult: jnp.ndarray | None  # (ndev, 3, n_owned_max) fine multiplicity^-1
    owned_gid: jnp.ndarray       # (ndev, n_owned_max) int32 global node ids
    num_nodes: int


def build_dist_levels(problem, part_fine, ndev: int) -> list[DistLevel]:
    """Build DistLevel data for every MG level of an ElasticityProblem."""
    levels = []
    prev_degree = None
    for l, space in enumerate(problem.spaces):
        part = part_fine if l == len(problem.spaces) - 1 else partition_space(
            space.conn, space.num_nodes, ndev, elem_gid=part_fine.elem_gid
        )
        sa = ShardArrays.from_partition(part)
        mask_np = np.asarray(problem._level_mask(space))      # (3, nn)
        mask = jnp.asarray(scatter_global_to_owned(part, mask_np))
        basis = problem.factory.levels[l].basis
        c2f = None
        if prev_degree is not None:
            c2f = Basis3D.create(prev_degree + 1, space.degree + 1,
                                 "gauss_lobatto", problem.dtype)
        gid = np.where(part.owned_valid, part.owned_global_ids, 0)
        levels.append(DistLevel(
            sa=sa, mask=mask, basis=basis, c2f=c2f, inv_mult=None,
            owned_gid=jnp.asarray(gid.astype(np.int32)),
            num_nodes=space.num_nodes,
        ))
        prev_degree = space.degree
    return levels


# ---------------------------------------------------------------------------
# Inside-shard_map building blocks. `lvl` fields arrive as per-shard blocks
# (leading axis 1) through the shard_map in_specs.
# ---------------------------------------------------------------------------
def level_apply(v_owned, stash, qdatas, lvl, elem_jacobian):
    """BC-masked distributed Jacobian action at one level."""
    v = jnp.where(dist._blk(lvl.mask), 0.0, dist._blk(v_owned))[None]
    local = dist.g2l(v, lvl.sa)
    ue = dist.gather_elements(local, lvl.sa)
    ve = elem_jacobian(ue, qdatas, stash, lvl.basis)
    acc = dist.scatter_elements(ve, lvl.sa)
    jv = dist.l2g_add(acc, lvl.sa)
    return jnp.where(lvl.mask, 0.0, jv)


def compute_inv_mult(lvl):
    ones = jnp.ones(
        (3, lvl.sa.conn_local.shape[1], lvl.sa.conn_local.shape[2]),
        jnp.float32,
    )
    acc = dist.scatter_elements(ones, lvl.sa)
    mult = dist.l2g_add(acc, lvl.sa)
    return 1.0 / jnp.where(mult == 0, 1.0, mult)


def prolong(uc_owned, lvl_c, lvl_f, inv_mult_f):
    """coarse owned -> fine owned (matops.c:115-157, distributed)."""
    local_c = dist.g2l(uc_owned, lvl_c.sa)
    ue = dist.gather_elements(local_c, lvl_c.sa)
    fe = lvl_f.c2f.apply_interp(ue)
    acc = dist.scatter_elements(fe, lvl_f.sa)
    out = dist.l2g_add(acc, lvl_f.sa)
    return out * inv_mult_f


def restrict(uf_owned, lvl_c, lvl_f, inv_mult_f):
    """fine owned -> coarse owned (matops.c:160-203, distributed)."""
    local_f = dist.g2l(uf_owned * inv_mult_f, lvl_f.sa)
    fe = dist.gather_elements(local_f, lvl_f.sa)
    ce = lvl_f.c2f.apply_interp_T(fe)
    acc = dist.scatter_elements(ce, lvl_c.sa)
    return dist.l2g_add(acc, lvl_c.sa)


def owned_to_replicated_global(owned, owned_gid, num_nodes):
    """(1, 3, n_owned) -> replicated (3, num_nodes) via all_gather+scatter."""
    gathered = jax.lax.all_gather(dist._blk(owned), AXIS)      # (ndev,3,no)
    gids = jax.lax.all_gather(dist._blk(owned_gid), AXIS)      # (ndev,no)
    flat = jnp.moveaxis(gathered, 1, 0).reshape(3, -1)         # (3, ndev*no)
    ids = gids.reshape(-1)
    return jax.vmap(
        lambda d: jax.ops.segment_sum(d, ids, num_segments=num_nodes)
    )(flat)
    # padding slots all carry gid 0 but value 0 -> harmless


def replicated_global_to_owned(g, owned_gid):
    """replicated (3, num_nodes) -> (1, 3, n_owned) owned slice."""
    return jnp.take(g, dist._blk(owned_gid), axis=1)[None]


def estimate_eigs_dist(A, dinv, shape, dtype, valid=None, iters=10):
    """Distributed CG-Lanczos extreme-eigenvalue estimate (bounds transform
    0.1/1.1 as elasticity.c:540). `valid` masks out BC/padding slots from
    the probe vector so they do not pollute the Lanczos recurrence."""
    # deterministic 'noisy' rhs: integer hash of the flat slot index
    # (identical scheme on every shard; shard offset irrelevant for bounds)
    n = int(np.prod(shape))
    idx = jax.lax.broadcasted_iota(jnp.uint32, (n, 1), 0).reshape(shape)
    r = ((idx * jnp.uint32(2654435761) % jnp.uint32(65536)).astype(dtype)
         / 65536.0) - 0.5
    if valid is not None:
        r = jnp.where(valid, r, 0.0)
    _, lmax = lanczos_extreme_eigs(A, dinv, r, iters, dot=dist.ddot)
    return 0.1 * lmax, 1.1 * lmax

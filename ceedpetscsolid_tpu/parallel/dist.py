"""Distributed operator execution under shard_map (the PetscSF runtime).

Implements the two primitives every operator application needs
(reference src/matops.c:26-60):
  * halo gather   (DMGlobalToLocal, INSERT):  g2l
  * owner-sum     (DMLocalToGlobal, ADD):     l2g_add
as static all_to_all exchanges over the 1-D device mesh axis "mesh",
plus the distributed dot products (psum) that CG needs.

All functions here are designed to be called INSIDE a shard_map body; the
per-shard static index arrays travel as a `ShardArrays` pytree sharded on
axis 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .partition import SpacePartition
from ..utils.precise import dot2_pair

AXIS = "mesh"


@dataclass
class ShardArrays:
    """Device-array views of a SpacePartition, leading axis = ndev."""

    conn_local: Any          # (ndev, nelem_max, P3) int32
    pair_owned_slot: Any     # (ndev[owner], ndev, m) int32
    pair_valid_owner: Any    # (ndev[owner], ndev, m) bool
    pair_ghost_slot: Any     # (ndev[holder], ndev, m) int32
    pair_valid_holder: Any   # (ndev[holder], ndev, m) bool
    owned_valid: Any         # (ndev, n_owned_max) bool
    n_owned_max: int         # static
    n_local: int             # static
    n_elem_int: int          # static: leading interior elements, all shards

    @staticmethod
    def from_partition(part: SpacePartition) -> "ShardArrays":
        return ShardArrays(
            conn_local=jnp.asarray(part.conn_local),
            pair_owned_slot=jnp.asarray(part.pair_owned_slot),
            pair_valid_owner=jnp.asarray(part.pair_valid_owner),
            pair_ghost_slot=jnp.asarray(part.pair_ghost_slot),
            pair_valid_holder=jnp.asarray(part.pair_valid_holder),
            owned_valid=jnp.asarray(part.owned_valid),
            n_owned_max=part.n_owned_max,
            n_local=part.n_local,
            n_elem_int=part.n_elem_int,
        )


jax.tree_util.register_pytree_node(
    ShardArrays,
    lambda s: (
        (s.conn_local, s.pair_owned_slot, s.pair_valid_owner,
         s.pair_ghost_slot, s.pair_valid_holder, s.owned_valid),
        (s.n_owned_max, s.n_local, s.n_elem_int),
    ),
    lambda aux, ch: ShardArrays(*ch, n_owned_max=aux[0], n_local=aux[1],
                                n_elem_int=aux[2]),
)


# ---------------------------------------------------------------------------
# Inside-shard_map primitives. Per-shard blocks carry a leading axis of 1.
# ---------------------------------------------------------------------------
def _blk(x):
    """Strip the per-shard leading axis."""
    return x[0]


def g2l_start(owned, sa: ShardArrays):
    """Issue the ghost-value all_to_all; returns (owned block, in-flight
    recv). Compute that only needs owned values (interior elements) can be
    scheduled between start and finish — XLA's async collectives then hide
    the exchange behind it (halo/compute overlap, SURVEY §5)."""
    ow = _blk(owned)                                            # (c, n_owned)
    send = jnp.take(ow, _blk(sa.pair_owned_slot), axis=1)       # (c, ndev, m)
    send = send * _blk(sa.pair_valid_owner)[None]
    recv = jax.lax.all_to_all(send, AXIS, split_axis=1, concat_axis=1,
                              tiled=True)
    return ow, recv


def g2l_finish(ow, recv, sa: ShardArrays):
    """Assemble the (c, n_local) local vector from owned block + received
    ghost values (pad slots land in trash)."""
    c = ow.shape[0]
    local = jnp.zeros((c, sa.n_local), ow.dtype)
    local = local.at[:, : sa.n_owned_max].set(ow)
    gslots = _blk(sa.pair_ghost_slot).reshape(-1)               # pads -> trash
    local = local.at[:, gslots].set(recv.reshape(c, -1))
    return local


def g2l(owned, sa: ShardArrays):
    """(1, c, n_owned_max) -> (c, n_local): fill owned + exchange ghosts.

    Component-major: the node axis is minor-most."""
    ow, recv = g2l_start(owned, sa)
    return g2l_finish(ow, recv, sa)


def l2g_add(local, sa: ShardArrays):
    """(c, n_local) -> (1, c, n_owned_max): keep owned part + owner-sum ghosts."""
    c = local.shape[0]
    send = jnp.take(local, _blk(sa.pair_ghost_slot), axis=1)    # (c, ndev, m)
    send = send * _blk(sa.pair_valid_holder)[None]
    recv = jax.lax.all_to_all(send, AXIS, split_axis=1, concat_axis=1,
                              tiled=True)
    oslots = _blk(sa.pair_owned_slot).reshape(-1)
    add = jax.vmap(
        lambda d: jax.ops.segment_sum(d, oslots, num_segments=sa.n_owned_max)
    )(recv.reshape(c, -1))
    out = local[:, : sa.n_owned_max] + add
    out = out * _blk(sa.owned_valid)[None]
    return out[None]


def gather_elements(local, sa: ShardArrays):
    """(c, n_local) -> (c, nelem_max, P3) E-vector."""
    return jnp.take(local, _blk(sa.conn_local), axis=1)


def scatter_elements(ve, sa: ShardArrays):
    """(c, nelem_max, P3) -> (c, n_local) scatter-add (trash collects pads)."""
    c = ve.shape[0]
    ids = _blk(sa.conn_local).reshape(-1)
    return jax.vmap(
        lambda d: jax.ops.segment_sum(d, ids, num_segments=sa.n_local)
    )(ve.reshape(c, -1))


def node_rows(src, conn_rows):
    """(c, n) values + (ne, P3) local indices -> (ne, P3*c) node-major rows
    (components contiguous per node). Generic over the source vector: the
    owned block for interior-element batches, the full local vector for
    boundary batches."""
    ne, P3 = conn_rows.shape
    rows = jnp.take(src.T, conn_rows.reshape(-1), axis=0)
    return rows.reshape(ne, P3 * src.shape[0])


def gather_node_rows(local, sa: ShardArrays):
    """(c, n_local) -> (nelem_max, P3*c) node-major rows, components
    contiguous per node, element-local columns in PLAIN LATTICE order.

    The per-shard analog of StructuredRestriction.gather_rows: feeds the
    single-GEMM gradient pipeline (ops/structured.grad_gemm_matrices with
    identity col_lattice), so the distributed step runs the same structured
    hot path as the serial one (reference runs identical CeedOperator
    kernels per rank, src/matops.c:26-60)."""
    conn = _blk(sa.conn_local)
    nelem_max, P3 = conn.shape
    rows = jnp.take(local.T, conn.reshape(-1), axis=0)
    return rows.reshape(nelem_max, P3 * local.shape[0])


def scatter_node_rows(ve, sa: ShardArrays, c: int = 3):
    """(nelem_max, P3*c) -> (c, n_local) owner-summed (adjoint of
    gather_node_rows; trash slot collects element padding)."""
    flat = ve.reshape(-1, c)
    ids = _blk(sa.conn_local).reshape(-1)
    return jax.ops.segment_sum(flat, ids, num_segments=sa.n_local).T


def apply_local_op(owned, sa: ShardArrays, element_fn):
    """Full ApplyLocalCeedOp analog (matops.c:26-60):
    G2L -> element kernel -> scatter-add -> L2G(ADD)."""
    local = g2l(owned, sa)
    ue = gather_elements(local, sa)
    ve = element_fn(ue)
    acc = scatter_elements(ve, sa)
    return l2g_add(acc, sa)


def ddot(a, b):
    """Distributed dot over owned blocks (padding is zero by invariant).

    Per-shard compensated (double-float) partial sums, psum'ed as a
    (hi, lo) pair so the cross-device reduction keeps the f64-grade
    accuracy of the local Dot2 (utils/precise.py; SURVEY hard-part 5)."""
    hi, lo = dot2_pair(a.reshape(-1), b.reshape(-1))
    return jax.lax.psum(hi, AXIS) + jax.lax.psum(lo, AXIS)


def dnorm(a):
    return jnp.sqrt(ddot(a, a))

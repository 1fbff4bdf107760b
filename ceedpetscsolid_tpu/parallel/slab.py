"""Slab-partitioned spectral (global-GEMM) pipeline for box meshes.

The serial hot path on box lattices is the sum-factorized spectral fold
(ops/spectral.py): 16 banded global GEMMs, no E-vector. This module carries
that path into the SPMD step (the reference runs identical per-rank
CeedOperators, src/matops.c:26-60): the box is partitioned into contiguous
z-slabs of elements, each shard's local node set is a contiguous plane range
of the global lattice, and the halo is exactly ONE node plane (the slab's
bottom interface, owned by the lower-id shard). The generic
partition/ShardArrays machinery (parallel/partition.py) reproduces this
structure automatically when handed slab-aligned element blocks — its ghost
list IS the interface plane in lattice order — so the existing g2l/l2g_add
all_to_all exchange moves the plane and the owner-sum, and the only new
piece is the (owned | ghost) <-> dense-local-lattice layout shuffle, which
is one concatenate + one dynamic_slice per direction.

Shapes are uniform across shards (shard_map traces one program): every
shard carries ez_max slabs (`slab_sizes` gives the remainder to shard 0, so
shard 0 — the only shard owning its bottom plane — also has the largest
owned count, making n_owned_max == NP * Ny * Nx exactly); tail slabs of
shorter shards hold zero qdata and zero lattice values and contribute
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.spectral import SpectralLattice


def slab_sizes(ez: int, ndev: int) -> list[int]:
    """Contiguous z-slab element counts; remainder slabs go to the LOWEST
    shard ids so shard 0 (which owns one extra node plane) has ez_max."""
    base, rem = divmod(ez, ndev)
    return [base + (1 if s < rem else 0) for s in range(ndev)]


@dataclass
class SlabSpectral:
    """Static slab data for the distributed spectral pipeline.

    sp / sp_p: SpectralLattice of the LOCAL slab dims (ex, ey, ez_max) for
    the displacement (and composite pressure) bases; shared by all shards.
    qd_planes / qdp_planes: (ndev, k, Qz_loc, Qy, Qx) per-shard qdata in
    global-quadrature slab layout, zero-padded tail slabs.
    is_first: (ndev, 1) int32 flag (shard 0 owns its bottom plane).
    elem_gid: (ndev, nelem_max) slab-aligned element blocks for
    partition_space (global element order is z-outer on box meshes).
    """

    sp: SpectralLattice
    sp_p: SpectralLattice | None
    qd_planes: jnp.ndarray
    qdp_planes: jnp.ndarray | None
    is_first: jnp.ndarray
    elem_gid: np.ndarray
    NyNx: int
    NP: int            # local node planes = p * ez_max + 1
    toff: jnp.ndarray | None = None  # (ndev, 1) top-plane owned offset

    @staticmethod
    def build(prob, ndev: int) -> "SlabSpectral | None":
        """None when the problem has no spectral fine path or ndev > ez."""
        spg = prob.factory.fine.spectral
        if spg is None:
            return None
        ex, ey, ez = spg.dims
        if ndev > ez:
            return None
        sizes = slab_sizes(ez, ndev)
        ez_max = sizes[0]
        per_slab = ex * ey
        nelem_max = ez_max * per_slab
        elem_gid = np.full((ndev, nelem_max), -1, dtype=np.int64)
        z0 = 0
        z0s = []
        for s, sz in enumerate(sizes):
            n = sz * per_slab
            elem_gid[s, :n] = np.arange(z0 * per_slab, (z0 + sz) * per_slab)
            z0s.append(z0)
            z0 += sz

        basis = prob.factory.fine.basis
        sp = SpectralLattice((ex, ey, ez_max), prob.fine_space.degree,
                             basis, prob.dtype)
        Q = basis.Q

        def shard_planes(qdata, spg_, Q_):
            g = np.asarray(spg_.qdata_to_global(qdata))   # (k, Qz, Qy, Qx)
            k = g.shape[0]
            out = np.zeros((ndev, k, ez_max * Q_, g.shape[2], g.shape[3]),
                           g.dtype)
            for s, (zz, sz) in enumerate(zip(z0s, sizes)):
                out[s][:, : sz * Q_] = g[:, zz * Q_: (zz + sz) * Q_]
            return jnp.asarray(out)

        qd_planes = shard_planes(prob.qdata, spg, Q)
        sp_p = None
        qdp_planes = None
        if prob.composite:
            pfine = prob.pfactory.levels[-1]
            sp_p = SpectralLattice((ex, ey, ez_max), prob.fine_space.degree,
                                   pfine.basis, prob.dtype)
            qdp_planes = shard_planes(prob.qdata_p, pfine.spectral,
                                      pfine.basis.Q)
        is_first = jnp.asarray(
            np.array([[1] + [0] * (ndev - 1)], np.int32).T)
        NyNx = sp.Ny * sp.Nx
        p = prob.fine_space.degree
        toff = np.array(
            [[(p * sz + (1 if s == 0 else 0)) * NyNx - NyNx]
             for s, sz in enumerate(sizes)], np.int32)
        return SlabSpectral(
            sp=sp, sp_p=sp_p, qd_planes=qd_planes, qdp_planes=qdp_planes,
            is_first=is_first, elem_gid=elem_gid,
            NyNx=NyNx, NP=sp.Nz, toff=jnp.asarray(toff),
        )


# ---------------------------------------------------------------------------
# ppermute halo: the slab halo is ONE interface plane per neighbor pair, so
# the general all_to_all + ghost-slot assembly of dist.g2l/l2g_add is
# replaced by a neighbor ppermute of the plane plus static-slice
# arithmetic. ndev == 1 is a static no-comm
# specialization (what a single-chip production run executes).
#
# Plane ownership (see module docstring): the interface plane between
# slabs s and s+1 is OWNED by s (its top plane = the LAST NyNx valid
# owned slots); shard s > 0 reads it as its bottom ghost plane.
# ---------------------------------------------------------------------------
def halo_fwd(owned, isf, toff, ndev: int, axis, NP: int, NyNx: int):
    """owned (c, n_owned_max) -> dense local lattice (c, NP*NyNx):
    ppermute my top plane to my right neighbor; prepend the received
    plane (shard 0 owns its bottom plane and shifts instead).

    toff: per-shard scalar slot offset of the shard's TOP (interface)
    plane within its owned block (valid_count - NyNx; handles uneven
    slab sizes) — static data shipped via slabd."""
    c, no = owned.shape
    n = NP * NyNx
    if ndev == 1:
        return owned[:, :n]
    import jax

    z = jnp.zeros((), toff.dtype)
    top = jax.lax.dynamic_slice(owned, (z, toff), (c, NyNx))
    recv = jax.lax.ppermute(top, axis,
                            [(s, s + 1) for s in range(ndev - 1)])
    cat = jnp.concatenate([recv, owned[:, : no - NyNx]], axis=1)  # (c, no)
    return jnp.where(isf > 0, owned[:, :n], cat[:, :n])


def halo_adj(v, isf, toff, ndev: int, axis, NP: int, NyNx: int,
             n_owned: int):
    """Adjoint of halo_fwd: dense-lattice contributions (c, NP*NyNx) ->
    owned-block contributions (c, n_owned_max); the bottom-plane
    contribution of shard s > 0 rides a ppermute back to its owner's
    top plane (window given by the owner's toff)."""
    c = v.shape[0]
    no = n_owned
    n = NP * NyNx
    import jax

    if ndev == 1:
        out = v
        if n < no:
            out = jnp.pad(v, ((0, 0), (0, no - n)))
        return out
    # my owned contribution (shard 0: all planes; others: planes 1..NP)
    own0 = v[:, :no] if n >= no else jnp.pad(v, ((0, 0), (0, no - n)))
    tail = v[:, NyNx:n]
    own1 = jnp.pad(tail, ((0, 0), (0, no - tail.shape[1])))
    out = jnp.where(isf > 0, own0, own1)
    # bottom-plane contribution -> left neighbor's top plane
    gc = v[:, :NyNx] * (1 - isf).astype(v.dtype)
    recv = jax.lax.ppermute(gc, axis,
                            [(s, s - 1) for s in range(1, ndev)])
    z = jnp.zeros((), toff.dtype)
    win = jax.lax.dynamic_slice(out, (z, toff), (c, NyNx))
    return jax.lax.dynamic_update_slice(out, win + recv, (z, toff))


# ---------------------------------------------------------------------------
# Inside-shard_map layout shuffles. `local` is the (c, n_local) vector of
# dist.g2l: [owned | ghost | trash]; the slab lattice is the dense
# (c, NP * NyNx) plane range [p*z0, p*z0 + NP) of the global lattice.
# ---------------------------------------------------------------------------
def lattice_from_local(local, sa, isf, NP: int, NyNx: int):
    """[owned | ghost] -> dense local lattice. Shard 0 owns its plane 0
    (shift past the ghost buffer); others prepend the received plane."""
    c = local.shape[0]
    n_ghost = sa.n_local - sa.n_owned_max - 1
    if n_ghost >= NyNx:
        ghost = local[:, sa.n_owned_max: sa.n_owned_max + NyNx]
    else:                                      # ndev == 1: no exchange
        ghost = jnp.zeros((c, NyNx), local.dtype)
    cat = jnp.concatenate([ghost, local[:, : sa.n_owned_max]], axis=1)
    # two STATIC slices + select instead of a dynamic_slice with a traced
    # start
    n = NP * NyNx
    return jnp.where(isf > 0, cat[:, NyNx: NyNx + n], cat[:, :n])


def local_to_lattice_adjoint(v, sa, isf, NP: int, NyNx: int):
    """Adjoint of lattice_from_local: dense local-lattice contributions ->
    (c, n_local) [owned | ghost | trash] for dist.l2g_add (the bottom-plane
    contribution of shards s > 0 rides the ghost slots back to its owner)."""
    c = v.shape[0]
    vcat = jnp.concatenate([v, jnp.zeros((c, NyNx), v.dtype)], axis=1)
    no = sa.n_owned_max
    owned = jnp.where(isf > 0, vcat[:, :no], vcat[:, NyNx: NyNx + no])
    parts = [owned]
    n_ghost = sa.n_local - sa.n_owned_max - 1
    if n_ghost > 0:
        gc = v[:, :NyNx] * (1 - isf).astype(v.dtype)
        if n_ghost > NyNx:
            gc = jnp.pad(gc, ((0, 0), (0, n_ghost - NyNx)))
        parts.append(gc)
    parts.append(jnp.zeros((c, 1), v.dtype))   # trash slot
    return jnp.concatenate(parts, axis=1)

"""Entity-structured restriction + single-GEMM gradient pipeline.

The hot-path alternative to ops/restriction.py + ops/basis.py: instead of a
node-by-node gather into (ncomp, nelem, P3) followed by an einsum over the
basis, the element apply becomes

    gather (entity-row takes)  ->  ONE GEMM (e, P3*3) @ (P3*3, 9*Q3)
      ->  physics on Mat3 views of the GEMM output columns
      ->  ONE GEMM (e, 9*Q3) @ (9*Q3, P3*3)  ->  entity-row scatter-sum

exploiting the entity-class node numbering of mesh/fespace.py
([vertices | edge nodes | face nodes | cell interiors], each entity's nodes
contiguous, interiors element-ordered):

* interior nodes need NO gather at all — a pure reshape of the L-vector;
* edge/face nodes are gathered as whole entity ROWS (one contiguous row of
  (p-1)*3 resp. (p-1)^2*3 values per entity), with the per-element lattice
  ordering restored by a static orientation permutation — orders of
  magnitude fewer gather rows than per-node takes;
* the transpose (owner-sum) is one row-take per entity class plus a
  masked reshape-sum, bitwise deterministic.

Layout rules (each was chosen for the old accelerator's memory system and
has not been re-measured on a GPU yet):

* each entity class gathers from its own natural-width table (a free
  reshape view of the L-vector region) instead of one padded union table;
* every take flattens its indices to a 1-D array;
* orientation permutations are (rows, w) 0/1-matrix GEMMs at
  precision='highest' (exact for 0/1 matrices) plus a select chain.

This is the CeedElemRestriction + CeedBasis pair (reference
src/setuplibceed.c:194-240, 335-348): row-major moves, one GEMM per
direction set, zero 4D transposes.

Unlike the reference, constrained (Dirichlet) DOFs are NOT encoded as
negative indices; boundary conditions are applied by masking at the solver
level.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def lattice_class_positions(p: int) -> dict:
    """Flat lattice indices per entity class, in slot-major local order.

    Matches the entity slot conventions of mesh/fespace.py (edge slots
    direction-major, face (u, v) with u fastest).
    """
    P = p + 1
    flat = lambda i, j, k: i + P * (j + P * k)  # noqa: E731
    verts = np.array(
        [flat(p * (v & 1), p * ((v >> 1) & 1), p * ((v >> 2) & 1))
         for v in range(8)]
    )
    if p == 1:
        return dict(verts=verts,
                    edges=np.zeros((12, 0), np.int64),
                    faces=np.zeros((6, 0), np.int64),
                    interior=np.zeros(0, np.int64))
    rng = np.arange(1, p)
    edges = np.zeros((12, p - 1), dtype=np.int64)
    for cj in range(2):
        for ck in range(2):
            edges[cj + 2 * ck] = flat(rng, cj * p, ck * p)
    for ci in range(2):
        for ck in range(2):
            edges[4 + ci + 2 * ck] = flat(ci * p, rng, ck * p)
    for ci in range(2):
        for cj in range(2):
            edges[8 + ci + 2 * cj] = flat(ci * p, cj * p, rng)
    uu = np.tile(rng, p - 1)          # u fastest within a face row
    vv = np.repeat(rng, p - 1)
    faces = np.zeros((6, (p - 1) ** 2), dtype=np.int64)
    faces[0] = flat(0, uu, vv)
    faces[1] = flat(p, uu, vv)
    faces[2] = flat(uu, 0, vv)
    faces[3] = flat(uu, p, vv)
    faces[4] = flat(uu, vv, 0)
    faces[5] = flat(uu, vv, p)
    ii = np.tile(rng, (p - 1) ** 2)
    jj = np.tile(np.repeat(rng, p - 1), p - 1)
    kk = np.repeat(rng, (p - 1) ** 2)
    interior = flat(ii, jj, kk)
    return dict(verts=verts, edges=edges, faces=faces, interior=interior)


def _orientation_sigs(perm: np.ndarray):
    """perm (e, ns, s): local ordering of each entity's canonical row.

    Deduplicates into (unique perms tuple-of-tuples, sig (e, ns) int32)."""
    e, ns, s = perm.shape
    uniq, sig = np.unique(perm.reshape(-1, s), axis=0, return_inverse=True)
    perms = tuple(tuple(int(x) for x in row) for row in uniq)
    return perms, sig.reshape(e, ns).astype(np.int32)


def _transpose_map(ids: np.ndarray, nent: int) -> np.ndarray:
    """ids (e, ns): entity id per element slot. Returns padded (nent, K)
    table of flat e*ns positions contributing to each entity; sentinel =
    e*ns (masked to zero at apply time)."""
    e, ns = ids.shape
    flat = ids.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=nent)
    K = int(counts.max(initial=1))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = np.full((nent, K), e * ns, dtype=np.int32)
    for k in range(K):
        rows = np.nonzero(counts > k)[0]
        out[rows, k] = order[starts[rows] + k]
    return out


def _perm_matrices(perms, width: int) -> np.ndarray:
    """(n_perm, width, width) lane matrices realizing the node perms on
    node-major comp-fastest rows: out[:, i*3+c] = in[:, perm[i]*3+c].
    Entries are exact 0/1; applied with precision='highest' these GEMMs
    are bitwise-exact (a reduced-precision matmul such as TF32 would round
    the VALUES)."""
    mats = []
    for pm in perms:
        M = np.zeros((width, width), np.float32)
        for i, src in enumerate(pm):
            for c in range(3):
                M[src * 3 + c, i * 3 + c] = 1.0
        mats.append(M)
    return np.stack(mats)


class StructuredMaps:
    """Entity-id / orientation tables extracted from an FESpace (setup time,
    numpy). Requires the fespace invariants: per-entity node contiguity and
    element-ordered interiors — guaranteed by mesh/fespace.py numbering."""

    def __init__(self, fes):
        p = fes.degree
        self.p = p
        conn = fes.conn.astype(np.int64)
        nelem = conn.shape[0]
        self.nelem = nelem
        self.num_nodes = fes.num_nodes
        self.off_e, self.off_f, self.off_c = (
            fes.off_edge, fes.off_face, fes.off_cell)
        self.nverts = self.off_e
        pos = lattice_class_positions(p)
        self.P3 = (p + 1) ** 3

        # class-ordered local column order: verts | edges | faces | interior
        self.col_lattice = np.concatenate(
            [pos["verts"], pos["edges"].ravel(), pos["faces"].ravel(),
             pos["interior"]]
        )
        assert np.array_equal(np.sort(self.col_lattice), np.arange(self.P3))

        self.vert_ids = conn[:, pos["verts"]].astype(np.int32)     # (e, 8)
        self.vert_tmap = _transpose_map(self.vert_ids, self.nverts)

        if p > 1:
            s_e = p - 1
            ed = conn[:, pos["edges"].ravel()].reshape(nelem, 12, s_e) - self.off_e
            eids = ed[:, :, 0] // s_e
            assert (ed // s_e == eids[:, :, None]).all(), "edge nodes straddle"
            self.edge_ids = eids.astype(np.int32)                  # (e, 12)
            self.nedges = (self.off_f - self.off_e) // s_e
            self.edge_perms, self.edge_sig = _orientation_sigs(
                ed - eids[:, :, None] * s_e)
            self.edge_tmap = _transpose_map(self.edge_ids, self.nedges)

            s_f = (p - 1) ** 2
            fd = conn[:, pos["faces"].ravel()].reshape(nelem, 6, s_f) - self.off_f
            fids = fd[:, :, 0] // s_f
            assert (fd // s_f == fids[:, :, None]).all(), "face nodes straddle"
            self.face_ids = fids.astype(np.int32)                  # (e, 6)
            self.nfaces = (self.off_c - self.off_f) // s_f
            self.face_perms, self.face_sig = _orientation_sigs(
                fd - fids[:, :, None] * s_f)
            self.face_tmap = _transpose_map(self.face_ids, self.nfaces)

            s_c = (p - 1) ** 3
            want = self.off_c + np.arange(nelem)[:, None] * s_c + np.arange(s_c)
            assert np.array_equal(conn[:, pos["interior"]], want), \
                "interior nodes not element-ordered"


def grad_gemm_matrices_cm(basis, col_lattice: np.ndarray, dtype):
    """Component-BATCHED single-GEMM gradient operator.

    Kg3: (P3, 3*Q3) with columns (d, q); applying to component-major
    E-vectors (3*e, P3) @ Kg3 gives (3*e, 3*Q3) whose (c-block, d-column)
    slices are the nine du[c,d] (e, Q3) planes — 3x fewer GEMM flops than
    the interleaved (P3*3, 9*Q3) factorization (no structurally-zero
    rows). Returns (Kg3, Kg3^T)."""
    grad = np.asarray(basis.grad, np.float64)          # (3, Q3, P3) lattice
    Q3, P3 = grad.shape[1], grad.shape[2]
    Kg = np.zeros((P3, 3 * Q3))
    for d in range(3):
        Kg[:, d * Q3:(d + 1) * Q3] = grad[d][:, col_lattice].T
    return jnp.asarray(Kg, dtype), jnp.asarray(np.ascontiguousarray(Kg.T), dtype)


def grad_gemm_matrices(basis, col_lattice: np.ndarray, dtype):
    """Single-GEMM gradient operator in class-column order.

    Kg: (P3*ncomp, 9*Q3) with rows (node p class-ordered, comp c)
    c-fastest and columns ((c*3+d), q) so GEMM-output column slices are
    exactly the nine du[c,d] (e, Q3) planes of a Mat3. Returns (Kg, Kg^T).
    """
    grad = np.asarray(basis.grad, np.float64)          # (3, Q3, P3) lattice
    Q3, P3 = grad.shape[1], grad.shape[2]
    Kg = np.zeros((P3 * 3, 9 * Q3))
    for c in range(3):
        for d in range(3):
            Kg[c::3, (c * 3 + d) * Q3:(c * 3 + d + 1) * Q3] = \
                grad[d][:, col_lattice].T
    return jnp.asarray(Kg, dtype), jnp.asarray(np.ascontiguousarray(Kg.T), dtype)


class StructuredRestriction:
    """Device-side entity-structured gather/scatter (pytree).

    gather_rows: (num_nodes, 3) -> (nelem, P3*3) class-ordered, node-major
      with the 3 components contiguous per node.
    scatter_rows: transpose with owner-sum, (nelem, P3*3) -> (num_nodes, 3).

    Every take reads from a per-class natural-width table (a reshape VIEW
    of an L-vector region — no union table is ever materialized) with flat
    1-D indices (see the module docstring).
    """

    def __init__(self, maps: StructuredMaps):
        p = maps.p
        self._init_static(
            p, maps.nelem, maps.num_nodes, maps.nverts,
            maps.off_e, maps.off_f, maps.off_c,
            getattr(maps, "nedges", 0), getattr(maps, "nfaces", 0),
            getattr(maps, "edge_perms", ()), getattr(maps, "face_perms", ()),
        )

        def masked(tmap, sentinel):
            m = (tmap != sentinel)
            ids = np.where(m, tmap, 0).astype(np.int32)
            return jnp.asarray(ids), jnp.asarray(m.astype(np.float32))

        self.vert_ids = jnp.asarray(maps.vert_ids)
        self.vert_tmap, self.vert_tmask = masked(
            np.asarray(maps.vert_tmap), maps.nelem * 8)
        if p == 1:
            self.edge_ids = self.face_ids = None
            self.e_sig = self.f_sig = None
            self.e_pmats = self.f_pmats = None
            self.edge_tmap = self.edge_tmask = None
            self.face_tmap = self.face_tmask = None
            return
        self.edge_ids = jnp.asarray(maps.edge_ids)
        self.face_ids = jnp.asarray(maps.face_ids)
        self.e_sig = jnp.asarray(maps.edge_sig.reshape(-1))    # (e*12,)
        self.f_sig = jnp.asarray(maps.face_sig.reshape(-1))    # (e*6,)
        self.e_pmats = jnp.asarray(_perm_matrices(maps.edge_perms, (p - 1) * 3))
        self.f_pmats = jnp.asarray(
            _perm_matrices(maps.face_perms, (p - 1) ** 2 * 3))
        self.edge_tmap, self.edge_tmask = masked(
            np.asarray(maps.edge_tmap), maps.nelem * 12)
        self.face_tmap, self.face_tmask = masked(
            np.asarray(maps.face_tmap), maps.nelem * 6)

    def _init_static(self, p, nelem, num_nodes, nverts, off_e, off_f, off_c,
                     nedges, nfaces, edge_perms, face_perms):
        self.p = p
        self.nelem = nelem
        self.num_nodes = num_nodes
        self.nverts = nverts
        self.off_e, self.off_f, self.off_c = off_e, off_f, off_c
        self.nedges, self.nfaces = nedges, nfaces
        self.edge_perms = edge_perms        # tuple of tuples (static)
        self.face_perms = face_perms
        self.P3 = (p + 1) ** 3

    # -- orientation perms: per-variant 0/1-matrix GEMM + select ---------
    @staticmethod
    def _perm_select(rows, pmats, sig, perms, inverse=False):
        """rows (R, w); pmats (n, w, w) exact perm matrices; sig (R,);
        perms the STATIC tuple the matrices realize (identity fast path)."""
        n = len(perms)
        if n == 1 and tuple(perms[0]) == tuple(range(len(perms[0]))):
            return rows
        mats = jnp.transpose(pmats, (0, 2, 1)) if inverse else pmats
        acc = jnp.dot(rows, mats[0], precision="highest")
        for o in range(1, n):
            acc = jnp.where((sig == o)[:, None],
                            jnp.dot(rows, mats[o], precision="highest"), acc)
        return acc

    def gather_rows(self, u_rows: jnp.ndarray) -> jnp.ndarray:
        """(num_nodes, 3) -> (nelem, P3*3) class-ordered."""
        p, nelem = self.p, self.nelem
        if p == 1:
            return jnp.take(u_rows, self.vert_ids.reshape(-1),
                            axis=0).reshape(nelem, -1)
        s_e, s_f, s_c = p - 1, (p - 1) ** 2, (p - 1) ** 3
        we, wf = s_e * 3, s_f * 3
        et = u_rows[self.off_e:self.off_f].reshape(self.nedges, we)
        ft = u_rows[self.off_f:self.off_c].reshape(self.nfaces, wf)
        vr = jnp.take(u_rows[:self.nverts], self.vert_ids.reshape(-1),
                      axis=0).reshape(nelem, 24)
        er = jnp.take(et, self.edge_ids.reshape(-1), axis=0)   # (e*12, we)
        fr = jnp.take(ft, self.face_ids.reshape(-1), axis=0)   # (e*6, wf)
        er = self._perm_select(er, self.e_pmats, self.e_sig, self.edge_perms)
        fr = self._perm_select(fr, self.f_pmats, self.f_sig, self.face_perms)
        parts = [
            vr,
            er.reshape(nelem, 12 * we),
            fr.reshape(nelem, 6 * wf),
            u_rows[self.off_c:].reshape(nelem, s_c * 3),
        ]
        return jnp.concatenate(parts, axis=1)

    @staticmethod
    def _gather_sum(rows_flat, tmap, tmask):
        """Masked owner-sum: one flat take + reshape-sum. Sentinel slots
        point at row 0 with weight 0 (exact zero contribution)."""
        nent, K = tmap.shape
        g = jnp.take(rows_flat, tmap.reshape(-1), axis=0)
        g = g.reshape(nent, K, rows_flat.shape[1])
        return (g * tmask[:, :, None]).sum(axis=1)

    def scatter_rows(self, ve: jnp.ndarray) -> jnp.ndarray:
        """(nelem, P3*3) class-ordered -> (num_nodes, 3) owner-summed."""
        p, nelem = self.p, self.nelem
        if p == 1:
            return self._gather_sum(ve[:, :24].reshape(nelem * 8, 3),
                                    self.vert_tmap, self.vert_tmask)
        s_e, s_f = p - 1, (p - 1) ** 2
        we, wf = s_e * 3, s_f * 3
        o1 = 24
        o2 = o1 + 12 * we
        o3 = o2 + 6 * wf
        vrow = ve[:, :o1].reshape(nelem * 8, 3)
        erow = self._perm_select(ve[:, o1:o2].reshape(nelem * 12, we),
                                 self.e_pmats, self.e_sig, self.edge_perms,
                                 inverse=True)
        frow = self._perm_select(ve[:, o2:o3].reshape(nelem * 6, wf),
                                 self.f_pmats, self.f_sig, self.face_perms,
                                 inverse=True)
        parts = [
            self._gather_sum(vrow, self.vert_tmap, self.vert_tmask),
            self._gather_sum(erow, self.edge_tmap,
                             self.edge_tmask).reshape(-1, 3),
            self._gather_sum(frow, self.face_tmap,
                             self.face_tmask).reshape(-1, 3),
            ve[:, o3:].reshape(-1, 3),
        ]
        return jnp.concatenate(parts, axis=0)

    def multiplicity(self) -> jnp.ndarray:
        """(num_nodes,) per-node element count."""
        ones = jnp.ones((self.nelem, self.P3 * 3), dtype=jnp.float32)
        return self.scatter_rows(ones)[:, 0]

    # -- pytree protocol (index tables travel as jit args) ----------------
    def tree_flatten(self):
        children = (self.vert_ids, self.edge_ids, self.face_ids,
                    self.e_sig, self.f_sig, self.e_pmats, self.f_pmats,
                    self.vert_tmap, self.vert_tmask,
                    self.edge_tmap, self.edge_tmask,
                    self.face_tmap, self.face_tmask)
        aux = (self.p, self.nelem, self.num_nodes, self.nverts,
               self.off_e, self.off_f, self.off_c, self.nedges, self.nfaces,
               self.edge_perms, self.face_perms)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj._init_static(*aux)
        (obj.vert_ids, obj.edge_ids, obj.face_ids,
         obj.e_sig, obj.f_sig, obj.e_pmats, obj.f_pmats,
         obj.vert_tmap, obj.vert_tmask,
         obj.edge_tmap, obj.edge_tmask,
         obj.face_tmap, obj.face_tmask) = children
        return obj


jax.tree_util.register_pytree_node(
    StructuredRestriction,
    lambda r: r.tree_flatten(),
    StructuredRestriction.tree_unflatten,
)

"""Element restriction: L-vector <-> E-vector gather / scatter-add.

The CeedElemRestriction analog (reference src/setuplibceed.c:194-240).
Component-major layout: L-vectors are (ncomp, num_nodes), E-vectors are
(ncomp, nelem, P3) — the long node/element axes sit minor-most so gathers
and segment-sums vectorize over them.

Unlike the reference, constrained (Dirichlet) DOFs are NOT encoded as
negative indices; boundary conditions are applied by masking at the solver
level.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Restriction is registered as a jax pytree so its O(nelem) index arrays can
# be passed through jit boundaries as ARGUMENTS rather than being baked into
# the compiled module as constants (which would inflate every compiled
# program by hundreds of MB on large meshes).


class Restriction:
    """Gather/scatter between (ncomp, num_nodes) and (ncomp, nelem, P3).

    The transpose (scatter-add) is executed as a node-centric GATHER-SUM:
    at setup, the positions in the flattened E-vector referencing each node
    are tabulated into padded (nodes_in_range, K) index blocks, one block
    per contiguous node-id range of roughly uniform multiplicity (the
    [vertices | edges | faces | cell-interiors] entity ranges of
    mesh/fespace.py are ideal: K = ~8 / ~4 / 2 / 1). At runtime the
    scatter becomes K row-gathers + adds per range: bitwise deterministic,
    unlike an atomic scatter-add.
    """

    def __init__(self, conn: np.ndarray, num_nodes: int,
                 node_ranges: list | None = None):
        self.conn = jnp.asarray(conn, dtype=jnp.int32)      # (nelem, P3)
        self.num_nodes = int(num_nodes)
        self.nelem, self.P3 = conn.shape
        self._flat = self.conn.reshape(-1)
        self._build_transpose_map(np.asarray(conn), node_ranges)

    def _build_transpose_map(self, conn: np.ndarray, node_ranges):
        flat = conn.reshape(-1).astype(np.int64)
        N = self.num_nodes
        counts = np.bincount(flat, minlength=N)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos_sorted = np.argsort(flat, kind="stable")
        sentinel = flat.size                    # extra zero slot appended
        if not node_ranges:
            node_ranges = [(0, N)]
        blocks = []
        for a, b in node_ranges:
            if b <= a:
                continue
            K = int(counts[a:b].max(initial=0))
            if K == 0:
                K = 1
            idx = np.full((b - a, K), sentinel, dtype=np.int64)
            for k in range(K):
                sel = counts[a:b] > k
                rows = np.nonzero(sel)[0]
                idx[rows, k] = pos_sorted[starts[a:b][rows] + k]
            blocks.append((a, b, jnp.asarray(idx.astype(np.int32))))
        self._t_blocks = blocks

    def gather(self, u: jnp.ndarray) -> jnp.ndarray:
        """(ncomp, num_nodes) -> (ncomp, nelem, P3).

        Gathers whole rows of the row-major (num_nodes, ncomp) view; the
        transposes fuse.
        """
        rows = jnp.take(u.T, self.conn, axis=0)       # (nelem, P3, ncomp)
        return jnp.moveaxis(rows, -1, 0)

    def scatter_add(self, ve: jnp.ndarray) -> jnp.ndarray:
        """(ncomp, nelem, P3) -> (ncomp, num_nodes), summed over elements.

        Node-centric gather-sum through row-major (see class docstring)."""
        ncomp = ve.shape[0]
        rows = jnp.moveaxis(ve.reshape(ncomp, -1), 0, 1)       # (eP3, c)
        ext = jnp.concatenate(
            [rows, jnp.zeros((1, ncomp), rows.dtype)], axis=0
        )
        parts = []
        for a, b, idx in self._t_blocks:
            acc = jnp.take(ext, idx[:, 0], axis=0)
            for k in range(1, idx.shape[1]):
                acc = acc + jnp.take(ext, idx[:, k], axis=0)
            parts.append(acc)
        out = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        return out.T                                            # (c, N)

    def multiplicity(self) -> jnp.ndarray:
        """(num_nodes,) per-node element count."""
        ones = jnp.ones((1, self.nelem, self.P3), dtype=jnp.float32)
        return self.scatter_add(ones)[0]

    # -- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        idxs = tuple(idx for _, _, idx in self._t_blocks)
        ranges = tuple((a, b) for a, b, _ in self._t_blocks)
        return (self.conn, self._flat, idxs), (
            self.num_nodes, self.nelem, self.P3, ranges,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        conn, flat, idxs = children
        obj = cls.__new__(cls)
        obj.conn = conn
        obj._flat = flat
        obj.num_nodes, obj.nelem, obj.P3, ranges = aux
        obj._t_blocks = [
            (a, b, idx) for (a, b), idx in zip(ranges, idxs)
        ]
        return obj


jax.tree_util.register_pytree_node(
    Restriction,
    lambda r: r.tree_flatten(),
    Restriction.tree_unflatten,
)

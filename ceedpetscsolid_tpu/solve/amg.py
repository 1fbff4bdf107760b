"""Device-side AMG V-cycle over a natively-built hierarchy (E3e).

The C++ library (csrc/amg.cpp) performs smoothed-aggregation SETUP on the
assembled p=1 matrix — the GAMG-equivalent of the reference's coarse solve
(elasticity.c:568-585) and of its whole preconditioner at degree 1
(elasticity.c:519-521). This module converts the hierarchy to padded-ELL
device arrays and applies ONE V-cycle entirely inside jit (a fixed linear
operation — a valid stationary preconditioner for the outer CG).

After the first setup the hierarchy STRUCTURE is frozen; subsequent Newton
iterations only refresh matrix values (amg_refresh), so all device shapes
stay static and nothing recompiles.
"""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


def _ell_map(n, rowptr):
    """Vectorized CSR->ELL slot map: src[i,k] = rowptr[i]+k (clamped) and a
    validity mask. Shared by structure extraction and value-only refresh."""
    counts = np.diff(rowptr)
    K = int(counts.max(initial=1))
    src = rowptr[:-1, None] + np.arange(K)[None, :]
    mask = np.arange(K)[None, :] < counts[:, None]
    return np.where(mask, src, 0), mask, K


def _csr_to_ell(n, rowptr, colind, vals, dtype):
    src, mask, K = _ell_map(n, rowptr)
    idx = np.where(mask, colind[src], 0).astype(np.int32)
    v = np.where(mask, vals[src], 0.0)
    return jnp.asarray(idx), jnp.asarray(v, dtype)


def ell_matvec(idx, vals, x):
    """y[i] = sum_k vals[i,k] * x[idx[i,k]] (padding: val 0 at col 0)."""
    return jnp.sum(vals * jnp.take(x, idx, axis=0), axis=1)


class AMGPreconditioner:
    """Owns the native hierarchy handle + device ELL/dense arrays.

    Tiny sparse gathers are latency-bound on an accelerator, so the
    per-level matvec picks a dense representation where it can:

      * level 0 with `top_mf=True`: the caller passes `top_matvec` to
        `apply` — the existing matrix-free p=1 operator (GEMM
        pipeline). The assembled level-0 matrix is then never uploaded at
        all (it IS the Galerkin matrix of that operator, ops/assembly.py),
        which also removes the dominant d2h traffic from every refresh.
      * levels with n <= dense_n: dense (n, n) matrix — a dense matvec
        instead of an ELL gather at these sizes (dense_n was tuned on the
        old accelerator; not re-measured on a GPU).
      * remaining mid-size levels: padded ELL (the general fallback).
    """

    def __init__(self, dtype, theta: float = 0.0, max_levels: int = 10,
                 coarse_size: int = 600, smooth_its: int = 2,
                 top_mf: bool = False, dense_n: int = 4096):
        self.dtype = dtype
        self.theta = theta
        self.max_levels = max_levels
        self.coarse_size = coarse_size
        self.smooth_its = smooth_its
        self.top_mf = top_mf
        self.dense_n = dense_n
        self.handle = None
        self._pattern = None
        self._struct = None       # host-side frozen structure + ELL maps
        self.data = None          # pytree of device arrays

    # -- host-side setup/refresh ----------------------------------------
    def setup(self, A: sp.csr_matrix):
        from ..native import lib

        L = lib()
        A = A.tocsr()
        A.sort_indices()
        n = A.shape[0]
        rowptr = A.indptr.astype(np.int64)
        colind = A.indices.astype(np.int32)
        vals = A.data.astype(np.float64)
        if self.handle is not None and not (
            np.array_equal(self._pattern[0], rowptr)
            and np.array_equal(self._pattern[1], colind)
        ):
            # pattern changed (should not happen with CSRAssembler) --
            # rebuild from scratch rather than corrupt the hierarchy
            L.amg_free(self.handle)
            self.handle = None
            self._struct = None
        if self.handle is None:
            self.handle = ctypes.c_void_p(L.amg_setup(
                n, np.int64(vals.size), rowptr, colind, vals,
                float(self.theta), int(self.max_levels), int(self.coarse_size),
            ))
            self._pattern = (rowptr, colind)
        else:
            L.amg_refresh(self.handle, vals)
        if self._struct is not None:
            self._extract_values(L)
        else:
            self._extract(L)

    def _level_rep(self, l: int, nlev: int, n: int) -> str:
        """Representation of level l's operator: 'none' (coarsest — solved
        by coarse_inv), 'mf' (level 0 applied matrix-free by the caller),
        'dense' (small level as a dense matvec), or 'ell' (general
        fallback)."""
        if l == nlev - 1:
            return "none"
        if l == 0 and self.top_mf:
            return "mf"
        if n <= self.dense_n:
            return "dense"
        return "ell"

    def _extract_values(self, L):
        """Values-only refresh (per-Newton-step hot path): the hierarchy
        STRUCTURE is frozen after the first setup (amg_refresh keeps
        aggregation/prolongator patterns), so only A values, diagonals,
        lambda_max, and the dense coarse inverse change. Index arrays stay
        on device untouched; each level's new values are one vectorized
        gather through the cached CSR->ELL slot map (or a dense fill)."""
        h = self.handle
        levels = self.data["levels"]
        for l, st in enumerate(self._struct):
            vals, diag, lam = st["vals"], st["diag"], st["lam"]
            L.amg_get_matrix(h, l, st["rowptr"], st["colind"], vals, diag, lam)
            e = levels[l]
            rep = st["rep"]
            if rep == "ell":
                src, mask = st["src"], st["mask"]
                e["a_val"] = jnp.asarray(np.where(mask, vals[src], 0.0),
                                         self.dtype)
            elif rep == "dense":
                e["a_dense"] = jnp.asarray(
                    sp.csr_matrix((vals, st["colind"], st["rowptr"]),
                                  shape=(st["n"], st["n"])).toarray(),
                    self.dtype)
            if rep != "none":
                e["dinv"] = jnp.asarray(
                    np.where(diag != 0, 1.0 / np.where(diag == 0, 1, diag),
                             1.0), self.dtype)
                e["lam"] = jnp.asarray(float(lam[0]), self.dtype)
        self.data["coarse_inv"] = self._coarse_inv(L)

    def _coarse_inv(self, L):
        nc = self._coarse_n
        dense = np.zeros(nc * nc, np.float64)
        L.amg_coarse_dense(self.handle, dense)
        M = dense.reshape(nc, nc)
        if not np.isfinite(M).all():
            raise FloatingPointError(
                "AMG coarse matrix has non-finite entries (check the "
                "element matrices / stash feeding CSRAssembler)")
        # Galerkin coarse matrices are symmetric: the eigh-based pinv is
        # both faster and robust where dgesdd occasionally fails to
        # converge on ill-conditioned inputs
        try:
            coarse_inv = np.linalg.pinv(M, hermitian=True)
        except np.linalg.LinAlgError:
            coarse_inv = np.linalg.pinv(M + 1e-12 * np.eye(nc) * np.abs(M).max())
        return jnp.asarray(coarse_inv, self.dtype)

    def _extract(self, L):
        h = self.handle
        nlev = L.amg_num_levels(h)
        levels = []
        self._struct = []
        for l in range(nlev):
            dims = np.zeros(4, np.int64)
            L.amg_level_dims(h, l, dims)
            n, annz, pnnz, pcols = (int(d) for d in dims)
            rowptr = np.zeros(n + 1, np.int64)
            colind = np.zeros(max(annz, 1), np.int32)
            vals = np.zeros(max(annz, 1), np.float64)
            diag = np.zeros(n, np.float64)
            lam = np.zeros(1, np.float64)
            L.amg_get_matrix(h, l, rowptr, colind, vals, diag, lam)
            rep = self._level_rep(l, nlev, n)
            st = {"rowptr": rowptr, "colind": colind,
                  "vals": vals, "diag": diag, "lam": lam, "n": n, "rep": rep}
            entry = {}
            if rep == "ell":
                entry["a_idx"], entry["a_val"] = _csr_to_ell(
                    n, rowptr, colind, vals, self.dtype)
                st["src"], st["mask"], _ = _ell_map(n, rowptr)
            elif rep == "dense":
                entry["a_dense"] = jnp.asarray(
                    sp.csr_matrix((vals, colind, rowptr),
                                  shape=(n, n)).toarray(), self.dtype)
            if rep != "none":
                entry["dinv"] = jnp.asarray(
                    np.where(diag != 0, 1.0 / np.where(diag == 0, 1, diag),
                             1.0), self.dtype)
                entry["lam"] = jnp.asarray(float(lam[0]), self.dtype)
            self._struct.append(st)
            entry["n"] = n
            if l < nlev - 1 and pnnz > 0:
                prow = np.zeros(n + 1, np.int64)
                pcol = np.zeros(pnnz, np.int32)
                pval = np.zeros(pnnz, np.float64)
                L.amg_get_prolongator(h, l, prow, pcol, pval)
                P = sp.csr_matrix(
                    (pval, pcol, prow), shape=(n, pcols)
                )
                if n <= self.dense_n:
                    # prolongator values are frozen across refreshes, so
                    # dense transfers cost nothing after the first setup
                    pd = P.toarray()
                    entry["p_dense"] = jnp.asarray(pd, self.dtype)
                    entry["pt_dense"] = jnp.asarray(pd.T.copy(), self.dtype)
                else:
                    entry["p_idx"], entry["p_val"] = _csr_to_ell(
                        n, P.indptr.astype(np.int64), P.indices, P.data,
                        self.dtype
                    )
                    PT = P.T.tocsr()
                    PT.sort_indices()
                    entry["pt_idx"], entry["pt_val"] = _csr_to_ell(
                        pcols, PT.indptr.astype(np.int64), PT.indices, PT.data,
                        self.dtype,
                    )
            levels.append(entry)
        self._coarse_n = levels[-1]["n"]
        for e in levels:
            e.pop("n")          # keep the pytree numeric-leaf only
        self.data = {"levels": levels, "coarse_inv": self._coarse_inv(L)}

    # -- device-side application (jit-traceable) -------------------------
    def apply(self, r_flat, data, top_matvec=None):
        """One V-cycle on a flat (3N,) node-major residual vector.

        top_matvec: flat (3N,) -> (3N,) level-0 operator action; REQUIRED
        when the hierarchy was built with top_mf=True (the caller supplies
        the matrix-free p=1 apply, e.g. the p-MG level-0 operator closed
        over the current Newton stash — bitwise the same Galerkin matrix
        up to roundoff, at GEMM speed instead of ELL gathers)."""
        sm = self.smooth_its
        levels = data["levels"]
        nlev = len(levels)

        def matvec(l, lv, x):
            if "a_dense" in lv:
                return lv["a_dense"] @ x
            if "a_val" in lv:
                return ell_matvec(lv["a_idx"], lv["a_val"], x)
            if l == 0 and top_matvec is not None:
                return top_matvec(x)
            raise ValueError(
                "AMG level 0 is matrix-free (top_mf=True) but no "
                "top_matvec was passed to apply()")

        def transfer_down(lv, r):
            if "pt_dense" in lv:
                return lv["pt_dense"] @ r
            return ell_matvec(lv["pt_idx"], lv["pt_val"], r)

        def transfer_up(lv, xc):
            if "p_dense" in lv:
                return lv["p_dense"] @ xc
            return ell_matvec(lv["p_idx"], lv["p_val"], xc)

        def smooth(l, lv, b, x=None):
            # Chebyshev on [0.1, 1.1]*lam of D^{-1}A (matching the p-MG
            # smoother bounds, elasticity.c:540)
            lam = lv["lam"]
            lo, hi = 0.1 * lam, 1.1 * lam
            theta = 0.5 * (hi + lo)
            delta = 0.5 * (hi - lo)
            sigma1 = theta / delta
            rho = 1.0 / sigma1
            # x = None encodes a zero initial guess: r = b without paying
            # a (possibly matrix-free) A @ 0 application
            r = b if x is None else b - matvec(l, lv, x)
            d = (lv["dinv"] * r) / theta
            x = d if x is None else x + d
            for _ in range(sm - 1):
                r = b - matvec(l, lv, x)
                rho_new = 1.0 / (2.0 * sigma1 - rho)
                d = rho_new * rho * d + (2.0 * rho_new / delta) * (lv["dinv"] * r)
                rho = rho_new
                x = x + d
            return x

        bs = [None] * nlev
        xs = [None] * nlev
        bs[0] = r_flat
        for l in range(nlev - 1):
            lv = levels[l]
            xs[l] = smooth(l, lv, bs[l])
            r = bs[l] - matvec(l, lv, xs[l])
            bs[l + 1] = transfer_down(lv, r)
        xs[nlev - 1] = data["coarse_inv"] @ bs[nlev - 1]
        for l in range(nlev - 2, -1, -1):
            lv = levels[l]
            x = xs[l] + transfer_up(lv, xs[l + 1])
            xs[l] = smooth(l, lv, bs[l], x)
        return xs[0]

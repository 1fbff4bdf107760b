"""Tensor-product H1 Lagrange bases (the CeedBasis analog).

A `Basis1D` holds the 1D interpolation and differentiation matrices from P
Lagrange nodes (at Gauss-Lobatto points, matching
CeedBasisCreateTensorH1Lagrange, reference src/setuplibceed.c:335-348) to Q
evaluation points (Gauss quadrature, or Gauss-Lobatto for collocation
bases).

3D application is by Kronecker structure. Two device paths are provided:

* ``kron`` (default): the full (Q^3 x P^3) interp matrix and the three
  (Q^3 x P^3) gradient matrices are materialized once at setup; application
  is a single large batched GEMM. More FLOPs than sum factorization but one
  dense matrix-unit-shaped contraction for the tiny P, Q of this workload.
* ``sumfact``: classic sum-factorized 1D contractions (O(P^2 Q^2 (P+Q))
  work); the libCEED-equivalent algorithm, used as cross-check and for very
  high degree.

Index conventions: lattice points are ordered x-fastest, i.e. flat index
n = i + P*(j + P*k) for node (i,j,k); likewise for quadrature points.
Gradient direction d: 0=x, 1=y, 2=z (reference-coordinate derivatives).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from . import quadrature


def lagrange_matrices(nodes: np.ndarray, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Interp and derivative matrices of the Lagrange basis on `nodes` at `pts`.

    Returns (B, D) with B[q, p] = l_p(x_q) and D[q, p] = l'_p(x_q).
    Uses barycentric weights for stability.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    pts = np.asarray(pts, dtype=np.float64)
    P = nodes.size
    B = np.zeros((pts.size, P))
    D = np.zeros((pts.size, P))
    # Direct product-form evaluation (P <= 8 here; conditioning is fine and
    # exact at nodes, unlike naive barycentric evaluation).
    for qi, x in enumerate(pts):
        for p in range(P):
            val = 1.0
            for m in range(P):
                if m != p:
                    val *= (x - nodes[m]) / (nodes[p] - nodes[m])
            B[qi, p] = val
            acc = 0.0
            for m in range(P):
                if m == p:
                    continue
                term = 1.0 / (nodes[p] - nodes[m])
                for r in range(P):
                    if r in (p, m):
                        continue
                    term *= (x - nodes[r]) / (nodes[p] - nodes[r])
                acc += term
            D[qi, p] = acc
    return B, D


@dataclass(frozen=True)
class Basis1D:
    """1D basis: P Lagrange nodes (Lobatto) -> Q evaluation points."""

    P: int
    Q: int
    nodes: np.ndarray      # (P,) Gauss-Lobatto nodal points on [-1,1]
    qpts: np.ndarray       # (Q,) evaluation points
    qweights: np.ndarray   # (Q,) quadrature weights (zeros for collocation use)
    B: np.ndarray          # (Q, P) interp
    D: np.ndarray          # (Q, P) derivative

    @staticmethod
    def create(P: int, Q: int, quad_mode: str = "gauss") -> "Basis1D":
        nodes, _ = quadrature.gauss_lobatto(P) if P > 1 else (np.zeros(1), np.full(1, 2.0))
        if quad_mode == "gauss":
            qpts, qwts = quadrature.gauss(Q)
        elif quad_mode == "gauss_lobatto":
            qpts, qwts = quadrature.gauss_lobatto(Q)
        else:
            raise ValueError(f"unknown quadrature mode {quad_mode!r}")
        B, D = lagrange_matrices(nodes, qpts)
        return Basis1D(P=P, Q=Q, nodes=nodes, qpts=qpts, qweights=qwts, B=B, D=D)


def _kron3(A2: np.ndarray, A1: np.ndarray, A0: np.ndarray) -> np.ndarray:
    """kron over (z, y, x) with x fastest: out[(qz qy qx), (pz py px)]."""
    return np.kron(A2, np.kron(A1, A0))


@dataclass(frozen=True)
class Basis3D:
    """Tensor-product 3D basis with precomputed device matrices.

    Attributes (all jnp arrays, framework dtype):
      interp   : (Q3, P3)     value interpolation
      grad     : (3, Q3, P3)  reference-coordinate gradients
      qweights : (Q3,)        tensor quadrature weights
    """

    b1: Basis1D
    interp: jnp.ndarray
    grad: jnp.ndarray
    qweights: jnp.ndarray

    @property
    def P(self) -> int:
        return self.b1.P

    @property
    def Q(self) -> int:
        return self.b1.Q

    @property
    def P3(self) -> int:
        return self.b1.P ** 3

    @property
    def Q3(self) -> int:
        return self.b1.Q ** 3

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def create(P: int, Q: int, quad_mode: str = "gauss", dtype=jnp.float64) -> "Basis3D":
        b1 = Basis1D.create(P, Q, quad_mode)
        B, D = b1.B, b1.D
        interp = _kron3(B, B, B)
        grad = np.stack(
            [
                _kron3(B, B, D),   # d/dX0 (x fastest)
                _kron3(B, D, B),   # d/dX1
                _kron3(D, B, B),   # d/dX2
            ]
        )
        w1 = b1.qweights
        qw = (w1[:, None, None] * w1[None, :, None] * w1[None, None, :]).reshape(-1)
        return Basis3D(
            b1=b1,
            interp=jnp.asarray(interp, dtype=dtype),
            grad=jnp.asarray(grad, dtype=dtype),
            qweights=jnp.asarray(qw, dtype=dtype),
        )

    # ------------------------------------------------------------------
    # Device application, COMPONENT-MAJOR (long dims minor).
    # ue: (ncomp, nelem, P3); gradients are (ncomp, 3, nelem, Q3) planes.
    # Each application is a single GEMM contraction over P3.
    # ------------------------------------------------------------------
    def apply_interp(self, ue: jnp.ndarray) -> jnp.ndarray:
        """(ncomp, nelem, P3) -> (ncomp, nelem, Q3)."""
        return jnp.einsum("qp,cep->ceq", self.interp, ue,
                          preferred_element_type=ue.dtype)

    def apply_grad(self, ue: jnp.ndarray) -> jnp.ndarray:
        """(ncomp, nelem, P3) -> (ncomp, 3, nelem, Q3) reference-coord grads."""
        return jnp.einsum("dqp,cep->cdeq", self.grad, ue,
                          preferred_element_type=ue.dtype)

    def apply_interp_T(self, vq: jnp.ndarray) -> jnp.ndarray:
        """(ncomp, nelem, Q3) -> (ncomp, nelem, P3)."""
        return jnp.einsum("qp,ceq->cep", self.interp, vq,
                          preferred_element_type=vq.dtype)

    def apply_grad_T(self, dv: jnp.ndarray) -> jnp.ndarray:
        """(ncomp, 3, nelem, Q3) -> (ncomp, nelem, P3)."""
        return jnp.einsum("dqp,cdeq->cep", self.grad, dv,
                          preferred_element_type=dv.dtype)

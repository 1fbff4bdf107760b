"""Spectral global-GEMM lattice path (ops/spectral.py) vs the generic
unstructured pipeline, plus adjointness of grad/grad_T.

The spectral path is the production hot path on box meshes: the whole
G^T B^T D B G pipeline as 16 per-axis global banded GEMMs with no
E-vector (reference pipeline: src/setuplibceed.c:529-542)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ceedpetscsolid_tpu.mesh.box import box_mesh
from ceedpetscsolid_tpu.mesh.fespace import build_fespace
from ceedpetscsolid_tpu.models import Physics, get_model
from ceedpetscsolid_tpu.ops.basis import Basis3D
from ceedpetscsolid_tpu.ops.operator import OperatorFactory
from ceedpetscsolid_tpu.ops.spectral import SpectralLattice


def test_grad_matches_element_path_and_adjoint():
    degree, faces = 3, (3, 2, 4)
    mesh = box_mesh(faces)
    fes = build_fespace(mesh, degree)
    basis = Basis3D.create(degree + 1, degree + 2, "gauss", jnp.float64)
    sp = SpectralLattice(faces, degree, basis, jnp.float64)
    mats = sp.matrices()

    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((3, fes.num_nodes)))
    du = sp.grad(u, mats)

    # element-path reference: gather -> kron grad
    fac = OperatorFactory([fes], qextra=1, use_spectral=False,
                          dtype=jnp.float64)
    ue = fac.fine.restr.gather(u)
    du_ref = fac.fine.basis.apply_grad(ue)      # (3, 3, nelem, Q3)
    for c in range(3):
        for d in range(3):
            a = sp.plane_to_elem(du.m[3 * c + d])
            np.testing.assert_allclose(np.asarray(a),
                                       np.asarray(du_ref[c, d]),
                                       rtol=1e-12, atol=1e-12)

    # adjointness: <grad u, w> == <u, grad_T w>
    from ceedpetscsolid_tpu.models.base import Mat3
    w = Mat3([jnp.asarray(rng.standard_normal(du.m[0].shape))
              for _ in range(9)])
    lhs = sum(float(jnp.vdot(a, b)) for a, b in zip(du.m, w.m))
    rhs = float(jnp.vdot(u, sp.grad_T(w, mats)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-13


@pytest.mark.parametrize("problem", ["linElas", "hyperSS", "hyperFS",
                                     "hyperFSIncomp"])
def test_spectral_matches_generic(problem):
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem
    import ceedpetscsolid_tpu.ops.operator as op_mod

    cfg = Config(problem=problem, degree=2, nu=0.3, E=1.0, test_mode=True,
                 box_faces=(3, 3, 3), multigrid="none", num_increments=1)
    prob = ElasticityProblem(cfg)
    assert prob.factory.use_spectral

    orig = op_mod.OperatorFactory.__init__

    def patched(self, *a, **kw):
        kw["use_spectral"] = False
        orig(self, *a, **kw)

    op_mod.OperatorFactory.__init__ = patched
    try:
        ref = ElasticityProblem(cfg)
    finally:
        op_mod.OperatorFactory.__init__ = orig
    assert not ref.factory.use_spectral

    bc = prob.bc_values(1.0)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.normal(size=(3, prob.fine_space.num_nodes)) * 0.01,
                    prob.dtype)
    v = jnp.asarray(rng.normal(size=u.shape), prob.dtype)

    G_sp, s_sp = prob._nonlinear_residual(u, bc, prob.F)
    G_rf, s_rf = ref._nonlinear_residual(u, bc, ref.F)
    np.testing.assert_allclose(np.asarray(G_sp), np.asarray(G_rf),
                               rtol=1e-11, atol=1e-13)

    Jv_sp = prob._jacobian_action(v, s_sp)
    Jv_rf = ref._jacobian_action(v, s_rf)
    np.testing.assert_allclose(np.asarray(Jv_sp), np.asarray(Jv_rf),
                               rtol=1e-11, atol=1e-13)

"""Native AMG + assembled-coarse oracles (SURVEY E3e/E3f, hard part 3)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np

from ceedpetscsolid_tpu.native import lib
from ceedpetscsolid_tpu.ops.assembly import CSRAssembler, make_element_matrices
from ceedpetscsolid_tpu.problem import Config, ElasticityProblem
from ceedpetscsolid_tpu.solve.amg import AMGPreconditioner
from ceedpetscsolid_tpu.solve.cg import pcg


def _p1_matrix(prob, stash=None):
    emfn = make_element_matrices(
        prob.model.jacobian_qf, prob.phys, prob.factory.levels[0].basis,
        prob.dtype,
    )
    em = np.asarray(jax.jit(lambda: emfn(prob.qdata, stash))())
    sp0 = prob.spaces[0]
    asm = CSRAssembler(sp0.conn, sp0.num_nodes,
                       np.asarray(prob._level_mask(sp0)))
    return asm.assemble(em), asm


def test_assembled_matches_matrix_free():
    cfg = Config(problem="linElas", degree=1, nu=0.3, E=1.0, test_mode=True,
                 box_faces=(4, 4, 4), multigrid="none")
    prob = ElasticityProblem(cfg)
    A, _ = _p1_matrix(prob)
    rng = np.random.default_rng(0)
    mask = np.asarray(prob.bc_mask)
    v = np.where(mask, 0.0, rng.normal(size=mask.shape))
    Av = np.where(mask, 0.0, (A @ v.T.reshape(-1)).reshape(-1, 3).T)
    Jv = np.asarray(prob._jacobian_action(jnp.asarray(v), None))
    assert np.abs(Av - Jv).max() / np.abs(Jv).max() < 1e-13


def test_amg_reduces_cg_iterations():
    cfg = Config(problem="linElas", degree=1, nu=0.3, E=1.0, test_mode=True,
                 box_faces=(8, 8, 8), multigrid="none")
    prob = ElasticityProblem(cfg)
    A, _ = _p1_matrix(prob)
    amg = AMGPreconditioner(prob.dtype)
    amg.setup(A)
    G, stash = prob._nonlinear_residual(
        jnp.zeros((3, prob.fine_space.num_nodes)), prob.bc_values(1.0), prob.F
    )
    Aop = lambda x: prob._jacobian_action(x, stash)  # noqa: E731
    M = lambda r: amg.apply(r.T.reshape(-1), amg.data).reshape(-1, 3).T  # noqa: E731
    plain = pcg(Aop, -G, rtol=1e-10)
    pre = pcg(Aop, -G, M_inv=M, rtol=1e-10)
    assert int(pre.iters) < int(plain.iters) // 2
    assert float(jnp.abs(pre.x - plain.x).max()) < 1e-12


def test_amg_refresh_keeps_pattern_and_quality():
    """Value-only refresh with the fixed-pattern assembler must not degrade
    the preconditioner (the bug class: pattern drift corrupting refresh)."""
    cfg = Config(problem="hyperSS", degree=2, nu=0.3, E=1e6, forcing="none",
                 box_faces=(2, 2, 2), bc_clamp=(6, 5),
                 bc_clamp_translate={5: (0.0, 0.0, 0.05)},
                 num_increments=1, multigrid="logarithmic")
    prob = ElasticityProblem(cfg)
    info = prob.solve()
    assert info.converged
    # several Newton iterations ran -> refresh path exercised; iteration
    # count must stay MG-like, not Jacobi-like
    assert info.ksp_iters < 30 * info.snes_iters


def test_amg_representations_agree():
    """The dense-shaped cycle (matrix-free top level + dense small levels)
    must produce the SAME preconditioner action as the plain
    ELL hierarchy, up to roundoff: same native setup, different device
    representations (solve/amg.py _level_rep)."""
    cfg = Config(problem="linElas", degree=1, nu=0.3, E=1.0, test_mode=True,
                 box_faces=(8, 8, 8), multigrid="none")
    prob = ElasticityProblem(cfg)
    A, _ = _p1_matrix(prob)

    ell = AMGPreconditioner(prob.dtype, dense_n=0)        # pure ELL
    ell.setup(A)
    fast = AMGPreconditioner(prob.dtype, top_mf=True, dense_n=4096)
    fast.setup(A)
    assert any("a_dense" in lv or "p_dense" in lv
               for lv in fast.data["levels"]), "dense rep not engaged"
    assert "a_val" not in fast.data["levels"][0], "top level still ELL"

    rng = np.random.default_rng(1)
    n = A.shape[0]
    r = jnp.asarray(rng.normal(size=n), prob.dtype)
    top_mv = lambda x: jnp.asarray(A @ np.asarray(x))     # noqa: E731
    x_ell = ell.apply(r, ell.data)
    x_fast = fast.apply(r, fast.data, top_matvec=top_mv)
    rel = float(jnp.linalg.norm(x_fast - x_ell) / jnp.linalg.norm(x_ell))
    assert rel < 1e-12, rel


def test_degree1_amg_pc():
    """PCGAMG-at-degree-1 analog (elasticity.c:519-521)."""
    cfg = Config(problem="linElas", degree=1, nu=0.3, E=1.0, test_mode=True,
                 box_faces=(6, 6, 6), multigrid="logarithmic")
    prob = ElasticityProblem(cfg)
    info = prob.solve()
    assert info.converged
    assert info.ksp_iters <= 15

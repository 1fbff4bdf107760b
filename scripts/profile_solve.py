"""Attribute the solve-level cost of the bench solve config: hyperFS
degree 4 on a 16^3 box, MMS, p-MG + AMG coarse, f32.

All device timings are SCAN-AMORTIZED: each piece runs `R` times inside
one jitted lax.scan with a data dependency, so the per-call number is
operator cost, not per-dispatch launch overhead (which is reported
separately as `dispatch_overhead_ms`).

Pieces:
  residual / jacobian apply      -- fine operator costs
  level{d}_apply                 -- per-p-MG-level Jacobian action
  vcycle                         -- one full p-MG V-cycle M(r)
  amg_cycle                      -- the AMG coarse solve alone (with the
                                    matrix-free top level, solve/amg.py)
  pc_setup                       -- per-Jacobian eig estimation
  amg refresh breakdown          -- elem mats / d2h / CSR / native C++ /
                                    device re-upload, each barriered
  linear_solve, per_cg_iter      -- end-to-end CG cost

Writes results/SOLVE_PROFILE.json.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, reps=3, warmup=1):
    for _ in range(warmup):
        r = fn()
    jax.block_until_ready(r)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def scan_time(fn_one, x0, args, R=16):
    """Best per-call seconds of `fn_one(x, *args)` amortized over a scan
    with a data dependency (mirrors bench.py's measurement)."""

    @jax.jit
    def many(x, a):
        def body(c, _):
            r = fn_one(c, *a)
            leaf = r[0] if isinstance(r, tuple) else r
            return c + 1e-30 * jnp.sum(leaf) , None
        o, _ = jax.lax.scan(body, x, None, length=R)
        return o

    return timeit(lambda: many(x0, args)) / R


def main():
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem, _flatwrap
    from ceedpetscsolid_tpu.solve.pmg import make_vcycle

    cfg = Config(problem="hyperFS", degree=4, nu=0.3, E=1.0, test_mode=True,
                 box_faces=(16, 16, 16), num_increments=2, ksp_rtol=1e-6)
    cfg.newton.rtol = 1e-6
    prob = ElasticityProblem(cfg)

    bc = prob.bc_values(1.0)
    F = prob.F
    u = jnp.zeros((3, prob.fine_space.num_nodes), prob.dtype)
    out = {"dofs": 3 * prob.fine_space.num_nodes,
           "backend": jax.default_backend(),
           "pc_precision": cfg.pc_precision}

    # --- fine applies (scan-amortized) + dispatch overhead ---------------
    G, stash = prob._nonlinear_residual(u, bc, F)
    jax.block_until_ready(G)
    out["residual_ms"] = scan_time(
        lambda c, bc_, F_, big: prob._nl_res_j(c, bc_, F_, big)[0],
        u, (bc, F, prob._big)) * 1e3
    t_single = timeit(lambda: prob._nl_res_j(u, bc, F, prob._big)[0]) * 1e3
    out["residual_single_dispatch_ms"] = t_single
    out["dispatch_overhead_ms"] = t_single - out["residual_ms"]
    out["jacobian_ms"] = scan_time(
        lambda c, s, big: prob._jac_act_j(c, s, big),
        G, (stash, prob._big)) * 1e3

    # --- per-level applies ------------------------------------------------
    for l, deg in enumerate(prob.level_degrees):
        nn = prob.spaces[l].num_nodes
        v0 = jnp.ones((3, nn), prob.dtype)
        out[f"level{deg}_apply_ms"] = scan_time(
            lambda c, s, big, l=l: prob._raw_jacobian(c, big, s, level=l),
            v0, (stash, prob._big)) * 1e3

    # --- AMG refresh breakdown (all device work barriered) ----------------
    t0 = time.perf_counter()
    prob._refresh_amg(stash)
    out["amg_refresh_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob._refresh_amg(stash)
    jax.block_until_ready(prob._big["amg"])
    out["amg_refresh_ms"] = (time.perf_counter() - t0) * 1e3

    em = prob._elem_mats0(stash, prob._big)
    jax.block_until_ready(em)            # ensure queue is drained
    t0 = time.perf_counter()
    em = prob._elem_mats0(stash, prob._big)
    jax.block_until_ready(em)
    out["amg_elem_mats_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    em_h = np.asarray(em)
    out["amg_d2h_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    A = prob._assembler0.assemble(em_h)
    out["amg_csr_assemble_ms"] = (time.perf_counter() - t0) * 1e3
    from ceedpetscsolid_tpu.native import lib
    A = A.tocsr()
    A.sort_indices()
    t0 = time.perf_counter()
    lib().amg_refresh(prob._amg.handle, A.data.astype(np.float64))
    out["amg_native_refresh_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    prob._amg._extract_values(lib())
    jax.block_until_ready(prob._amg.data)
    out["amg_extract_upload_ms"] = (time.perf_counter() - t0) * 1e3
    prob._big["amg"] = prob._amg.data
    out["amg_level_sizes"] = [s["n"] for s in prob._amg._struct]
    out["amg_level_reps"] = [s["rep"] for s in prob._amg._struct]

    # --- pc setup (eig estimation) ----------------------------------------
    pc = prob._pc_setup_j(stash, prob._big)
    jax.block_until_ready(pc)
    out["pc_setup_ms"] = timeit(
        lambda: prob._pc_setup_j(stash, prob._big)) * 1e3

    # --- AMG cycle + full V-cycle (scan-amortized) ------------------------
    diag_invs, bounds = pc
    nn0 = prob.spaces[0].num_nodes
    b0 = jnp.ones((3, nn0), prob.dtype)

    def amg_once(b, data, s, big):
        mg = prob._build_mg_levels(s, big)
        top = _flatwrap(lambda v: mg[0].apply(v, s))
        return prob._amg_apply(b, data, top_mv=top)

    out["amg_cycle_ms"] = scan_time(
        amg_once, b0, (prob._big["amg"], stash, prob._big)) * 1e3

    bf = jnp.ones_like(G)

    def vcycle_once(r, s, big, di, bo, data):
        mg = prob._build_mg_levels(s, big)
        top = _flatwrap(lambda v: mg[0].apply(v, s))
        ca = lambda b0_, cd: prob._amg_apply(b0_, cd, top_mv=top)  # noqa: E731
        vc = make_vcycle(mg, smooth_its=cfg.smooth_its,
                         coarse_cheb_its=cfg.coarse_cheb_its,
                         coarse_apply=ca)
        return vc(r, s, list(di), list(bo), data)

    out["vcycle_ms"] = scan_time(
        vcycle_once, bf,
        (stash, prob._big, diag_invs, bounds, prob._big["amg"])) * 1e3

    # --- full linear solve -------------------------------------------------
    t0 = time.perf_counter()
    d, iters = prob._lin_solve_j(G, stash, prob._big, pc)
    jax.block_until_ready(d)
    out["linear_solve_first_s"] = time.perf_counter() - t0
    t_ls = timeit(lambda: prob._lin_solve_j(G, stash, prob._big, pc)[0])
    its = int(iters)
    out["linear_solve_ms"] = t_ls * 1e3
    out["linear_solve_iters"] = its
    out["per_cg_iter_ms"] = t_ls * 1e3 / max(its, 1)
    # the honest ratio: against the scan-amortized residual apply
    out["per_cg_iter_vs_residual"] = (
        out["per_cg_iter_ms"] / out["residual_ms"])
    out["per_cg_iter_model_ms"] = out["jacobian_ms"] + out["vcycle_ms"]

    # --- full warm solve ----------------------------------------------------
    info = prob.solve()
    out["solve_time_s"] = round(info.solve_time, 3)
    out["solve_snes"] = info.snes_iters
    out["solve_ksp"] = info.ksp_iters
    out["solve_mdofs_per_sec"] = round(info.mdofs_per_sec, 3)

    for k, vv in out.items():
        print(f"{k:28s} {vv}")
    outp = Path(__file__).parent.parent / "results" / "SOLVE_PROFILE.json"
    outp.write_text(json.dumps(out, indent=1, default=float) + "\n")


if __name__ == "__main__":
    main()

"""Benchmark harness. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": null, "extra": {...}}

Headline metric (BASELINE.md north star): hyperFS residual-evaluation
throughput per chip at degree 4 — millions of DoFs processed per second,
where one "DoF processed" is one degree of freedom touched by one full
matrix-free residual evaluation (gather -> basis -> physics -> basis^T ->
scatter). The reference defines DoFs/sec = dofs * CG_iters / time
(elasticity.c:763-764); each CG iteration is one operator evaluation, so
this is the same quantity measured at the operator level. Measured at a
24^3 box (13824 elements).

`extra` carries the solve-level benchmark (the reference's actual headline,
elasticity.c:754-765): full Newton + p-MG + AMG-coarse solve of hyperFS at
degree 4, reporting dofs*KSP_iters/time, plus roofline context for the
residual (achieved GEMM TF/s and device-memory GB/s), and the device each
stage ran on.

Every measurement stage runs in its own subprocess (`python bench.py
--stage NAME`) within a total wall budget (CPSTPU_BENCH_BUDGET_S, default
2400 s); the parent never imports JAX, so only one process holds the card
at a time, and it always prints its line. A stage that finds no GPU fails
(its error is recorded in `extra`); no stage falls back to the CPU.
There is no H100 baseline yet, so vs_baseline is null.

Env knobs: CPSTPU_BENCH_BUDGET_S total wall budget;
CPSTPU_BENCH_FAST=1 runs the headline residual stage only.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))


# ======================================================================
# Measurement stages — each runs in its own subprocess via --stage NAME
# and prints "STAGE_RESULT {json}" on success. jax is imported lazily so
# the orchestrator process never touches the card. Every timing ends in
# jax.block_until_ready.
# ======================================================================

def _require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench stage needs a GPU, found {dev.platform!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _time(fn, *args, reps=3):
    """Best-of-`reps` wall seconds of fn(*args) after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def residual_bench():
    import jax
    import jax.numpy as jnp
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    device = _require_gpu()
    faces, reps = (24, 24, 24), 30

    cfg = Config(
        problem="hyperFS", degree=4, nu=0.3, E=1.0, test_mode=True,
        box_faces=faces, multigrid="none", num_increments=1,
    )
    prob = ElasticityProblem(cfg)
    ndofs = 3 * prob.fine_space.num_nodes

    bc = prob.bc_values(1.0)
    F = prob.F
    u = jnp.zeros((3, prob.fine_space.num_nodes), prob.dtype)

    # Time `reps` residual evaluations inside ONE jitted scan with a data
    # dependency between iterations: measures operator throughput, not the
    # per-dispatch launch latency. Mesh-sized arrays ride as jit arguments,
    # not closure constants.
    @jax.jit
    def many(u0, bc_, F_, big):
        def body(c, _):
            r = prob._nl_res_j(c, bc_, F_, big)[0]
            return c + 1e-30 * jnp.sum(r), None
        out, _ = jax.lax.scan(body, u0, None, length=reps)
        return out

    t_apply = _time(many, u, bc, F, prob._big) / reps
    nelem = prob.factory.nelem
    P3, Q3 = prob.factory.fine.basis.P3, prob.factory.Q3
    sp = prob.factory.fine.spectral
    if sp is not None:
        # spectral path: 16 global axis GEMMs (8 forward + 8 adjoint)
        C = 3
        fx = 2 * C * sp.Nz * sp.Ny * sp.Nx * sp.Qx       # per x pass
        fy = 2 * C * sp.Nz * sp.Qx * sp.Ny * sp.Qy       # per y pass
        fz = 2 * C * sp.Qy * sp.Qx * sp.Nz * sp.Qz       # per z pass
        gemm_flops = 2 * (2 * fx + 3 * fy + 3 * fz)      # fwd + adjoint
        # HBM floor: u in/out + qdata + stash out (intermediates excluded)
        hbm_bytes = 4 * (2 * 3 * prob.fine_space.num_nodes
                         + 10 * sp.num_quad + 9 * sp.num_quad)
    else:
        # GEMM flops of the two contraction sets (component-blocked): 2 * 9
        # dots of (e, P3) x (P3, Q3)
        gemm_flops = 2 * 9 * 2 * nelem * P3 * Q3
        # HBM floor: u + rows + packed ue in, out + rows + u back, qdata,
        # stash
        hbm_bytes = 4 * (2 * 3 * prob.fine_space.num_nodes
                         + 4 * nelem * P3 * 3 + 10 * nelem * Q3
                         + 9 * nelem * Q3)
    mdofs = 1e-6 * ndofs / t_apply
    return {
        "_headline_mdofs": round(mdofs, 3),
        "residual_t_apply_ms": round(t_apply * 1e3, 4),
        "residual_gemm_tfs": round(gemm_flops / t_apply / 1e12, 3),
        "residual_hbm_floor_gbs": round(hbm_bytes / t_apply / 1e9, 2),
        "residual_ndofs": ndofs,
        "residual_box_faces": faces[0],
        "device": device,
    }


def dist_bench():
    """Distributed-vs-serial fine-apply parity at equal elements/shard,
    ndev=1 (the SPMD-overhead factor; reference runs identical per-rank
    CeedOperators, src/matops.c:26-60). Two variants:
      * box slab  — the ppermute plane-halo pipeline (parallel/slab.py)
      * unstructured — the generic all_to_all halo path on the cylinder
        mesh (VERDICT r4 weak #6: this path had no r4 measurement)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem
    from ceedpetscsolid_tpu.parallel.driver import DistributedProblem

    out = {"device": _require_gpu()}

    def time_pair(cfg, mesh=None):
        prob = ElasticityProblem(cfg, mesh=mesh)
        dp = DistributedProblem(prob, ndev=1)
        ndofs = 3 * prob.fine_space.num_nodes
        u = dp.to_owned(np.zeros((3, prob.fine_space.num_nodes), prob.dtype))
        bc = dp.to_owned(
            prob.bcs.values(prob._coords, 1.0).T.astype(prob.dtype))
        args = (bc, dp.F_sh, dp.mask_sh, dp.qdata_sh, dp.qdata_p_sh, dp.sa,
                dp._sgrads[-1], dp.sgrads_p[-1] if dp.composite else None,
                dp._slabd, dp._smats2)
        reps = 20

        @jax.jit
        def many(u0, a):
            def body(c, _):
                r = dp._resid_sm(c, *a)
                return c + 1e-30 * r, None
            o, _ = jax.lax.scan(body, u0, None, length=reps)
            return o

        t_dist = _time(many, u, args) / reps

        # serial apply on the same problem for the overhead ratio
        bc_s = prob.bc_values(1.0)
        u_s = jnp.zeros((3, prob.fine_space.num_nodes), prob.dtype)

        @jax.jit
        def many_s(u0, bc_, F_, big):
            def body(c, _):
                r = prob._nl_res_j(c, bc_, F_, big)[0]
                return c + 1e-30 * jnp.sum(r), None
            o, _ = jax.lax.scan(body, u0, None, length=reps)
            return o

        t_ser = _time(many_s, u_s, bc_s, prob.F, prob._big) / reps
        return ndofs, t_dist, t_ser, dp.slab is not None

    # box slab variant (the r4 headline path)
    cfg = Config(problem="hyperFS", degree=4, nu=0.3, E=1.0, test_mode=True,
                 box_faces=(24, 24, 24), multigrid="none", num_increments=1)
    ndofs, t_d, t_s, is_slab = time_pair(cfg)
    out["dist1_residual_mdofs"] = round(1e-6 * ndofs / t_d, 1)
    out["dist1_residual_ms"] = round(t_d * 1e3, 3)
    out["dist1_overhead_x"] = round(t_d / t_s, 3)
    out["dist1_slab"] = is_slab

    # unstructured variant (generic all_to_all halo, no slab structure) on
    # the scrambled 18^3 box (5832 elements), whole-boundary MMS conditions
    from chip_smoke import scrambled_box

    cfg_u = Config(problem="hyperFS", degree=3, nu=0.3, E=1.0,
                   test_mode=True, multigrid="none", num_increments=1)
    try:
        ndofs, t_d, t_s, is_slab = time_pair(
            cfg_u, scrambled_box((18, 18, 18)))
        out["dist1_unstructured_mdofs"] = round(1e-6 * ndofs / t_d, 1)
        out["dist1_unstructured_ms"] = round(t_d * 1e3, 3)
        out["dist1_unstructured_overhead_x"] = round(t_d / t_s, 3)
        out["dist1_unstructured_slab"] = is_slab
    except Exception as e:                          # noqa: BLE001
        out["dist1_unstructured_error"] = repr(e)[:200]
    return out


def unstructured_bench():
    """Residual throughput of the XLA entity-row path on an unstructured
    mesh at hyperFS degree 4 — the scrambled 36^3 box of chip_smoke.py
    (46,656 elements, 9.1M DoF; the reference's largest committed cylinder
    had 44,928 elements and 8.87M DoF) — plus the gather/scatter share of
    the row apply (the E-vector restriction is SURVEY hard-part #1)."""
    import jax
    import jax.numpy as jnp
    from chip_smoke import scrambled_box
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    out = {"device": _require_gpu()}
    cfg = Config(problem="hyperFS", degree=4, nu=0.3, E=1.0,
                 test_mode=True, multigrid="none", num_increments=1)
    prob = ElasticityProblem(cfg, mesh=scrambled_box((36, 36, 36)))
    ndofs = 3 * prob.fine_space.num_nodes
    bc = prob.bc_values(1.0)
    F = prob.F
    u = jnp.zeros((3, prob.fine_space.num_nodes), prob.dtype)
    reps = 20

    @jax.jit
    def many(u0, bc_, F_, big):
        def body(c, _):
            r = prob._nl_res_j(c, bc_, F_, big)[0]
            return c + 1e-30 * jnp.sum(r), None
        o, _ = jax.lax.scan(body, u0, None, length=reps)
        return o

    t = _time(many, u, bc, F, prob._big) / reps
    out["unstructured_row_mdofs"] = round(1e-6 * ndofs / t, 1)
    out["unstructured_row_ms"] = round(t * 1e3, 3)
    out["unstructured_ndofs"] = ndofs

    # gather/scatter share of the row apply, measured on the STRUCTURED
    # entity-row restriction the row pipeline actually uses
    srestr = prob.factory.fine.srestr     # pytree: travels as a jit arg
    u_rows = jnp.zeros((prob.fine_space.num_nodes, 3), prob.dtype)

    @jax.jit
    def gs(u0, r_):
        def body(c, _):
            ve = r_.gather_rows(c)
            c2 = r_.scatter_rows(ve) * 1e-30 + c
            # roll-by-data-dependent-zero: gather(x + broadcast(s)) would
            # otherwise commute + hoist out of the scan
            zi = jnp.where(jnp.isfinite(c2[0, 0]), 0, 1)
            return jnp.roll(c2, zi, axis=0), None
        o, _ = jax.lax.scan(body, u0, None, length=20)
        return o

    t = _time(gs, u_rows, srestr) / 20
    out["unstructured_gather_scatter_ms"] = round(t * 1e3, 3)
    out["unstructured_gs_share_of_row"] = round(
        out["unstructured_gather_scatter_ms"] / out["unstructured_row_ms"], 3)
    return out


def solve_bench():
    """Full-solve DoFs/sec (dofs * KSP_iters / time, elasticity.c:763-764):
    hyperFS degree 4 with the full p-MG + AMG-coarse stack, Newton + CP
    line search, 2 load increments, 16^3 box (1.6M DoF). MMS forcing so the
    f32 solve has a well-conditioned exact-solution target."""
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    device = _require_gpu()
    cfg = Config(
        problem="hyperFS", degree=4, nu=0.3, E=1.0, test_mode=True,
        box_faces=(16, 16, 16), num_increments=2, ksp_rtol=1e-6,
    )
    cfg.newton.rtol = 1e-6
    prob = ElasticityProblem(cfg)
    # Cold solve compiles the whole Newton/p-MG/AMG stack; the reference's
    # "SNES Solve Time" (elasticity.c:632-676) excludes setup, and XLA
    # compilation is setup. Report the warm (compile-cached) solve; cold
    # wall time recorded alongside.
    cold = prob.solve()
    info = prob.solve()
    return {
        "solve_mdofs_per_sec": round(info.mdofs_per_sec, 3),
        "solve_dofs": info.dofs,
        "solve_snes_iters": info.snes_iters,
        "solve_ksp_iters": info.ksp_iters,
        "solve_time_s": round(info.solve_time, 3),
        "solve_cold_time_s": round(cold.solve_time, 3),
        "solve_rnorm": float(info.rnorm),
        "solve_converged": bool(info.converged),
        "solve_config": "hyperFS deg4 box16 MMS, pMG+AMG, 2 increments",
        "device": device,
    }


STAGE_FNS = {
    "residual": residual_bench,
    "solve": solve_bench,
    "unstructured": unstructured_bench,
    "dist": dist_bench,
}


def run_stage_child(name):
    """Child-process entry: run one stage, print STAGE_RESULT json."""
    out = STAGE_FNS[name]()
    print("STAGE_RESULT " + json.dumps(out if out is not None else {}),
          flush=True)


# ======================================================================
# Orchestrator — budget accounting, subprocess stages, guaranteed output
# ======================================================================

def _spawn_stage(name, timeout_s):
    """Run `bench.py --stage name` capped at timeout_s. Returns (dict or
    None, note). Never raises."""
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--stage", name],
            capture_output=True, text=True, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired as e:
        tail = ((e.stdout or "") + (e.stderr or ""))[-300:]
        return None, f"timeout after {timeout_s:.0f}s: {tail[-150:]}"
    except Exception as e:                              # noqa: BLE001
        return None, repr(e)[:200]
    for line in (r.stdout or "").splitlines():
        if line.startswith("STAGE_RESULT "):
            try:
                return json.loads(line[len("STAGE_RESULT "):]), None
            except json.JSONDecodeError:
                break
    tail = ((r.stdout or "") + (r.stderr or ""))[-300:]
    return None, f"rc={r.returncode}: {tail[-200:]}"


def _usolve_stage(deadline, extra):
    """Unstructured solve (BASELINE config 5): hyperFS deg 4 on
    cylinder8_44928e with full p-MG + AMG, run once by
    scripts/usolve_ckpt.py within the remaining budget."""
    import tempfile
    ck = Path(tempfile.gettempdir()) / "usolve_bench_ckpt.npz"
    if ck.exists():
        ck.unlink()
    script = Path(__file__).parent / "scripts" / "usolve_ckpt.py"
    try:
        r = subprocess.run(
            [sys.executable, str(script), str(ck), "4"], capture_output=True,
            text=True, timeout=max(60, deadline - time.monotonic()))
        stdout, tail = r.stdout or "", ((r.stdout or "")
                                        + (r.stderr or ""))[-400:]
    except subprocess.TimeoutExpired as e:
        stdout, tail = e.stdout or "", "hit the bench budget"
    final = partial = None
    for line in stdout.splitlines():
        for tag in ("USOLVE_PARTIAL ", "USOLVE_RESULT "):
            if line.startswith(tag):
                try:
                    rec = json.loads(line[len(tag):])
                except json.JSONDecodeError:
                    continue
                if tag == "USOLVE_RESULT ":
                    final = rec
                else:
                    partial = rec
    if final is not None:
        extra.update(final)
    elif partial is not None:
        partial["usolve_completed"] = False
        partial["usolve_note"] = "budget ended mid-continuation; " \
            "numbers cover the converged increments so far"
        extra.update(partial)
    else:
        extra["usolve_error"] = f"no increment completed: {tail[-200:]}"


def _nvidia_smi():
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return repr(e)[:200]


def orchestrate():
    t0 = time.monotonic()
    budget = float(os.environ.get("CPSTPU_BENCH_BUDGET_S", "2400"))
    reserve = 20.0                      # always keep time to print

    def remaining():
        return budget - (time.monotonic() - t0) - reserve

    extra = {}
    final = {
        "metric": "hyperfs_residual_mdofs_per_sec_per_chip",
        "value": 0.0,
        "unit": "MDoF/s",
        "vs_baseline": None,
        "extra": extra,
    }
    extra["nvidia_smi"] = _nvidia_smi()
    emitted = []

    def emit():
        if not emitted:
            emitted.append(True)
            print(json.dumps(final), flush=True)

    signal.signal(signal.SIGTERM, lambda *_: (emit(), os._exit(1)))
    try:
        # -- headline: residual throughput -------------------------------
        res, note = _spawn_stage("residual", min(420.0, remaining()))
        if res is not None:
            final["value"] = res.pop("_headline_mdofs", 0.0)
            extra.update(res)
        else:
            extra["residual_error"] = note

        if not os.environ.get("CPSTPU_BENCH_FAST"):
            for name, est, cap in (("solve", 90, 420.0),
                                   ("unstructured", 120, 420.0)):
                if remaining() < est:
                    extra[f"{name}_skipped"] = \
                        f"{remaining():.0f}s budget left < {est}s estimate"
                    continue
                out, note = _spawn_stage(name, min(cap, remaining()))
                if out is not None:
                    extra.update(out)
                else:
                    extra[f"{name}_error"] = note

            # unstructured solve (BASELINE config 5 — the reference's
            # actual headline): runs BEFORE the dist stage so a tight
            # caller window drops the least-informative stage first;
            # reserve 300 s so dist still gets a slot afterwards.
            if remaining() > 540:
                _usolve_stage(t0 + budget - reserve - 300, extra)
            elif remaining() > 240:
                _usolve_stage(t0 + budget - reserve, extra)
            else:
                extra["usolve_skipped"] = \
                    f"{remaining():.0f}s budget left < 240s floor"

            if remaining() < 60:
                extra["dist_skipped"] = \
                    f"{remaining():.0f}s budget left < 60s estimate"
            else:
                out, note = _spawn_stage("dist", min(300.0, remaining()))
                if out is not None:
                    extra.update(out)
                else:
                    extra["dist_error"] = note

        extra["bench_wall_s"] = round(time.monotonic() - t0, 1)
        extra["bench_budget_s"] = budget
    finally:
        emit()


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        run_stage_child(sys.argv[2])
    else:
        orchestrate()

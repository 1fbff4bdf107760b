"""BASELINE config-4 oracle & bisection harness (VERDICT r2 item 1).

The reference's flagship workload: hyperFS, cyl-hole_3140e_2ss_us.exo,
degree 4, clamp faces 998/999 with translate (0,0,0.2) + rotate (0,0,1)
by 0.2*pi on 998, 10 load increments (elasticity.c:636-765,
boundary.c:53-74). This script produces:

  * an f64 oracle (CPU backend; full config or a reduced-degree variant),
  * GPU runs in f32 and f64 against it,

appending each record to results/CONFIG4_ORACLE.json.

Usage: python scripts/validate_config4.py VARIANT [VARIANT...]
  variants: cpu64-deg2 cpu32-deg2 cpu64-deg3 cpu64-deg4 cpu32-deg4
            gpu32-deg2 gpu32-deg4 gpu64-deg4
Env: CPSTPU_INCREMENTS overrides num_increments (default 10).
"""

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax

MESH = "/root/reference/meshes/cyl-hole_3140e_2ss_us.exo"
OUT = Path(__file__).parent.parent / "results" / "CONFIG4_ORACLE.json"

VARIANTS = {
    # name: (backend, x64, degree)
    "cpu64-deg2": ("cpu", True, 2),
    "cpu32-deg2": ("cpu", False, 2),
    "cpu64-deg3": ("cpu", True, 3),
    "cpu64-deg4": ("cpu", True, 4),
    "cpu32-deg4": ("cpu", False, 4),
    "gpu32-deg2": ("gpu", False, 2),
    "gpu32-deg4": ("gpu", False, 4),
    "gpu64-deg4": ("gpu", True, 4),
}


def run(name):
    backend, x64, degree = VARIANTS[name]
    if backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)

    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    ninc = int(os.environ.get("CPSTPU_INCREMENTS", "10"))
    t0 = time.perf_counter()
    cfg = Config(problem="hyperFS", degree=degree, nu=0.3, E=1e6,
                 mesh_file=MESH, forcing="none", num_increments=ninc,
                 bc_clamp=(998, 999),
                 bc_clamp_translate={998: (0.0, 0.0, 0.2)},
                 bc_clamp_rotate={998: (0.0, 0.0, 1.0, 0.2)},
                 ksp_rtol=1e-10 if x64 else 1e-6)
    if not x64:
        cfg.newton.rtol = 1e-6
    stop_load = os.environ.get("CPSTPU_STOP_LOAD")
    if stop_load:
        cfg.stop_at_load = float(stop_load)
        name = f"{name}-l{cfg.stop_at_load:g}"
    if ninc != 10:
        name = f"{name}-i{ninc}"
    if os.environ.get("CPSTPU_LS"):
        cfg.newton.linesearch = os.environ["CPSTPU_LS"]
    if os.environ.get("CPSTPU_EW"):
        # Eisenstat-Walker adaptive forcing (-snes_ksp_ew): VERDICT r5
        # item 4 — don't over-solve noisy f32 linearizations
        cfg.newton.ew = True
        name = f"{name}-ew"
    if os.environ.get("CPSTPU_NEWTON_MONITOR"):
        cfg.newton.monitor = lambda it, rn: print(
            f"    newton {it:3d}: rnorm {rn:.4e}", flush=True)
    prob = ElasticityProblem(cfg)
    t_setup = time.perf_counter() - t0

    incs = []

    def monitor(inc, load, res):
        rec = {"inc": inc, "load": round(load, 3),
               "snes": res.iters, "ksp": res.linear_iters,
               "rnorm": float(res.rnorm), "reason": res.reason}
        if res.converged:
            # per-increment energy: diagnoses WHERE a trajectory leaves
            # the f64 branch (the l0.2 deg-4 discrepancy, round 4)
            ub = prob.insert_bc(res.u, prob.bc_values(load))
            rec["energy"] = prob.strain_energy(ub)
        incs.append(rec)
        print(f"  inc {inc:2d} load {load:.2f}: {res.iters} SNES "
              f"{res.linear_iters} KSP rnorm {res.rnorm:.3e} [{res.reason}]"
              f" E={rec.get('energy', float('nan')):.6g}",
              flush=True)

    info = prob.solve(monitor=monitor)
    rec = {
        "variant": name,
        "backend": jax.default_backend(),
        "x64": bool(jax.config.jax_enable_x64),
        "degree": degree,
        "num_increments": ninc,
        "dofs": info.dofs,
        "snes_iters": info.snes_iters,
        "ksp_iters": info.ksp_iters,
        "rnorm": float(info.rnorm),
        "converged": bool(info.converged),
        "reason": info.reason,
        "strain_energy": prob.strain_energy(info.u),
        "solve_time_s": round(info.solve_time, 3),
        "setup_time_s": round(t_setup, 3),
        "increments": incs,
    }
    print(json.dumps({k: v for k, v in rec.items() if k != "increments"},
                     indent=1), flush=True)
    if os.environ.get("CPSTPU_SAVE_U"):
        import numpy as np
        snap = OUT.parent / "config4_states"
        snap.mkdir(exist_ok=True)
        np.save(snap / f"{name}.npy", np.asarray(info.u, np.float64))
    OUT.parent.mkdir(exist_ok=True)
    data = json.loads(OUT.read_text()) if OUT.exists() else {}
    data[name] = rec
    OUT.write_text(json.dumps(data, indent=1) + "\n")
    return rec


def main():
    names = sys.argv[1:]
    if not names:
        print(__doc__)
        return 1
    for name in names:
        print(f"=== {name} ===", flush=True)
        run(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())

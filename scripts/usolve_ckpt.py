"""Checkpointed unstructured-solve runner (bench config 5 surface).

Solves hyperFS degree 4 on the 8.9M-DoF cylinder and checkpoints
(u, load_done, counters, floor_atol) after every converged increment; run
again with the same checkpoint, it resumes the continuation where it
stopped (`ElasticityProblem.solve(u0, start_load, floor_atol0)`, a
capability the reference lacks, SURVEY §5).

Usage: python scripts/usolve_ckpt.py CKPT.npz [increments]
Exit 0 with a final JSON line on completion; nonzero otherwise (progress
up to the last converged increment is in the checkpoint).
"""

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np


def main():
    ckpt_path = Path(sys.argv[1])
    ninc = int(sys.argv[2]) if len(sys.argv) > 2 else 2

    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    cfg = Config(problem="hyperFS", degree=4, nu=0.3, E=1e6,
                 mesh_file="/root/reference/meshes/"
                           "cylinder8_44928e_2ss_us.exo",
                 forcing="none", num_increments=ninc, ksp_rtol=1e-6,
                 ksp_max_it=1000,
                 bc_clamp=(998, 999),
                 bc_clamp_translate={998: (0.0, 0.0, 0.02)})
    cfg.newton.rtol = 1e-6
    # lag the AMG value refresh (a host round trip, ROADMAP S3) to every
    # 2nd Jacobian; Eisenstat-Walker forcing stops over-solving noisy f32
    # linearizations
    cfg.pc_lag = int(os.environ.get("CPSTPU_USOLVE_PC_LAG", "2"))
    cfg.newton.ew = os.environ.get("CPSTPU_USOLVE_EW", "1") == "1"
    prob = ElasticityProblem(cfg)

    state = {"u": None, "load": 0.0, "snes": 0, "ksp": 0, "time": 0.0,
             "floor": 0.0, "restarts": 0}
    if ckpt_path.exists():
        z = np.load(ckpt_path)
        state = {"u": z["u"], "load": float(z["load"]),
                 "snes": int(z["snes"]), "ksp": int(z["ksp"]),
                 "time": float(z["time"]), "floor": float(z["floor"]),
                 "restarts": int(z["restarts"]) + 1}
        print(f"resuming from load {state['load']} "
              f"(restart #{state['restarts']})", flush=True)

    t0 = time.perf_counter()

    _c = [0, 0]   # snes/ksp accumulated THIS process (converged or not)

    def monitor(inc, load, res):
        _c[0] += res.iters
        _c[1] += res.linear_iters
        print(f"  inc {inc} load {load:.3f}: {res.iters} SNES "
              f"{res.linear_iters} KSP rnorm {res.rnorm:.3e} "
              f"[{res.reason}]", flush=True)
        if res.converged:
            snes = state["snes"] + _c[0]
            ksp = state["ksp"] + _c[1]
            t = state["time"] + time.perf_counter() - t0
            np.savez(ckpt_path, u=np.asarray(res.u, np.float32), load=load,
                     snes=snes, ksp=ksp, time=t,
                     floor=max(state["floor"], float(res.rnorm)),
                     restarts=state["restarts"])
            # progress line for the bench orchestrator: even if the budget
            # ends this process, the converged-increments-so-far throughput
            # is reported honestly
            ndofs = 3 * prob.fine_space.num_nodes
            print("USOLVE_PARTIAL " + json.dumps({
                "usolve_partial_mdofs_per_sec": round(
                    1e-6 * ndofs * ksp / max(t, 1e-9), 3),
                "usolve_partial_load": load,
                "usolve_partial_snes": snes,
                "usolve_partial_ksp": ksp,
                "usolve_partial_time_s": round(t, 3),
                "usolve_dofs": ndofs,
                "usolve_restarts": state["restarts"],
                "usolve_config": "hyperFS deg4 cylinder8_44928e clamp, "
                                 "pMG+AMG (checkpointed)",
            }), flush=True)

    info = prob.solve(monitor=monitor, u0=state["u"],
                      start_load=state["load"], floor_atol0=state["floor"])
    total_time = state["time"] + info.solve_time
    total_snes = state["snes"] + info.snes_iters
    total_ksp = state["ksp"] + info.ksp_iters
    out = {
        "usolve_mdofs_per_sec": round(
            1e-6 * info.dofs * total_ksp / max(total_time, 1e-9), 3),
        "usolve_dofs": info.dofs,
        "usolve_snes_iters": total_snes,
        "usolve_ksp_iters": total_ksp,
        "usolve_time_s": round(total_time, 3),
        "usolve_rnorm": float(info.rnorm),
        "usolve_converged": bool(info.converged),
        "usolve_restarts": state["restarts"],
        "usolve_config": "hyperFS deg4 cylinder8_44928e clamp, pMG+AMG, "
                         f"{ninc} increments (checkpointed)",
    }
    print("USOLVE_RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

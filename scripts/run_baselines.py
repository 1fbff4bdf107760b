"""Measure the BASELINE.md target configurations and write
results/BASELINE_RESULTS.json — the committed regression anchor
(reference oracles: strain energy matops.c:247-296, SNES/KSP iteration
counts and rnorm elasticity.c:684-765, MMS rel-L2 elasticity.c:800-811).

Usage: python scripts/run_baselines.py [config...]   (default: 1 2 3)
  configs 1-3 are CPU/f64-runnable; config 4 (hyperFS degree 4 on
  cyl-hole_3140e, f64) is practical on a GPU.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax

MESHES = Path("/root/reference/meshes")
OUT = Path(__file__).parent.parent / "results" / "BASELINE_RESULTS.json"


def _info_dict(prob, info, t_setup, extra=None):
    d = {
        "dofs": info.dofs,
        "snes_iters": info.snes_iters,
        "ksp_iters": info.ksp_iters,
        "rnorm": float(info.rnorm),
        "converged": bool(info.converged),
        "solve_time_s": round(info.solve_time, 3),
        "setup_time_s": round(t_setup, 3),
        "mdofs_per_sec": round(info.mdofs_per_sec, 3),
        "strain_energy": prob.strain_energy(info.u),
        "backend": jax.default_backend(),
        "dtype": str(prob.dtype.__name__ if hasattr(prob.dtype, "__name__")
                     else prob.dtype),
    }
    if extra:
        d.update(extra)
    return d


def config1():
    """linElas MMS, box 4x4x4, degree 2, E=1e6 nu=0.3 (BASELINE config 1)."""
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    t0 = time.perf_counter()
    cfg = Config(problem="linElas", degree=2, nu=0.3, E=1e6,
                 box_faces=(4, 4, 4), test_mode=True)
    prob = ElasticityProblem(cfg)
    t_setup = time.perf_counter() - t0
    info = prob.solve()
    return _info_dict(prob, info, t_setup,
                      {"mms_rel_l2": prob.mms_error(info.u),
                       "flags": "-problem linElas -degree 2 -nu 0.3 -E 1e6 "
                                "-test -dm_plex_box_faces 4,4,4"})


def config2():
    """linElas MMS on cube8_512e_6ss_s.exo, degrees 2/3/4: convergence
    rates (BASELINE config 2; README.rst:122-126 verification method)."""
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    mesh = str(MESHES / "cube8_512e_6ss_s.exo")
    out = {"mesh": "cube8_512e_6ss_s.exo", "degrees": {}}
    for deg in (2, 3, 4):
        t0 = time.perf_counter()
        cfg = Config(problem="linElas", degree=deg, nu=0.3, E=1e6,
                     mesh_file=mesh, forcing="mms", test_mode=True)
        prob = ElasticityProblem(cfg)
        t_setup = time.perf_counter() - t0
        info = prob.solve()
        out["degrees"][str(deg)] = _info_dict(
            prob, info, t_setup, {"mms_rel_l2": prob.mms_error(info.u)})
    return out


def config3():
    """hyperSS on cylinder8_672e_2ss_us.exo, degree 3, 10 increments,
    clamped ends with translate on 998 (README.rst:63 example values)."""
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    t0 = time.perf_counter()
    # translate magnitude sized for the SMALL-strain model (hyperSS's
    # log(1 + tr eps) needs tr eps > -1; the README example values 0,-0.5,1
    # are finite-strain-sized and blow it up)
    cfg = Config(problem="hyperSS", degree=3, nu=0.3, E=1e6,
                 mesh_file=str(MESHES / "cylinder8_672e_2ss_us.exo"),
                 forcing="none", num_increments=10,
                 bc_clamp=(998, 999),
                 bc_clamp_translate={998: (0.0, -0.02, 0.05)})
    prob = ElasticityProblem(cfg)
    t_setup = time.perf_counter() - t0
    info = prob.solve()
    return _info_dict(prob, info, t_setup, {
        "mesh": "cylinder8_672e_2ss_us.exo",
        "flags": "-problem hyperSS -degree 3 -nu 0.3 -E 1e6 -num_steps 10 "
                 "-bc_clamp 998,999 -bc_clamp_998_translate 0,-0.02,0.05"})


def config4():
    """hyperFS on cyl-hole_3140e_2ss_us.exo, degree 4, clamp translate +
    rotate (BASELINE config 4). Runs in f64: the finite-strain twist
    Jacobian at degree 4 has a condition number f32 CG cannot solve to
    Newton-grade directions."""
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    cfg = Config(problem="hyperFS", degree=4, nu=0.3, E=1e6,
                 mesh_file=str(MESHES / "cyl-hole_3140e_2ss_us.exo"),
                 forcing="none", num_increments=10,
                 bc_clamp=(998, 999),
                 bc_clamp_translate={998: (0.0, 0.0, 0.2)},
                 bc_clamp_rotate={998: (0.0, 0.0, 1.0, 0.2)},
                 ksp_rtol=1e-10)
    prob = ElasticityProblem(cfg)
    t_setup = time.perf_counter() - t0
    info = prob.solve()
    return _info_dict(prob, info, t_setup, {
        "mesh": "cyl-hole_3140e_2ss_us.exo",
        "flags": "-problem hyperFS -degree 4 -nu 0.3 -E 1e6 -num_steps 10 "
                 "-bc_clamp 998,999 -bc_clamp_998_translate 0,0,0.2 "
                 "-bc_clamp_998_rotate 0,0,1,0.2"})


def main():
    which = sys.argv[1:] or ["1", "2", "3"]
    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)
    OUT.parent.mkdir(exist_ok=True)
    results = json.loads(OUT.read_text()) if OUT.exists() else {}
    fns = {"1": config1, "2": config2, "3": config3, "4": config4}
    for w in which:
        t0 = time.perf_counter()
        print(f"running config {w} ...", flush=True)
        results[f"config{w}"] = fns[w]()
        print(f"config {w} done in {time.perf_counter()-t0:.1f}s: "
              f"{json.dumps(results[f'config{w}'])[:200]}", flush=True)
        OUT.write_text(json.dumps(results, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()

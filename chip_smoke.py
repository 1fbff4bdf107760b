"""Smoke test of the Newton-p-multigrid solver on one NVIDIA GPU.

    python chip_smoke.py               # phases A-D on one card
    python chip_smoke.py --multichip   # phase E only, on four cards

Each phase checks the production path against an independent reference at
a stated tolerance and prints one line; a failed check ends the run with a
non-zero exit status. The phases:

  A  hyperFS degree 4 on a 24^3 box (2.74M DoF) through `cli.run`, the body
     of `python -m ceedpetscsolid_tpu.cli`: default p-multigrid with the
     native AMG coarse solve, f32. Converges, and its strain energy agrees
     with the same problem solved in f64 (CG rtol 1e-10) to 1e-5 relative;
     the CLI's MMS contract (rel-L2 < 0.05) holds for linElas at the same
     size (see phase_a for why not for hyperFS).
  B  residual, Jacobian action and stash of the production entity-row
     path (f32, IEEE matmuls) on a scrambled 36^3 box at degree 4 (9.1M
     DoF) against the plain per-node reference in f64: rel-L2 <= 1e-5.
  C  hyperFS degree 4 solve on a scrambled 24^3 box (unstructured path)
     against phase A's f32 solve on the canonical box (spectral path):
     strain energies (evaluated in f64) agree to 1e-5 relative.
  D  precision: compensated dot2 on 1e7 cancelling f32 entries against an
     f64 dot (relative error <= 10 u^2 cond), and IEEE-f32 matmuls under
     accurate_matmuls (phase B's residual on a 12^3 box within 1e-6 of
     f64) against the XLA default (TF32), which must read worse.
  E  (--multichip) one full distributed Newton step on four cards for the
     box slab, the scrambled unstructured box and the composite
     hyperFSIncomp operator: serial parity of the entry residual within
     1e-5 (a reproducibility bound: the sharded and serial pipelines sum
     in different orders) and a decreasing |G|.

The script refuses to run without a GPU. The last line of its output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
The phase functions take their sizes as arguments so the CPU tests
(tests/test_chip_smoke.py) run them at a tiny size.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ceedpetscsolid_tpu.mesh.box import box_mesh  # noqa: E402
from ceedpetscsolid_tpu.mesh.core import HexMesh  # noqa: E402


# ---------------------------------------------------------------------------
# Scrambled box mesh: the unstructured pipeline on a mesh whose exact
# answer is known (it is the canonical box, renumbered).
# ---------------------------------------------------------------------------
def _rotations() -> np.ndarray:
    """(24, 8) local-vertex maps of the 24 proper rotations of the unit
    cube: a rotated element's local vertex v is the old local vertex
    table[r, v] (tensor order v = i + 2j + 4k)."""
    corners = np.array([[v & 1, (v >> 1) & 1, (v >> 2) & 1]
                        for v in range(8)]) - 0.5
    out = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1, -1), repeat=3):
            R = np.zeros((3, 3))
            R[np.arange(3), perm] = signs
            if np.linalg.det(R) < 0:
                continue
            img = np.rint(corners @ R.T + 0.5).astype(int)
            out.append(img[:, 0] + 2 * img[:, 1] + 4 * img[:, 2])
    return np.array(out)


def scrambled_box(faces, seed: int = 0) -> HexMesh:
    """The canonical `box_mesh(faces)` with seeded vertex and element
    renumbering and a handedness-preserving local rotation per element
    (all 24 rotations occur once the mesh has 24 elements), so every edge
    and face orientation class occurs. Face sets are dropped: use it with
    whole-boundary (test-mode) Dirichlet conditions."""
    base = box_mesh(faces)
    rng = np.random.default_rng(seed)
    vnew = rng.permutation(base.num_vertices)       # old id -> new id
    verts = np.empty_like(base.vertices)
    verts[vnew] = base.vertices
    conn = vnew[base.connectivity][rng.permutation(base.num_elements)]
    rot = rng.permutation(np.arange(base.num_elements) % 24)
    conn = np.take_along_axis(conn, _rotations()[rot], axis=1)
    return HexMesh(vertices=verts, connectivity=conn)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _say(msg: str) -> None:
    print(msg, flush=True)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def energy64(fes, model, phys, u) -> float:
    """Strain energy of the nodal field u on `fes`, evaluated in f64.

    The hyperFS energy density cancels its first-order terms, so at MMS
    strains (~1e-6) an f32 evaluation carries ~1% noise; comparing the
    SOLUTIONS needs an f64 evaluation of both."""
    from ceedpetscsolid_tpu.ops.operator import OperatorFactory

    with jax.enable_x64(True):
        fac = OperatorFactory([fes], dtype=jnp.float64)
        fn = jax.jit(fac.make_energy(model.energy_qf, phys))
        return float(fn(jnp.asarray(np.asarray(u), jnp.float64),
                        fac.compute_qdata(), fac.fine.restr))


def _median_ms(fn, *args, reps=10) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


# ---------------------------------------------------------------------------
# Phase A: box solve through the CLI path
# ---------------------------------------------------------------------------
def phase_a(n: int = 24, degree: int = 4, steps: int = 2) -> dict:
    """hyperFS through `cli.run` in f32 and in f64, plus the CLI's MMS
    contract (test mode exits 0, silently) on linElas at the same size.

    The two solutions are compared by their strain energies, both evaluated
    in f64 (see energy64). The manufactured forcing is the reference's
    linElas one, whose law applies mu (not 2 mu) to the tensor shear strain
    (models/lin_elas.py), so a hyperFS solve sits a fixed ~7-8% (rel-L2)
    from the manufactured solution however fine the mesh: the MMS contract
    is defined for linElas only. The hyperFS MMS error is printed."""
    from ceedpetscsolid_tpu import cli

    def argv(problem):
        return ["-problem", problem, "-degree", str(degree),
                "-dm_plex_box_faces", f"{n},{n},{n}", "-E", "1", "-nu",
                "0.3", "-test", "-num_steps", str(steps)]

    out = {}
    for tag, x64 in (("f32", False), ("f64", True)):
        with jax.enable_x64(x64):
            args = argv("hyperFS") + (["-outer_ksp_rtol", "1e-10"]
                                      if x64 else [])
            t0 = time.perf_counter()
            _, prob, info = cli.run(args)
            cold = time.perf_counter() - t0
            _check(info.converged, f"A[{tag}]: not converged ({info.reason})")
            want = jnp.float64 if x64 else jnp.float32
            _check(prob.dtype == want and info.u.dtype == want
                   and prob.qdata.dtype == want,
                   f"A[{tag}]: arrays are {info.u.dtype}, want {want}")
            warm = prob.solve()            # same jitted programs: no compile
            _check(warm.converged, f"A[{tag}]: warm solve not converged")
            u = np.asarray(warm.u)
            out[tag] = dict(energy=prob.strain_energy(warm.u),
                            snes=warm.snes_iters, ksp=warm.ksp_iters,
                            solve_s=warm.solve_time, dofs=warm.dofs,
                            mms=prob.mms_error(warm.u))
        out[tag]["energy64"] = energy64(prob.fine_space, prob.model,
                                        prob.phys, u)
        if tag == "f32":
            out["box"] = dict(n=n, degree=degree, steps=steps,
                              energy64=out[tag]["energy64"])
        del prob, info, warm
        _say(f"compile[A-{tag}] {cold - out[tag]['solve_s']:.1f} s "
             "(cold cli run minus warm solve)")
    rel = abs(out["f32"]["energy64"] - out["f64"]["energy64"]) / abs(
        out["f64"]["energy64"])
    for tag in ("f32", "f64"):
        o = out[tag]
        _say(f"A[{tag}] hyperFS p={degree} box {n}^3 {o['dofs']} DoF: "
             f"SNES {o['snes']} KSP {o['ksp']} solve {o['solve_s']:.3f} s "
             f"(compile excluded) MMS rel-L2 {o['mms']:.3e} energy "
             f"{o['energy64']:.12e} (in f64; in {tag}: {o['energy']:.6e})")
    _say(f"A: strain energy f32 vs f64 solution rel {rel:.3e} (tol 1e-05)")
    _check(rel <= 1e-5, f"A: energy rel diff {rel:.3e} > 1e-5")
    # Jacobi-CG (-multigrid none): the contract is about the discrete
    # solution, and a third p-MG solver compile would cost minutes
    t0 = time.perf_counter()
    rc = cli.main(argv("linElas") + ["-multigrid", "none"])
    _say(f"A[linElas] cli test mode (-multigrid none) exit {rc} in "
         f"{time.perf_counter() - t0:.1f} s (includes compile; silent exit 0"
         " = MMS rel-L2 < 0.05)")
    _check(rc == 0, f"A: linElas MMS contract failed (exit {rc})")
    out["energy_rel"] = rel
    return out


# ---------------------------------------------------------------------------
# Phase B: unstructured residual / Jacobian vs the per-node f64 reference
# ---------------------------------------------------------------------------
def phase_b(n: int = 36, degree: int = 4, default_too: bool = False) -> dict:
    """Production entity-row path (default dtype, accurate matmuls) vs the
    plain per-node pipeline in f64 on the same random u, v (amplitude
    1e-3 / n). default_too also evaluates the production residual at the XLA
    default matmul precision (phase D)."""
    from ceedpetscsolid_tpu.mesh.fespace import build_fespace
    from ceedpetscsolid_tpu.models import Physics, get_model
    from ceedpetscsolid_tpu.ops.operator import OperatorFactory, default_dtype
    from ceedpetscsolid_tpu.ops.structured import StructuredRestriction
    from ceedpetscsolid_tpu.utils.precise import accurate_matmuls

    fes = build_fespace(scrambled_box((n, n, n)), degree)
    _check(fes.lattice_dims is None, "B: scrambled box took the lattice path")
    model = get_model("hyperFS")
    phys = Physics(nu=0.3, E=1.0)
    dtype = default_dtype()
    fac = OperatorFactory([fes], dtype=dtype)
    _check(isinstance(fac.fine.srestr, StructuredRestriction),
           "B: production factory is not on the entity-row path")
    lvl = fac.fine
    # amplitude 1e-3 of the element size h = 1/n: random nodal values make
    # |grad u| ~ amplitude * p^2 / h, and a fixed 1e-3 would drive det F
    # toward 0 (log J -> NaN) at some quadrature points of a fine mesh
    rng = np.random.default_rng(1)
    u64 = rng.standard_normal((3, fes.num_nodes)) * (1e-3 / n)
    v64 = rng.standard_normal((3, fes.num_nodes)) * (1e-3 / n)

    res = fac.make_residual_structured(model.residual_planes, phys)
    jac = fac.make_jacobian_structured(model.jacobian_planes, phys)

    def accurate(fn):
        def wrapped(*a):
            with accurate_matmuls():
                return fn(*a)
        return jax.jit(wrapped)

    res_j, jac_j = accurate(res), accurate(jac)
    with accurate_matmuls():
        qd = jax.jit(fac.compute_qdata)()
    u, v = jnp.asarray(u64, dtype), jnp.asarray(v64, dtype)
    t0 = time.perf_counter()
    compiled = res_j.lower(u, qd, lvl.srestr, lvl.sgrad).compile()
    t_compile = time.perf_counter() - t0
    r, stash = compiled(u, qd, lvl.srestr, lvl.sgrad)
    jv = jac_j(v, qd, stash, lvl.srestr, lvl.sgrad)
    t_res = _median_ms(compiled, u, qd, lvl.srestr, lvl.sgrad)
    t_jac = _median_ms(jac_j, v, qd, stash, lvl.srestr, lvl.sgrad)
    r, jv = np.asarray(r), np.asarray(jv)
    stash = np.stack([np.asarray(p) for p in stash.m])
    r_default = None
    if default_too:
        r_default = np.asarray(jax.jit(res)(u, qd, lvl.srestr, lvl.sgrad)[0])

    with jax.enable_x64(True):
        f64 = jnp.float64
        ref = OperatorFactory([fes], dtype=f64)
        qd_ref = jax.jit(ref.compute_qdata)()
        res_ref = jax.jit(ref.make_residual(model.residual_qf, phys))
        jac_ref = jax.jit(ref.make_jacobian(model.jacobian_qf, phys))
        r_ref, stash_ref = res_ref(jnp.asarray(u64, f64), qd_ref,
                                   ref.fine.restr)
        jv_ref = np.asarray(jac_ref(jnp.asarray(v64, f64), qd_ref, stash_ref,
                                    ref.fine.restr))
        r_ref = np.asarray(r_ref)
        stash_ref = np.stack([np.asarray(p) for p in stash_ref.m])

    out = dict(res=_rel(r, r_ref), jac=_rel(jv, jv_ref),
               stash=_rel(stash, stash_ref), dofs=3 * fes.num_nodes,
               nelem=fes.num_elements, compile_s=t_compile,
               res_ms=t_res, jac_ms=t_jac,
               memory=compiled.memory_analysis())
    if r_default is not None:
        out["res_default"] = _rel(r_default, r_ref)
    _say(f"compile[B] residual {t_compile:.1f} s")
    _say(f"B: memory_analysis(residual) {out['memory']}")
    _say(f"B[hyperFS p={degree} scrambled {n}^3, {fes.num_elements} elem, "
         f"{out['dofs']} DoF, {np.dtype(dtype).name} vs f64 per-node]: "
         f"rel-L2 residual {out['res']:.3e} jacobian {out['jac']:.3e} "
         f"stash {out['stash']:.3e} (tol 1e-05); row-path residual "
         f"{t_res:.3f} ms, jacobian {t_jac:.3f} ms (median of 10, "
         "block_until_ready)")
    for k in ("res", "jac", "stash"):
        _check(out[k] <= 1e-5, f"B: {k} rel-L2 {out[k]:.3e} > 1e-5")
    return out


# ---------------------------------------------------------------------------
# Phase C: unstructured solve vs the canonical (spectral) box solve
# ---------------------------------------------------------------------------
def phase_c(n: int = 24, degree: int = 4, steps: int = 2,
            multigrid: str = "logarithmic", box: dict | None = None) -> dict:
    """Scrambled-box solve against the canonical-box solve of the same
    problem, energies of both solutions evaluated in f64. `box` (phase A's
    f32 result, same n/degree/steps) stands in for the canonical solve, so
    the smoke compiles the solver once less."""
    from ceedpetscsolid_tpu.ops.operator import default_dtype
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    x64 = default_dtype() == jnp.float64
    out = {}
    cases = [("scrambled", scrambled_box((n, n, n)))]
    if box is None:
        cases.append(("box", None))
    else:
        _check((box["n"], box["degree"], box["steps"]) == (n, degree, steps),
               "C: phase A's box solve is a different problem")
        out["box"] = dict(energy64=box["energy64"], src="phase A")
    for tag, mesh in cases:
        # the CLI's f32/f64 tolerance pairing (cli.run)
        cfg = Config(problem="hyperFS", degree=degree, nu=0.3, E=1.0,
                     test_mode=True, box_faces=(n, n, n),
                     num_increments=steps, multigrid=multigrid,
                     ksp_rtol=1e-10 if x64 else 1e-6)
        if not x64:
            cfg.newton.rtol = 1e-6
        prob = ElasticityProblem(cfg, mesh=mesh)
        _check(prob.factory.use_spectral == (mesh is None),
               f"C[{tag}]: wrong hot path")
        t0 = time.perf_counter()
        info = prob.solve()
        cold = time.perf_counter() - t0
        _check(info.converged, f"C[{tag}]: not converged ({info.reason})")
        out[tag] = dict(energy64=energy64(prob.fine_space, prob.model,
                                          prob.phys, info.u),
                        snes=info.snes_iters, ksp=info.ksp_iters,
                        mms=prob.mms_error(info.u), src="solved here")
        _say(f"compile[C-{tag}] first solve {cold:.1f} s (includes compile)"
             f": SNES {info.snes_iters} KSP {info.ksp_iters} "
             f"MMS rel-L2 {out[tag]['mms']:.3e}")
    rel = abs(out["scrambled"]["energy64"] - out["box"]["energy64"]) / abs(
        out["box"]["energy64"])
    _say(f"C: hyperFS p={degree} {n}^3 strain energy (f64 evaluation) "
         f"scrambled {out['scrambled']['energy64']:.12e} vs box "
         f"{out['box']['energy64']:.12e} ({out['box']['src']}): rel "
         f"{rel:.3e} (tol 1e-05)")
    _check(rel <= 1e-5, f"C: energy rel diff {rel:.3e} > 1e-5")
    out["energy_rel"] = rel
    return out


# ---------------------------------------------------------------------------
# Phase D: compensated reductions and matmul precision
# ---------------------------------------------------------------------------
def cancelling_pair(n: int, cond: float, seed: int = 0):
    """f32 vectors whose dot has condition number ~cond
    (sum|a_i b_i| / |sum a_i b_i|). Returns (a, b, exact f64 dot, cond)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    scale = float(np.abs(a64 * b64).sum())
    # move the sum onto scale/cond through the largest |a_i| entry
    i = int(np.argmax(np.abs(a)))
    b[i] = np.float32(b64[i] + (scale / cond - a64 @ b64) / a64[i])
    exact = float(a.astype(np.float64) @ b.astype(np.float64))
    scale = float(np.abs(a.astype(np.float64) * b.astype(np.float64)).sum())
    return a, b, exact, scale / abs(exact)


def phase_d(n: int = 10_000_000, cond: float = 1e4,
            residual: dict | None = None, expect_tf32: bool = True) -> dict:
    """dot2 check, and the matmul-precision check on `residual` (a phase B
    output with res_default), by default phase B on a 12^3 scrambled box:
    at 36^3 the f32 geometry factors alone (vertex coordinates ~1 against
    elements 1/36 wide) cost ~1e-6 of the residual's accuracy."""
    from ceedpetscsolid_tpu.utils.precise import dot2_pair

    if residual is None:
        residual = phase_b(12, 4, default_too=True)

    a, b, exact, kappa = cancelling_pair(n, cond)
    hi, lo = jax.jit(dot2_pair)(jnp.asarray(a), jnp.asarray(b))
    got = float(np.float64(hi) + np.float64(lo))
    naive = float(jax.jit(jnp.vdot)(jnp.asarray(a), jnp.asarray(b)))
    u = 2.0 ** -24
    bound = 10 * u * u * kappa
    rel = abs(got - exact) / abs(exact)
    rel_naive = abs(naive - exact) / abs(exact)
    _say(f"D: dot2 n={n} cond={kappa:.3e} rel err {rel:.3e} "
         f"(bound 10u^2cond {bound:.3e}); plain f32 vdot {rel_naive:.3e}")
    _check(rel <= bound, f"D: dot2 rel err {rel:.3e} > {bound:.3e}")
    acc, dflt = residual["res"], residual["res_default"]
    _say(f"D: residual vs f64: accurate_matmuls {acc:.3e} (tol 1e-06), "
         f"XLA default {dflt:.3e} ({dflt / max(acc, 1e-300):.1f}x)")
    _check(acc <= 1e-6, f"D: accurate residual {acc:.3e} > 1e-6")
    if expect_tf32:
        _check(dflt > 10 * acc, "D: default matmuls read as accurate as "
               "IEEE f32 — not TF32?")
    return dict(dot2_rel=rel, dot2_bound=bound, cond=kappa, naive=rel_naive,
                accurate=acc, default=dflt)


# ---------------------------------------------------------------------------
# Phase E: distributed Newton step on four cards
# ---------------------------------------------------------------------------
def dist_step_parity(name, prob, ndev, devs):
    """One FULL distributed Newton step (halo exchange + p-MG CG + CP line
    search under shard_map) with serial parity of the entry residual and
    progress asserted. The sharded and serial pipelines sum in different
    orders (and a GPU segment_sum may use atomics), so the parity bound is
    a reproducibility bound: 1e-7 in f64, 1e-5 in f32."""
    from ceedpetscsolid_tpu.parallel.driver import DistributedProblem
    from ceedpetscsolid_tpu.utils.precise import dot2

    t0 = time.perf_counter()
    dp = DistributedProblem(prob, ndev=ndev, devices=devs)
    _check(len(dp.qdata_sh.sharding.device_set) == ndev,
           f"{name}: qdata is not sharded over {ndev} devices")
    u = dp.to_owned(np.zeros((3, prob.fine_space.num_nodes)))
    amg_data = dp.refresh_amg(u, 1.0) if dp.use_mg else None
    u1, rnorm_in, rnorm, iters, _step, _unorm = dp.newton_step(
        u, 1.0, amg_data=amg_data)
    jax.block_until_ready(u1)
    t_step = time.perf_counter() - t0

    u0 = jnp.zeros((3, prob.fine_space.num_nodes), prob.dtype)
    G, _ = prob._nonlinear_residual(u0, prob.bc_values(1.0), prob.F)
    rn_serial = float(jnp.sqrt(jnp.abs(dot2(G, G))))
    rel = abs(float(rnorm_in) - rn_serial) / max(rn_serial, 1e-30)
    tol = 1e-7 if prob.dtype == jnp.float64 else 1e-5
    _say(f"dist[{name}] ndev={ndev} {3 * prob.fine_space.num_nodes} DoF: "
         f"|G_in|={float(rnorm_in):.6e} -> |G_out|={float(rnorm):.6e}, "
         f"cg_iters={int(iters)}, serial_parity={rel:.2e} (tol {tol:g}), "
         f"slab={dp.slab is not None}, first step {t_step:.1f} s "
         "(includes compile)")
    _check(rel < tol, f"{name}: |G| serial parity {rel:.3e} > {tol}")
    _check(float(rnorm) < float(rnorm_in),
           f"{name}: Newton step made no progress")
    return rel


def phase_e(ndev: int = 4, sizes=((24, 4), (24, 3), (16, 3)),
            devs=None) -> None:
    """Jacobi-CG Newton steps: the sharded p-MG programs take minutes each
    to compile, and four cards cost four times as much."""
    from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

    devs = devs if devs is not None else jax.devices()[:ndev]
    _check(len(devs) == ndev, f"E: need {ndev} devices, have {len(devs)}")
    (nb, pb), (nu, pu), (nc, pc) = sizes

    def problem(n, degree, name="hyperFS", mesh=None):
        cfg = Config(problem=name, degree=degree, nu=0.3, E=1.0,
                     test_mode=True, box_faces=(n, n, n), num_increments=1,
                     multigrid="none")
        return ElasticityProblem(cfg, mesh=mesh)

    dist_step_parity("box-slab", problem(nb, pb), ndev, devs)
    dist_step_parity("unstructured",
                     problem(nu, pu, mesh=scrambled_box((nu, nu, nu))),
                     ndev, devs)
    dist_step_parity("composite", problem(nc, pc, "hyperFSIncomp"), ndev,
                     devs)


# ---------------------------------------------------------------------------
def _nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().replace("\n", " | ")


def _lap(name, phase, **kw):
    t0 = time.perf_counter()
    out = phase(**kw)
    _say(f"phase {name} wall {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only phase E, on four cards")
    args = ap.parse_args(argv)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r}); refusing to run")
    kind = devs[0].device_kind
    _say(f"device: {kind} x{len(devs)} | nvidia-smi: {_nvidia_smi()} | "
         f"jax {jax.__version__} | compile cache "
         f"{jax.config.jax_compilation_cache_dir} | XLA_FLAGS="
         f"{os.environ.get('XLA_FLAGS', '')!r}")
    t0 = time.perf_counter()
    if args.multichip:
        phase_e(4, devs=devs[:4])
    else:
        a = _lap("A", phase_a)
        _lap("B", phase_b)
        _lap("C", phase_c, box=a["box"])
        _lap("D", phase_d)
    _say(f"all phases passed in {time.perf_counter() - t0:.1f} s "
         f"on {kind} ({_nvidia_smi()})")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind, "count": len(devs)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Regression anchors: re-run the cheap BASELINE.md configurations and
assert the oracles (MMS rel-L2, strain energy, iteration counts — reference
elasticity.c:684-811) against the committed measurements in
results/BASELINE_RESULTS.json (produced by scripts/run_baselines.py).

Config 3 (hyperSS cylinder, ~6 min) runs only with CPSTPU_SLOW=1;
config 4 runs through scripts/validate_config4.py.
"""

import json
import os
from pathlib import Path

import pytest

from ceedpetscsolid_tpu.problem import Config, ElasticityProblem

RESULTS = Path(__file__).parent.parent / "results" / "BASELINE_RESULTS.json"
MESHES = Path("/root/reference/meshes")


@pytest.fixture(scope="module")
def anchors():
    if not RESULTS.exists():
        pytest.skip("no committed BASELINE_RESULTS.json")
    return json.loads(RESULTS.read_text())


def test_config1_regression(anchors):
    ref = anchors["config1"]
    cfg = Config(problem="linElas", degree=2, nu=0.3, E=1e6,
                 box_faces=(4, 4, 4), test_mode=True)
    prob = ElasticityProblem(cfg)
    info = prob.solve()
    assert info.converged
    assert abs(prob.mms_error(info.u) - ref["mms_rel_l2"]) \
        < 1e-6 + 1e-3 * ref["mms_rel_l2"]
    e = prob.strain_energy(info.u)
    assert abs(e - ref["strain_energy"]) < 1e-9 + 1e-6 * abs(ref["strain_energy"])
    assert info.ksp_iters <= ref["ksp_iters"] + 2
    assert info.snes_iters <= ref["snes_iters"] + 1


def test_config2_regression_deg3(anchors):
    ref = anchors["config2"]["degrees"]["3"]
    cfg = Config(problem="linElas", degree=3, nu=0.3, E=1e6,
                 mesh_file=str(MESHES / "cube8_512e_6ss_s.exo"),
                 forcing="mms", test_mode=True)
    prob = ElasticityProblem(cfg)
    info = prob.solve()
    assert info.converged
    err = prob.mms_error(info.u)
    assert abs(err - ref["mms_rel_l2"]) < 1e-9 + 1e-2 * ref["mms_rel_l2"]
    assert info.ksp_iters <= ref["ksp_iters"] + 2


def test_config2_convergence_rates(anchors):
    """MMS error must drop by >10x per degree (measured: 1.5e-4 -> 2.9e-6
    -> 4.8e-8 on cube8_512e, README.rst:122-126 verification method)."""
    degs = anchors["config2"]["degrees"]
    e2, e3, e4 = (degs[d]["mms_rel_l2"] for d in ("2", "3", "4"))
    assert e3 < e2 / 10
    assert e4 < e3 / 10


@pytest.mark.skipif(not os.environ.get("CPSTPU_SLOW"),
                    reason="config 3 takes ~6 min; set CPSTPU_SLOW=1")
def test_config3_regression(anchors):
    ref = anchors["config3"]
    cfg = Config(problem="hyperSS", degree=3, nu=0.3, E=1e6,
                 mesh_file=str(MESHES / "cylinder8_672e_2ss_us.exo"),
                 forcing="none", num_increments=10,
                 bc_clamp=(998, 999),
                 bc_clamp_translate={998: (0.0, -0.02, 0.05)})
    prob = ElasticityProblem(cfg)
    info = prob.solve()
    assert info.converged
    e = prob.strain_energy(info.u)
    assert abs(e - ref["strain_energy"]) < 1e-6 * abs(ref["strain_energy"])
    assert info.snes_iters <= ref["snes_iters"] + 3
    assert info.ksp_iters <= ref["ksp_iters"] * 1.1 + 10

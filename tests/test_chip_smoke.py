"""chip_smoke.py at a tiny size on the CPU.

Phases B, C and D run on a scrambled 3x3x3 box in f64: the entity-row
production path against the per-node reference, the unstructured solve
against the canonical-box solve, and the compensated dot. The script's
entry point must refuse a backend without a GPU. The `chip` test runs the
f32 checks of phases B and D on a GPU and skips elsewhere.
"""

import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from ceedpetscsolid_tpu.mesh.fespace import build_fespace  # noqa: E402
from ceedpetscsolid_tpu.ops.structured import StructuredMaps  # noqa: E402


@pytest.mark.parametrize("degree", [2, 3])
def test_chip_smoke_phases_on_cpu(degree, capsys):
    fes = build_fespace(chip_smoke.scrambled_box((3, 3, 3)), degree)
    assert fes.lattice_dims is None
    if degree >= 3:      # 1-node entities (p=2) have only identity perms
        maps = StructuredMaps(fes)
        assert len(maps.face_perms) > 1 and len(maps.edge_perms) > 1

    b = chip_smoke.phase_b(3, degree, default_too=True)
    assert max(b["res"], b["jac"], b["stash"]) < 1e-12
    chip_smoke.phase_d(100_000, residual=b, expect_tf32=False)
    c = chip_smoke.phase_c(3, degree, steps=1, multigrid="none")
    assert c["energy_rel"] < 1e-9

    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.chip
def test_f32_row_path_and_precision_on_gpu(gpu):
    with jax.enable_x64(False):
        chip_smoke.phase_d()

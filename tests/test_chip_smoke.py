"""chip_smoke.py: its phases at tiny sizes on the CPU, its refusal to run
without a GPU, and (marked `gpu`) its kernel phases at production widths
on the card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

TINY = {
    "destripe": lambda: cs.phase_destripe(shape=(2, 200, 240), n_ref=2),
    "lightsheet": lambda: cs.phase_lightsheet(shape=(256, 320)),
    "ncc": lambda: cs.phase_ncc(shape=(3, 40, 96), radius=6),
    "rl": lambda: cs.phase_rl(shapes=((32, 40, 48),)),
    "convs": lambda: cs.phase_convs(vol_shape=(24, 28, 32),
                                    tiles=(2, 64, 80)),
    "decon": lambda: cs.phase_decon(shape=(40, 160, 192), n_beads=200,
                                    extra=("--max-block-mvox", "2")),
    "planned_block": lambda: cs.phase_planned_block(vol_shape=(120, 300,
                                                               300)),
    "mesh_decon": lambda: cs.phase_mesh_decon(shape=(48, 256, 256),
                                              max_block_mvox=0.5),
    "sharded_rl": lambda: cs.phase_sharded_rl(shape=(96, 64, 64)),
}


@pytest.mark.parametrize("phase", sorted(TINY))
def test_phase_runs_tiny_on_cpu(phase):
    """Every phase's control flow, references and checks pass at a tiny
    size (the four-card phases on four of the virtual CPU devices)."""
    TINY[phase]()


def test_stitch_phase_recovers_offsets_on_cpu():
    cs.phase_stitch(tile=600, depth=8, grid=3, sigma=64, search=12)


def test_main_refuses_a_non_gpu_platform():
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_kernel_phases_at_production_width(gpu):
    cs.phase_destripe()
    cs.phase_rl()
    cs.phase_ncc()
    cs.phase_lightsheet()

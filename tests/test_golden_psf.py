"""Golden PSF suite: the reference's OWN psf_generator.py runs verbatim and
pins ipp_tpu.ops.psf.make_psf.

The reference has two PSF builders with identical math:
LsDeconvolveMultiGPU/LsMakePSF.m (MATLAB, used by LsDeconv) and
LsDeconvolveMultiGPU/psf_generator.py (Python, used by the FNT path).  The
Python one is runnable here, so it is the golden.  Both sample the Bessel
Born-Wolf integral on the first octant at the CORRECTED pitch
dxy_psf = min(dxy, Rxy/3) — LsDeconv.m:161 passes dxy_corr into LsMakePSF,
and generate_psf computes dxy_psf itself (psf_generator.py:100-111) — so
make_psf's default sampling pitch must be the corrected one.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import math

import numpy as np
import pytest

from tests.refshims import REF, install_shims

from ipp_tpu.ops.psf import make_psf

# coarse sheet + coarse steps keep the quad loops small (~300 integrals)
PARAMS = dict(NA=0.4, n=1.42, lambda_ex=488.0, lambda_em=525.0,
              fcyl=240.0, slitwidth=12.0, dxy=800.0, dz=4000.0)


@pytest.fixture(scope="module")
def ref_psf_gen():
    path = REF / "LsDeconvolveMultiGPU" / "psf_generator.py"
    if not path.exists():
        pytest.skip(f"reference {path} unavailable")
    install_shims()
    spec = importlib.util.spec_from_file_location("ref_psf_generator", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_point_eq_matches_reference(ref_psf_gen):
    """ls_psf_eq at scattered points (the innermost optics model)."""
    na_ls = math.sin(math.atan(0.5 * PARAMS["slitwidth"] / PARAMS["fcyl"]))
    from ipp_tpu.ops.psf import psf_value

    for (x, y, z) in [(0, 0, 0), (200, 0, 0), (0, 300, 0), (0, 0, 2500),
                      (150, 250, 1800), (700, 100, 5000)]:
        ref = ref_psf_gen.ls_psf_eq(
            x, y, z, PARAMS["NA"], PARAMS["n"], PARAMS["lambda_ex"],
            PARAMS["lambda_em"], na_ls)
        ours = psf_value(x, y, z, PARAMS["NA"], PARAMS["n"],
                         PARAMS["lambda_ex"], PARAMS["lambda_em"], na_ls)
        assert ref == pytest.approx(ours, rel=2e-3), (x, y, z)


def test_grid_size_and_fwhm_match_reference(ref_psf_gen):
    """determine_psf_size: same odd grid dims and FWHMs (ref fsolve vs our
    brentq must land on the same half-max crossing)."""
    res_xy = 0.61 * PARAMS["lambda_em"] / PARAMS["NA"]
    res_z = 2.0 * PARAMS["lambda_ex"] * PARAMS["n"] / PARAMS["NA"] ** 2
    dxy_psf = min(PARAMS["dxy"], res_xy / 3)
    nxy, nz, fwhm_xy, fwhm_z = ref_psf_gen.determine_psf_size(
        dxy_psf, PARAMS["dz"], PARAMS["NA"], PARAMS["n"],
        PARAMS["lambda_ex"], PARAMS["lambda_em"], PARAMS["fcyl"],
        PARAMS["slitwidth"], res_xy, res_z)
    ours, our_fwhm_xy, our_fwhm_z = make_psf(
        dxy=PARAMS["dxy"], dz=PARAMS["dz"], NA=PARAMS["NA"], n=PARAMS["n"],
        lambda_ex=PARAMS["lambda_ex"], lambda_em=PARAMS["lambda_em"],
        fcyl=PARAMS["fcyl"], slitwidth=PARAMS["slitwidth"])
    assert our_fwhm_xy == pytest.approx(fwhm_xy, rel=1e-3)
    assert our_fwhm_z == pytest.approx(fwhm_z, rel=1e-3)
    assert ours.shape == (nxy, nxy, nz)


def test_psf_volume_matches_reference(ref_psf_gen, capsys):
    """Full generate_psf vs make_psf: same grid, same values.  The
    reference returns (z, y, x); ours returns (x, y, z)."""
    with contextlib.redirect_stdout(io.StringIO()):
        ref, dxy_psf = ref_psf_gen.generate_psf(
            lambda_em=PARAMS["lambda_em"], lambda_ex=PARAMS["lambda_ex"],
            numerical_aperture=PARAMS["NA"], dxy=PARAMS["dxy"],
            dz=PARAMS["dz"], refractive_index=PARAMS["n"],
            f_cylinder_lens=PARAMS["fcyl"], slit_width=PARAMS["slitwidth"],
            gaussian_sgima=0, doubled_psf=False)
    ours, _, _ = make_psf(
        dxy=PARAMS["dxy"], dz=PARAMS["dz"], NA=PARAMS["NA"], n=PARAMS["n"],
        lambda_ex=PARAMS["lambda_ex"], lambda_em=PARAMS["lambda_em"],
        fcyl=PARAMS["fcyl"], slitwidth=PARAMS["slitwidth"])
    ours_zyx = np.transpose(ours, (2, 1, 0))
    assert ours_zyx.shape == ref.shape
    assert dxy_psf == pytest.approx(
        min(PARAMS["dxy"], 0.61 * PARAMS["lambda_em"] / PARAMS["NA"] / 3))
    nrmse = np.sqrt(np.mean((ours_zyx - ref) ** 2)) / ref.max()
    assert nrmse < 1e-3, nrmse


def test_data_pitch_mode_spans_two_fwhm():
    """sample_at_data_pitch=True sizes AND samples at the voxel pitch: the
    grid spans ~2 FWHM at dxy (the pycudadecon-resampling equivalent for
    the FNT path), so it is smaller than the corrected-pitch grid when
    dxy > Rxy/3."""
    fine, fwhm_xy, _ = make_psf(dxy=PARAMS["dxy"], dz=PARAMS["dz"],
                                NA=PARAMS["NA"], n=PARAMS["n"],
                                lambda_ex=PARAMS["lambda_ex"],
                                lambda_em=PARAMS["lambda_em"],
                                fcyl=PARAMS["fcyl"],
                                slitwidth=PARAMS["slitwidth"])
    coarse, _, _ = make_psf(dxy=PARAMS["dxy"], dz=PARAMS["dz"],
                            NA=PARAMS["NA"], n=PARAMS["n"],
                            lambda_ex=PARAMS["lambda_ex"],
                            lambda_em=PARAMS["lambda_em"],
                            fcyl=PARAMS["fcyl"],
                            slitwidth=PARAMS["slitwidth"],
                            sample_at_data_pitch=True)
    assert coarse.shape[0] < fine.shape[0]
    expected_n = math.ceil(2.0 * fwhm_xy / PARAMS["dxy"])
    expected_n += (expected_n + 1) % 2
    assert coarse.shape[0] == expected_n
    assert abs(coarse.sum() - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# seeded optics fuzz: random (NA, n, lambdas, pitches, cylinder lens)
# points vs the reference's generate_psf run verbatim — the grid-size
# solver (our brentq vs the reference's fsolve, psf_generator.py:100-152)
# and the Born-Wolf quadrature must agree across the optics envelope,
# not just the 15x preset
# ---------------------------------------------------------------------------


def _psf_fuzz_configs(n=5, seed=20260819):
    r = np.random.default_rng(seed)
    cfgs = []
    for _ in range(n):
        lam_ex = float(r.choice([405.0, 488.0, 561.0, 642.0]))
        cfgs.append(dict(
            NA=float(r.uniform(0.25, 0.8)),
            n=float(r.choice([1.33, 1.42, 1.52])),
            lambda_ex=lam_ex,
            lambda_em=lam_ex + float(r.uniform(20.0, 60.0)),
            fcyl=float(r.choice([160.0, 240.0, 320.0])),
            slitwidth=float(r.uniform(8.0, 14.0)),
            # coarse pitches keep the reference quad loops small
            dxy=float(r.uniform(600.0, 1000.0)),
            dz=float(r.uniform(3000.0, 5000.0)),
        ))
    return cfgs


@pytest.mark.parametrize("p", _psf_fuzz_configs())
def test_psf_volume_golden_fuzz(ref_psf_gen, p):
    with contextlib.redirect_stdout(io.StringIO()):
        ref, dxy_psf = ref_psf_gen.generate_psf(
            lambda_em=p["lambda_em"], lambda_ex=p["lambda_ex"],
            numerical_aperture=p["NA"], dxy=p["dxy"], dz=p["dz"],
            refractive_index=p["n"], f_cylinder_lens=p["fcyl"],
            slit_width=p["slitwidth"], gaussian_sgima=0, doubled_psf=False)
    ours, _, _ = make_psf(
        dxy=p["dxy"], dz=p["dz"], NA=p["NA"], n=p["n"],
        lambda_ex=p["lambda_ex"], lambda_em=p["lambda_em"],
        fcyl=p["fcyl"], slitwidth=p["slitwidth"])
    ours_zyx = np.transpose(ours, (2, 1, 0))
    assert ours_zyx.shape == ref.shape, (p, ours_zyx.shape, ref.shape)
    assert dxy_psf == pytest.approx(
        min(p["dxy"], 0.61 * p["lambda_em"] / p["NA"] / 3))
    nrmse = np.sqrt(np.mean((ours_zyx - ref) ** 2)) / ref.max()
    assert nrmse < 1e-3, (nrmse, p)

"""FNT cube deconvolution — the fnt_cube_processor equivalent.

(reference fnt_cube_processor.py:30-388: deconvolve FNT .nrrd cubes with
pycudadecon GPU RL, PSF from the LsDeconv optics model, padding to
2,3,5,7-smooth FFT dims, optional destriping/gaussian, GPU semaphore
queue.)

Here: cubes stream through the batched RL kernel; the PSF comes from
ipp_tpu.ops.psf.make_psf; FFT dims are already smooth via fft_shape_for.
The reference surface carries over: --gaussian sigma (pre-filter, and —
via --dg-iteration — re-applied every N RL iterations, its
num_gaussian_decons cadence), --background (number or 'auto'),
--contrast-enhancement-factor (pre-division), --destripe (the rot90
axial destripe, fnt_cube_processor.py:245-251), --no-deconvolution, and
the optics flags (--nimm, --wavelength-ex/-em, --f-cylinder-lens,
--slit-width).  The reference's --doubled_psf selects a special
pre-built OTF file; pass the equivalent PSF volume via --psf-file.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from ..io.nrrd import read_nrrd, write_nrrd
from ..ops.deconv import fft_shape_for, richardson_lucy
from ..ops.destripe import filter_streaks
from ..ops.psf import make_psf
from ..utils.jaxconfig import enable_persistent_cache
from ..utils.log import Logger
from ..utils.progress import ProgressReporter

__all__ = ["process_cubes", "main"]


def process_cubes(
    input_dir,
    output_dir,
    voxel_um: Tuple[float, float, float] = (1.0, 0.4, 0.4),
    na: float = 0.4,
    refractive_index: float = 1.42,
    lambda_ex: float = 488.0,
    lambda_em: float = 525.0,
    fcyl: float = 80000.0,
    slitwidth: float = 12000.0,
    niter: int = 10,
    destripe_sigma: float = 0.0,
    axial_destripe: bool = False,
    dark: Union[float, str] = 0.0,
    gaussian_sigma: float = 0.0,
    dg_iteration: int = 0,
    contrast_enhancement_factor: float = 1.0,
    deconvolve: bool = True,
    psf_file: Optional[Path] = None,
    doubled_psf: bool = False,
    resume: bool = False,
    log: Optional[Logger] = None,
) -> int:
    enable_persistent_cache()
    import jax.numpy as jnp

    from ..ops.deconv import gauss3d

    log = log or Logger()
    input_dir = Path(input_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    cubes = sorted(input_dir.rglob("*.nrrd"))
    if not cubes:
        raise FileNotFoundError(f"no .nrrd cubes under {input_dir}")
    psf_zyx = None
    if deconvolve:
        if psf_file is not None:
            # custom PSF volume (the reference's --doubled_psf picks a
            # pre-built OTF file the same way)
            p = Path(psf_file)
            psf_zyx = (np.load(p) if p.suffix == ".npy"
                       else np.asarray(__import__(
                           "ipp_tpu.io.tiff", fromlist=["read_tiff_stack"]
                       ).read_tiff_stack(p)))
            psf_zyx = psf_zyx.astype(np.float32)
            psf_zyx /= psf_zyx.sum()
            log.info(f"custom PSF {psf_zyx.shape} from {p}")
        else:
            # sample at the cube's own voxel pitch: our RL convolves the
            # PSF directly on the data grid, which is what pycudadecon's
            # internal OTF-to-data-grid resampling achieves for the
            # reference (fnt_cube_processor.py:201-222 passes dxpsf
            # separately from dxdata)
            psf, fwhm_xy, fwhm_z = make_psf(
                dxy=voxel_um[1] * 1000.0, dz=voxel_um[0] * 1000.0, NA=na,
                n=refractive_index, lambda_ex=lambda_ex,
                lambda_em=lambda_em, fcyl=fcyl, slitwidth=slitwidth,
                sample_at_data_pitch=True)
            psf_zyx = np.transpose(psf, (2, 1, 0))
            if doubled_psf:
                # camera "doubling" artifact PSF: the reference stacks
                # the sampled PSF twice along z and renormalizes
                # (psf_generator.py:186-195)
                psf_zyx = np.concatenate([psf_zyx, psf_zyx], axis=0)
                psf_zyx /= psf_zyx.sum()
            log.info(f"PSF {psf_zyx.shape}, FWHM xy {fwhm_xy:.0f} nm "
                     f"z {fwhm_z:.0f} nm")
    prog = ProgressReporter(len(cubes), desc="cubes")
    done = 0

    # one cube in flight: cube k's result streams device->host while
    # cube k+1 reads/uploads/dispatches (the reference overlaps via its
    # GPU semaphore worker pool instead, fnt_cube_processor.py:227-388)
    from ..utils.lagged import OneInFlight

    lag = OneInFlight()

    def _finalize(item):
        nonlocal done
        out_path_f, header_f, in_dtype_f, dec_f = item
        dec_f = np.asarray(dec_f)
        if np.issubdtype(in_dtype_f, np.integer):
            info = np.iinfo(in_dtype_f)
            dec_f = np.clip(np.rint(dec_f), info.min, info.max)
        write_nrrd(out_path_f, dec_f.astype(in_dtype_f), extra_header={
            k: v for k, v in header_f.items()
            if k in ("space", "space directions", "space origin")})
        done += 1
        prog.step()

    for cube_path in cubes:
        out_path = output_dir / cube_path.relative_to(input_dir)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        if resume and out_path.exists():
            prog.step()
            continue
        vol, header = read_nrrd(cube_path)
        in_dtype = vol.dtype
        x = jnp.asarray(vol, jnp.float32)
        dark_val = dark
        if isinstance(dark, str):
            # 'auto' background (reference --background auto): the cube's
            # modal/low-end intensity
            dark_val = float(np.percentile(vol, 1.0))
        if dark_val and dark_val > 0:
            x = jnp.maximum(x - dark_val, 0.0)
        if contrast_enhancement_factor and contrast_enhancement_factor != 1:
            x = x / contrast_enhancement_factor
        if gaussian_sigma > 0:
            x = gauss3d(x, gaussian_sigma)
        if axial_destripe:
            # the reference's axial destripe: rot90 on (y, x), per-plane
            # db9 bidirectional sigma (1,1), rot90 back
            # (fnt_cube_processor.py:245-251)
            xr = jnp.rot90(x, k=1, axes=(1, 2))
            xr = filter_streaks(xr, sigma=(1.0, 1.0), wavelet="db9",
                                bidirectional=True)
            x = jnp.rot90(xr, k=-1, axes=(1, 2))
        elif destripe_sigma > 0:
            x = filter_streaks(x, sigma=(destripe_sigma,) * 2)
        if deconvolve:
            fft_shape = fft_shape_for(x.shape, psf_zyx.shape)
            psf_j = jnp.asarray(psf_zyx)
            if gaussian_sigma > 0 and 0 < dg_iteration < niter:
                # the reference's cadence: deconvolve in dg_iteration
                # chunks with the USER's gaussian applied between chunks
                # (apply_deconvolution n_iters//num_gaussian_decons +
                # gaussian(img, sigma), fnt_cube_processor.py:202-251)
                dec = x
                remaining = niter
                while remaining > 0:
                    step_n = min(dg_iteration, remaining)
                    dec = richardson_lucy(dec, psf_j, niter=step_n,
                                          fft_shape=fft_shape)
                    remaining -= step_n
                    if remaining > 0:
                        dec = gauss3d(dec, gaussian_sigma)
            else:
                dec = richardson_lucy(x, psf_j, niter=niter,
                                      fft_shape=fft_shape)
        else:
            dec = x
        prev = lag.put((out_path, header, in_dtype, dec), dec)
        if prev is not None:
            _finalize(prev)
    for item in lag.flush():
        _finalize(item)
    prog.close()
    return done


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="deconvolve FNT .nrrd cubes")
    p.add_argument("--input", "-i", required=True, type=Path)
    p.add_argument("--output", "-o", required=True, type=Path)
    p.add_argument("--voxel", type=float, nargs=3, default=(1.0, 0.4, 0.4),
                   metavar=("Z", "Y", "X"))
    p.add_argument("--dxy", "-dxy", type=float, default=None,
                   help="xy pitch in um (reference flag; overrides "
                        "--voxel y/x)")
    p.add_argument("--dz", "-dz", type=float, default=None,
                   help="z pitch in um (reference flag)")
    p.add_argument("--na", "-na", type=float, default=0.4)
    p.add_argument("--nimm", "-im", "--rf", dest="nimm", type=float,
                   default=1.42, help="immersion refractive index")
    p.add_argument("--wavelength-ex", "--wavelength_ex", "-ex", type=float,
                   default=488.0)
    p.add_argument("--wavelength-em", "--wavelength_em", "-em", type=float,
                   default=525.0)
    p.add_argument("--f-cylinder-lens", "--f_cylinder_lens", "-fc",
                   type=float, default=80000.0)
    p.add_argument("--slit-width", "--slit_width", "-dw", type=float,
                   default=12000.0)
    p.add_argument("--niter", "--n_iters", "-it", dest="niter", type=int,
                   default=10)
    p.add_argument("--dark", "--background", "-b", dest="dark",
                   default="0",
                   help="background to subtract (number, or 'auto')")
    p.add_argument("--gaussian", "-g", type=float, default=0.0,
                   help="3D gaussian sigma; 0 disables")
    p.add_argument("--dg-iteration", "--dg_interation", "-dgi",
                   dest="dg_iteration", type=int, default=0,
                   help="re-apply the gaussian every N RL iterations")
    p.add_argument("--contrast-enhancement-factor",
                   "--contrast_enhancement_factor", "-cef", type=float,
                   default=1.0)
    p.add_argument("--destripe", "-ds", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="axial destripe (rot90 + db9 sigma 1, the "
                        "reference semantics; fnt_cube_processor.py:335)")
    p.add_argument("--destripe-sigma", type=float, default=0.0,
                   help="plain per-plane destripe at this sigma")
    p.add_argument("--deconvolution", "-d", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="apply deconvolution (reference flag surface: "
                        "--deconvolution / --no-deconvolution, "
                        "fnt_cube_processor.py:337)")
    p.add_argument("--psf-file", type=Path, default=None,
                   help="custom PSF volume (.npy or multi-page .tif)")
    p.add_argument("--doubled_psf", "-dpsf", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="z-doubled PSF for the camera doubling artifact "
                        "(reference fnt_cube_processor.py:385, "
                        "psf_generator.py:186-195)")
    p.add_argument("--resume", action="store_true")
    # accepted for reference compatibility and ignored: cubes stream
    # through one device with a lagged fetch instead of a GPU worker
    # pool (fnt_cube_processor.py:227-388)
    p.add_argument("--num_processes", "-n", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--threads_per_gpu", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--exclude_gpus", nargs="+", default=None,
                   help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    voxel = list(args.voxel)
    if args.dz is not None:
        voxel[0] = args.dz
    if args.dxy is not None:
        voxel[1] = voxel[2] = args.dxy
    dark: Union[float, str] = args.dark
    if isinstance(dark, str) and dark.lower() != "auto":
        dark = float(dark)
    process_cubes(
        args.input, args.output, tuple(voxel), na=args.na,
        refractive_index=args.nimm, lambda_ex=args.wavelength_ex,
        lambda_em=args.wavelength_em, fcyl=args.f_cylinder_lens,
        slitwidth=args.slit_width, niter=args.niter, dark=dark,
        gaussian_sigma=args.gaussian, dg_iteration=args.dg_iteration,
        contrast_enhancement_factor=args.contrast_enhancement_factor,
        axial_destripe=args.destripe,
        destripe_sigma=args.destripe_sigma,
        deconvolve=args.deconvolution,
        psf_file=args.psf_file, doubled_psf=args.doubled_psf,
        resume=args.resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())

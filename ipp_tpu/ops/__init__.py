"""Device kernels (JAX/XLA)."""

from . import deconv, destripe, fftutil, intensity, lightsheet, ncc  # noqa: F401
from . import process, psf, resample, stats, wavelets  # noqa: F401

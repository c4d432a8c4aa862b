"""Compile-cache placement and the precision of the lightsheet resize."""

from pathlib import Path

import numpy as np

from ipp_tpu.utils import jaxconfig

REPO = Path(__file__).resolve().parent.parent


def test_cache_dir_follows_jax_compilation_cache_dir(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the cache lives there and the
    program sets no directory of its own."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    target = tmp_path / "xla"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
    assert jaxconfig.cache_dir() == target
    jaxconfig.enable_persistent_cache()
    assert target.is_dir()
    assert jax.config.jax_compilation_cache_dir == before


def test_default_cache_dir_is_fixed_inside_the_checkout(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxconfig.cache_dir() == REPO / ".jax_cache"
    jaxconfig.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_resize_linear_mm_matches_scipy_zoom_at_u16_scale(rng):
    """The two-matmul linear resize of the lightsheet fields equals
    scipy.ndimage.zoom(order=1) on u16-scale values to well under a
    count (full float32 matmuls, never a reduced-precision pass)."""
    import jax.numpy as jnp
    from scipy.ndimage import zoom

    from ipp_tpu.ops.lightsheet import _resize_linear_mm

    vals = rng.random((2, 7, 9)) * 65535.0
    out = np.asarray(_resize_linear_mm(jnp.asarray(vals, jnp.float32),
                                       (50, 61)))
    ref = np.stack([zoom(v, (50 / 7, 61 / 9), order=1) for v in vals])
    assert out.shape == ref.shape == (2, 50, 61)
    np.testing.assert_allclose(out, ref, atol=0.02)

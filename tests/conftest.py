"""Test configuration: JAX on an 8-virtual-device CPU mesh.

The platform follows JAX_PLATFORMS when it is set (the tier-1 command sets
it to cpu) and is the CPU otherwise.  Tests marked `gpu` need the card:
run them there with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`;
elsewhere the `gpu` fixture skips them."""

import os

os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ipp_tpu.utils.jaxconfig import enable_persistent_cache  # noqa: E402

enable_persistent_cache()


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


@pytest.fixture()
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev

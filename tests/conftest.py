"""Test configuration: force a virtual 8-device CPU mesh before JAX import.

Multi-device sharding tests run on forced host devices (the standard way to
test multi-device JAX code without a cluster; SURVEY.md section 4 item 6).

Tests marked `gpu` need an NVIDIA GPU and skip elsewhere.  They run on the
card with

    FALCON_R1CS_TEST_GPU=1 python -m pytest tests/ -m gpu

which leaves JAX on its default platform instead of the CPU.
"""

import os

if os.environ.get("FALCON_R1CS_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax
import numpy as np
import pytest

from falcon_r1cs_tpu.falcon import make_instance
from falcon_r1cs_tpu.params import FALCON_512, FALCON_1024
from falcon_r1cs_tpu.utils.compile_cache import configure_compile_cache

configure_compile_cache()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260816)


@pytest.fixture(scope="session")
def inst_512(rng):
    return make_instance(rng, FALCON_512)


@pytest.fixture(scope="session")
def inst_1024(rng):
    return make_instance(rng, FALCON_1024)


@pytest.fixture()
def gpu():
    """Skip unless JAX's default platform is an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (FALCON_R1CS_TEST_GPU=1 on the card)")

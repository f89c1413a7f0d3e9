"""The threefry layout of repro_torch's draws in the CPU parity tests.

The port draws in JAX's partitionable layout unless told otherwise; JAX's
default depends on its version (``jax_threefry_partitionable`` is ``False``
up to 0.4 and ``True`` from 0.5). A test module that holds the port's draws
against the reference's imports this fixture, which sets the port's layout
to the one JAX runs with for the module and restores it after.
"""
import jax
import pytest

from repro_torch.utils import prng


@pytest.fixture(autouse=True, scope="module")
def prng_layout():
    with prng.threefry_partitionable(jax.config.jax_threefry_partitionable):
        yield

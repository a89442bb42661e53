"""Test configuration.

Forces the CPU backend with 8 virtual devices BEFORE any backend is
initialized, so sharding tests run without a GPU. Tests that need the card
carry the ``gpu`` marker and decide inside a fixture whether one exists;
they run on the GPU with ``SASSY_TESTS_GPU=1 pytest -m gpu``.
"""

import os

if os.environ.get("SASSY_TESTS_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bounded_jit_state():
    """Drop accumulated executables at every test-module boundary.

    A single full-lane process compiles hundreds of XLA CPU programs
    across ~25 modules; with all of them live, the CPU client's JIT
    eventually segfaults inside backend_compile (observed repeatedly at
    tests/test_sharded.py after ~180 prior tests, while the same module
    is green in a fresh process). Clearing the jit caches and the
    framework's executable memos bounds live-program count; modules
    recompile what they need."""
    yield
    import jax

    from sassy_tpu.ops import batch as _b

    _b._BATCH_JIT.clear()
    _b._SCALAR_MEMO.clear()
    jax.clear_caches()

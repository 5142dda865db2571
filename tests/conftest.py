"""Test harness configuration.

All tests run on a virtual 8-device CPU mesh so multi-device sharding logic
is exercised without accelerators. Environment must be set before jax is
imported anywhere.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and skip on the CPU
(the ``_gpu_only`` fixture decides, at run time). On a machine with a card:
``SGE_TEST_DEVICE=gpu python -m pytest tests -m gpu``.
"""

import os

if os.environ.get("SGE_TEST_DEVICE") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from swift_game_engine_tpu.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_default_matmul_precision", "float32")
# Persistent compile cache: re-compiling every eager op per pytest worker
# dominates test time without it.
enable_compile_cache(min_compile_secs=0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "fast: quick iteration subset (`pytest -m fast`, < 5 min): "
        "math/pose/queries/assets oracles — no Pallas interpret mode, no "
        "subprocess fan-out, no full-scene builds")
    config.addinivalue_line(
        "markers",
        "slow: multi-minute tests (subprocess renders, soak runs); "
        "excluded from -m fast by definition")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (compiled Triton kernel); skips on the CPU. "
        "Run with SGE_TEST_DEVICE=gpu python -m pytest tests -m gpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests when JAX has no GPU (decided per test at
    run time, never at import)."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU: the Triton kernel has no CPU "
                        "compile path")

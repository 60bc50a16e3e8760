"""Test configuration: the CPU with 8 virtual devices, unless asked otherwise.

Mirrors the survey's multi-chip test plan (SURVEY.md §4): a
``jax.sharding`` mesh over virtual CPU devices is the "fake multi-node"
fixture; sharded runs are compared against single-device runs.

``JAX_PLATFORMS`` picks the backend when it is set; unset, the tests run on
the CPU.  Tests marked ``gpu`` need a GPU and skip elsewhere; run them on a
GPU machine with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

# the repository root, for the scripts the tests drive (chip_smoke, bench)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)
# f64-on-CPU verification mode (SURVEY.md §7 hard part 5): tests may build
# float64 grids to check discrete identities to machine precision.
jax.config.update("jax_enable_x64", True)
# The persistent compilation cache stays off in test processes, even where
# JAX_COMPILATION_CACHE_DIR is set, so that concurrent test workers neither
# write nor load cached executables: every test compiles what it runs.  On
# the GPU the cache works, bfloat16 scan programs included; the programs
# use it there (breeze_tpu.backend.enable_compile_cache).
jax.config.update("jax_enable_compilation_cache", False)


def pytest_addoption(parser):
    parser.addoption(
        "--nightly", action="store_true", default=False,
        help="run the nightly tier (example --check physics runs and "
             "validation smokes) in addition to the default suite")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "nightly: long-running physics-assertion tier (example --check "
        "runs, validation smokes); deselected unless --nightly is given")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips elsewhere (run with JAX_PLATFORMS=cuda "
        "python -m pytest -m gpu tests/)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip a ``gpu``-marked test unless JAX runs on a GPU (decided when the
    test runs, never at import)."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs a GPU")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--nightly"):
        return
    skip = pytest.mark.skip(
        reason="nightly tier — run with --nightly (or ./runtests.sh --nightly)")
    for item in items:
        if "nightly" in item.keywords:
            item.add_marker(skip)

"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The JAX platform is pinned through the config (not only the environment)
before any backend is initialized.  ``NEEDLETAIL_TEST_PLATFORM=gpu`` leaves
JAX on its default accelerator instead: ``chip_smoke.py`` sets it to run
the ``gpu``-marked tests on the card.  Those tests decide inside a fixture
whether a GPU is present and skip otherwise.
"""

import os

import pytest

_ON_GPU = os.environ.get("NEEDLETAIL_TEST_PLATFORM") == "gpu"

if not _ON_GPU:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import pathlib
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

DATA_DIR = REPO_ROOT / "tests" / "data"
SPECIMEN_DIR = REPO_ROOT / "tests" / "specimen"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA_DIR


@pytest.fixture(scope="session")
def specimen_dir() -> pathlib.Path:
    return SPECIMEN_DIR


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, so
    every pytest worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return jax.devices()[0]

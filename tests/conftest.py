import os
import sys

import pytest

# src/ layout import without install (+ repo root for benchmarks/,
# tests/ for the shared _hypothesis_shim helper)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))


def pytest_addoption(parser):
    parser.addoption(
        "--sanitize", action="store_true", default=False,
        help="sanitizer-hardened mode (DESIGN.md §10): enables the "
             "@pytest.mark.sanitize tests (transfer-guard, leak-check, "
             "debug-nans) and sets jax_numpy_rank_promotion=raise "
             "process-wide so silent broadcasts fail loudly")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "sanitize: sanitizer-harness test, runs only with --sanitize")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips (inside the test) when CUDA is absent")
    if config.getoption("--sanitize"):
        import jax
        jax.config.update("jax_numpy_rank_promotion", "raise")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--sanitize"):
        return
    skip = pytest.mark.skip(reason="sanitizer harness: run with --sanitize")
    for item in items:
        if "sanitize" in item.keywords:
            item.add_marker(skip)

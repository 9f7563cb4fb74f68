"""Fixtures of the benchmark's CPU tests (``portbench_tiny``)."""

import pytest

from portbench_tiny import make_tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> str:
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))

"""Set-up of the benchmark's CPU tests: the checkout's root and ``src`` on
the path, and a tiny checkout (:mod:`_recbench_tiny`) for each module."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT), str(Path(__file__).resolve().parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from _recbench_tiny import make_root  # noqa: E402


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("recbench"))

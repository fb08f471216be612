"""The benchmark's own tests: on the CPU at a tiny scale, but for the
`chip` tests, which need a CUDA card and skip without one.

    python -m pytest portbench/tests -q
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_SF = 0.002


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    """The card; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """A configuration by name, cut to TINY_SF."""
    from portbench import registry

    def load(name):
        cfg = registry.config(name)
        cfg["scale_factor"] = TINY_SF
        return cfg
    return load

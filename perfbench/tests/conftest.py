"""perfbench's own tests: `python -m pytest perfbench/tests -q` from the
repository root. Those marked `card` need a CUDA card and skip without
one (decided inside the test, by the `card` fixture); on the card:
`python -m pytest perfbench/tests -q -m card`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

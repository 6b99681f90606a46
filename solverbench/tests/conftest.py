"""Markers of the benchmark's own tests (run them from the checkout's root:
`python -m pytest solverbench/tests -q`; the card's: the same on the chip)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")

"""The benchmark's own tests: CPU at test scale, and (marked ``cuda``) on
the card. Run from the repository root: ``python -m pytest portbench/tests``.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")

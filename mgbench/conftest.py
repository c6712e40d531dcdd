"""pytest settings of the benchmark's own tests (mgbench/tests).

Run them from the checkout's root: `python -m pytest mgbench/tests -q`.
A test marked `card` needs an NVIDIA card and skips without one; on the
card, `python -m pytest mgbench/tests -q -m card` runs those alone."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (decided inside the test)")

"""Settings of the benchmark's own tests (run with
`python -m pytest portbench/tests`): the `cuda` marker, and the path of
the repository root."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (runs the cell on the card)")

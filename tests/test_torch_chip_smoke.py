"""``chip_smoke.py`` refuses to run, and prints no result, without a card
or outside a checkout of the repository."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent


def _run(cwd, script):
    return subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                          text=True, timeout=120)


def test_fails_alone_in_a_directory(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", script)
    res = _run(tmp_path, script)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run(ROOT, ROOT / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

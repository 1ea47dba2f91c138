"""chip_smoke.py off the card: it refuses to run without a GPU, and its
parity phase passes at a tiny size on CPU (the real run, on the GPU,
is `python chip_smoke.py`)."""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from sdvpcmdecoder_tpu.ops import stitch_native as sn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where,args", [
    ("repo", []), ("repo", ["--four-cards"]), ("alone", [])])
def test_refuses_without_gpu(tmp_path, where, args):
    """No GPU (JAX_PLATFORMS=cpu), or no package beside the script:
    non-zero exit and no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script, *args], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_phase_device_refuses_cpu():
    with pytest.raises(SystemExit, match="not a GPU"):
        cs.phase_device(1)


def test_check_equal_reports_first_difference():
    a = np.arange(12).reshape(3, 4)
    cs.check_equal("same", a, a.copy())
    b = a.copy()
    b[2, 1] += 1
    with pytest.raises(AssertionError, match=r"\[\[2, 1\]\]"):
        cs.check_equal("one word", b, a)
    with pytest.raises(AssertionError, match="shapes"):
        cs.check_equal("shape", a[:2], a)


@pytest.mark.skipif(not sn.available(), reason="native core unavailable")
def test_parity_phase_tiny(capsys):
    """Phase 2 at 2 frames: the trial grid, P/Q correction and PCM
    rounds equal the native and numpy references, and the noisy round
    takes the fallback trials and both correction branches."""
    cs.phase_parity(n_frames=2, n_numpy=16)
    out = capsys.readouterr().out
    assert out.count("[parity]") == 8
    fixed = re.search(r"noise 30: correct_blocks.*14-bit: \d+ blocks, "
                      r"(\d+) fixed by P, (\d+) by Q", out)
    assert int(fixed[1]) > 0 and int(fixed[2]) > 0

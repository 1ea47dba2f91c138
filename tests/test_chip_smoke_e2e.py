"""chip_smoke.py's end-to-end, timing and four-card phases at tiny sizes
on the suite's virtual CPU devices: the WAV-identity and comparison
logic the GPU run relies on."""
import jax
import pytest

import chip_smoke as cs
from sdvpcmdecoder_tpu.ops import stitch_native as sn

pytestmark = pytest.mark.skipif(not sn.available(),
                                reason="native core unavailable")


def test_e2e_phase_tiny(tmp_path, capsys):
    cs.phase_e2e("cpu", str(tmp_path), cli_frames=6, fleet=(2, 4),
                 pcm=(2, 3))
    out = capsys.readouterr().out
    assert "--backend device WAV == --backend native WAV" in out
    assert out.count("WAVs identical") == 3
    assert out.count("(1 at noise 30)") == 3
    assert "'native_tail'" in out or "'stage_machine'" in out


def test_timings_phase_tiny(capsys):
    cs.phase_timings("cpu", cs.stc007_round(2, 10.0, 1), n=1)
    assert "whole steady_round_packed" in capsys.readouterr().out


def test_four_cards_phase_on_virtual_devices(tmp_path, capsys):
    devs = jax.devices()[:4]
    assert len(devs) == 4
    cs.phase_four_cards(devs, "cpu", str(tmp_path), n_caps=4, n_frames=3,
                        mesh_chunk=112)
    out = capsys.readouterr().out
    assert "over 4 cards" in out and "(2 data x 2 seq) mesh" in out

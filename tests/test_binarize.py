"""Binarizer op tests: encoder->decoder roundtrip, hysteresis scan
equivalence, trial-grid selection."""
import numpy as np
import jax.numpy as jnp
import pytest

from sdvpcmdecoder_tpu.formats import stc007
from sdvpcmdecoder_tpu.ops import binarize as bz
from sdvpcmdecoder_tpu.synth import encoder as enc


def _random_samples(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 14, size=n), rng.integers(0, 1 << 14, size=n))


def test_hysteresis_scan_matches_serial():
    rng = np.random.default_rng(1)
    px = rng.integers(0, 256, size=(32, 128)).astype(np.int32)
    rl = rng.integers(80, 128, size=(32,)).astype(np.int32)
    rh = rl + rng.integers(0, 40, size=(32,)).astype(np.int32)
    got = np.asarray(bz.hysteresis_read(jnp.asarray(px), jnp.asarray(rl),
                                        jnp.asarray(rh)))
    expect = bz.hysteresis_read_np(px, rl, rh)
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("ppb", [7.5, 6.0, 7.25])
def test_encode_decode_roundtrip_clean(ppb):
    left, right = _random_samples(180, seed=2)
    pixels, coords, line_words, crcs = enc.encode_stream(
        left, right, width=1056, ppb=ppb)
    N = pixels.shape[0]
    ref = jnp.full((N,), 110, jnp.int32)
    blk = jnp.full((N,), 20, jnp.int32)
    wht = jnp.full((N,), 200, jnp.int32)
    words, crc_read, crc_calc, synd, valid = bz.stc007_line_decode(
        jnp.asarray(pixels), jnp.asarray(coords), ref, blk, wht, 0, 0)
    assert bool(jnp.all(valid)), f"{int(jnp.sum(valid))}/{N} valid"
    np.testing.assert_array_equal(np.asarray(words), line_words)
    np.testing.assert_array_equal(np.asarray(crc_read), crcs)


def test_decode_grid_noisy():
    """With noise, the trial grid must recover more lines than depth-0."""
    left, right = _random_samples(150, seed=3)
    pixels, coords, line_words, crcs = enc.encode_stream(
        left, right, width=1152, ppb=8.0, noise_sigma=42.0,
        rng=np.random.default_rng(7))
    N = pixels.shape[0]
    ref = jnp.full((N,), 110, jnp.int32)
    blk = jnp.full((N,), 5, jnp.int32)
    wht = jnp.full((N,), 250, jnp.int32)
    *_, valid0 = bz.stc007_line_decode(
        jnp.asarray(pixels), jnp.asarray(coords), ref, blk, wht, 0, 0)
    batch = bz.stc007_read_pcm_grid(
        jnp.asarray(pixels), jnp.asarray(coords), ref, blk, wht)
    n0 = int(jnp.sum(valid0))
    ng = int(jnp.sum(batch.valid))
    assert ng >= n0
    # Every grid-valid line must decode to the true words.
    ok = np.asarray(batch.valid)
    np.testing.assert_array_equal(np.asarray(batch.words)[ok],
                                  line_words[ok])


def test_grid_prefers_lowest_hyst_shift():
    """Clean lines must select trial (0,0) — the serial loop's first hit."""
    left, right = _random_samples(150, seed=4)
    pixels, coords, *_ = enc.encode_stream(left, right, width=1152, ppb=8.0)
    N = pixels.shape[0]
    batch = bz.stc007_read_pcm_grid(
        jnp.asarray(pixels), jnp.asarray(coords),
        jnp.full((N,), 110, jnp.int32), jnp.full((N,), 20, jnp.int32),
        jnp.full((N,), 200, jnp.int32))
    assert bool(jnp.all(batch.valid))
    assert int(jnp.max(batch.hyst)) == 0
    assert int(jnp.max(batch.shift)) == 0


def test_ref_clipping_forces_invalid():
    """Hysteresis refs clipping into black/white -> read_ok False
    (fillDataWords binarizer.cpp:7590-7625)."""
    left, right = _random_samples(120, seed=5)
    pixels, coords, *_ = enc.encode_stream(left, right, width=1152, ppb=8.0)
    N = pixels.shape[0]
    ref = jnp.full((N,), 110, jnp.int32)
    *_, valid = bz.stc007_line_decode(
        jnp.asarray(pixels), jnp.asarray(coords), ref,
        jnp.full((N,), 105, jnp.int32), jnp.full((N,), 115, jnp.int32),
        10, 0)  # depth 10 -> rl=100 <= black=105
    assert not bool(jnp.any(valid))


def test_encoder_blocks_decode_through_deinterleaver():
    """Full synth chain -> binarize -> deinterleave -> original samples."""
    from sdvpcmdecoder_tpu.ops import deinterleave as di
    left, right = _random_samples(3 * 64, seed=6)
    pixels, coords, line_words, crcs = enc.encode_stream(
        left, right, width=1152, ppb=8.0)
    N = pixels.shape[0]
    batch = bz.stc007_line_decode(
        jnp.asarray(pixels), jnp.asarray(coords),
        jnp.full((N,), 110, jnp.int32), jnp.full((N,), 20, jnp.int32),
        jnp.full((N,), 200, jnp.int32), 0, 0)
    words, _, _, _, valid = batch
    crc_ok = jnp.tile(valid[:, None], (1, 8))
    n_blocks = N - stc007.MIN_DEINT_DATA
    shifts = jnp.arange(n_blocks, dtype=jnp.int32)
    blocks = di.deinterleave(words, crc_ok, shifts,
                             res_mode=di.RES_MODE_14BIT)
    assert bool(jnp.all(blocks.stage != di.STG_BAD_BLOCK))
    got = np.asarray(blocks.words)
    nb = len(left) // 3
    np.testing.assert_array_equal(got[:nb, 0], left[0::3])
    np.testing.assert_array_equal(got[:nb, 1], right[0::3])
    np.testing.assert_array_equal(got[:nb, 4], left[2::3])


def test_frame_decode_matches_per_line_grid():
    """The frame-grouped one-hot matmul path must pick identical trials/words as the
    per-line gather path when coords/levels are uniform."""
    left, right = _random_samples(150, seed=8)
    pixels, coords, line_words, crcs = enc.encode_stream(
        left, right, width=1152, ppb=8.0, noise_sigma=35.0,
        rng=np.random.default_rng(9))
    N = pixels.shape[0]
    # Trim to a multiple of a fake frame size.
    F, Lf = 4, N // 4
    N = F * Lf
    pixels = pixels[:N]
    ref = jnp.full((N,), 110, jnp.int32)
    blk = jnp.full((N,), 5, jnp.int32)
    wht = jnp.full((N,), 250, jnp.int32)
    per_line = bz.stc007_read_pcm_grid(
        jnp.asarray(pixels), jnp.asarray(coords[:N]), ref, blk, wht,
        hyst_limit=3, shift_limit=2)
    framed = bz.stc007_frame_decode(
        jnp.asarray(pixels.reshape(F, Lf, -1)),
        jnp.asarray(coords[:F * Lf:Lf], jnp.int32),
        jnp.full((F,), 110, jnp.int32), jnp.full((F,), 5, jnp.int32),
        jnp.full((F,), 250, jnp.int32), hyst_limit=3, shift_limit=2)
    np.testing.assert_array_equal(np.asarray(framed.valid).reshape(-1),
                                  np.asarray(per_line.valid))
    np.testing.assert_array_equal(np.asarray(framed.words).reshape(N, 8),
                                  np.asarray(per_line.words))
    np.testing.assert_array_equal(np.asarray(framed.hyst).reshape(-1),
                                  np.asarray(per_line.hyst))
    np.testing.assert_array_equal(np.asarray(framed.shift).reshape(-1),
                                  np.asarray(per_line.shift))


"""Seeded synthetic captures at the widths real transfers use.

Each `*_frames` function returns interlaced frame rows [F, H, W] uint8,
as a capture card writes them; `write_captures` stores a set of them as
Y4M files and returns (capture, wav) job pairs for the batch drivers.
`noise_sigma` adds Gaussian noise to every pixel, which drives the
decoder's fallback trials, the P/Q correction and the Bit Picker.
"""
from __future__ import annotations

import os

import numpy as np

from . import encoder as enc

PAL_FIELD_LINES = 294          # config.h:80-81
PAL_WIDTH = 1152
PCM1_WIDTH = 1024
PCM16X0_WIDTH = 1600


def _interlace(field_major):
    """Field-sequential lines [L, W] -> frame rows (field 0 on even rows)."""
    L = field_major.shape[0]
    img = np.empty_like(field_major)
    img[0::2] = field_major[:L // 2]
    img[1::2] = field_major[L // 2:]
    return img


def _add_noise(frames, sigma, seed):
    if not sigma:
        return frames
    rng = np.random.default_rng(seed + 1_000_003)
    return np.clip(frames + rng.normal(0.0, sigma, frames.shape),
                   0, 255).astype(np.uint8)


def stc007_pal_frames(n_frames, seed, noise_sigma=0.0):
    """STC-007 PAL, 14-bit: 588 lines x 1152 px, 8 px per bit."""
    rng = np.random.default_rng(seed)
    n = 3 * n_frames * 2 * PAL_FIELD_LINES
    frames = enc.encode_fields(rng.integers(1, 1 << 14, n),
                               rng.integers(1, 1 << 14, n), n_frames,
                               lines_pf=PAL_FIELD_LINES)
    out = np.empty((n_frames, 2 * PAL_FIELD_LINES, PAL_WIDTH), np.uint8)
    for k, fr in enumerate(frames):
        px, _ = enc.render_lines(fr["line_words"], fr["crcs"],
                                 width=PAL_WIDTH, ppb=8.0)
        out[k] = _interlace(px)
    return _add_noise(out, noise_sigma, seed)


def pcm1_frames(n_frames, seed, noise_sigma=0.0):
    """Sony PCM-1: 1024 px wide, 10 px per bit."""
    from ..formats import pcm1
    from ..ops import pcm1_deint as di1
    from ..pipeline import stitcher_pcm1 as sp1
    rng = np.random.default_rng(seed)
    out = np.full((n_frames, 2 * sp1.LINES_PF, PCM1_WIDTH), 20, np.uint8)
    for f in range(n_frames):
        for half in range(2):
            left = rng.integers(0, 1 << 13, di1.FIELD_SUBLINES)
            right = rng.integers(0, 1 << 13, di1.FIELD_SUBLINES)
            sl, sr = di1.interleave_field(left, right)
            words = np.zeros((sp1.LINES_PF, 6), np.int64)
            words[:, 0::2] = np.stack([sl[0::3], sl[1::3], sl[2::3]], 1)
            words[:, 1::2] = np.stack([sr[0::3], sr[1::3], sr[2::3]], 1)
            crcs = pcm1.calc_crc(words, xp=np)
            bits = pcm1.words_to_data_bits(words, crcs, xp=np)
            px, _ = enc.render_bits(np.asarray(bits), width=PCM1_WIDTH,
                                    ppb=10.0)
            out[f, half::2] = px
    return _add_noise(out, noise_sigma, seed)


def pcm16x0_frames(n_frames, seed, noise_sigma=0.0):
    """Sony PCM-1600 SI: 1600 px wide, 7 px per bit."""
    from ..formats import pcm16x0
    from ..ops import pcm16x0_deint as di16
    from ..pipeline import stitcher_pcm16x0 as sp16
    rng = np.random.default_rng(seed)
    LPF = sp16.LINES_PF
    usable = (LPF * 3 // sp16.SI_TRUE_INTERLEAVE) * sp16.SI_TRUE_INTERLEAVE
    out = np.zeros((n_frames, 2 * LPF, PCM16X0_WIDTH), np.uint8)
    for f in range(n_frames):
        for half in range(2):
            left = rng.integers(1, 1 << 16, usable)
            right = rng.integers(1, 1 << 16, usable)
            sub, _ = di16.interleave_field(left, right, LPF)
            crcs = np.asarray(pcm16x0.calc_crc(sub, xp=np))
            bits = pcm16x0.line_bits(sub.reshape(LPF, 3, 3),
                                     crcs.reshape(LPF, 3), 1, xp=np)
            px, _ = enc.render_bits(np.asarray(bits),
                                    width=PCM16X0_WIDTH, ppb=7.0)
            out[f, half::2] = px
    return _add_noise(out, noise_sigma, seed)


def write_captures(directory, frames_fn, n_caps, n_frames, seed0=0,
                   prefix="cap", noise_sigma=0.0):
    """Write n_caps captures (seeds seed0, seed0+1, ...) as Y4M into
    `directory`; returns [(capture_path, wav_path), ...]."""
    from ..pipeline import ingest
    jobs = []
    for c in range(n_caps):
        p = os.path.join(directory, f"{prefix}{c}.y4m")
        ingest.write_y4m(p, frames_fn(n_frames, seed0 + c, noise_sigma))
        jobs.append((p, os.path.join(directory, f"{prefix}{c}.wav")))
    return jobs

"""Minimal end-to-end STC-007 stream decoder (the round-1 vertical slice).

pixels [L, W] -> binarize trial grid -> deinterleave + ECC -> stereo int16.

This covers the reference chain VideoToDigital -> Binarizer ->
STC007Deinterleaver for a continuous line stream with known coordinates and
levels; frame/field reassembly (stitcher), AGC and marker search layer on
top in later stages.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..formats import stc007
from ..ops import binarize as bz
from ..ops import deinterleave as di


class DecodeResult(NamedTuple):
    samples: jnp.ndarray       # [n_samples, 2] int16 stereo
    sample_valid: jnp.ndarray  # [n_samples, 2] bool (word valid after ECC)
    line_valid: jnp.ndarray    # [L] bool CRC per line
    block_state: jnp.ndarray   # [B] int32 AUD_* per block


@functools.partial(
    jax.jit,
    static_argnames=("hyst_limit", "shift_limit", "res_mode", "m2"))
def decode_stream(pixels, coords, ref_level, black, white,
                  hyst_limit=4, shift_limit=2,
                  res_mode=di.RES_MODE_14BIT, m2=False):
    """Jitted device decode: lines -> samples.

    pixels [L, W] uint8, coords [L, 2] int32, ref/black/white [L] int32.
    Number of blocks = L - 112 (static).
    """
    batch = bz.stc007_read_pcm_grid(pixels, coords, ref_level, black, white,
                                    hyst_limit=hyst_limit,
                                    shift_limit=shift_limit)
    crc_ok = jnp.tile(batch.valid[:, None], (1, 8))
    n_blocks = pixels.shape[0] - stc007.MIN_DEINT_DATA
    shifts = jnp.arange(n_blocks, dtype=jnp.int32)
    blocks = di.deinterleave(batch.words, crc_ok, shifts, res_mode=res_mode)
    samples6 = di.block_samples(blocks, m2=m2)           # [B, 6]
    valid6 = blocks.valid[:, :6]
    # Block b yields stereo pairs (3b, 3b+1, 3b+2): (L0,R0),(L1,R1),(L2,R2).
    stereo = samples6.reshape(n_blocks * 3, 2)
    svalid = valid6.reshape(n_blocks * 3, 2)
    return DecodeResult(stereo, svalid, batch.valid, blocks.audio_state)


@functools.partial(
    jax.jit,
    static_argnames=("hyst_limit", "shift_limit", "res_mode", "m2"))
def decode_frames(pixels, coords, ref_level, black, white,
                  hyst_limit=4, shift_limit=2,
                  res_mode=di.RES_MODE_14BIT, m2=False):
    """Frame-grouped production path: pixels [F, Lf, W], coords [F, 2],
    ref/black/white [F]. Lines are temporally contiguous across frames;
    the deinterleaver runs over the flattened stream.
    """
    F, Lf, W = pixels.shape
    batch = bz.stc007_frame_decode(pixels, coords, ref_level, black, white,
                                   hyst_limit=hyst_limit,
                                   shift_limit=shift_limit)
    L = F * Lf
    words = batch.words.reshape(L, 8)
    valid = batch.valid.reshape(L)
    crc_ok = jnp.tile(valid[:, None], (1, 8))
    n_blocks = L - stc007.MIN_DEINT_DATA
    # Consecutive shifts -> contiguous-slice assembly (no gathers).
    w14, c14 = di.assemble_blocks_contiguous(words, crc_ok, n_blocks,
                                             di.RES_14BIT)
    if res_mode == di.RES_MODE_14BIT:
        blocks = di.correct_blocks(w14, c14, di.RES_14BIT)
    elif res_mode == di.RES_MODE_16BIT:
        w16, c16 = di.assemble_blocks_contiguous(words, crc_ok, n_blocks,
                                                 di.RES_16BIT)
        blocks = di.correct_blocks(w16, c16, di.RES_16BIT)
    else:
        first = di.RES_14BIT if res_mode == di.RES_MODE_14BIT_AUTO \
            else di.RES_16BIT
        other = di.RES_16BIT if first == di.RES_14BIT else di.RES_14BIT
        w16, c16 = di.assemble_blocks_contiguous(words, crc_ok, n_blocks,
                                                 di.RES_16BIT)
        pick = {di.RES_14BIT: (w14, c14), di.RES_16BIT: (w16, c16)}
        r1 = di.correct_blocks(*pick[first], first)
        r2 = di.correct_blocks(*pick[other], other)
        use2 = (r1.stage == di.STG_BAD_BLOCK) \
            & (r2.stage != di.STG_BAD_BLOCK)
        sel = lambda a, b: jnp.where(
            use2.reshape(use2.shape + (1,) * (a.ndim - 1)), b, a)
        blocks = di.BlockBatch(*(sel(a, b) for a, b in zip(r1, r2)))
    samples6 = di.block_samples(blocks, m2=m2)
    valid6 = blocks.valid[:, :6]
    stereo = samples6.reshape(n_blocks * 3, 2)
    svalid = valid6.reshape(n_blocks * 3, 2)
    return DecodeResult(stereo, svalid, valid, blocks.audio_state)


def decode_to_numpy(pixels, coords, black=20, white=200, ref_level=None,
                    **kw):
    """Host convenience wrapper (auto center reference level)."""
    L = pixels.shape[0]
    blk = jnp.full((L,), black, jnp.int32)
    wht = jnp.full((L,), white, jnp.int32)
    if ref_level is None:
        ref, _ = bz.pick_center_ref_level(blk, wht)
    else:
        ref = jnp.full((L,), ref_level, jnp.int32)
    res = decode_stream(jnp.asarray(pixels), jnp.asarray(coords, jnp.int32),
                        ref, blk, wht, **kw)
    return (np.asarray(res.samples), np.asarray(res.sample_valid),
            np.asarray(res.line_valid), np.asarray(res.block_state))

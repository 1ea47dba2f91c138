"""Batched binarizer: video lines -> PCM words, the decoder's hot path.

The reference binarizer (binarizer.cpp, 8.5 kLoC) reads one line at a time,
serially iterating hysteresis depth x pixel shift x reference level with
early exit (readPCMdata :7695-8090).  Here the FULL trial grid for thousands
of lines is evaluated at once:

  * integer PPB / bit-center pixel coordinates are computed vectorized
    (pcmline.cpp:249-311, :504-519 — INT_CALC_MULT=128 fixed point);
  * the state-dependent hysteresis read (fillSTC007, binarizer.cpp:7322+:
    out = prev ? px >= ref_high : px > ref_low) is a 2-state Schmitt scan,
    expressed as an O(log n) associative scan over the transition monoid
    {0,1}->{0,1} instead of a 128-step serial loop;
  * CRC validity of every trial is ONE matmul via the precomputed
    syndrome table (formats.crc);
  * the reference's early-exit selection (first valid (hyst, shift) in
    lexicographic order — the serial loops break on first valid CRC,
    readPCMdata :7801-7830) becomes an argmin over the trial axis.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..formats import stc007, crc as crc_mod

# Pixel-shift tables (pcmline.h:63-71).
PIX_SH_BG = np.array([0, 1, -1, 2, -2], dtype=np.int32)
PIX_SH_ED = np.array([0, 1, -1, 2, -2], dtype=np.int32)
SHIFT_STAGES_MAX = 4   # 5 stages (PCM_LINE_MAX_PS_STAGES)
HYST_DEPTH_MAX = 10    # binarizer.h:235-241
INT_CALC_MULT = 128


class LineBatch(NamedTuple):
    """Binarized lines [N, ...]."""
    words: jnp.ndarray       # [N, 8] int32 data words
    crc_read: jnp.ndarray    # [N] int32 CRC read from the line
    crc_calc: jnp.ndarray    # [N] int32 recalculated CRC
    valid: jnp.ndarray       # [N] bool CRC match
    hyst: jnp.ndarray        # [N] int32 chosen hysteresis depth
    shift: jnp.ndarray       # [N] int32 chosen pixel-shift stage


def calc_ppb(data_start, data_stop, bit_count):
    """Integer PPB math (pcmline.cpp:504-519). Returns (psm, half)."""
    pixels = data_stop - data_start
    psm = (pixels * INT_CALC_MULT + bit_count // 2) // bit_count
    half = (psm + 1) // 2
    return psm, half


def bit_pixel_coords(data_start, psm, half, shift_stage, n_bits, bit_ofs,
                     bits_per_line, left_zone, right_zone, pixel_stop,
                     pixel_start=0, xp=jnp):
    """Bit-center pixel coordinates [.., n_bits] (pcmline.cpp:249-311).

    data_start/psm/half may be per-line arrays [...]; shift_stage may be a
    scalar or array broadcastable against them.
    """
    bit = np.arange(n_bits, dtype=np.int32) + bit_ofs
    bit = np.minimum(bit, bits_per_line - 1)
    base = (bit[None, :] * psm[..., None] + half[..., None]) \
        // INT_CALC_MULT + data_start[..., None]
    bg = xp.asarray(PIX_SH_BG)[shift_stage]
    ed = xp.asarray(PIX_SH_ED)[shift_stage]
    uniform = bg == ed
    zone = xp.where(bit[None, :] < left_zone, bg[..., None],
                    xp.where(bit[None, :] > right_zone, ed[..., None], 0))
    shift = xp.where(uniform[..., None], bg[..., None], zone)
    px = base + shift
    return xp.clip(px, pixel_start, pixel_stop - 1)


def hysteresis_read(pixels_at_bits, ref_low, ref_high, xp=jnp):
    """Schmitt-trigger bit read over the last axis.

    out[i] = prev ? (px[i] >= ref_high) : (px[i] > ref_low), prev = out[i-1],
    initial prev = 0 (fillSTC007 binarizer.cpp:7365-7395).

    Each step is an element of the monoid of maps {0,1}->{0,1} represented
    as (value_if_prev0, value_if_prev1); composition is associative, so the
    whole line resolves in ceil(log2(n)) passes.
    """
    a = pixels_at_bits > ref_low[..., None]     # prev == 0 branch
    b = pixels_at_bits >= ref_high[..., None]   # prev == 1 branch

    def combine(l, r):
        la, lb = l
        ra, rb = r
        return (jnp.where(la, rb, ra), jnp.where(lb, rb, ra))

    fa, _ = jax.lax.associative_scan(combine, (a, b), axis=-1)
    return fa.astype(jnp.int32)


def hysteresis_read_np(pixels_at_bits, ref_low, ref_high):
    """Serial reference twin for testing."""
    out = np.zeros(pixels_at_bits.shape, dtype=np.int32)
    prev = np.zeros(pixels_at_bits.shape[:-1], dtype=bool)
    for i in range(pixels_at_bits.shape[-1]):
        px = pixels_at_bits[..., i]
        bit = np.where(prev, px >= ref_high, px > ref_low)
        out[..., i] = bit
        prev = bit
    return out


@functools.lru_cache(maxsize=None)
def _syndrome_const():
    table, const = stc007.crc_syndrome_table()
    return table.astype(np.int32), const


def stc007_line_decode(pixel_lines, coords, ref_level, black, white,
                       hyst_depth, shift_stage):
    """Decode one (hyst, shift) trial for a batch of lines.

    pixel_lines [N, W] uint8; coords [N, 2]; ref_level/black/white [N].
    Returns (words [N,8], crc_read, crc_calc, syndrome, read_ok).
    read_ok=False when hysteresis refs clip into black/white levels
    (fillDataWords binarizer.cpp:7590-7625 -> forced invalid CRC).
    """
    N, W = pixel_lines.shape
    data_start = coords[:, 0].astype(jnp.int32)
    data_stop = coords[:, 1].astype(jnp.int32)
    psm, half = calc_ppb(data_start, data_stop, stc007.BITS_BETWEEN_COORDS)
    shift_arr = jnp.full((N,), shift_stage, dtype=jnp.int32) \
        if np.ndim(shift_stage) == 0 else shift_stage
    px_coords = bit_pixel_coords(
        data_start, psm, half, shift_arr, stc007.BITS_PCM_DATA,
        stc007.COORD_BIT_OFS, stc007.BITS_IN_LINE, stc007.BITS_LEFT_SHIFT,
        stc007.BITS_RIGHT_SHIFT, pixel_stop=W)
    px = jnp.take_along_axis(pixel_lines.astype(jnp.int32), px_coords,
                             axis=-1)
    # Hysteresis levels (binarizer getLowLevel/getHighLevel).
    rl = jnp.maximum(ref_level - hyst_depth, 1)
    rh = jnp.minimum(ref_level + hyst_depth, 254)
    read_ok = (rl > black) & (rh < white)
    bits = hysteresis_read(px, rl, rh)
    words, crc_read = stc007.data_bits_to_words(bits)
    table, const = _syndrome_const()
    synd_bits = jnp.matmul(bits, jnp.asarray(table),
                           preferred_element_type=jnp.int32) & 1
    syndrome = crc_mod.pack_bits_to_u16(synd_bits) ^ const
    crc_calc = stc007.calc_crc(words)
    valid = (syndrome == 0) & read_ok
    return words, crc_read, crc_calc, syndrome, valid


def stc007_read_pcm_grid(pixel_lines, coords, ref_level, black, white,
                         hyst_limit=HYST_DEPTH_MAX,
                         shift_limit=SHIFT_STAGES_MAX):
    """Full readPCMdata trial grid + reference-faithful selection.

    Evaluates (hyst_limit+1) x (shift_limit+1) trials for every line at
    once and picks the lexicographically-first valid (hyst, shift) — the
    fixed point of the reference's break-on-first-valid serial loops.
    Falls back to (0, 0) when no trial is valid (readPCMdata :7957-8010:
    zeroed stats -> final fill at depth 0, stage 0).
    """
    n_h, n_s = hyst_limit + 1, shift_limit + 1

    def one_trial(h, s):
        return stc007_line_decode(pixel_lines, coords, ref_level, black,
                                  white, h, s)

    hh, ss = np.meshgrid(np.arange(n_h), np.arange(n_s), indexing="ij")
    trials = jax.vmap(
        lambda h, s: one_trial(h, s),
        in_axes=(0, 0), out_axes=0)(jnp.asarray(hh.ravel()),
                                    jnp.asarray(ss.ravel()))
    words_t, crc_read_t, crc_calc_t, synd_t, valid_t = trials  # [T, N, ...]
    T = n_h * n_s
    prio = jnp.arange(T, dtype=jnp.int32)[:, None]      # lexicographic h,s
    pick = jnp.argmin(jnp.where(valid_t, prio, T), axis=0)  # [N]
    any_valid = jnp.any(valid_t, axis=0)
    pick = jnp.where(any_valid, pick, 0)                # fallback trial (0,0)
    nsel = pick[None, ..., None]
    words = jnp.take_along_axis(words_t, nsel, axis=0)[0]
    sel = lambda arr: jnp.take_along_axis(arr, pick[None, :], axis=0)[0]
    return LineBatch(
        words=words,
        crc_read=sel(crc_read_t),
        crc_calc=sel(crc_calc_t),
        valid=any_valid,
        hyst=jnp.asarray(hh.ravel())[pick],
        shift=jnp.asarray(ss.ravel())[pick],
    )


def _selection_matrix(px_coords, width):
    """One-hot bit-sampling matrix [..., n_bits, W] (bfloat16).

    Turns the per-bit pixel gather into a one-hot bf16 contraction.  The
    product is exact: uint8 pixels are exact in bf16, the matrix is
    one-hot and accumulation is fp32.  Whether a plain gather is faster
    on a GPU has not been measured.
    """
    iota = jnp.arange(width, dtype=jnp.int32)
    return (px_coords[..., None] == iota).astype(jnp.bfloat16)


@functools.partial(jax.jit, static_argnums=(5, 6),
                   static_argnames=("hyst_limit", "shift_limit"))
def stc007_frame_decode(pixels, coords, ref_level, black, white,
                        hyst_limit=HYST_DEPTH_MAX,
                        shift_limit=SHIFT_STAGES_MAX):
    """Frame-grouped trial-grid decode: coords/levels shared per frame.

    pixels [F, L, W] uint8, coords [F, 2], ref/black/white [F] int32.
    This is the production fast path and mirrors the reference's data flow:
    V2D pre-scans each frame once and feeds damped frame-level coordinates
    to the binarizer (videotodigital.cpp:148 prescanCoordinates, :348
    medianCoordinates); per-line coordinate refinement only happens on the
    marker/sweep fallback paths.

    The pixel sampling for all shift stages is ONE batched bf16 matmul
    [F,L,W] x [F,S,W,128]; hysteresis trials share those samples; CRC
    syndromes for every trial are one more matmul. Selection is the
    lexicographically-first valid (hyst, shift), as in readPCMdata.

    Returns LineBatch with leading shape [F, L].
    """
    F, L, W = pixels.shape
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    data_start = coords[:, 0].astype(jnp.int32)
    data_stop = coords[:, 1].astype(jnp.int32)
    psm, half = calc_ppb(data_start, data_stop, stc007.BITS_BETWEEN_COORDS)
    # Coordinates per shift stage: [F, S, 128].
    shift_ids = jnp.arange(n_s, dtype=jnp.int32)
    pc = bit_pixel_coords(
        data_start[:, None], psm[:, None], half[:, None],
        shift_ids[None, :], stc007.BITS_PCM_DATA, stc007.COORD_BIT_OFS,
        stc007.BITS_IN_LINE, stc007.BITS_LEFT_SHIFT,
        stc007.BITS_RIGHT_SHIFT, pixel_stop=W)            # [F, S, 128]
    sel = _selection_matrix(pc, W)                        # [F, S, 128, W]
    px = jnp.einsum("flw,fsbw->fslb", pixels.astype(jnp.bfloat16), sel,
                    preferred_element_type=jnp.float32)   # [F, S, L, 128]
    px = px.astype(jnp.int32)

    # Hysteresis trials on shared samples: [H, F, S, L, 128] bits.
    depths = jnp.arange(n_h, dtype=jnp.int32)
    if ref_level.ndim == 2:
        # Per-LINE levels [F, L] (per-line AGC, findSTC007BW et al.):
        # the trial grid already broadcasts over lines, so drift-tracking
        # levels cost nothing extra.
        rl = jnp.maximum(ref_level[None] - depths[:, None, None], 1)
        rh = jnp.minimum(ref_level[None] + depths[:, None, None], 254)
        read_ok = (rl > black[None]) & (rh < white[None])   # [H, F, L]
        # hysteresis_read appends the bit axis itself: pass [H, F, 1, L].
        bits = hysteresis_read(px[None], rl[:, :, None, :],
                               rh[:, :, None, :])
        read_ok_hfsl = read_ok[:, :, None, :]               # [H, F, 1, L]
    else:
        rl = jnp.maximum(ref_level[None, :] - depths[:, None], 1)  # [H, F]
        rh = jnp.minimum(ref_level[None, :] + depths[:, None], 254)
        read_ok = (rl > black[None, :]) & (rh < white[None, :])    # [H, F]
        read_ok_hfsl = read_ok[:, :, None, None]
        bits = hysteresis_read(px[None], rl[:, :, None, None],
                               rh[:, :, None, None])      # [H, F, S, L, 128]

    # CRC syndrome for every trial: one matmul over the last axis.
    table, const = _syndrome_const()
    synd_bits = jnp.matmul(bits.astype(jnp.bfloat16),
                           jnp.asarray(table, jnp.bfloat16),
                           preferred_element_type=jnp.float32)
    synd_bits = synd_bits.astype(jnp.int32) & 1
    syndrome = crc_mod.pack_bits_to_u16(synd_bits) ^ const  # [H,F,S,L]
    valid = (syndrome == 0) & read_ok_hfsl

    # Lexicographic (h, s) priority selection per line.
    prio = (depths[:, None] * n_s + shift_ids[None, :])     # [H, S]
    prio = prio[:, None, :, None]                           # [H,1,S,1]
    big = n_h * n_s
    flat_valid = valid.transpose(1, 3, 0, 2).reshape(F, L, n_h * n_s)
    flat_prio = jnp.broadcast_to(prio, valid.shape) \
        .transpose(1, 3, 0, 2).reshape(F, L, n_h * n_s)
    order = jnp.where(flat_valid, flat_prio, big)
    pick = jnp.argmin(order, axis=-1)                       # [F, L]
    any_valid = jnp.any(flat_valid, axis=-1)
    pick = jnp.where(any_valid, pick, 0)
    pick_h = pick // n_s
    pick_s = pick % n_s

    # Gather the chosen trial's bits -> words (tiny gather, fine on VPU).
    bits_fl = bits.transpose(1, 3, 0, 2, 4)                 # [F,L,H,S,128]
    chosen = jnp.take_along_axis(
        bits_fl.reshape(F, L, n_h * n_s, stc007.BITS_PCM_DATA),
        pick[..., None, None], axis=2)[:, :, 0]             # [F, L, 128]
    words, crc_read = stc007.data_bits_to_words(chosen)
    crc_calc = stc007.calc_crc(words)
    return LineBatch(words=words, crc_read=crc_read, crc_calc=crc_calc,
                     valid=any_valid, hyst=pick_h, shift=pick_s)


def stc007_ref_sweep_decode(pixels, coords, black, white, ref_levels,
                            hyst_limit=HYST_DEPTH_MAX,
                            shift_limit=SHIFT_STAGES_MAX):
    """Full reference-level sweep as one device dispatch (sweepRefLevel
    binarizer.cpp:3551 / calcRefLevelBySweep :3821).

    The reference walks every brightness in [black+1, white-1] per line,
    re-running its serial trial loops at each level.  Here the sweep is
    just one more trial axis: per-shift pixel samples are computed ONCE
    (they don't depend on the reference level), then a lax.scan walks a
    shared ref-level grid, each step reducing the (hyst, shift) grid to
    the lexicographically-first valid result for that level — the
    early-exit readPCMdata call inside the reference's sweep loop.

    pixels [F, L, W] uint8; coords [F, 2]; black/white [F];
    ref_levels [R] int32 (descending, white -> black scan order).
    Returns per-level arrays with leading axis R: valid/crc/hyst/shift
    [R, F, L] and words [R, F, L, 8].  Levels outside a frame's
    (black, white) open interval are masked invalid, which realises the
    per-line sweep span without dynamic shapes.
    """
    F, L, W = pixels.shape
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    data_start = coords[:, 0].astype(jnp.int32)
    data_stop = coords[:, 1].astype(jnp.int32)
    psm, half = calc_ppb(data_start, data_stop, stc007.BITS_BETWEEN_COORDS)
    shift_ids = jnp.arange(n_s, dtype=jnp.int32)
    pc = bit_pixel_coords(
        data_start[:, None], psm[:, None], half[:, None],
        shift_ids[None, :], stc007.BITS_PCM_DATA, stc007.COORD_BIT_OFS,
        stc007.BITS_IN_LINE, stc007.BITS_LEFT_SHIFT,
        stc007.BITS_RIGHT_SHIFT, pixel_stop=W)            # [F, S, 128]
    sel = _selection_matrix(pc, W)                        # [F, S, 128, W]
    px = jnp.einsum("flw,fsbw->fslb", pixels.astype(jnp.bfloat16), sel,
                    preferred_element_type=jnp.float32)   # [F, S, L, 128]
    px = px.astype(jnp.int32)
    table, const = _syndrome_const()
    table = jnp.asarray(table, jnp.bfloat16)
    depths = jnp.arange(n_h, dtype=jnp.int32)
    prio = depths[:, None] * n_s + shift_ids[None, :]     # [H, S]
    big = n_h * n_s

    def step(_, ref):
        rl = jnp.maximum(ref - depths, 1)                 # [H]
        rh = jnp.minimum(ref + depths, 254)
        read_ok = (rl[:, None] > black) & (rh[:, None] < white)  # [H, F]
        bits = hysteresis_read(px[None],
                               rl[:, None, None, None],
                               rh[:, None, None, None])   # [H,F,S,L,128]
        synd_bits = jnp.matmul(bits.astype(jnp.bfloat16), table,
                               preferred_element_type=jnp.float32)
        synd_bits = synd_bits.astype(jnp.int32) & 1
        syndrome = crc_mod.pack_bits_to_u16(synd_bits) ^ const
        valid = (syndrome == 0) & read_ok[:, :, None, None]  # [H,F,S,L]
        flat_valid = valid.transpose(1, 3, 0, 2).reshape(F, L, big)
        flat_prio = jnp.broadcast_to(prio[:, None, :, None], valid.shape) \
            .transpose(1, 3, 0, 2).reshape(F, L, big)
        order = jnp.where(flat_valid, flat_prio, big)
        pick = jnp.argmin(order, axis=-1)                 # [F, L]
        any_valid = jnp.any(flat_valid, axis=-1)
        pick = jnp.where(any_valid, pick, 0)
        bits_fl = bits.transpose(1, 3, 0, 2, 4)           # [F,L,H,S,128]
        chosen = jnp.take_along_axis(
            bits_fl.reshape(F, L, big, stc007.BITS_PCM_DATA),
            pick[..., None, None], axis=2)[:, :, 0]
        words, crc_read = stc007.data_bits_to_words(chosen)
        return None, (any_valid, crc_read.astype(jnp.int32),
                      (pick // n_s).astype(jnp.int32),
                      (pick % n_s).astype(jnp.int32), words)

    _, (valid, crc, hyst, shift, words) = jax.lax.scan(
        step, None, ref_levels.astype(jnp.int32))
    return dict(valid=valid, crc=crc, hyst=hyst, shift=shift, words=words)


def pick_ref_sweep(valid, crc, hyst, shift, min_valid_crcs=5):
    """CRC-statistics selection over a ref-level sweep (host numpy).

    Port of calcRefLevelBySweep :3821 selection: find the most frequent
    CRC across levels (findMostFrequentCRC :1829), drop collisions
    (invalidateNonFrequentCRCs :1931), require a span of at least
    `min_valid_crcs` levels (digi_set default, binarizer.cpp:55), then
    pick the middle of the longest contiguous run at the lowest
    (hysteresis, shift) combo (pickLevelByCRCStats :1985).  A span that
    exists but is too narrow still yields a pick, flagged forced-bad
    (SPAN_TOO_NARROW -> pickLevelByCRCStatsOpt + setForcedBad :3997).

    Arrays are [R, N] (levels descending, lines flattened).
    Returns (pick_idx [N], good [N], forced_bad [N]); pick_idx is -1
    where no level produced a valid CRC.
    """
    R, N = valid.shape
    crc = np.where(valid, crc, -1)
    # Count, for each level r, how many valid levels of the same line
    # share its CRC — sort-grouped, O(RN log R) instead of an [R,R,N]
    # equality tensor.
    counts = np.zeros((R, N), dtype=np.int64)
    if valid.any():
        rr, nn = np.nonzero(valid)
        ids = nn.astype(np.int64) * (1 << 17) + crc[rr, nn] + 1
        _, inverse, grp_counts = np.unique(ids, return_inverse=True,
                                           return_counts=True)
        counts[rr, nn] = grp_counts[inverse]
    best = counts.argmax(axis=0)                          # first max:
    span = counts[best, np.arange(N)]                     # highest level
    modal_crc = crc[best, np.arange(N)]
    target = valid & (crc == modal_crc[None, :]) & (span[None, :] > 0)
    h_m = np.where(target, hyst, 0x7FFF)
    low_d = h_m.min(axis=0)
    s_m = np.where(target & (hyst == low_d[None, :]), shift, 0x7FFF)
    low_s = s_m.min(axis=0)
    region = target & (hyst == low_d[None, :]) & (shift == low_s[None, :])
    # Longest contiguous run per line; ties go to the LATER (lower-level)
    # run (pickLevelByCRCStats :2105 uses >=) — run extraction over all
    # lines at once via transitions, best run by an encoded score.
    pick_idx = np.full(N, -1, dtype=np.int64)
    padded = np.zeros((R + 2, N), np.int8)
    padded[1:-1] = region
    d = np.diff(padded, axis=0)
    ln_s, r_s = np.nonzero(d.T == 1)   # run starts, line-major order
    ln_e, r_e = np.nonzero(d.T == -1)  # run ends (exclusive), aligned
    if len(ln_s):
        length = r_e - r_s
        pick = r_s + (r_e - 1 - r_s) // 2
        score = (length * (R + 2) + r_s) * 512 + pick
        best_score = np.full(N, -1, dtype=np.int64)
        np.maximum.at(best_score, ln_s, score)
        found = best_score >= 0
        pick_idx[found] = best_score[found] % 512
    good = span >= min_valid_crcs
    forced_bad = (span > 0) & ~good
    return pick_idx, good, forced_bad


@functools.lru_cache(maxsize=None)
def format_syndrome_table(fmt: str):
    """Affine syndrome map (TABLE [n,16], CONST) for any format's line
    bits: syndrome(bits) == 0 iff calculated CRC equals the read CRC.

    Built numerically from the format's scalar CRC (linearity over GF(2)
    makes n+1 evaluations sufficient); covers the PCM-1 complemented CRC
    scheme transparently.
    """
    from ..formats import pcm1 as _p1, pcm16x0 as _p16

    if fmt == "stc007":
        table, const = stc007.crc_syndrome_table()
        return table.astype(np.int32), const

    if fmt == "pcm1":
        n_words, wbits, nb = 6, 13, _p1.BITS_PCM_DATA

        def synd(bits):
            words, crc_read = _p1.data_bits_to_words(bits[None], xp=np)
            return int(_p1.calc_crc(words, xp=np)[0]) ^ int(crc_read[0])
    elif fmt == "pcm16x0":
        n_words, wbits, nb = 3, 16, _p16.BITS_PCM_DATA

        def synd(bits):
            words, crc_read = _p16.data_bits_to_words(bits[None], xp=np)
            return int(_p16.calc_crc(words, xp=np)[0]) ^ int(crc_read[0])
    else:
        raise ValueError(fmt)
    zero = np.zeros(nb, dtype=np.int64)
    const = synd(zero)
    table = np.zeros((nb, 16), dtype=np.int32)
    for i in range(nb):
        e = zero.copy()
        e[i] = 1
        v = synd(e) ^ const
        table[i] = [(v >> j) & 1 for j in range(16)]
    return table, const


FORMAT_GEOM = {
    # n_bits, bit_ofs(part-adjusted at call), bits_between, bits_per_line,
    # left_zone, right_zone
    "stc007": (stc007.BITS_PCM_DATA, stc007.COORD_BIT_OFS,
               stc007.BITS_BETWEEN_COORDS, stc007.BITS_IN_LINE,
               stc007.BITS_LEFT_SHIFT, stc007.BITS_RIGHT_SHIFT),
    "pcm1": (94, 0, 94, 94, 16, 52),
    "pcm16x0": (64, 0, 193, 193, 34, 107),
}


def generic_frame_decode(pixels, coords, ref_level, black, white, fmt,
                         hyst_limit=0, shift_limit=2, part_start=0):
    """Format-parameterized frame-grouped trial-grid decode.

    Same one-hot matmul machinery as stc007_frame_decode for PCM-1 (94-bit lines)
    and PCM-16x0 (64-bit sublines; call 3x with part_start in
    {0, 64, 129}). Returns (bits [F, L, n_bits] int32, valid [F, L],
    hyst, shift).
    """
    F, L, W = pixels.shape
    n_h, n_s = hyst_limit + 1, shift_limit + 1
    n_bits, bit_ofs, between, per_line, lz, rz = FORMAT_GEOM[fmt]
    data_start = coords[:, 0].astype(jnp.int32)
    data_stop = coords[:, 1].astype(jnp.int32)
    psm, half = calc_ppb(data_start, data_stop, between)
    shift_ids = jnp.arange(n_s, dtype=jnp.int32)
    pc = bit_pixel_coords(
        data_start[:, None], psm[:, None], half[:, None],
        shift_ids[None, :], n_bits, bit_ofs + part_start, per_line, lz, rz,
        pixel_stop=W)
    sel = _selection_matrix(pc, W)
    px = jnp.einsum("flw,fsbw->fslb", pixels.astype(jnp.bfloat16), sel,
                    preferred_element_type=jnp.float32).astype(jnp.int32)
    depths = jnp.arange(n_h, dtype=jnp.int32)
    rl = jnp.maximum(ref_level[None, :] - depths[:, None], 1)
    rh = jnp.minimum(ref_level[None, :] + depths[:, None], 254)
    read_ok = (rl > black[None, :]) & (rh < white[None, :])
    bits = hysteresis_read(px[None], rl[:, :, None, None],
                           rh[:, :, None, None])  # [H, F, S, L, n]
    table, const = format_syndrome_table(fmt)
    synd_bits = jnp.matmul(bits.astype(jnp.bfloat16),
                           jnp.asarray(table, jnp.bfloat16),
                           preferred_element_type=jnp.float32)
    synd = crc_mod.pack_bits_to_u16(synd_bits.astype(jnp.int32) & 1) ^ const
    valid = (synd == 0) & read_ok[:, :, None, None]
    prio = (depths[:, None] * n_s + shift_ids[None, :])[:, None, :, None]
    big = n_h * n_s
    fv = valid.transpose(1, 3, 0, 2).reshape(F, L, big)
    fp = jnp.broadcast_to(prio, valid.shape) \
        .transpose(1, 3, 0, 2).reshape(F, L, big)
    pick = jnp.argmin(jnp.where(fv, fp, big), axis=-1)
    any_valid = jnp.any(fv, axis=-1)
    pick = jnp.where(any_valid, pick, 0)
    bits_fl = bits.transpose(1, 3, 0, 2, 4).reshape(F, L, big, n_bits)
    chosen = jnp.take_along_axis(bits_fl, pick[..., None, None],
                                 axis=2)[:, :, 0]
    return chosen, any_valid, pick // n_s, pick % n_s


@functools.partial(jax.jit, static_argnums=(5,),
                   static_argnames=("shift_limit", "hyst_limit"))
def pcm1_frame_decode(pixels, coords, ref_level, black, white,
                      shift_limit=2, hyst_limit=0):
    """PCM-1 frame decode -> (words [F,L,6], crc_read [F,L], valid).

    The hysteresis depth sweep applies to every format in the reference
    (readPCMdata binarizer.cpp:7695 is the shared path; limits
    binarizer.h:235-241) — hyst_limit adds that trial axis here too."""
    from ..formats import pcm1 as _p1
    bits, valid, hyst, shift = generic_frame_decode(
        pixels, coords, ref_level, black, white, "pcm1",
        hyst_limit=hyst_limit, shift_limit=shift_limit)
    words, crc_read = _p1.data_bits_to_words(bits)
    return words, crc_read, valid


@functools.partial(jax.jit, static_argnums=(5,),
                   static_argnames=("shift_limit", "hyst_limit"))
def pcm16x0_frame_decode(pixels, coords, ref_level, black, white,
                         shift_limit=2, hyst_limit=0):
    """PCM-16x0 frame decode: 3 sublines per line + control bit.

    Returns (words [F, L, 3, 3], crc_read [F, L, 3], valid [F, L, 3],
    ctrl_bit [F, L]).
    """
    from ..formats import pcm16x0 as _p16
    per_part = []
    for part, pstart in enumerate((0, 64, 129)):
        bits, valid, hyst, shift = generic_frame_decode(
            pixels, coords, ref_level, black, white, "pcm16x0",
            hyst_limit=hyst_limit, shift_limit=shift_limit,
            part_start=pstart)
        w, c = _p16.data_bits_to_words(bits)
        per_part.append((w, c, valid))
    words = jnp.stack([p[0] for p in per_part], axis=2)
    crc_read = jnp.stack([p[1] for p in per_part], axis=2)
    valid = jnp.stack([p[2] for p in per_part], axis=2)
    # Control bit: line bit 128 sampled at shift stage 0, plain threshold.
    F, L, W = pixels.shape
    n_bits, bit_ofs, between, per_line, lz, rz = FORMAT_GEOM["pcm16x0"]
    data_start = coords[:, 0].astype(jnp.int32)
    data_stop = coords[:, 1].astype(jnp.int32)
    psm, half = calc_ppb(data_start, data_stop, between)
    cpx = bit_pixel_coords(
        data_start[:, None], psm[:, None], half[:, None],
        jnp.zeros((1,), jnp.int32)[None, :], 1, 128, per_line, lz, rz,
        pixel_stop=W)                                   # [F, 1, 1]
    selc = _selection_matrix(cpx, W)
    cval = jnp.einsum("flw,fsbw->fslb", pixels.astype(jnp.bfloat16), selc,
                      preferred_element_type=jnp.float32)
    ctrl = cval[:, 0, :, 0].astype(jnp.int32) > ref_level[:, None]
    return words, crc_read, valid, ctrl


def pick_center_ref_level(black, white, min_contrast=8, min_ref_lvl=1,
                          max_ref_lvl=254, xp=jnp):
    """Mid-point reference pick (binarizer.cpp pickCenterRefLevel).

    Returns (ref_level, contrast_ok).
    """
    delta = white - black
    ok = delta >= min_contrast
    ref = black + delta // 2
    ref = xp.clip(ref, min_ref_lvl, max_ref_lvl)
    return ref, ok

"""Device (XLA/jit) twins of the stitcher's seam-scoring primitives.

The third seam-eval backend: under ``--backend tpu`` (the streaming
accelerator engine) the stitcher's padding search (reference tryPadding
stc007datastitcher.cpp:1417, findPadding :1743) runs as ONE batched
device dispatch scoring every padding 0..P-1 of a seam — each padding
is just a different index map into a master [field1 tail | silent row |
field2 head] buffer resident on the device (SURVEY.md §7.5).
Per-padding semantics are identical to ops.stitch_native.eval_seam /
the numpy queue path, pinned by tests/test_device_stitch.py.

Shapes are fully static: the field tail/head are capped at KEEP=120
rows (MIN_DEINT_DATA + INTERLEAVE_OFS/2, the most any padding queue
can use per side) and the sweep always scores P_MAX pads — narrower
sweeps mask with mode = -1 — so ONE XLA compilation serves every seam
of a capture.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..formats import stc007
from . import binarize as bz
from . import deinterleave as di

KEEP = stc007.MIN_DEINT_DATA + stc007.INTERLEAVE_OFS // 2   # 120
P_MAX = stc007.INTERLEAVE_OFS * 2                           # 32 paddings
# Longest queue: len1 <= KEEP - pad, so L = len1+pad+count2 <= 2*KEEP.
B_MAX = 2 * KEEP - stc007.MIN_DEINT_DATA                    # 128 blocks

# Flag bits (stitchcore.cpp stc007_eval_rows flags contract).
FLAG_BROKEN, FLAG_BLOCK_VALID, FLAG_CAN_FORCE, FLAG_SILENT = 1, 2, 4, 8
FLAG_FIX_P, FLAG_FIX_Q, FLAG_CWD_APP = 16, 32, 64


def blocks_flags_samples(batch: di.BlockBatch, cwd_in, m2: bool):
    """Per-block packed flags u8 + samples [B, 6] i16 from a corrected
    BlockBatch (the aux quantities of stitcher_stc007.eval_rows)."""
    is16 = batch.resolution == di.RES_16BIT
    lim = jnp.where(is16, 7, 8)
    widx = jnp.arange(8)[None, :]
    in_lim = widx < lim[:, None]
    broken = batch.audio_state == di.AUD_BROKEN
    block_valid = jnp.all(batch.valid[:, :6], axis=-1)
    raw_errs = jnp.sum(((~batch.line_crc) & in_lim) & ~(cwd_in & in_lim),
                       axis=-1)
    can_force = ~broken & jnp.where(is16, raw_errs == 0, raw_errs <= 1)
    samples = di.block_samples(batch, m2=m2, xp=jnp)
    silent = jnp.all(samples == 0, axis=-1)
    flags = (broken.astype(jnp.uint8) * FLAG_BROKEN
             | block_valid.astype(jnp.uint8) * FLAG_BLOCK_VALID
             | can_force.astype(jnp.uint8) * FLAG_CAN_FORCE
             | silent.astype(jnp.uint8) * FLAG_SILENT
             | (batch.audio_state == di.AUD_FIX_P).astype(jnp.uint8)
             * FLAG_FIX_P
             | (batch.audio_state == di.AUD_FIX_Q).astype(jnp.uint8)
             * FLAG_FIX_Q)
    return flags, samples


def select_by_mode(r14: di.BlockBatch, r16: di.BlockBatch, mode):
    """Per-block resolution-mode select: M14/M16 fixed, M14A/M16A fall
    back to the other resolution on STG_BAD_BLOCK (processBlock's
    refill passes, stc007deinterleaver.cpp:349-377)."""
    bad14 = r14.stage == di.STG_BAD_BLOCK
    bad16 = r16.stage == di.STG_BAD_BLOCK
    use16 = ((mode == di.RES_MODE_16BIT)
             | ((mode == di.RES_MODE_16BIT_AUTO) & ~(bad16 & ~bad14))
             | ((mode == di.RES_MODE_14BIT_AUTO) & bad14 & ~bad16))
    sel = lambda a, b: jnp.where(
        use16.reshape(use16.shape + (1,) * (a.ndim - 1)), b, a)
    return di.BlockBatch(*(sel(a, b) for a, b in zip(r14, r16)))


def assemble_rows_16(line_words, line_crc, rows):
    """16-bit (PCM-F1) block assembly over explicit row maps [.., 8]:
    14-bit word << 2 + 2 LSBs from the S-word of the SAME line
    (stc007deinterleaver.cpp:1195-1274)."""
    widx = jnp.arange(8, dtype=jnp.int32)
    w = line_words[rows, widx]
    c = line_crc[rows, widx]
    s_words = line_words[rows[..., :7], di.WORD_Q0]
    s_crc = line_crc[rows[..., :7], di.WORD_Q0]
    shifts = jnp.asarray(stc007.F1_S_OFFSETS, jnp.int32)
    w16 = ((w[..., :7] << stc007.F1_WORD_OFS)
           + ((s_words >> shifts) & stc007.F1_S_MASK))
    c16 = c[..., :7] & s_crc
    zeros = jnp.zeros_like(w[..., :1])
    return (jnp.concatenate([w16, zeros], axis=-1),
            jnp.concatenate([c16, jnp.ones_like(c[..., :1])], axis=-1),
            w, c)


def eval_rows_device(line_words, line_crc, rows, mode, en_p, en_q,
                     force_ecc, m2):
    """stitcher eval_rows compute core on device: rows [B, 8] absolute
    line indices, mode [B] i32 res mode per block (data, not static).
    Returns (flags [B] u8, samples [B, 6] i16, batch BlockBatch)."""
    w16, c16, w14, c14 = assemble_rows_16(line_words, line_crc, rows)
    r14 = di.correct_blocks(w14, c14, di.RES_14BIT, en_p=en_p, en_q=en_q,
                            force_ecc=force_ecc, xp=jnp)
    r16 = di.correct_blocks(w16, c16, di.RES_16BIT, en_p=en_p, en_q=en_q,
                            force_ecc=force_ecc, xp=jnp)
    batch = select_by_mode(r14, r16, mode)
    cwd_in = jnp.zeros(rows.shape[:-1] + (8,), bool)
    flags, samples = blocks_flags_samples(batch, cwd_in, m2)
    return flags, samples, batch


def burst_stats_batch(flags, nb, unch_lim, en_q: bool,
                      max_burst_silence: int, max_burst_broken: int):
    """Vectorized tryPadding burst counters over a batch of seams.

    flags [P, B] u8 (zeroed beyond each seam's nb blocks), nb [P] i32.
    Serial semantics of stc007datastitcher.cpp:1623-1720, cumulative-sum
    formulation (twin of stitcher_stc007._burst_stats; zero-padding the
    tail is safe: resets never fire there and the valid run freezes, so
    the trailing candidates equal the final run).
    Returns stats [P, 4] i32 = (valid_max, silent_max, unch_max, broken).
    """
    P, B = flags.shape
    idx = jnp.arange(B)[None, :]
    live = idx < nb[:, None]
    flags = jnp.where(live, flags, 0)
    broken = (flags & FLAG_BROKEN) != 0
    block_valid = (flags & FLAG_BLOCK_VALID) != 0
    can_force = (flags & FLAG_CAN_FORCE) != 0
    silent = (flags & FLAG_SILENT) != 0
    valid_b = block_valid & ~silent & can_force
    if en_q:
        unch = (~can_force | ((flags & FLAG_FIX_Q) != 0)) & live
    else:
        unch = (flags & FLAG_FIX_P) != 0

    def runs(mask):
        last_false = jax.lax.cummax(jnp.where(~mask, idx, -1), axis=1)
        return jnp.where(mask, idx - last_false, 0)

    sil_run = runs(silent)
    unch_run = runs(unch)
    sil_max = jnp.max(sil_run, axis=1)
    unch_max = jnp.max(unch_run, axis=1)
    broken_count = jnp.sum(broken, axis=1)

    reset = ((silent & (sil_run >= max_burst_silence))
             | (unch & (unch_run >= unch_lim[:, None]))
             | (broken & (jnp.cumsum(broken, axis=1)
                          >= max_burst_broken)))
    cumv = jnp.cumsum(valid_b.astype(jnp.int32), axis=1)
    last_reset = jax.lax.cummax(jnp.where(reset, idx, -1), axis=1)
    base = jnp.take_along_axis(cumv, jnp.maximum(last_reset, 0), axis=1)
    run_after = cumv - jnp.where(last_reset >= 0, base, 0)
    prev_run = jnp.concatenate(
        [jnp.zeros((P, 1), run_after.dtype), run_after[:, :-1]], axis=1)
    final = jnp.take_along_axis(
        run_after, jnp.maximum(nb[:, None] - 1, 0), axis=1)[:, 0]
    final = jnp.where(nb > 0, final, 0)
    cand = jnp.max(jnp.where(~valid_b, prev_run, 0), axis=1)
    valid_max = jnp.maximum(cand, final)
    return jnp.stack([valid_max, sil_max, unch_max, broken_count],
                     axis=1).astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("en_p", "en_q", "force_ecc", "m2"))
def _eval_rows_jit(line_words, line_crc, rows, modes, en_p, en_q,
                   force_ecc, m2):
    flags, samples, batch = eval_rows_device(
        line_words, line_crc, rows, modes, en_p, en_q, force_ecc, m2)
    return (batch.words, batch.valid, batch.line_crc, batch.audio_state,
            batch.stage, batch.resolution, flags, samples)


def _bucket(n, step=128):
    return max(step, -(-n // step) * step)


def eval_rows_arrays(line_words_i32, line_crc8, rows, start, n_blocks,
                     res_mode, en_p, en_q, force_ecc, m2):
    """Device twin of stitch_native.eval_rows_arrays: one dispatch per
    call; L and B are padded to 128-line buckets so a capture's whole
    decode reuses a handful of XLA compilations.

    rows=None means contiguous shifts from `start`.  Returns
    (words i64 [B,8], valid, line_crc, state, stage, res, flags,
    samples) — the exact native-core output contract."""
    B = int(n_blocks)
    if rows is None:
        taps = np.arange(8, dtype=np.int64) * stc007.INTERLEAVE_OFS
        rows = (np.arange(start, start + B, dtype=np.int64)[:, None]
                + taps[None, :])
    L = line_words_i32.shape[0]
    Lp, Bp = _bucket(L), _bucket(B)
    w = np.zeros((Lp, 8), np.int32)
    c = np.zeros((Lp, 8), bool)
    w[:L] = line_words_i32
    c[:L] = line_crc8
    r = np.zeros((Bp, 8), np.int32)
    r[:B] = rows
    modes = np.full(Bp, res_mode, np.int32)
    out = _eval_rows_jit(jnp.asarray(w), jnp.asarray(c), jnp.asarray(r),
                         jnp.asarray(modes), bool(en_p), bool(en_q),
                         bool(force_ecc), bool(m2))
    words, valid, lcrc, state, stage, res, flags, samples = \
        (np.asarray(o) for o in out)
    return (words[:B].astype(np.int64), valid[:B], lcrc[:B], state[:B],
            stage[:B], res[:B], flags[:B], samples[:B])


@functools.partial(jax.jit, static_argnames=("en_p", "en_q", "m2"))
def _seam_sweep(f1_words, f1_crc, f1_len, f2_words, f2_crc, f2_len,
                silent_w, modes, unch_lim, en_p, en_q, m2):
    """Score P_MAX paddings of one seam in one dispatch.

    f1_words [KEEP, 8] i32: field-1 tail, RIGHT-aligned (row KEEP-1 is
    the field's last line; unused leading rows are never referenced).
    f2_words [KEEP, 8]: field-2 head, top-aligned.  modes [P_MAX] i32
    res mode per padding (-1 = skip).  unch_lim [P_MAX] i32 per pad.
    Returns (stats [P_MAX, 4] i32, nb [P_MAX] i32).
    """
    master_w = jnp.concatenate([f1_words, silent_w[None, :], f2_words])
    master_c = jnp.concatenate(
        [f1_crc, jnp.zeros((1, 8), bool), f2_crc])
    pads = jnp.arange(P_MAX, dtype=jnp.int32)
    len1 = jnp.minimum(f1_len, KEEP - pads)                  # [P]
    count2 = jnp.minimum(f2_len, KEEP)
    nb = len1 + pads + count2 - stc007.MIN_DEINT_DATA        # [P]
    taps = jnp.arange(8, dtype=jnp.int32) * stc007.INTERLEAVE_OFS
    r = (jnp.arange(B_MAX, dtype=jnp.int32)[None, :, None]
         + taps[None, None, :])                              # [1, B, 8]
    l1 = len1[:, None, None]
    p = pads[:, None, None]
    rows = jnp.where(
        r < l1, KEEP - l1 + r,
        jnp.where(r < l1 + p, KEEP, KEEP + 1 + r - l1 - p))
    rows = jnp.clip(rows, 0, master_w.shape[0] - 1)
    mode_b = jnp.broadcast_to(modes[:, None], (P_MAX, B_MAX))
    flags, _, _ = eval_rows_device(
        master_w, master_c, rows.reshape(P_MAX * B_MAX, 8),
        mode_b.reshape(-1), en_p, en_q, True, m2)
    nb = jnp.where(modes >= 0, jnp.maximum(nb, 0), 0)
    stats = burst_stats_batch(flags.reshape(P_MAX, B_MAX), nb, unch_lim,
                              en_q, MAX_BURST_SILENCE, MAX_BURST_BROKEN)
    return stats, nb


MAX_BURST_SILENCE = stc007.INTERLEAVE_OFS // 2  # 8
MAX_BURST_BROKEN = 1


def _right_aligned_tail(words, crc8, cap=KEEP):
    """Last <= cap rows placed at the END of a [cap, 8] buffer."""
    n = min(len(words), cap)
    w = np.zeros((cap, 8), np.int32)
    c = np.zeros((cap, 8), bool)
    if n:
        w[cap - n:] = words[len(words) - n:]
        c[cap - n:] = crc8[len(words) - n:]
    return w, c, n


def _top_aligned_head(words, crc8, cap=KEEP):
    n = min(len(words), cap)
    w = np.zeros((cap, 8), np.int32)
    c = np.zeros((cap, 8), bool)
    if n:
        w[:n] = words[:n]
        c[:n] = crc8[:n]
    return w, c, n


# ---------------------------------------------------------------------------
# Device-resident steady round: binarize + duplicate detection + DUAL
# (14- and 16-bit) block eval of every pair's seam/res/conv queues in
# ONE dispatch per round of frames.  No resolution-mode logic, burst
# counters or finalize masking run on device — the host selects per
# block by the ACTUAL stage-machine mode at replay time and verifies
# the speculated geometry, so results are bit-identical by
# construction or discarded (docs/STEADY.md contract).
# ---------------------------------------------------------------------------

# packed u32 block word: valid[0:8] | line_crc[8:16] | flags[16:22]
# (FLAG_* order) | stage==BAD_BLOCK at bit 22.
PACK_BAD_BIT = 22
PACK_U16_BIT = 23   # selected-pack readback: 1 = 16-bit eval chosen


def _dual_eval(words_all, crc_all, rows, en_p, en_q, m2):
    """Both-resolutions eval over explicit rows: returns
    (packed [B, 2] u32, samples [B, 2, 6] i16), index 0 = 14-bit."""
    w16, c16, w14, c14 = assemble_rows_16(words_all, crc_all, rows)
    packs, samps = [], []
    for res, (w, c) in ((di.RES_14BIT, (w14, c14)),
                        (di.RES_16BIT, (w16, c16))):
        r = di.correct_blocks(w, c, res, en_p=en_p, en_q=en_q,
                              force_ecc=True, xp=jnp)
        cwd = jnp.zeros(rows.shape[:-1] + (8,), bool)
        flags, samples = blocks_flags_samples(r, cwd, m2)
        bits = jnp.arange(8, dtype=jnp.uint32)
        vbits = jnp.sum(r.valid.astype(jnp.uint32) << bits, axis=-1)
        lbits = jnp.sum(r.line_crc.astype(jnp.uint32) << bits, axis=-1)
        bad = (r.stage == di.STG_BAD_BLOCK).astype(jnp.uint32)
        packs.append(vbits | (lbits << 8)
                     | (flags.astype(jnp.uint32) << 16)
                     | (bad << PACK_BAD_BIT))
        samps.append(samples)
    return jnp.stack(packs, axis=1), jnp.stack(samps, axis=1)


def _dup_device(words, crc_read, valid, m2):
    """find_duplicate_lines twin on device: words [F, L, 8] i32,
    crc_read [F, L] i32, valid [F, L] bool; field bounds (0, ceil(L/2)),
    (ceil(L/2), L) — the batch driver's field-sequential layout."""
    F, L, _ = words.shape
    half = (L + 1) // 2
    thres = stc007.BITS_PCM_DATA // 4  # BIT_DIFF_THRES_DIV = 4
    samples = stc007.expand_sample(words[..., :6], m2=m2, xp=jnp)
    almost_silent = jnp.sum(
        (jnp.abs(samples.astype(jnp.int32)) < 16).astype(jnp.int32),
        axis=-1) >= 2
    idx = jnp.arange(L)
    fld = (idx >= half).astype(jnp.int32)           # field id per row
    # previous valid row WITHIN the same field (cummax resets at the
    # boundary by keying on field id).
    cand = jnp.where(valid, idx[None, :], -1)
    prev_incl = jax.lax.cummax(
        jnp.where(fld[None, :] == 0, cand, -1), axis=1)
    prev_incl2 = jax.lax.cummax(
        jnp.where(fld[None, :] == 1, cand, -1), axis=1)
    prev_incl = jnp.where(fld[None, :] == 0, prev_incl, prev_incl2)
    prev = jnp.concatenate(
        [jnp.full((F, 1), -1), prev_incl[:, :-1]], axis=1)
    prev = jnp.where(fld[None, :] == jnp.where(prev >= 0, fld[prev], -1),
                     prev, -1)
    pw = jnp.take_along_axis(words, jnp.maximum(prev, 0)[..., None],
                             axis=1)
    pc = jnp.take_along_axis(crc_read, jnp.maximum(prev, 0), axis=1)
    diff = jnp.sum(jax.lax.population_count(
        (words ^ pw).astype(jnp.uint32)), axis=-1) \
        + jax.lax.population_count((crc_read ^ pc).astype(jnp.uint32))
    return valid & (prev >= 0) & (diff <= thres) & ~almost_silent


def _steady_round_core(pixels, coords, refs, blacks, whites, usable,
                       prev_words, prev_ok8, carry_w, carry_ok8,
                       rows_g1, rows_g2, silent_w,
                       en_p, en_q, m2, hyst_limit, shift_limit):
    """The chip-resident production round: binarize a round of frames
    from HBM-resident pixels, run duplicate detection, and dual-eval
    every speculated seam/res/conv queue — one dispatch, outputs read
    back asynchronously.

    pixels [F, Ls, W] u8 (resident), prep arrays [F], prev_* [Ls, 8]
    (previous round's last frame, device handles), carry [112, 8]
    (uploaded conv state), rows_g1/g2 [B, 8] i32 (geometry-cached row
    maps into [prev | round | carry | silent]).
    Returns (words, crc_read, valid, dup, packed1, samples1, packed2,
    words_flat, lineok) — the last two stay on device for the next
    round's prev_* inputs."""
    F, Ls, W = pixels.shape
    batch = bz.stc007_frame_decode(
        pixels, coords, refs, blacks, whites,
        hyst_limit=hyst_limit, shift_limit=shift_limit)
    words = jnp.where(usable[:, None, None],
                      batch.words.astype(jnp.int32), 0)
    crc_read = jnp.where(usable[:, None], batch.crc_read.astype(jnp.int32),
                         0)
    valid = batch.valid & usable[:, None]
    dup = _dup_device(words, crc_read, valid, m2)
    lineok = (valid & ~dup).reshape(F * Ls)
    ok8 = jnp.repeat(lineok[:, None], 8, axis=1)
    wflat = words.reshape(F * Ls, 8)
    words_all = jnp.concatenate([prev_words, wflat, carry_w,
                                 silent_w[None, :]])
    ok_all = jnp.concatenate([prev_ok8, ok8, carry_ok8,
                              jnp.zeros((1, 8), bool)])
    packed1, samples1 = _dual_eval(words_all, ok_all, rows_g1,
                                   en_p, en_q, m2)
    packed2, _ = _dual_eval(words_all, ok_all, rows_g2, True, False, m2)
    return (words, crc_read, valid, dup, packed1, samples1, packed2,
            wflat, ok8)


MDD_ = stc007.MIN_DEINT_DATA


def round_param_layout(F):
    """Offsets into the packed per-round i32 parameter vector (ONE
    host->device upload per round instead of seven)."""
    o, n = {}, 0
    for key, sz in (("coords", 2 * F), ("refs", F), ("blacks", F),
                    ("whites", F), ("usable", F),
                    ("carry_w", MDD_ * 8), ("carry_ok", MDD_ * 8),
                    ("pred_mode", 1), ("unch_lim", 1)):
        o[key] = n
        n += sz
    return o, n


@functools.partial(
    jax.jit, static_argnames=("B_conv", "en_p", "en_q", "m2",
                              "hyst_limit", "shift_limit", "chained"))
def steady_round_packed(pixels, params, prev_words, prev_ok8,
                        carry_w_dev, carry_ok_dev, carry_next_rows,
                        rows_g1, rows_g2, nb_seam, silent_w, B_conv,
                        en_p, en_q, m2, hyst_limit, shift_limit,
                        chained=False):
    """One-upload / one-read steady round: _steady_round_core plus the
    on-device reductions of its outputs.

    Every per-round scalar input arrives in ONE i32 vector
    (round_param_layout) and
    every host-bound output leaves in ONE i32 buffer:
    crc|valid|dup|cb|crcm as one word per line (the word VALUES never
    cross — they stay resident and LineStore fetches rows lazily on a
    fallback), the conv queues' pred-mode-selected pack + samples, and
    the inner/outer seam queues fully reduced to their 4 burst
    counters each (only [F, 2, 4] i32 cross).  rows_g1 lays out ALL conv
    blocks first (B_conv of them), then per pair the inner and outer
    seam queues padded to B_MAX blocks (nb_seam [2F] i32 real
    lengths).  Returns (out i32 [N], words_flat [F*Ls, 8] resident
    CB-rewritten words, words_tail [Ls, 8], ok8_tail [Ls, 8]) — the
    tails stay on device as the next round's prev_* inputs."""
    F, Ls, _ = pixels.shape
    o, _n = round_param_layout(F)

    def cut(key, sz):
        return jax.lax.slice_in_dim(params, o[key], o[key] + sz)

    coords = cut("coords", 2 * F).reshape(F, 2)
    refs = cut("refs", F)
    blacks = cut("blacks", F)
    whites = cut("whites", F)
    usable = cut("usable", F).astype(bool)
    if chained:
        # The pair-0 carry is the PREVIOUS round's device-computed
        # chain carry (carry_next_* outputs) — nothing was uploaded and
        # the host never materialized its conv words.  The replay
        # verifies via the _steady_chain rule (carry_n = -1).
        carry_w = carry_w_dev
        carry_ok = carry_ok_dev
    else:
        carry_w = cut("carry_w", MDD_ * 8).reshape(MDD_, 8)
        carry_ok = cut("carry_ok", MDD_ * 8).reshape(MDD_, 8) \
            .astype(bool)
    pred_mode = cut("pred_mode", 1)[0]
    unch_lim = cut("unch_lim", 1)[0]
    (words, crc_read, valid, dup, packed1, samples1, packed2,
     wflat, ok8) = _steady_round_core(
        pixels, coords, refs, blacks, whites, usable,
        prev_words, prev_ok8, carry_w, carry_ok, rows_g1, rows_g2,
        silent_w, en_p, en_q, m2, hyst_limit, shift_limit)
    # The word VALUES stay in HBM (wflat returns as a resident array;
    # LineStore materializes rows lazily on a fallback).  What crosses
    # is one i32 of per-line facts: the source CRC — REWRITTEN for
    # Control-Block lines exactly as LineStore.from_decoded would
    # (zero the cue words, re-CRC; stc007line.cpp:101-129) — plus
    # valid/dup/cb/crc-match bits.
    cb = valid & stc007.is_control_block(words, xp=jnp)       # [F, Ls]
    words_rw = jnp.where(cb[..., None] & (jnp.arange(8) < 4),
                         0, words)
    crc_calc = stc007.calc_crc(words_rw, xp=jnp).astype(jnp.int32)
    crc_out = jnp.where(cb, crc_calc, crc_read)
    crcm = crc_calc == crc_out
    meta = (crc_out & 0xFFFF
            | (valid.astype(jnp.int32) << 16)
            | (dup.astype(jnp.int32) << 17)
            | (cb.astype(jnp.int32) << 18)
            | (crcm.astype(jnp.int32) << 19)).reshape(-1)
    wflat_rw = words_rw.reshape(-1, 8)

    def use16_of(pk):
        """spec_use16's exact math over the dual-eval bad bits."""
        bad14 = (pk[:, 0] >> PACK_BAD_BIT) & 1
        bad16 = (pk[:, 1] >> PACK_BAD_BIT) & 1
        return ((pred_mode == di.RES_MODE_16BIT)
                | ((pred_mode == di.RES_MODE_16BIT_AUTO)
                   & ~((bad16 == 1) & (bad14 == 0)))
                | ((pred_mode == di.RES_MODE_14BIT_AUTO)
                   & (bad14 == 1) & (bad16 == 0)))

    # Conv queues: pack AND samples selected ON DEVICE by the
    # predicted resolution mode (one u32 + 6 i16 per block instead of
    # the dual readback).  The chosen resolution is recorded at bit 23
    # of the selected pack (PACK_U16_BIT) for the host finalize.  The
    # replay verifies its actual conv mode equals pred_mode or bails
    # the pair (BS_SPEC).
    pk_conv = packed1[:B_conv]
    u16c = use16_of(pk_conv)
    sel_c = jnp.take_along_axis(
        pk_conv, u16c.astype(jnp.int32)[:, None], axis=1)[:, 0]
    sel_c = sel_c | (u16c.astype(jnp.uint32) << PACK_U16_BIT)
    p1 = jax.lax.bitcast_convert_type(sel_c, jnp.int32)
    cs_sel = jnp.take_along_axis(
        samples1[:B_conv], u16c.astype(jnp.int32)[:, None, None],
        axis=1)[:, 0]                                        # [Bc, 6]
    cs = jax.lax.bitcast_convert_type(
        cs_sel.reshape(-1, 2), jnp.int32)
    # Inner/outer seam queues: burst counters reduced ON DEVICE under
    # the same predicted mode (the serial tryPadding counters are a
    # cumulative-scan formulation, burst_stats_batch) — [2F, 4] i32
    # instead of every seam block's dual pack.
    pk_seam = packed1[B_conv:]                               # [2F*B_MAX, 2]
    u16s = use16_of(pk_seam).astype(jnp.int64)
    sel = jnp.take_along_axis(pk_seam, u16s[:, None], axis=1)[:, 0]
    sflags = ((sel >> 16) & 0x3F).astype(jnp.uint8).reshape(-1, B_MAX)
    seam_stats = burst_stats_batch(
        sflags, nb_seam, jnp.broadcast_to(unch_lim, nb_seam.shape),
        en_q, MAX_BURST_SILENCE, MAX_BURST_BROKEN).reshape(-1)
    # Fresh-field resolution counts reduced ON DEVICE: the floored-
    # decrement block counter (getFieldResolution :1090-1140) is a
    # cumsum/cummin scan, so only [F, 2 fields, 2 resolutions] i32
    # counts are read back instead of every res-queue block's pack.
    n_res = Ls // 2 - MDD_
    if n_res > 0:
        flags2 = (packed2 >> 16).astype(jnp.int32)
        good = ((flags2 & 2) != 0) & ((flags2 & 4) != 0) \
            & ((flags2 & 8) == 0)
        broken = (flags2 & 1) != 0
        x = good.astype(jnp.int32) - (~good & broken).astype(jnp.int32)
        x = x.reshape(F, 2, n_res, 2)
        cum = jnp.cumsum(x, axis=2)
        mn = jnp.minimum(jnp.min(cum, axis=2), 0)
        counts = (cum[:, :, -1, :] - mn).reshape(-1)
    else:
        counts = jnp.zeros(F * 4, jnp.int32)
    out = jnp.concatenate([meta, p1, cs, counts, seam_stats])
    # The NEXT round's chained pair-0 carry, computed here so steady
    # chains never upload a carry or materialize host conv words:
    # the end-of-round conv tail rows gathered over the CB-REWRITTEN
    # buffer (= the host store/conv content by construction).
    words_all_rw = jnp.concatenate([prev_words, wflat_rw, carry_w,
                                    silent_w[None, :]])
    ok_all = jnp.concatenate([prev_ok8, ok8, carry_ok,
                              jnp.zeros((1, 8), bool)])
    carry_next_w = words_all_rw[carry_next_rows]
    carry_next_ok = ok_all[carry_next_rows]
    return (out, wflat_rw, wflat_rw[-Ls:], ok8[-Ls:],
            carry_next_w, carry_next_ok)


def unpack_round(buf, F, Ls, Bc):
    """Host-side split of steady_round_packed's output buffer.  Returns
    (crc_read [F,Ls] i32 (CB-rewritten), valid, dup, cb, crcm [F,Ls]
    bool, packed_conv [Bc] u32 (pred_mode-selected, chosen resolution
    at PACK_U16_BIT), samples_conv [Bc,6] i16 (pred_mode-selected),
    res_counts [F,2,2] i32 — per frame (odd, even) x (count14,
    count16), seam_stats [F,2,4] i32 — per pair (inner, outer) x
    (valid_max, silent_max, unch_max, broken)).  The word values do
    NOT cross: they stay in the round's resident words_flat array."""
    n_m = F * Ls
    pos = 0
    meta = buf[pos:pos + n_m].reshape(F, Ls)
    pos += n_m
    crc_read = meta & 0xFFFF
    valid = (meta & (1 << 16)) != 0
    dup = (meta & (1 << 17)) != 0
    cb = (meta & (1 << 18)) != 0
    crcm = (meta & (1 << 19)) != 0
    packed_conv = buf[pos:pos + Bc].view(np.uint32)
    pos += Bc
    samples_conv = buf[pos:pos + 3 * Bc].view(np.int16) \
        .reshape(Bc, 6)
    pos += 3 * Bc
    res_counts = buf[pos:pos + 4 * F].reshape(F, 2, 2)
    pos += 4 * F
    seam_stats = buf[pos:pos + 8 * F].reshape(F, 2, 4)
    return (crc_read, valid, dup, cb, crcm, packed_conv, samples_conv,
            res_counts, seam_stats)


def unpack_eval_host(sel):
    """Decode device-selected single-pack evals (steady_round_packed's
    conv section): sel [B] u32 with valid[0:8] | line_crc[8:16] |
    flags[16:22] | bad at 22 | chosen-res at PACK_U16_BIT.  Returns
    (flags u8 [B], valid [B,8] bool, lcrc [B,8] bool)."""
    flags = ((sel >> 16) & 0x3F).astype(np.uint8)
    bits = np.arange(8, dtype=np.uint32)
    valid = ((sel[:, None] >> bits) & 1).astype(bool)
    lcrc = ((sel[:, None] >> (8 + bits)) & 1).astype(bool)
    return flags, valid, lcrc


def select_dual_host(packed, mode, samples=None):
    """Host-side resolution-mode select over dual-eval outputs:
    packed [B, 2] u32, mode scalar int or [B].  Returns
    (flags u8 [B], valid [B,8] bool, lcrc [B,8] bool, samples [B,6])."""
    bad14 = (packed[:, 0] >> PACK_BAD_BIT) & 1
    bad16 = (packed[:, 1] >> PACK_BAD_BIT) & 1
    mode = np.broadcast_to(np.asarray(mode), (packed.shape[0],))
    use16 = ((mode == di.RES_MODE_16BIT)
             | ((mode == di.RES_MODE_16BIT_AUTO)
                & ~((bad16 == 1) & (bad14 == 0)))
             | ((mode == di.RES_MODE_14BIT_AUTO)
                & (bad14 == 1) & (bad16 == 0)))
    sel = packed[np.arange(packed.shape[0]), use16.astype(np.int64)]
    flags = ((sel >> 16) & 0x3F).astype(np.uint8)
    bits = np.arange(8, dtype=np.uint32)
    valid = ((sel[:, None] >> bits) & 1).astype(bool)
    lcrc = ((sel[:, None] >> (8 + bits)) & 1).astype(bool)
    out_samples = None
    if samples is not None:
        out_samples = samples[np.arange(samples.shape[0]),
                              use16.astype(np.int64)]
    return flags, valid, lcrc, out_samples


def seam_sweep(f1_words, f1_crc8, f2_words, f2_crc8, silent_w32, modes,
               en_p, en_q, m2, unch_lim):
    """Host wrapper: all-paddings seam stats on the device.

    f1/f2 words [n,8] i32 + crc8 [n,8] bool (full fields; only the
    KEEP-row tail/head is shipped), modes len<=P_MAX ints (-1 skip),
    unch_lim int or per-pad array.  Returns (stats [len(modes),4] i64,
    has [len(modes)] bool) matching stitch_native.padding_sweep.
    """
    P = len(modes)
    md = np.full(P_MAX, -1, np.int32)
    md[:P] = np.asarray(modes, np.int32)[:P_MAX]
    ul = np.broadcast_to(np.asarray(unch_lim, np.int32), (P,))
    ulf = np.zeros(P_MAX, np.int32)
    ulf[:P] = ul[:P_MAX]
    w1, c1, n1 = _right_aligned_tail(np.asarray(f1_words, np.int32),
                                     np.asarray(f1_crc8, bool))
    w2, c2, n2 = _top_aligned_head(np.asarray(f2_words, np.int32),
                                   np.asarray(f2_crc8, bool))
    stats, nb = _seam_sweep(
        jnp.asarray(w1), jnp.asarray(c1), jnp.int32(len(f1_words)),
        jnp.asarray(w2), jnp.asarray(c2), jnp.int32(len(f2_words)),
        jnp.asarray(np.asarray(silent_w32, np.int32)),
        jnp.asarray(md), jnp.asarray(ulf),
        bool(en_p), bool(en_q), bool(m2))
    stats = np.asarray(stats)[:P]
    nb = np.asarray(nb)[:P]
    has = (nb > 0) & (md[:P] >= 0)
    return stats, has

"""STC-007 deinterleave + P/Q erasure correction, vectorized over blocks.

The reference processes one data block at a time through a serial state
machine (stc007deinterleaver.cpp:286-1123 `processBlock`) with 21 explicit
Q-code solve branches (:1627-1977).  Here ALL blocks in a line buffer are
deinterleaved and corrected at once:

  * block assembly is a gather: word w of the block at line shift s comes
    from line s + 16*w (stc007datablock.h:38-59);
  * the entire decision tree is evaluated branch-free with masks; the 21
    Q-solve branches collapse to   e1 = A[pair] @ sq  ^  B[pair] @ sp,
    e2 = e1 ^ sp  with per-pair GF(2) matrices gathered from a 22-entry bank
    (A = (T^d+I)^-1 T^-(6-j), B = (T^d+I)^-1 for audio pairs i<j<=5;
     A = T^-(6-i), B = 0 when the second erasure is the P word);
  * auto resolution (14<->16 refill passes, :349-377, :1039-1056) becomes
    "decode both resolutions, select" — each pass is deterministic, so the
    reference's 3-pass refill loop reduces to a 2-way select.

Semantics replicated bit-exactly from the reference, including:
  forced error check -> BROKEN marking (the stitcher's key mis-alignment
  signal, stc007datastitcher.h:76-88), Q-word patching, FIX_NOT_NEED
  bookkeeping, and markAsBroken's flag wipe (stc007datablock.cpp).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..formats import gf2, stc007

NO_ERR_INDEX = 64  # stc007deinterleaver.h:117

# Audio data state (stc007datablock.h:104-111).
AUD_ORIG, AUD_FIX_P, AUD_FIX_Q, AUD_BROKEN = range(4)
# Exit stage (subset of stc007deinterleaver.h:126-138 that survives a pass).
STG_DATA_OK, STG_NO_CHECK, STG_BAD_BLOCK = range(3)
# Resolution.
RES_14BIT, RES_16BIT = 0, 1
# Resolution modes (stc007deinterleaver.h:105-113).
RES_MODE_14BIT, RES_MODE_14BIT_AUTO, RES_MODE_16BIT_AUTO, RES_MODE_16BIT = (
    range(4))

_W = stc007  # alias for word indices
N_WORDS = 8
N_AUDIO = 6
WORD_P0, WORD_Q0 = 6, 7


class BlockBatch(NamedTuple):
    """Decoded data blocks [B, ...]."""
    words: jnp.ndarray        # [B, 8] int32
    valid: jnp.ndarray        # [B, 8] bool  (word_valid after correction)
    line_crc: jnp.ndarray     # [B, 8] bool  (source CRC state per word)
    audio_state: jnp.ndarray  # [B] int32    (AUD_*)
    stage: jnp.ndarray        # [B] int32    (STG_*)
    resolution: jnp.ndarray   # [B] int32    (RES_14BIT / RES_16BIT)


@functools.lru_cache(maxsize=None)
def _q_solve_banks():
    """A/B matrix banks indexed by pair id = i*7 + (j-1) flattened.

    Pair (i, j) with 0 <= i < j <= 6 (j==6 means the P word).
    Returns (A [49,14,14], B [49,14,14], np arrays); unused slots zero.
    """
    A = np.zeros((49, 14, 14), dtype=np.uint8)
    B = np.zeros((49, 14, 14), dtype=np.uint8)
    for i in range(6):
        for j in range(i + 1, 7):
            k = i * 7 + j
            if j <= 5:
                d = j - i
                inv = gf2.tk_plus_i_inv(d)
                A[k] = gf2.matmul_gf2(inv, gf2.tpow(-(6 - j)))
                B[k] = inv
            else:  # second erasure is P0
                A[k] = gf2.tpow(-(6 - i))
                # B stays zero
    return A, B


@functools.lru_cache(maxsize=None)
def _q_solve_banks_stacked():
    """Stacked transposed banks [14, 49*14] so e1 contributions for all
    pairs come from two fixed matmuls."""
    A, B = _q_solve_banks()
    Astack = np.concatenate([A[k].T for k in range(49)], axis=1)
    Bstack = np.concatenate([B[k].T for k in range(49)], axis=1)
    return Astack.astype(np.int64), Bstack.astype(np.int64)


def _calc_p(words):
    """P parity (stc007deinterleaver.cpp:1296-1304): XOR of audio words."""
    return (words[..., 0] ^ words[..., 1] ^ words[..., 2]
            ^ words[..., 3] ^ words[..., 4] ^ words[..., 5])


def _gf2_apply_const(matrix: np.ndarray, words, xp=jnp):
    return gf2.apply_gf2(matrix, words, xp=xp)


@functools.lru_cache(maxsize=None)
def _q_matrix_stacked():
    """[84, 14] stacked GF(2) matrix: concat of T^(6-k).T for k=0..5, so
    the whole Q code is ONE matmul over the 6 words' 84 bits."""
    return np.concatenate([gf2.tpow(6 - k).T for k in range(6)],
                          axis=0).astype(np.int64)


def _calc_q(words, xp=jnp):
    """Q code (stc007deinterleaver.cpp:1306-1317): sum T^(6-k) w_k.

    Evaluated as a single [..., 84] @ [84, 14] parity matmul.
    """
    shifts = np.arange(gf2.BITS)
    bits = (words[..., :6, None].astype(xp.int32) >> shifts) & 1
    flat = bits.reshape(bits.shape[:-2] + (6 * gf2.BITS,))
    m = _q_matrix_stacked()
    if xp is jnp:
        out = jnp.matmul(flat.astype(jnp.int32),
                         jnp.asarray(m, jnp.int32),
                         preferred_element_type=jnp.int32) & 1
    else:
        out = (flat.astype(np.float32) @ m.astype(np.float32)) \
            .astype(np.int64) & 1
    return gf2.bits_to_word(out, xp=xp)


def assemble_blocks(line_words, line_crc_ok, line_shifts, resolution,
                    xp=jnp):
    """Gather block words from the interleaved line buffer.

    line_words [L, 8] int32 : per-line data words (word index w is the word
        the line carries for interleave tap w, stc007line.h:89-102).
    line_crc_ok [L, 8] bool : per-word CRC flags of each line.
    line_shifts [B] int32   : block start lines.
    resolution              : RES_14BIT or RES_16BIT (static python int).

    Returns (words [B,8] int32, crc_ok [B,8] bool).
    """
    taps = np.arange(N_WORDS, dtype=np.int32) * stc007.INTERLEAVE_OFS
    rows = line_shifts[:, None] + taps[None, :]          # [B, 8]
    widx = np.arange(N_WORDS, dtype=np.int32)[None, :]   # word index per tap
    w = line_words[rows, widx]                           # [B, 8]
    c = line_crc_ok[rows, widx]
    if resolution == RES_14BIT:
        return w, c
    # 16-bit PCM-F1: 14-bit word<<2 + 2 LSBs from the same line's S-word
    # (stc007deinterleaver.cpp:1195-1274); Q slot zeroed and valid.
    s_words = line_words[rows[:, :7], WORD_Q0]           # [B, 7]
    s_crc = line_crc_ok[rows[:, :7], WORD_Q0]
    shifts = np.array(stc007.F1_S_OFFSETS, dtype=np.int32)[None, :]
    w16 = ((w[:, :7] << stc007.F1_WORD_OFS)
           + ((s_words >> shifts) & stc007.F1_S_MASK))
    c16 = c[:, :7] & s_crc
    zeros = xp.zeros_like(w[:, :1])
    w_out = xp.concatenate([w16, zeros], axis=-1)
    c_out = xp.concatenate([c16, xp.ones_like(c[:, :1])], axis=-1)
    return w_out, c_out


def assemble_blocks_contiguous(line_words, line_crc_ok, n_blocks,
                               resolution, xp=jnp):
    """assemble_blocks for consecutive shifts 0..n_blocks-1.

    Tap w of block b reads line b + 16w, so each tap column is ONE
    contiguous slice — no gather."""
    w_cols = [line_words[w * stc007.INTERLEAVE_OFS:
                         w * stc007.INTERLEAVE_OFS + n_blocks, w]
              for w in range(N_WORDS)]
    c_cols = [line_crc_ok[w * stc007.INTERLEAVE_OFS:
                          w * stc007.INTERLEAVE_OFS + n_blocks, w]
              for w in range(N_WORDS)]
    w = xp.stack(w_cols, axis=-1)
    c = xp.stack(c_cols, axis=-1)
    if resolution == RES_14BIT:
        return w, c
    s_cols = [line_words[k * stc007.INTERLEAVE_OFS:
                         k * stc007.INTERLEAVE_OFS + n_blocks, WORD_Q0]
              for k in range(7)]
    sc_cols = [line_crc_ok[k * stc007.INTERLEAVE_OFS:
                           k * stc007.INTERLEAVE_OFS + n_blocks, WORD_Q0]
               for k in range(7)]
    s_words = xp.stack(s_cols, axis=-1)
    s_crc = xp.stack(sc_cols, axis=-1)
    shifts = np.array(stc007.F1_S_OFFSETS, dtype=np.int32)[None, :]
    w16 = ((w[:, :7] << stc007.F1_WORD_OFS)
           + ((s_words >> shifts) & stc007.F1_S_MASK))
    c16 = c[:, :7] & s_crc
    zeros = xp.zeros_like(w[:, :1])
    return (xp.concatenate([w16, zeros], axis=-1),
            xp.concatenate([c16, xp.ones_like(c[:, :1])], axis=-1))


def _first_two_bad(crc_ok, xp=jnp):
    """Indices of first/second invalid audio word (or NO_ERR_INDEX)."""
    bad = ~crc_ok[..., :N_AUDIO]
    idx = np.arange(N_AUDIO, dtype=np.int32)
    big = xp.where(bad, idx, NO_ERR_INDEX)
    first = xp.min(big, axis=-1)
    big2 = xp.where(bad & (idx != first[..., None]), idx, NO_ERR_INDEX)
    second = xp.min(big2, axis=-1)
    return first, second


def correct_blocks(words, crc_ok, resolution, en_p=True, en_q=True,
                   force_ecc=True, xp=jnp):
    """Branch-free port of the decision tree of processBlock (single fill).

    words [B,8] int32, crc_ok [B,8] bool. resolution/en_*/force_ecc are
    static python values. Returns a BlockBatch.
    """
    if xp is np:
        # Host path: the native core (ops/stitch_native.py) runs the same
        # tree ~100x faster; the numpy code below stays the reference
        # implementation (tests assert bit-identity between the two).
        from . import stitch_native as _sn
        if _sn.available():
            w, v, lc, a, s = _sn.correct_blocks_arrays(
                words, crc_ok, resolution, en_p, en_q, force_ecc)
            res_arr = np.full((words.shape[0],), resolution, dtype=np.int32)
            return BlockBatch(w, v, lc, a, s, res_arr)
    B = words.shape[0]
    is14 = resolution == RES_14BIT
    q_active = is14 and en_q

    line_crc = crc_ok
    valid = crc_ok
    first, second = _first_two_bad(crc_ok, xp=xp)
    aud_errs = xp.sum((~crc_ok[:, :N_AUDIO]).astype(xp.int32), axis=-1)
    tot_limit = N_WORDS if is14 else 7
    tot_errs = xp.sum((~crc_ok[:, :tot_limit]).astype(xp.int32), axis=-1)

    p_ok = crc_ok[:, WORD_P0]
    q_ok = crc_ok[:, WORD_Q0]

    sp = _calc_p(words) ^ words[:, WORD_P0]
    sq = (_calc_q(words, xp=xp) ^ words[:, WORD_Q0]) if is14 \
        else xp.zeros_like(sp)

    # ---- P-path quantities (aud_errs <= 1, P word usable) ----------------
    # Fix of the single bad audio word by parity: word ^= sp.
    p_fix_mask = sp  # xor mask applied to `first` when needed

    # ---- Q-path quantities (erasure pair solve) --------------------------
    A_bank, B_bank = _q_solve_banks()
    # Effective pair: (first, second) with second -> P0 when only one audio
    # erasure and P word bad (fixByQ:1480-1488).
    eff_second = xp.where((second == NO_ERR_INDEX) & ~p_ok,
                          WORD_P0, second)
    pair_valid = (first != NO_ERR_INDEX) & (eff_second != NO_ERR_INDEX) \
        & (eff_second <= WORD_P0)
    pair_k = xp.where(pair_valid,
                      first * 7 + xp.minimum(eff_second, 6), 0)
    if q_active:
        # e1 = A[k] @ sq ^ B[k] @ sp for the per-block pair k. Evaluated
        # as two FIXED matmuls against the stacked banks [14, 49*14]
        # followed by a one-hot pair selection — no per-block matrix
        # gathers.
        Astack, Bstack = _q_solve_banks_stacked()
        sq_bits = gf2.word_to_bits(sq, xp=xp).astype(
            jnp.int32 if xp is jnp else np.int64)
        sp_bits = gf2.word_to_bits(sp, xp=xp).astype(sq_bits.dtype)
        if xp is jnp:
            allq = jnp.matmul(sq_bits, jnp.asarray(Astack, jnp.int32),
                              preferred_element_type=jnp.int32) & 1
            allp = jnp.matmul(sp_bits, jnp.asarray(Bstack, jnp.int32),
                              preferred_element_type=jnp.int32) & 1
        else:
            allq = (sq_bits.astype(np.float32)
                    @ Astack.astype(np.float32)).astype(np.int64) & 1
            allp = (sp_bits.astype(np.float32)
                    @ Bstack.astype(np.float32)).astype(np.int64) & 1
        both = (allq ^ allp).reshape(sq.shape + (49, 14))
        onehot_k = (xp.arange(49) == pair_k[..., None])
        e1_bits = xp.sum(both * onehot_k[..., None], axis=-2)
        e1 = gf2.bits_to_word(e1_bits, xp=xp)
        e2 = e1 ^ sp
    else:
        e1 = e2 = xp.zeros_like(sp)

    # ======================================================================
    # Decision masks (mirror processBlock's reachable terminal states).
    # ======================================================================
    onehot = jnp.arange(N_WORDS, dtype=jnp.int32)[None, :] if xp is jnp \
        else np.arange(N_WORDS, dtype=np.int32)[None, :]

    def at(index):
        """One-hot [B,8] mask for a per-block word index."""
        return onehot == index[:, None]

    # Default outcome: untouched.
    out_words = words
    out_valid = valid
    out_line_crc = line_crc
    audio_state = xp.zeros((B,), dtype=xp.int32)
    stage = xp.full((B,), STG_BAD_BLOCK, dtype=xp.int32)

    le2 = tot_errs <= 2
    m_overflow = ~le2                                 # > 2 errors: BAD, ORIG

    # ---- aud_errs == 0 ---------------------------------------------------
    m_a0 = le2 & (aud_errs == 0)
    if not force_ecc:
        stage = xp.where(m_a0, STG_DATA_OK, stage)
    elif not en_p:
        stage = xp.where(m_a0, STG_NO_CHECK, stage)
    else:
        # Forced P check with no CRC marks.
        m = m_a0 & p_ok
        sp_zero = sp == 0
        # sp==0 -> DATA_OK (Q phase below); sp!=0 -> BROKEN.
        stage = xp.where(m & sp_zero, STG_DATA_OK, stage)
        broken0 = m & ~sp_zero
        # P word bad:
        m = m_a0 & ~p_ok
        if q_active:
            # Q_CORR with no marks:
            #  Q bad -> NO_CHECK + patch P and Q to recalculated values.
            mq = m & ~q_ok
            stage = xp.where(mq, STG_NO_CHECK, stage)
            new_p = _calc_p(words)
            new_q = _calc_q(words, xp=xp)
            patch = mq[:, None] & (onehot >= WORD_P0)
            out_words = xp.where(patch,
                                 xp.where(onehot == WORD_P0,
                                          new_p[:, None], new_q[:, None]),
                                 out_words)
            out_valid = out_valid | patch
            out_line_crc = xp.where(patch, False, out_line_crc)
            #  Q ok: second->P0; sq==0 -> recalcP + DATA_OK; else BROKEN.
            mq = m & q_ok
            sq_zero = sq == 0
            stage = xp.where(mq & sq_zero, STG_DATA_OK, stage)
            rp = mq & sq_zero
            new_p_now = _calc_p(out_words)
            ppatch = rp[:, None] & (onehot == WORD_P0)
            p_changed = (new_p_now != out_words[:, WORD_P0])
            out_words = xp.where(ppatch, new_p_now[:, None], out_words)
            out_valid = out_valid | ppatch
            out_line_crc = xp.where(ppatch & p_changed[:, None],
                                    False, out_line_crc)
            broken0 = broken0 | (mq & ~sq_zero)
        else:
            stage = xp.where(m, STG_NO_CHECK, stage)
        # Apply BROKEN for forced-check failures.
        audio_state = xp.where(broken0, AUD_BROKEN, audio_state)

    # ---- aud_errs == 1 ---------------------------------------------------
    m_a1 = le2 & (aud_errs == 1)
    broken1 = xp.zeros((B,), dtype=bool)
    fixp1 = xp.zeros((B,), dtype=bool)
    fixq1 = xp.zeros((B,), dtype=bool)
    if en_p:
        m = m_a1 & p_ok
        sp_zero = sp == 0
        # sp==0: the marked word was actually fine -> setValid + FIX_P mark.
        ok1 = m & sp_zero
        out_valid = out_valid | (ok1[:, None] & at(first))
        fixp1 = fixp1 | ok1
        # sp!=0: fix word `first` with parity.
        fx = m & ~sp_zero
        fmask = fx[:, None] & at(first)
        out_words = xp.where(fmask, out_words ^ p_fix_mask[:, None],
                             out_words)
        out_valid = out_valid | fmask
        out_line_crc = xp.where(fmask, False, out_line_crc)
        fixp1 = fixp1 | fx
        stage = xp.where(m, STG_DATA_OK, stage)
        # P word bad -> Q route.
        if q_active:
            m = m_a1 & ~p_ok
            # Q bad -> BAD_BLOCK (ORIG). Q ok -> pair (first, P0).
            mq = m & q_ok
            sq_zero = sq == 0
            # sq==0: audio word fine; recalc P; FIX_NOT_NEED -> FIX_Q mark.
            ok2 = mq & sq_zero
            out_valid = out_valid | (ok2[:, None] & at(first))
            new_p_now = _calc_p(out_words)
            ppatch = ok2[:, None] & (onehot == WORD_P0)
            p_changed = new_p_now != out_words[:, WORD_P0]
            out_words = xp.where(ppatch, new_p_now[:, None], out_words)
            out_valid = out_valid | ppatch
            out_line_crc = xp.where(ppatch & p_changed[:, None], False,
                                    out_line_crc)
            stage = xp.where(ok2, STG_DATA_OK, stage)
            fixq1 = fixq1 | ok2
            # sq!=0: solve pair (first, P0): e1 on first, e2 on P0.
            fx2 = mq & ~sq_zero
            f1mask = fx2[:, None] & at(first)
            e1nz = e1 != 0
            out_words = xp.where(f1mask & e1nz[:, None],
                                 out_words ^ e1[:, None], out_words)
            out_valid = out_valid | f1mask
            out_line_crc = xp.where(f1mask & e1nz[:, None], False,
                                    out_line_crc)
            pmask = fx2[:, None] & (onehot == WORD_P0)
            e2nz = e2 != 0
            out_words = xp.where(pmask & e2nz[:, None],
                                 out_words ^ e2[:, None], out_words)
            out_valid = out_valid | pmask
            out_line_crc = xp.where(pmask & e2nz[:, None], False,
                                    out_line_crc)
            stage = xp.where(fx2, STG_DATA_OK, stage)
            fixq1 = fixq1 | fx2
        elif is14 and not en_q and False:
            pass  # unreachable: q_active == (is14 and en_q)
    # 14-bit Q post-check after successful P path (forced check / patch).
    if en_p and q_active:
        m = m_a1 & p_ok  # blocks that went through the P route above
        # Q valid + forced check: recompute Q syndrome on FIXED words.
        if force_ecc:
            sq_fixed = (_calc_q(out_words, xp=xp) ^ out_words[:, WORD_Q0])
            bq = m & q_ok & (sq_fixed != 0)
            broken1 = broken1 | bq
            stage = xp.where(bq, STG_BAD_BLOCK, stage)
        # Q invalid: patch it from fixed words.
        mqp = m & ~q_ok
        new_q_now = _calc_q(out_words, xp=xp)
        qpatch = mqp[:, None] & (onehot == WORD_Q0)
        q_changed = new_q_now != out_words[:, WORD_Q0]
        out_words = xp.where(qpatch, new_q_now[:, None], out_words)
        out_valid = out_valid | qpatch
        out_line_crc = xp.where(qpatch & q_changed[:, None], False,
                                out_line_crc)
    audio_state = xp.where(fixp1 & ~broken1, AUD_FIX_P, audio_state)
    audio_state = xp.where(fixq1, AUD_FIX_Q, audio_state)
    audio_state = xp.where(broken1, AUD_BROKEN, audio_state)

    # Same Q post-check applies to the aud_errs==0 forced-P success path.
    if force_ecc and en_p and q_active:
        m = m_a0 & p_ok & (sp == 0)
        sq_fixed = (_calc_q(out_words, xp=xp) ^ out_words[:, WORD_Q0])
        bq = m & q_ok & (sq_fixed != 0)
        audio_state = xp.where(bq, AUD_BROKEN, audio_state)
        stage = xp.where(bq, STG_BAD_BLOCK, stage)
        mqp = m & ~q_ok
        new_q_now = _calc_q(out_words, xp=xp)
        qpatch = mqp[:, None] & (onehot == WORD_Q0)
        q_changed = new_q_now != out_words[:, WORD_Q0]
        out_words = xp.where(qpatch, new_q_now[:, None], out_words)
        out_valid = out_valid | qpatch
        out_line_crc = xp.where(qpatch & q_changed[:, None], False,
                                out_line_crc)

    # ---- aud_errs == 2 ---------------------------------------------------
    m_a2 = le2 & (aud_errs == 2)
    if q_active:
        mq = m_a2 & q_ok
        # 3-erasure guard: two audio marks + bad P -> FIX_NA (BAD, ORIG).
        solvable = mq & p_ok
        both_zero = (sp == 0) & (sq == 0)
        ok3 = solvable & both_zero
        out_valid = out_valid | (ok3[:, None] & (at(first) | at(second)))
        stage = xp.where(ok3, STG_DATA_OK, stage)
        fx3 = solvable & ~both_zero
        f1mask = fx3[:, None] & at(first)
        s1mask = fx3[:, None] & at(second)
        e1nz, e2nz = e1 != 0, e2 != 0
        out_words = xp.where(f1mask & e1nz[:, None],
                             out_words ^ e1[:, None], out_words)
        out_line_crc = xp.where(f1mask & e1nz[:, None], False, out_line_crc)
        out_words = xp.where(s1mask & e2nz[:, None],
                             out_words ^ e2[:, None], out_words)
        out_line_crc = xp.where(s1mask & e2nz[:, None], False, out_line_crc)
        out_valid = out_valid | f1mask | s1mask
        stage = xp.where(fx3, STG_DATA_OK, stage)
        audio_state = xp.where(fx3 | ok3, AUD_FIX_Q, audio_state)
    # 16-bit mode / q disabled: two audio errors cannot be fixed (BAD, ORIG).

    # ---- markAsBroken flag wipe (stc007datablock.cpp) --------------------
    brk = audio_state == AUD_BROKEN
    wipe = brk[:, None] & (onehot < (N_WORDS if is14 else 7))
    out_valid = xp.where(wipe, False, out_valid)
    out_line_crc = xp.where(wipe, False, out_line_crc)

    res_arr = xp.full((B,), resolution, dtype=xp.int32)
    # Overflow blocks stay BAD/ORIG with untouched words (already default).
    del m_overflow
    return BlockBatch(out_words, out_valid, out_line_crc, audio_state,
                      stage, res_arr)


def correct_blocks_cwd(words, crc_ok, cwd_fixed, resolution, en_p=True,
                       en_q=True, force_ecc=True, xp=jnp):
    """correct_blocks with Cross-Word-Decoding assist.

    The reference enters STG_CWD_CORR only from failure paths (>2 total
    errors, or 2 audio errors in 16-bit mode; stc007deinterleaver.cpp:
    586-635) and then re-runs selection with pre-fixed words counted valid.
    Vectorized: run the tree on raw CRC flags and on (crc | cwd_fixed);
    select the CWD result exactly for blocks that would have entered
    STG_CWD_CORR with at least one applicable pre-fixed word.

    Returns (BlockBatch, cwd_applied [B] bool).
    """
    r_raw = correct_blocks(words, crc_ok, resolution, en_p=en_p, en_q=en_q,
                           force_ecc=force_ecc, xp=xp)
    eff_ok = crc_ok | cwd_fixed
    r_eff = correct_blocks(words, eff_ok, resolution, en_p=en_p, en_q=en_q,
                           force_ecc=force_ecc, xp=xp)
    is14 = resolution == RES_14BIT
    tot_limit = N_WORDS if is14 else 7
    raw_tot = xp.sum((~crc_ok[:, :tot_limit]).astype(xp.int32), axis=-1)
    raw_aud = xp.sum((~crc_ok[:, :N_AUDIO]).astype(xp.int32), axis=-1)
    enters_cwd = (raw_tot > 2) | ((raw_aud == 2) & (not is14))
    helpful = xp.any(cwd_fixed[:, :tot_limit] & ~crc_ok[:, :tot_limit],
                     axis=-1)
    use_eff = enters_cwd & helpful
    sel = lambda a, b: xp.where(
        use_eff.reshape(use_eff.shape + (1,) * (a.ndim - 1)), b, a)
    out = BlockBatch(*(sel(a, b) for a, b in zip(r_raw, r_eff)))
    # line_crc keeps RAW source CRC state even for CWD blocks (setWord in
    # STG_CWD_CORR does not touch line_crc).
    out = out._replace(line_crc=xp.where(use_eff[:, None], crc_ok,
                                         out.line_crc))
    return out, use_eff


def deinterleave(line_words, line_crc_ok, line_shifts,
                 res_mode=RES_MODE_14BIT_AUTO, en_p=True, en_q=True,
                 force_ecc=True, xp=jnp):
    """Full processBlock equivalent incl. auto-resolution refill passes.

    The reference refills up to 3 times, toggling resolution on BAD_BLOCK
    (stc007deinterleaver.cpp:349-377, 1039-1056); pass 3 repeats pass 1, so
    auto mode == "use first resolution unless it fails and the other
    succeeds".
    """
    contiguous = (isinstance(line_shifts, np.ndarray)
                  and len(line_shifts) > 0
                  and line_shifts[0] == 0
                  and np.array_equal(line_shifts,
                                     np.arange(len(line_shifts))))

    def run(res):
        if contiguous:
            w, c = assemble_blocks_contiguous(
                line_words, line_crc_ok, len(line_shifts), res, xp=xp)
        else:
            w, c = assemble_blocks(line_words, line_crc_ok, line_shifts,
                                   res, xp=xp)
        return correct_blocks(w, c, res, en_p=en_p, en_q=en_q,
                              force_ecc=force_ecc, xp=xp)

    if res_mode == RES_MODE_14BIT:
        return run(RES_14BIT)
    if res_mode == RES_MODE_16BIT:
        return run(RES_16BIT)
    first_res = RES_14BIT if res_mode == RES_MODE_14BIT_AUTO else RES_16BIT
    other_res = RES_16BIT if first_res == RES_14BIT else RES_14BIT
    r1 = run(first_res)
    r2 = run(other_res)
    use2 = (r1.stage == STG_BAD_BLOCK) & (r2.stage != STG_BAD_BLOCK)
    sel = lambda a, b: xp.where(
        use2.reshape(use2.shape + (1,) * (a.ndim - 1)), b, a)
    return BlockBatch(*(sel(a, b) for a, b in zip(r1, r2)))


def block_samples(batch: BlockBatch, m2=False, xp=jnp):
    """Audio samples [B, 6] int16 from a BlockBatch (res-aware)."""
    w14 = stc007.expand_sample(batch.words[:, :N_AUDIO], m2=m2, xp=xp)
    w16 = batch.words[:, :N_AUDIO].astype(xp.int32) & 0xFFFF
    w16 = xp.where(w16 >= 0x8000, w16 - 0x10000, w16).astype(xp.int16)
    is16 = (batch.resolution == RES_16BIT)[:, None]
    return xp.where(is16, w16, w14)

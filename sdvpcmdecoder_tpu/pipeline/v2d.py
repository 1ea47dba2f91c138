"""V2D: per-frame driver of the binarizer (video lines -> PCM lines).

Port of VideoToDigital (videotodigital.{h,cpp}) re-architected for batch
decode:

  * frame pre-scan (prescanCoordinates :148-290): sample COORD_CHECK_LINES
    spread lines, find coordinates + reference, take medians;
  * coordinate damping (medianCoordinates :348-370): median over a 9-deep
    per-line history and 16-deep frame history (COORD_HISTORY_DEPTH /
    COORD_LONG_HISTORY, videotodigital.h:103-104);
  * duplicate-line detection vs the previous line by word-bit difference
    (BIT_DIFF_THRES_DIV videotodigital.h:107-110);
  * the fast path decodes the whole frame on device with shared frame
    coordinates (ops.binarize.stc007_frame_decode); only lines that fail
    get the per-line marker search + trial-grid fallback — the inverse of
    the reference, which walks line by line and skips work when previous
    parameters hold.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from ..formats import stc007
from ..ops import agc, binarize as bz, markers

COORD_CHECK_LINES = 4     # videotodigital.h:98-105
COORD_CHECK_PARTS = COORD_CHECK_LINES + 1
COORD_HISTORY_DEPTH = 9
COORD_LONG_HISTORY = 16
# Good-params skip cadence: a stable, fully-valid stream re-searches
# once per this many frames (drift spot check); any surviving invalid
# line forces an immediate search (V2DDriver.search_needed).
SEARCH_PERIOD = 256
BIT_DIFF_THRES_DIV = 4    # videotodigital.h:107-110


def _imed(a):
    """int(np.median(a)) for small 1-D nonnegative int data without
    np.median's ~20us dispatch overhead (for nonnegative values the
    even-length floor-mean equals the truncated float mean).  Small
    inputs — the 4-sample prescan medians and the 16-deep damping
    histories, passed as plain lists — skip numpy entirely."""
    if isinstance(a, list):
        vals = sorted(a)
    else:
        a = np.asarray(a)
        if a.size > 24:
            a = np.sort(a.astype(np.int64, copy=False).ravel())
            n = a.shape[0]
            h = n >> 1
            if n & 1:
                return int(a[h])
            return int(a[h - 1] + a[h]) >> 1
        vals = sorted(int(v) for v in a.ravel().tolist())
    n = len(vals)
    h = n >> 1
    return int(vals[h]) if n & 1 \
        else (int(vals[h - 1]) + int(vals[h])) >> 1


if hasattr(np, "bitwise_count"):
    _popcount = np.bitwise_count
else:  # numpy < 2.0
    def _popcount(x):
        return np.unpackbits(
            np.ascontiguousarray(x).view(np.uint8), axis=-1) \
            .reshape(x.shape + (8 * x.dtype.itemsize,)).sum(-1)


def prescan_rows(L, n_chk=None):
    """Prescan sample-row indices for an L-line frame (COORD_CHECK
    spread, videotodigital.h:98-105)."""
    gap = L // COORD_CHECK_PARTS
    n = COORD_CHECK_LINES if n_chk is None else n_chk
    return np.array([(i + 1) * gap for i in range(n)])


def find_duplicate_lines(words, crc_read, valid, field_bounds=None,
                         m2=False):
    """Head-switch duplicate detection (doBinarize :1210-1260): a VALID
    line whose 128 data+CRC bits differ from the previous valid line of
    the same field by <= BITS_PCM_DATA/BIT_DIFF_THRES_DIV bits, and which
    is not almost-silent (>=2 of 6 samples within +/-16,
    stc007line.cpp:582-613), is a probable duplicate.

    words [L, 8], crc_read [L], valid [L]; field_bounds: list of (lo, hi)
    row ranges (the "last line" resets at field boundaries).  Returns a
    [L] bool mask marking the LATER line of each duplicate pair.
    """
    L = len(valid)
    dup = np.zeros(L, bool)
    thres = stc007.BITS_PCM_DATA // BIT_DIFF_THRES_DIV
    from ..ops import stitch_native as _sn
    if _sn.available():
        bounds = np.asarray(field_bounds or [(0, L)], np.int64)
        return _sn.find_dup_lines(words, crc_read, valid, bounds,
                                  thres, m2)
    samples = np.asarray(stc007.expand_sample(words[:, :6], m2=m2, xp=np))
    almost_silent = (np.abs(samples.astype(np.int32)) < 16).sum(-1) >= 2
    for lo, hi in (field_bounds or [(0, L)]):
        vi = np.nonzero(valid[lo:hi])[0] + lo
        if len(vi) < 2:
            continue
        a, b = vi[:-1], vi[1:]
        x = (words[a] ^ words[b]).astype(np.uint64)
        c = (crc_read[a] ^ crc_read[b]).astype(np.uint64)
        diff = _popcount(x).sum(axis=-1).astype(np.int64) \
            + _popcount(c).astype(np.int64)
        dup[b] = (diff <= thres) & ~almost_silent[b]
    return dup


@dataclass
class V2DState:
    coord_history: list = field(default_factory=list)  # per-frame medians
    ref_history: list = field(default_factory=list)


@dataclass
class FrameDecodeResult:
    words: np.ndarray       # [L, 8]
    crc_read: np.ndarray    # [L]
    valid: np.ndarray       # [L]
    ref_level: int
    black: int
    white: int
    coords: tuple
    duplicates: np.ndarray  # [L] bool
    forced_bad: np.ndarray | None = None  # [L] narrow ref-sweep span


class V2DDriver:
    """STC-007 frame decoder with prescan + damping + fallback.

    With ref_sweep=True (INSANE quality) every line additionally runs the
    full reference-level sweep with CRC-collision statistics
    (calcRefLevelBySweep binarizer.cpp:3821); the sweep result overrides
    the center-reference fast path whenever any level yields a valid CRC.
    The reference also sweeps at NORMAL for STC-007; here NORMAL keeps the
    center-reference trial grid (which already trials hyst x shift) and
    the sweep is reserved for INSANE — one batched R-level dispatch.
    """

    def __init__(self, hyst_limit=4, shift_limit=2,
                 preset: agc.BinPreset | None = None,
                 ref_sweep=False, sweep_step=4, min_valid_crcs=5,
                 forced_coords=None, ref_sweep_fallback=False,
                 per_line_agc=False, dup_detect=True,
                 m2=False, normal_sweep_prescan=False, coord_skip=True):
        self.hyst_limit = hyst_limit
        self.shift_limit = shift_limit
        self.preset = preset or agc.BinPreset()
        # Per-line histogram AGC with the STC-007 marker-aware scan
        # regions (findSTC007BW binarizer.cpp:2683) instead of one
        # frame-level black/white from 4 sampled lines — tracks per-line
        # brightness drift (head switching, AGC pumping).
        self.per_line_agc = per_line_agc
        self.dup_detect = dup_detect  # check_line_copy (doBinarize :1210)
        self.m2 = m2  # M2 sample companding (almost-silent dup gate)
        self.ref_sweep = ref_sweep
        # NORMAL-mode analog of the reference's always-on STC-007 sweep:
        # only lines still invalid after the marker fallback re-run the
        # full level sweep, bucketed to a fixed shape.
        self.ref_sweep_fallback = ref_sweep_fallback
        # NORMAL-mode sweep fidelity for the FAST PATH: the reference
        # derives the working reference level from a full sweep with
        # CRC-collision statistics whenever params are (re)found at
        # NORMAL/INSANE (processLine binarizer.cpp:1121-1133 always
        # routes STC-007 to STG_REF_SWEEP_RUN), and the swept level then
        # propagates through the previous-good fast path.  Here the
        # sweep runs on the prescan's sample lines and its CRC-stats
        # pick replaces the naive center-reference level, so a
        # wrong-but-CRC-colliding read at the center level cannot poison
        # the frame (tests/test_normal_sweep.py crafts exactly that).
        self.normal_sweep_prescan = normal_sweep_prescan
        self.sweep_step = sweep_step
        self.min_valid_crcs = min_valid_crcs
        # bin_preset_t.en_force_coords/horiz_coords (binarizer.h:175-176):
        # skip marker/coordinate search entirely and sample at the given
        # (data_start, data_stop) pixel coordinates.
        self.forced_coords = forced_coords
        self.state = V2DState()
        # Good-params search skip, frame scope (binarizer.cpp:1105-1141:
        # lines with good previous parameters skip the coordinate
        # search; re-searched on failure).  While the damped histories
        # are stable and every decoded line stays CRC-valid, rounds
        # reuse the history medians instead of re-running AGC + marker
        # search + the NORMAL sweep; any surviving invalid line
        # (note_feedback) or SEARCH_PERIOD frames force a fresh search.
        # PCMFrameDriver applies the same policy for PCM-1/16x0.
        self.coord_skip = coord_skip
        self._frames_prepared = 0
        self._next_search = 0
        self._force_search = False
        self._bw_last = None

    # -- prescan ----------------------------------------------------------
    def prescan(self, pixels: np.ndarray):
        """Frame prescan: AGC + marker coords on sampled lines -> medians.

        Returns (coords (start, stop), ref, black, white) or None when no
        PCM is detected in the sampled lines.
        """
        L = pixels.shape[0]
        if L <= COORD_CHECK_PARTS:
            return None
        gap = L // COORD_CHECK_PARTS
        idx = np.array([(i + 1) * gap for i in range(COORD_CHECK_LINES)])
        sample = pixels[idx]
        black, white, ok = agc.find_black_white(sample, self.preset)
        if not ok.any():
            return None
        ref, cok = bz.pick_center_ref_level(black, white,
                                            self.preset.min_contrast,
                                            xp=np)
        res = markers.search_markers(sample, ref, preset=self.preset)
        ds, de, mok = markers.coords_from_markers(res)
        good = ok & cok & mok
        if self.forced_coords is not None:
            # Forced coordinates: markers are not required, keep AGC/ref.
            good = ok & cok
        if not good.any():
            return None
        med = lambda a: _imed(a[good])
        return ((med(ds), med(de)), med(ref), med(black), med(white))

    def _damped_coords(self, fresh):
        """Median over the frame-level coordinate history (16 deep)."""
        self.state.coord_history.append(fresh[0])
        self.state.coord_history = \
            self.state.coord_history[-COORD_LONG_HISTORY:]
        self.state.ref_history.append(fresh[1])
        self.state.ref_history = self.state.ref_history[-COORD_LONG_HISTORY:]
        hs = self.state.coord_history
        start = _imed([h[0] for h in hs])
        stop = _imed([h[1] for h in hs])
        ref = _imed(list(self.state.ref_history))
        return (start, stop), ref

    # -- good-params search skip ------------------------------------------
    def search_needed(self) -> bool:
        """False when the next prepare_frames round may run entirely
        from the damped histories (callers then skip gathering the
        prescan sample rows — on the device driver that removes a
        per-round device gather + read-back)."""
        if (not self.coord_skip or self._force_search
                or self.per_line_agc or self._bw_last is None
                or self._frames_prepared < 4
                or self._frames_prepared >= self._next_search
                or len(self.state.coord_history) < 2):
            return True
        (a0, a1), (b0, b1) = self.state.coord_history[-1], \
            self.state.coord_history[-2]
        return abs(a0 - b0) > 1 or abs(a1 - b1) > 1

    def note_feedback(self, bad: bool):
        """Decode-quality feedback: any line still invalid after the
        fallbacks forces a fresh parameter search next round (the
        reference re-searches failing lines, binarizer.cpp:1137)."""
        if bad:
            self._force_search = True

    def _prep_from_history(self, F):
        hs = self.state.coord_history
        start = _imed([h[0] for h in hs])
        stop = _imed([h[1] for h in hs])
        ref = _imed(list(self.state.ref_history))
        blk, wht = self._bw_last
        coords = np.tile(np.array([start, stop], np.int64), (F, 1))
        if self.forced_coords is not None:
            coords[:] = self.forced_coords
        return dict(coords=coords,
                    refs=np.full(F, ref, np.int64),
                    blacks=np.full(F, blk, np.int64),
                    whites=np.full(F, wht, np.int64),
                    usable=np.ones(F, bool))

    # -- batched frame decode (production path) ---------------------------
    def prepare_frames(self, pixels: np.ndarray, perm=None, sample=None,
                       shape=None):
        """Host phase: batched prescan + per-frame damping -> parameters.

        The AGC + marker prescan for ALL frames' sample lines runs as one
        batched call (the per-frame loop only does medians and the
        sequential history damping).  `perm` maps field-sequential line
        index -> row of `pixels` (None = identity); with it, `pixels` can
        be the RAW frame-row view straight off the capture mmap — the
        prescan gathers just COORD_CHECK_LINES rows per frame instead of
        forcing a field-ordered copy of the whole batch.

        With `sample` given ([F*COORD_CHECK_LINES, W], the prescan rows
        pre-gathered — e.g. read back from device-resident pixels by
        pipeline/device_driver.py), the gather is skipped and `pixels`
        may be None (`shape` supplies (F, L, W)); per-line AGC needs
        full pixels and is rejected in that mode.

        Returns dict(coords [F,2], refs/blacks/whites [F] (or [F,L] with
        per-line AGC, in `pixels` row order), usable [F]).
        """
        F, L, W = shape if shape is not None else pixels.shape
        if sample is not None and self.per_line_agc:
            raise ValueError("per_line_agc needs full pixels")
        if not self.search_needed():
            self._frames_prepared += F
            return self._prep_from_history(F)
        coords = np.zeros((F, 2), np.int64)
        refs = np.zeros(F, np.int64)
        blacks = np.zeros(F, np.int64)
        whites = np.full(F, 255, np.int64)
        usable = np.zeros(F, bool)
        n_chk = COORD_CHECK_LINES
        if L > COORD_CHECK_PARTS:
            if sample is None:
                idx = prescan_rows(L)
                if perm is not None:
                    idx = np.asarray(perm)[idx]
                sample = np.ascontiguousarray(pixels[:, idx, :]) \
                    .reshape(F * n_chk, W)
            black, white, ok = agc.find_black_white(sample, self.preset)
            ref, cok = bz.pick_center_ref_level(black, white,
                                                self.preset.min_contrast,
                                                xp=np)
            res = markers.search_markers(sample, ref, preset=self.preset)
            ds, de, mok = markers.coords_from_markers(res)
            good = ok & np.asarray(cok) & mok
            if self.forced_coords is not None:
                good = ok & np.asarray(cok)
            good = good.reshape(F, n_chk)
            ds = ds.reshape(F, n_chk)
            de = de.reshape(F, n_chk)
            ref = np.asarray(ref).reshape(F, n_chk)
            black = black.reshape(F, n_chk)
            white = white.reshape(F, n_chk)
        else:
            good = np.zeros((F, n_chk), bool)
        for f in range(F):
            g = good[f]
            if not g.any():
                if self.forced_coords is not None:
                    coords[f] = self.forced_coords
                    refs[f] = 127
                    blacks[f], whites[f] = 0, 255
                    usable[f] = True
                elif self.state.coord_history:
                    hs = np.array(self.state.coord_history)
                    coords[f] = (_imed(hs[:, 0]), _imed(hs[:, 1]))
                    refs[f] = _imed(self.state.ref_history)
                    blacks[f], whites[f] = 0, 255
                    usable[f] = True
                continue
            med = lambda a: _imed(a[f][g])
            c, r = self._damped_coords(((med(ds), med(de)), med(ref)))
            coords[f] = c
            refs[f] = r
            blacks[f], whites[f] = med(black), med(white)
            usable[f] = True
        if self.forced_coords is not None:
            coords[:] = self.forced_coords
        if self.normal_sweep_prescan and usable.any() \
                and L > COORD_CHECK_PARTS:
            refs = self._sweep_sample_refs(sample, coords, refs, blacks,
                                           whites, usable)
        if self.per_line_agc and usable.any():
            refs, blacks, whites = self._per_line_levels(
                pixels, coords, refs, blacks, whites, usable)
        self._frames_prepared += F
        if usable.any() and not self.per_line_agc:
            self._bw_last = (int(np.median(blacks[usable])),
                             int(np.median(whites[usable])))
            self._next_search = self._frames_prepared + SEARCH_PERIOD
            self._force_search = False
        return dict(coords=coords, refs=refs, blacks=blacks,
                    whites=whites, usable=usable)

    def _sweep_sample_refs(self, sample, coords, refs, blacks, whites,
                           usable):
        """NORMAL-mode reference-level derivation: full sweep + CRC
        statistics on the prescan sample lines; the per-frame working
        level is the median of the per-line picks (the reference's
        swept level propagated through good-params, here through the
        frame-level parameter flow).  Lines whose sweep finds nothing
        keep the center-reference level."""
        F = len(refs)
        n_chk = COORD_CHECK_LINES
        rows = np.nonzero(np.repeat(usable, n_chk))[0]
        if len(rows) == 0:
            return refs
        px = np.ascontiguousarray(sample[rows])
        cds = np.repeat(coords, n_chk, axis=0)[rows]
        bk = np.clip(np.repeat(blacks, n_chk)[rows], 0, 254)
        wt = np.clip(np.repeat(whites, n_chk)[rows], 1, 255)
        levels = np.arange(254, 1, -self.sweep_step, dtype=np.int32)
        from ..ops import stitch_native as sn
        if sn.available():
            sw = sn.ref_sweep_lines(px, cds, bk, wt, levels,
                                    self.hyst_limit, self.shift_limit)
            sv, sc = sw["valid"], sw["crc"]
            sh, ss = sw["hyst"], sw["shift"]
        else:
            out = bz.stc007_ref_sweep_decode(
                jnp.asarray(px[:, None, :]), jnp.asarray(cds, jnp.int32),
                jnp.asarray(bk, jnp.int32), jnp.asarray(wt, jnp.int32),
                jnp.asarray(levels), hyst_limit=self.hyst_limit,
                shift_limit=self.shift_limit)
            R, Nn = len(levels), len(rows)
            sv = np.asarray(out["valid"]).reshape(R, Nn)
            sc = np.asarray(out["crc"]).reshape(R, Nn)
            sh = np.asarray(out["hyst"]).reshape(R, Nn)
            ss = np.asarray(out["shift"]).reshape(R, Nn)
        pick, good, fbad = bz.pick_ref_sweep(
            sv, sc, sh, ss, min_valid_crcs=self.min_valid_crcs)
        pick_ref = np.where(pick >= 0, levels[np.maximum(pick, 0)], -1)
        per_frame = np.full(F * n_chk, -1, np.int64)
        per_frame[rows] = pick_ref
        per_frame = per_frame.reshape(F, n_chk)
        refs = refs.copy()
        for f in range(F):
            sel = per_frame[f][per_frame[f] >= 0]
            if len(sel):
                refs[f] = _imed(sel)
        return refs

    def _per_line_levels(self, pixels, coords, refs, blacks, whites,
                         usable):
        """Per-line black/white/ref [F, L] via format-aware histogram AGC
        (findSTC007BW); lines where AGC fails keep the frame medians."""
        F, L, W = pixels.shape
        spans = coords[usable, 1] - coords[usable, 0]
        ppb = max(_imed(spans) // stc007.BITS_BETWEEN_COORDS, 1)
        flat = pixels.reshape(F * L, W)
        blk, wht, ok = agc.find_black_white(flat, self.preset,
                                            fmt="stc007", ppb=ppb)
        ref, cok = bz.pick_center_ref_level(blk, wht,
                                            self.preset.min_contrast,
                                            xp=np)
        good = (ok & np.asarray(cok)).reshape(F, L)
        blk = blk.reshape(F, L)
        wht = wht.reshape(F, L)
        ref = np.asarray(ref).reshape(F, L)
        blk2 = np.where(good, blk, blacks[:, None])
        wht2 = np.where(good, wht, whites[:, None])
        ref2 = np.where(good, ref, refs[:, None])
        return ref2, blk2, wht2

    def dispatch_frames_async(self, pixels, prep):
        """Device phase, non-blocking: enqueue one batched trial-grid
        dispatch and return the on-device result (the caller overlaps
        host work with device execution — the VIN/V2D double-buffer
        analog, config.h:76-77).

        Safe to call with a CONCATENATION of several drivers' prepared
        batches — everything here is per-frame.
        """
        coords, blacks, whites = prep["coords"], prep["blacks"], \
            prep["whites"]
        batch = bz.stc007_frame_decode(
            jnp.asarray(pixels), jnp.asarray(coords, jnp.int32),
            jnp.asarray(np.maximum(prep["refs"], 1), jnp.int32),
            jnp.asarray(np.clip(blacks, 0, 254), jnp.int32),
            jnp.asarray(np.clip(whites, 1, 255), jnp.int32),
            hyst_limit=self.hyst_limit, shift_limit=self.shift_limit)
        # Words are 14-bit, CRC 16-bit: narrow them on the DEVICE before
        # the transfer (half the bytes of the int32 words), flattened to
        # one [F, L*8] view.
        F = batch.words.shape[0]
        return batch._replace(
            words=batch.words.astype(jnp.int16).reshape(F, -1),
            crc_read=batch.crc_read.astype(jnp.uint16))

    def materialize_frames(self, pixels, prep, batch):
        """Blocking device->host transfer of a dispatch + INSANE sweep."""
        import jax
        # One batched device_get over flat views instead of N small
        # device-to-host transfers.
        words, crc_read, valid = jax.device_get(
            [batch.words, batch.crc_read, batch.valid])
        if words.ndim == 2:  # flattened [F, L*8] transfer layout
            words = words.reshape(words.shape[0], -1, 8)
        forced = np.zeros(valid.shape, bool)
        if self.ref_sweep:
            blacks, whites = prep["blacks"], prep["whites"]
            if blacks.ndim == 2:  # per-line AGC: sweep uses frame medians
                blacks = np.median(blacks, axis=1).astype(np.int64)
                whites = np.median(whites, axis=1).astype(np.int64)
            words, crc_read, valid, forced = self._ref_sweep_merge(
                pixels, prep["coords"], blacks, whites,
                words, crc_read, valid)
        return words, crc_read, valid, forced

    def dispatch_frames(self, pixels, prep):
        """Device phase (blocking): dispatch + materialize."""
        return self.materialize_frames(
            pixels, prep, self.dispatch_frames_async(pixels, prep))

    # -- host (native) backend --------------------------------------------
    def decode_frames_host(self, pixels: np.ndarray, perm=None):
        """Decode a frame batch on the HOST via the native early-exit
        trial grid (stitch_native.binarize_frames — bit-identical to the
        XLA grid, tests/test_native_binarize.py).

        `pixels` may be ANY strided uint8 view [F, L, W] — with `perm`
        (field-sequential index -> pixel row) it is the raw frame-row
        mmap view and no full-frame copy ever happens; results come back
        in field-sequential line order, and no pixels move to the
        device; the level sweeps stay on the device (see BatchDecoder
        backend policy).
        """
        F = pixels.shape[0]
        prep = self.prepare_frames(pixels, perm=perm)
        return self.decode_prepared_host(pixels, prep, perm=perm)

    def decode_prepared_host(self, pixels, prep, perm=None):
        """Native grid decode + fallbacks for an already-prepared batch
        (prepare/decode split so drivers can time and interleave the
        phases)."""
        from ..ops import stitch_native as sn
        F = pixels.shape[0]
        if not prep["usable"].any():
            return [None] * F
        if not sn.available():
            # No compiler on this host: run the prepared batch through
            # the device dispatch instead (field-ordered copy; per-line
            # AGC rows ride along).
            px = np.ascontiguousarray(pixels[:, perm, :]) \
                if perm is not None else pixels
            prep2 = prep
            if perm is not None and np.asarray(prep["refs"]).ndim == 2:
                prep2 = dict(prep, refs=prep["refs"][:, perm],
                             blacks=prep["blacks"][:, perm],
                             whites=prep["whites"][:, perm])
            words, crc_read, valid, forced = self.dispatch_frames(px,
                                                                  prep2)
            return self.finalize_frames(px, prep2, words, crc_read,
                                        valid, forced)
        # perm rides into the native grid as an input row map: outputs
        # arrive field-sequential straight off the raw capture view,
        # with no post-hoc [:, perm] gathers of the whole round.
        words, crc_read, valid, hyst, shift = sn.binarize_frames(
            pixels, prep["coords"], np.maximum(prep["refs"], 1),
            np.clip(prep["blacks"], 0, 254), np.clip(prep["whites"], 1, 255),
            self.hyst_limit, self.shift_limit, row_map=perm)
        forced = np.zeros(valid.shape, bool)
        if self.ref_sweep:
            # INSANE sweep stays on the device (the full level sweep is
            # the search the device is for); gather a field-ordered copy.
            px_seq = np.ascontiguousarray(
                pixels[:, perm, :]) if perm is not None else pixels
            blacks, whites = prep["blacks"], prep["whites"]
            if np.asarray(blacks).ndim == 2:
                blacks = np.median(blacks, axis=1).astype(np.int64)
                whites = np.median(whites, axis=1).astype(np.int64)
            words, crc_read, valid, forced = self._ref_sweep_merge(
                px_seq, prep["coords"], blacks, whites,
                words, crc_read, valid)
        return self.finalize_frames(pixels, prep, words, crc_read, valid,
                                    forced, perm=perm, native=True)

    def finalize_frames(self, pixels, prep, words, crc_read, valid,
                        forced, perm=None, native=False):
        """Host phase: per-line marker fallback + result assembly.

        `perm` maps field-sequential line index -> `pixels` row (the raw
        mmap-view layout of decode_frames_host); words/crc/valid arrive
        in field-sequential order either way."""
        F, L, W = pixels.shape
        coords, refs = prep["coords"], prep["refs"]
        blacks, whites, usable = prep["blacks"], prep["whites"], \
            prep["usable"]
        per_line = refs.ndim == 2
        out = []
        for f in range(F):
            if not usable[f]:
                out.append(None)
                continue
            # With per-line AGC the scalar fallback paths use the frame
            # median of the per-line levels.
            rf = _imed(refs[f]) if per_line else int(refs[f])
            bf = _imed(blacks[f]) if per_line else int(blacks[f])
            wh = _imed(whites[f]) if per_line else int(whites[f])
            wf, cf, vf = self._marker_fallback(
                pixels[f], words[f], crc_read[f], valid[f], rf, bf, wh,
                perm=perm, native=native)
            ff = forced[f]
            if self.ref_sweep_fallback and not self.ref_sweep \
                    and not vf.all():
                wf, cf, vf, ff = self._sweep_failed_lines(
                    pixels[f], (int(coords[f, 0]), int(coords[f, 1])),
                    bf, wh, wf, cf, vf, ff, perm=perm)
            dup = np.zeros(L, bool)
            if self.dup_detect:
                # Lines arrive field-sequentially; the duplicate tracker
                # resets at the field boundary (doBinarize :1040-1046).
                half = (L + 1) // 2  # field 1 holds ceil(H/2) lines
                dup = find_duplicate_lines(
                    wf, cf, vf & ~ff, [(0, half), (half, L)],
                    m2=self.m2)
                ff = ff | dup
            out.append(FrameDecodeResult(
                wf, cf, vf, rf, bf, wh,
                (int(coords[f, 0]), int(coords[f, 1])),
                dup, ff))
        self.note_feedback(any(r is not None and not r.valid.all()
                               for r in out))
        return out

    def _sweep_failed_lines(self, pixels, coords, black, white, words,
                            crc_read, valid, forced, perm=None):
        """Per-line ref-level sweep for lines the fast path and marker
        fallback could not decode (NORMAL-mode sweep parity, bucketed
        to a fixed shape so only one sweep shape ever compiles)."""
        bad = np.nonzero(~valid)[0]
        if len(bad) == 0:
            return words, crc_read, valid, forced
        rows_of = (lambda r: np.asarray(perm)[r]) if perm is not None \
            else (lambda r: r)
        # AGC gate (processLine binarizer.cpp:1090-1101): lines whose
        # histogram finds no valid black/white contrast never reach the
        # sweep — dropped/blank lines must not burn 64-level sweeps.
        _, _, agc_ok = agc.find_black_white(
            np.ascontiguousarray(pixels[rows_of(bad)]), self.preset,
            fmt="stc007")
        bad = bad[agc_ok]
        if len(bad) == 0:
            return words, crc_read, valid, forced
        B = self.FALLBACK_BUCKET
        levels = np.arange(254, 1, -self.sweep_step, dtype=np.int32)
        R = len(levels)
        words = words.copy()
        crc_read = crc_read.copy()
        valid = valid.copy()
        forced = forced.copy()
        for base in range(0, len(bad), B):
            grp = bad[base:base + B]
            n = len(grp)
            px = np.zeros((B, 1, pixels.shape[1]), np.uint8)
            px[:n, 0] = pixels[rows_of(grp)]
            sw = bz.stc007_ref_sweep_decode(
                jnp.asarray(px),
                jnp.asarray(np.tile(np.asarray(coords)[None], (B, 1)),
                            jnp.int32),
                jnp.full((B,), max(black, 0), jnp.int32),
                jnp.full((B,), min(white, 255), jnp.int32),
                jnp.asarray(levels),
                hyst_limit=self.hyst_limit, shift_limit=self.shift_limit)
            sv = np.asarray(sw["valid"]).reshape(R, B)
            sc = np.asarray(sw["crc"]).reshape(R, B)
            pick, good, fbad = bz.pick_ref_sweep(
                sv, sc, np.asarray(sw["hyst"]).reshape(R, B),
                np.asarray(sw["shift"]).reshape(R, B),
                min_valid_crcs=self.min_valid_crcs)
            sw_words = np.asarray(sw["words"]).reshape(R, B, 8)
            for k in range(n):
                if pick[k] < 0:
                    continue
                row = grp[k]
                words[row] = sw_words[pick[k], k]
                crc_read[row] = sc[pick[k], k]
                valid[row] = True
                forced[row] = fbad[k]
        return words, crc_read, valid, forced

    def decode_frames(self, pixels: np.ndarray):
        """Decode a BATCH of frames [F, L, W] in one device dispatch.

        Per-frame prescan + damping run on host; the trial-grid decode for
        all frames is a single stc007_frame_decode call (one compile for a
        fixed batch shape). Returns list of FrameDecodeResult (None for
        frames with no PCM detected and no history).
        """
        F = pixels.shape[0]
        prep = self.prepare_frames(pixels)
        if not prep["usable"].any():
            return [None] * F
        words, crc_read, valid, forced = self.dispatch_frames(pixels, prep)
        return self.finalize_frames(pixels, prep, words, crc_read, valid,
                                    forced)

    def _ref_sweep_merge(self, pixels, coords, blacks, whites,
                         words, crc_read, valid):
        """INSANE path: batched ref-level sweep + CRC-stats pick; the
        sweep result replaces the fast-path read for every line where
        any level produced a valid CRC (STG_REF_SWEEP_RUN replaces
        STG_REF_FIND entirely in the reference, processLine :1130)."""
        F, L, _ = pixels.shape
        levels = np.arange(254, 1, -self.sweep_step, dtype=np.int32)
        R = len(levels)
        sw = bz.stc007_ref_sweep_decode(
            jnp.asarray(pixels), jnp.asarray(coords, jnp.int32),
            jnp.asarray(np.clip(blacks, 0, 254), jnp.int32),
            jnp.asarray(np.clip(whites, 1, 255), jnp.int32),
            jnp.asarray(levels),
            hyst_limit=self.hyst_limit, shift_limit=self.shift_limit)
        sv = np.asarray(sw["valid"]).reshape(R, F * L)
        sc = np.asarray(sw["crc"]).reshape(R, F * L)
        sh = np.asarray(sw["hyst"]).reshape(R, F * L)
        ss = np.asarray(sw["shift"]).reshape(R, F * L)
        pick, good, fbad = bz.pick_ref_sweep(
            sv, sc, sh, ss, min_valid_crcs=self.min_valid_crcs)
        rows = np.nonzero(pick >= 0)[0]
        words = words.reshape(F * L, -1).copy()
        crc_read = crc_read.reshape(F * L).copy()
        valid = valid.reshape(F * L).copy()
        forced = np.zeros(F * L, bool)
        sw_words = np.asarray(sw["words"]).reshape(R, F * L, -1)
        words[rows] = sw_words[pick[rows], rows]
        crc_read[rows] = sc[pick[rows], rows]
        valid[rows] = True
        forced[rows] = fbad[rows]
        return (words.reshape(F, L, -1), crc_read.reshape(F, L),
                valid.reshape(F, L), forced.reshape(F, L))

    FALLBACK_BUCKET = 64  # fixed shape so the retry path compiles once

    def _marker_fallback(self, pixels, words, crc_read, valid, ref, black,
                         white, perm=None, native=False):
        """Per-line marker coordinates for failed lines (the reference's
        STG_INPUT_LEVEL re-find). Lines are re-decoded through the same
        frame-grouped matmul path as batches of single-line frames,
        padded to a fixed bucket so only one shape ever compiles; the
        native backend re-decodes exactly the retry set in one call."""
        if self.forced_coords is not None:
            # Coordinates are forced: no marker re-search (sweepRefLevel
            # :3714-3720 "Data coordinates are forced, don't perform
            # the search").
            return words, crc_read, valid
        L = pixels.shape[0]
        bad = np.nonzero(~valid)[0]
        if len(bad) == 0 or len(bad) == L:
            return words, crc_read, valid
        # Device outputs arrive as read-only views; the retry writes
        # per-line results back in place.
        words = np.array(words)
        crc_read = np.array(crc_read)
        valid = np.array(valid)
        sub = pixels[bad] if perm is None \
            else np.ascontiguousarray(pixels[np.asarray(perm)[bad]])
        res = markers.search_markers(sub, np.full(len(bad), ref),
                                     preset=self.preset)
        ds, de, mok = markers.coords_from_markers(res)
        retry = np.nonzero(mok)[0]
        if native:
            from ..ops import stitch_native as sn
            if len(retry):
                n = len(retry)
                cds = np.stack([ds[retry], de[retry]], axis=1)
                w2, c2, v2, _, _ = sn.binarize_frames(
                    sub[retry][:, None, :], cds,
                    np.full(n, ref, np.int32),
                    np.full(n, max(black, 0), np.int32),
                    np.full(n, min(white, 255), np.int32),
                    self.hyst_limit, self.shift_limit)
                ok2 = v2[:, 0]
                rows = bad[retry[ok2]]
                words[rows] = w2[ok2, 0]
                crc_read[rows] = c2[ok2, 0]
                valid[rows] = True
            return words, crc_read, valid
        B = self.FALLBACK_BUCKET
        for base in range(0, len(retry), B):
            grp = retry[base:base + B]
            n = len(grp)
            px = np.zeros((B, 1, pixels.shape[1]), np.uint8)
            px[:n, 0] = sub[grp]
            cds = np.zeros((B, 2), np.int64)
            cds[:, 1] = pixels.shape[1] - 1
            cds[:n, 0] = ds[grp]
            cds[:n, 1] = de[grp]
            w2 = bz.stc007_frame_decode(
                jnp.asarray(px), jnp.asarray(cds, jnp.int32),
                jnp.full((B,), ref, jnp.int32),
                jnp.full((B,), max(black, 0), jnp.int32),
                jnp.full((B,), min(white, 255), jnp.int32),
                hyst_limit=self.hyst_limit, shift_limit=self.shift_limit)
            ok2 = np.asarray(w2.valid)[:n, 0]
            rows = bad[grp[ok2]]
            words[rows] = np.asarray(w2.words)[:n, 0][ok2]
            crc_read[rows] = np.asarray(w2.crc_read)[:n, 0][ok2]
            valid[rows] = True
        return words, crc_read, valid

    # -- frame decode -----------------------------------------------------
    def decode_frame(self, pixels: np.ndarray) -> FrameDecodeResult | None:
        """pixels [L, W] uint8 (one frame, field-sequential order)."""
        pre = self.prescan(pixels)
        if pre is None:
            if self.forced_coords is not None:
                coords, ref, black, white = self.forced_coords, 127, 0, 255
            elif self.state.coord_history:
                hs = np.array(self.state.coord_history)
                coords = (_imed(hs[:, 0]), _imed(hs[:, 1]))
                ref = _imed(self.state.ref_history)
                black, white = 0, 255
            else:
                return None
        else:
            (coords, ref, black, white) = pre
            coords, ref = self._damped_coords((coords, ref))
        if self.forced_coords is not None:
            coords = tuple(self.forced_coords)
        L, W = pixels.shape
        batch = bz.stc007_frame_decode(
            jnp.asarray(pixels[None]),
            jnp.asarray([[coords[0], coords[1]]], jnp.int32),
            jnp.asarray([ref], jnp.int32),
            jnp.asarray([max(black, 0)], jnp.int32),
            jnp.asarray([min(white, 255)], jnp.int32),
            hyst_limit=self.hyst_limit, shift_limit=self.shift_limit)
        words = np.asarray(batch.words[0])
        crc_read = np.asarray(batch.crc_read[0])
        valid = np.asarray(batch.valid[0])
        forced = np.zeros(L, bool)
        if self.ref_sweep:
            w4, c4, v4, f4 = self._ref_sweep_merge(
                pixels[None], np.asarray([[coords[0], coords[1]]]),
                np.asarray([max(black, 0)]), np.asarray([min(white, 255)]),
                words[None], crc_read[None], valid[None])
            words, crc_read, valid, forced = w4[0], c4[0], v4[0], f4[0]

        words, crc_read, valid = self._marker_fallback(
            pixels, words, crc_read, valid, ref, black, white)
        if self.ref_sweep_fallback and not self.ref_sweep \
                and not valid.all():
            words, crc_read, valid, forced = self._sweep_failed_lines(
                pixels, coords, black, white, words, crc_read, valid,
                forced)

        dup = np.zeros(L, dtype=bool)
        if self.dup_detect:
            half = (L + 1) // 2
            dup = find_duplicate_lines(words, crc_read, valid & ~forced,
                                       [(0, half), (half, L)], m2=self.m2)
            forced = forced | dup
        return FrameDecodeResult(words, crc_read, valid, ref, black, white,
                                 coords, dup, forced)

"""STC-007 data stitcher: frame reassembly, padding/field-order/resolution
auto-detection, CWD pre-scan, final deinterleave with masking.

Host-side port of the reference's STC007DataStitcher (stc007datastitcher.
{h,cpp}) re-architected around the vectorized deinterleaver: every place the
reference serially runs `processBlock` over a window (tryPadding
:1417-1743, getFieldResolution :996-1214, performCWD :5905-6401,
performDeinterleave :6675-6888) becomes ONE batched evaluation over all
block shifts; the tiny stage machines / burst counters / majority stats
stay as plain Python over per-block flag arrays.

Line data is a struct-of-arrays (`LineStore`), not per-line objects.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

from ..formats import stc007
from ..ops import deinterleave as di

# Video standards / field orders (frametrimset.h:117-137).
VID_UNKNOWN, VID_PAL, VID_NTSC = 0, 1, 2
ORDER_UNK, ORDER_TFF, ORDER_BFF = 0, 1, 2

# Frame geometry (config.h:80-81 via stc007datastitcher.h:166-177).
LINES_PF_NTSC = 245
LINES_PF_PAL = 294
LINES_PF_DEFAULT = LINES_PF_NTSC
LINES_PF_MAX_PAL = LINES_PF_PAL + stc007.INTERLEAVE_OFS
LINES_PF_MAX_NTSC = LINES_PF_PAL - 2 * stc007.INTERLEAVE_OFS
FLD_ORDER_DEFAULT = ORDER_TFF

MIN_GOOD_LINES_PF = LINES_PF_DEFAULT - stc007.INTERLEAVE_OFS // 2
MIN_FILL_LINES_PF = stc007.MIN_DEINT_DATA // 2

# Padding limits (stc007datastitcher.h:186-197).
MAX_PADDING_14BIT = stc007.INTERLEAVE_OFS * 2   # 32
MAX_PADDING_16BIT = stc007.INTERLEAVE_OFS       # 16
MAX_BURST_SILENCE = stc007.INTERLEAVE_OFS // 2  # 8
MAX_BURST_BROKEN = 1
MAX_BURST_UNCH_DELTA = 8
MAX_BURST_UNCH_14BIT = 0x40
MAX_BURST_UNCH_16BIT = 0x20
UNCH_MASK_DURATION = stc007.INTERLEAVE_OFS * 8  # 128 lines
STATS_DEPTH = 65

# Resolution results (stc007datastitcher.h:199-206) and deinterleaver modes.
SAMPLE_RES_UNKNOWN, SAMPLE_RES_14BIT, SAMPLE_RES_16BIT = 0, 1, 2


def _sn_mod():
    from ..ops import stitch_native as _sn
    return _sn


def _res_of_counts(c14, c16):
    """getFieldResolution's counts -> SAMPLE_RES rule (:996-1214)."""
    if c14 > stc007.INTERLEAVE_OFS * 2:
        return SAMPLE_RES_16BIT if (c16 * 128 // c14) > 32 \
            else SAMPLE_RES_14BIT
    return SAMPLE_RES_UNKNOWN

# tryPadding / findPadding results (stc007datastitcher.h:208-216).
DS_RET_NO_DATA, DS_RET_SILENCE, DS_RET_BROKE, DS_RET_NO_PAD, DS_RET_OK = \
    range(5)

SAMPLE_RATE_44100 = 44100
SAMPLE_RATE_44056 = 44056

# Service tags (mirror PCMLine SRVLINE_*).
SRV_NO, SRV_NEW_FILE, SRV_END_FILE, SRV_FILLER, SRV_END_FIELD, \
    SRV_END_FRAME, SRV_CTRL_BLOCK = 0, 1, 2, 3, 4, 5, 7


# ---------------------------------------------------------------------------
# Line storage
# ---------------------------------------------------------------------------
class LineStore:
    """Struct-of-arrays container of binarized STC-007 lines.

    `words` may be LAZY: a store built by `from_decoded_spec` (the
    chip-resident driver, pipeline/device_driver) holds a fetch
    closure instead of the [n, 8] array, and the first `.words` read
    materializes it (pulling the rows from the device buffer).  Every
    per-line fact the steady machinery needs (CRC validity, service
    tags, duplicate flags) is carried by eager arrays, so steady
    rounds never touch `.words` and the word values are never read
    back; fallback pairs, CWD, Control-Block parsing and rendering
    materialize transparently.  take/view/concat propagate laziness."""

    FIELDS = ("words", "source_crc", "word_crc", "word_valid",
              "frame_number", "line_number", "ref_level", "forced_bad",
              "coords_valid", "bw_set", "service", "has_markers")

    @property
    def words(self):
        w = self._words
        if w is None:
            w = self._words = np.asarray(self._words_fetch(), np.int64)
            self._words_fetch = None
        return w

    @words.setter
    def words(self, v):
        self._words = v
        self._words_fetch = None

    def _set_lazy_words(self, fetch):
        self._words = None
        self._words_fetch = fetch

    def words_materialized(self):
        return self._words is not None

    def __init__(self, n: int):
        self.words = np.zeros((n, 8), dtype=np.int64)
        self.source_crc = np.zeros(n, dtype=np.int64)
        self.word_crc = np.zeros((n, 9), dtype=bool)
        self.word_valid = np.zeros((n, 9), dtype=bool)
        self.frame_number = np.zeros(n, dtype=np.int64)
        self.line_number = np.zeros(n, dtype=np.int64)
        self.ref_level = np.zeros(n, dtype=np.int64)
        self.forced_bad = np.zeros(n, dtype=bool)
        self.coords_valid = np.zeros(n, dtype=bool)
        self.bw_set = np.zeros(n, dtype=bool)
        self.service = np.zeros(n, dtype=np.int8)
        self.has_markers = np.zeros(n, dtype=bool)
        # Silent-line defaults: invalid CRC (clear() stc007line.cpp:69-98).
        self.source_crc[:] = (~stc007.CRC_SILENT) & 0xFFFF

    @classmethod
    def _blank(cls) -> "LineStore":
        """Uninitialized instance for take/concat/view_slice, which
        overwrite every field — skips 12 pointless np.zeros."""
        return cls.__new__(cls)

    def __len__(self):
        return len(self.source_crc)

    def copy(self):
        out = LineStore._blank()
        for f in self.FIELDS:
            if f == "words" and self._words is None:
                out._set_lazy_words(lambda s=self: s.words.copy())
                continue
            setattr(out, f, getattr(self, f).copy())
        return out

    def take(self, idx) -> "LineStore":
        out = LineStore._blank()
        for f in self.FIELDS:
            if f == "words" and self._words is None:
                ix = np.asarray(idx).copy()
                out._set_lazy_words(lambda s=self, ix=ix: s.words[ix])
                continue
            a = getattr(self, f)[idx]
            # Fancy indexing already copied; only slices are views.
            setattr(out, f, a.copy() if a.base is not None else a)
        cached = getattr(self, "_crcv", None)
        if cached is not None:
            c = cached[idx]
            out._crcv = c.copy() if c.base is not None else c
        return out

    def take_or_view(self, idx) -> "LineStore":
        """take(), except an evenly-strided index set (the common case:
        a parity split of interleaved frame rows) becomes a zero-copy
        strided VIEW — callers must treat the result as immutable."""
        if len(idx) > 1:
            step = int(idx[1]) - int(idx[0])
            if step > 0 and np.all(np.diff(idx) == step):
                return self.view_rows(slice(int(idx[0]),
                                            int(idx[-1]) + 1, step))
        return self.take(idx)

    def view_rows(self, sl) -> "LineStore":
        """Zero-copy row view through an arbitrary slice (the strided
        sibling of view_slice) — the result must be treated as
        immutable."""
        out = LineStore._blank()
        for f in self.FIELDS:
            if f == "words" and self._words is None:
                out._set_lazy_words(lambda s=self, sl=sl: s.words[sl])
                continue
            setattr(out, f, getattr(self, f)[sl])
        cached = getattr(self, "_crcv", None)
        if cached is not None:
            out._crcv = cached[sl]
        return out

    def view_slice(self, a, b) -> "LineStore":
        """Zero-copy row window [a, b) — for feeding LineStore.concat
        (which copies); the view itself must not outlive the source."""
        out = LineStore._blank()
        for f in self.FIELDS:
            if f == "words" and self._words is None:
                out._set_lazy_words(lambda s=self, a=a, b=b: s.words[a:b])
                continue
            setattr(out, f, getattr(self, f)[a:b])
        cached = getattr(self, "_crcv", None)
        if cached is not None:
            out._crcv = cached[a:b]
        return out

    @staticmethod
    def concat(stores) -> "LineStore":
        out = LineStore._blank()
        for f in LineStore.FIELDS:
            if f == "words" and any(s._words is None for s in stores):
                parts = list(stores)
                out._set_lazy_words(lambda ps=parts: np.concatenate(
                    [p.words for p in ps]))
                continue
            setattr(out, f, np.concatenate([getattr(s, f) for s in stores]))
        # The CRC-valid cache composes: avoids re-CRC'ing every frame pair
        # (each frame is otherwise CRC'd once as frame 2, again as frame 1).
        caches = [getattr(s, "_crcv", None) for s in stores]
        if all(c is not None for c in caches):
            out._crcv = np.concatenate(caches)
        return out

    @staticmethod
    def empty_lines(n, frame_number=0, line_numbers=None, m2=False):
        """Filler/padding lines: silent words, invalid CRC, no coords."""
        out = LineStore(n)
        out.words[:] = stc007.silent_words(m2=m2, xp=np)[None, :]
        # All rows are the identical silent word pattern: CRC once.
        calc = int(stc007.calc_crc(out.words[:1], xp=np)[0]) if n else 0
        out.source_crc = np.full(n, (~calc) & 0xFFFF, np.int64)
        out.frame_number[:] = frame_number
        if line_numbers is not None:
            out.line_number[:] = line_numbers
        out._crcv = np.zeros(n, bool)  # source CRC is the complement
        return out

    # -- derived per-line quantities --------------------------------------
    def calc_crc(self):
        from ..ops import stitch_native as _sn
        if _sn.available():
            return _sn.crc_rows(self.words).astype(np.int64)
        return stc007.calc_crc(self.words, xp=np)

    def crc_valid_ignore_forced(self):
        # The trim/split/seam machinery asks ~10x per frame; cache until
        # words are mutated (CWD write-back calls invalidate_crc()).
        cached = getattr(self, "_crcv", None)
        if cached is None:
            cached = self.calc_crc() == self.source_crc
            self._crcv = cached
        return cached

    def invalidate_crc(self):
        self._crcv = None
        self._w32 = None
        self._crc8 = None

    def words_i32(self):
        """Cached int32 copy of words for the native core (the eval
        sweeps ask ~10x per frame; invalidate_crc() clears it alongside
        the CRC cache on CWD write-back)."""
        w = getattr(self, "_w32", None)
        if w is None:
            w = np.ascontiguousarray(self.words, np.int32)
            self._w32 = w
        return w

    def crc_valid(self):
        return (~self.forced_bad) & self.crc_valid_ignore_forced()

    def crc_ok8(self):
        """Cached `word_crc[:, :8] & ~forced_bad` — the per-line CRC-ok
        input of every seam/deinterleave eval (cleared by
        invalidate_crc alongside the other derived caches)."""
        c = getattr(self, "_crc8", None)
        if c is None:
            c = self.word_crc[:, :8] & ~self.forced_bad[:, None]
            self._crc8 = c
        return c

    def is_fixed_by_cwd(self):
        """isFixedByCWD (stc007line.cpp:629-642): CRC valid and some word
        has bad source CRC flag but is valid now."""
        return self.crc_valid() & np.any(~self.word_crc & self.word_valid,
                                         axis=-1)

    def samples_silent(self, m2=False):
        s = stc007.expand_sample(self.words[:, :6], m2=m2, xp=np)
        return np.all(s == 0, axis=-1)

    def apply_crc_state_per_word(self):
        v = self.crc_valid()
        self.word_crc[:] = v[:, None]
        self.word_valid[:] = v[:, None]
        self._crc8 = None

    @staticmethod
    def from_decoded(words, crc_read, valid, frame_number, line_number,
                     ref_level=None, has_markers=None, forced_bad=None):
        """Build a store from binarizer output arrays (device -> host).

        Constructed through _blank: every field is assigned outright, so
        the LineStore(n) zero-init would be pure overwritten work."""
        n = len(crc_read)
        out = LineStore._blank()
        out.forced_bad = np.zeros(n, bool) if forced_bad is None \
            else np.asarray(forced_bad, bool).copy()
        out.words = np.array(words, np.int64)
        out.source_crc = np.array(crc_read, np.int64)
        v = np.asarray(valid, bool)
        out.word_crc = np.repeat(v[:, None], 9, axis=1)
        out.word_valid = out.word_crc.copy()
        out.frame_number = np.array(frame_number, np.int64)
        out.line_number = np.array(line_number, np.int64)
        out.ref_level = np.zeros(n, np.int64) if ref_level is None \
            else np.asarray(ref_level, np.int64).copy()
        out.coords_valid = np.ones(n, bool)
        out.bw_set = np.ones(n, bool)
        out.service = np.zeros(n, np.int8)
        out.has_markers = v.copy() if has_markers is None \
            else np.asarray(has_markers, bool).copy()
        # Control Block detection (binarizer.cpp:1609-1614 after a valid
        # read -> setServCtrlBlk, stc007line.cpp:101-129): zero the cue
        # words, keep ID/ADDR1/ADDR2/CTRL, make the CRC valid, tag the
        # line as service so it never enters field data.
        cb = v & np.asarray(stc007.is_control_block(out.words, xp=np))
        if cb.any():
            out.words[cb, :4] = 0
            out.source_crc[cb] = stc007.calc_crc(out.words[cb], xp=np)
            out.service[cb] = SRV_CTRL_BLOCK
        # Prime the CRC-validity cache from the binarizer's own verdict:
        # a valid line IS a CRC match by construction (binarize.py:151
        # `valid = (syndrome == 0) & read_ok`; same rule in the native
        # trial grid), so only the invalid rows need the re-CRC (the
        # rare collision-filter rejections whose read still matches).
        crcv = v.copy()
        inv = np.nonzero(~v)[0]
        if len(inv):
            w_inv = out.words[inv]
            from ..ops import stitch_native as _sn
            calc = _sn.crc_rows(w_inv).astype(np.int64) \
                if _sn.available() else stc007.calc_crc(w_inv, xp=np)
            crcv[inv] = calc == out.source_crc[inv]
        out._crcv = crcv
        return out

    @staticmethod
    def from_decoded_spec(fetch, crc_read, valid, cb, crcm,
                          frame_number, line_number, ref_level=None,
                          forced_bad=None):
        """from_decoded for the chip-resident driver: the per-line
        facts (crc_read ALREADY rewritten for Control-Block lines,
        valid, cb = valid CB line, crcm = calc_crc(words) == crc_read)
        were computed ON DEVICE (ops/device_stitch.steady_round_packed)
        and the word values stay in HBM — `fetch` materializes them
        (CB-rewritten, matching from_decoded's store content exactly)
        only if a fallback/CWD/render path reads `.words`."""
        n = len(crc_read)
        out = LineStore._blank()
        out._set_lazy_words(fetch)
        out.forced_bad = np.zeros(n, bool) if forced_bad is None \
            else np.asarray(forced_bad, bool).copy()
        out.source_crc = np.array(crc_read, np.int64)
        v = np.asarray(valid, bool)
        out.word_crc = np.repeat(v[:, None], 9, axis=1)
        out.word_valid = out.word_crc.copy()
        out.frame_number = np.array(frame_number, np.int64)
        out.line_number = np.array(line_number, np.int64)
        out.ref_level = np.zeros(n, np.int64) if ref_level is None \
            else np.asarray(ref_level, np.int64).copy()
        out.coords_valid = np.ones(n, bool)
        out.bw_set = np.ones(n, bool)
        out.service = np.zeros(n, np.int8)
        out.has_markers = v.copy()
        cb = np.asarray(cb, bool)
        if cb.any():
            out.service[cb] = SRV_CTRL_BLOCK
        # crcm is calc==read over the (CB-rewritten) device words: True
        # by construction for valid rows, the from_decoded re-CRC
        # verdict for the rest.
        out._crcv = np.asarray(crcm, bool) | v
        return out


# ---------------------------------------------------------------------------
# Frame assembly descriptor
# ---------------------------------------------------------------------------
@dataclass
class FrameAsm:
    """Port of FrameAsmSTC007 (frametrimset.h:117-291)."""
    frame_number: int = 0
    video_standard: int = VID_UNKNOWN
    vid_std_preset: bool = False
    odd_std_lines: int = 0
    even_std_lines: int = 0
    odd_data_lines: int = 0
    even_data_lines: int = 0
    odd_valid_lines: int = 0
    even_valid_lines: int = 0
    odd_top_data: int = 0
    odd_bottom_data: int = 0
    even_top_data: int = 0
    even_bottom_data: int = 0
    odd_sample_rate: int = 0
    even_sample_rate: int = 0
    odd_ref: int = 0
    even_ref: int = 0
    odd_resolution: int = di.RES_MODE_14BIT_AUTO
    even_resolution: int = di.RES_MODE_14BIT_AUTO
    field_order: int = ORDER_UNK
    order_preset: bool = False
    order_guessed: bool = False
    tff_cnt: int = 0
    bff_cnt: int = 0
    inner_padding: int = 0
    outer_padding: int = 0
    trim_ok: bool = False
    inner_padding_ok: bool = False
    outer_padding_ok: bool = False
    inner_silence: bool = False
    outer_silence: bool = False
    blocks_total: int = 0
    blocks_drop: int = 0
    samples_drop: int = 0
    blocks_broken_field: int = 0
    blocks_fix_p: int = 0
    blocks_fix_q: int = 0
    blocks_fix_cwd: int = 0
    ctrl_index: int = -1
    ctrl_hour: int = -1
    ctrl_minute: int = -1
    ctrl_second: int = -1
    ctrl_field: int = -1
    ctrl_emphasis: bool = False   # CB control bit 0, active low
    ctrl_m2: bool = False         # CB format ID == M2
    ctrl_seen: bool = False

    # -- order helpers (frametrimset.cpp:505-640) -------------------------
    def is_order_set(self):
        return self.field_order in (ORDER_TFF, ORDER_BFF)

    def is_order_tff(self):
        return self.field_order == ORDER_TFF

    def is_order_bff(self):
        return self.field_order == ORDER_BFF

    def preset_tff(self):
        self.order_preset, self.order_guessed = True, False
        self.field_order = ORDER_TFF

    def preset_bff(self):
        self.order_preset, self.order_guessed = True, False
        self.field_order = ORDER_BFF

    def set_order_unknown(self):
        if not self.order_preset:
            self.field_order = ORDER_UNK
            self.order_guessed = False

    def set_order_tff(self):
        if not self.order_preset:
            self.field_order = ORDER_TFF

    def set_order_bff(self):
        if not self.order_preset:
            self.field_order = ORDER_BFF

    def set_order_guessed(self, flag):
        if not self.order_preset:
            self.order_guessed = flag

    def update_vid_std_soft(self, std):
        if not self.vid_std_preset and std < 3:
            self.video_standard = std

    def clear_asm_stats(self):
        self.blocks_total = self.blocks_drop = self.samples_drop = 0
        self.blocks_broken_field = 0
        self.blocks_fix_p = self.blocks_fix_q = self.blocks_fix_cwd = 0

    def snapshot(self):
        """Shallow per-frame copy for the work log — dataclasses.replace
        re-runs __init__ over ~40 fields and shows up in the steady-state
        profile; all fields are scalars, so a dict copy is exact."""
        new = FrameAsm.__new__(FrameAsm)
        new.__dict__.update(self.__dict__)
        return new


@dataclass
class StitchStats:
    """FieldStitchStats (frametrimset.h:97-114)."""
    index: int = 0
    valid: int = 0
    silent: int = 0
    unchecked: int = 0
    broken: int = 0

    def sort_key(self):
        # operator< (frametrimset.cpp): broken asc, valid desc,
        # unchecked asc, silent asc, index asc.
        return (self.broken, -self.valid, self.unchecked, self.silent,
                self.index)


@dataclass
class SamplePair:
    """PCMSamplePair payload (pcmsamplepair.h:46-112)."""
    left: int = 0
    right: int = 0
    block_ok: bool = False
    left_valid: bool = False
    right_valid: bool = False
    left_fixed: bool = False
    right_fixed: bool = False
    sample_rate: int = SAMPLE_RATE_44100
    emphasis: bool = False
    service: int = SRV_NO
    file_path: str = ""


@dataclass
class SampleChunk:
    """A run of sample pairs as struct-of-arrays (the batch analog of a
    list of PCMSamplePair).  Service tags travel as chunks with
    service != SRV_NO and empty arrays."""
    samples: np.ndarray = None   # [N, 2] int
    valid: np.ndarray = None     # [N, 2] bool
    fixed: np.ndarray = None     # [N, 2] bool
    block_ok: np.ndarray = None  # [N] bool
    sample_rate: int = SAMPLE_RATE_44100
    emphasis: bool = False
    service: int = SRV_NO
    file_path: str = ""

    @staticmethod
    def tag(service, file_path=""):
        return SampleChunk(service=service, file_path=file_path)

    def to_pairs(self):
        if self.service != SRV_NO:
            return [SamplePair(service=self.service,
                               file_path=self.file_path)]
        return [SamplePair(left=int(self.samples[i, 0]),
                           right=int(self.samples[i, 1]),
                           block_ok=bool(self.block_ok[i]),
                           left_valid=bool(self.valid[i, 0]),
                           right_valid=bool(self.valid[i, 1]),
                           left_fixed=bool(self.fixed[i, 0]),
                           right_fixed=bool(self.fixed[i, 1]),
                           sample_rate=self.sample_rate,
                           emphasis=self.emphasis)
                for i in range(len(self.block_ok))]


def chunks_to_arrays(chunks):
    """Concatenate data chunks -> (samples [N,2] int16, valid [N,2],
    block_ok [N,2], rate) skipping service tags; None if no data."""
    data = [c for c in chunks if c.service == SRV_NO and len(c.block_ok)]
    if not data:
        return None
    samples = np.concatenate([c.samples for c in data]).astype(np.int16)
    valid = np.concatenate([c.valid for c in data])
    blk = np.concatenate([np.repeat(c.block_ok[:, None], 2, axis=1)
                          for c in data])
    return samples, valid, blk, data[0].sample_rate


# ---------------------------------------------------------------------------
# Deinterleave evaluation helpers (vectorized over block shifts)
# ---------------------------------------------------------------------------
def _res_mode_is16(res_mode):
    return res_mode in (di.RES_MODE_16BIT, di.RES_MODE_16BIT_AUTO)


def eval_blocks(store: LineStore, res_mode, ignore_crc=False,
                force_ecc=True, en_p=True, en_q=True, en_cwd=False,
                start=0, stop=None, m2=False, full_aux=True,
                backend=None):
    """Run the vectorized deinterleaver over shifts [start, stop).

    Equivalent of the reference's serial processBlock sweep. Returns
    (BlockBatch, cwd_applied, aux dict with per-block derived flags).
    """
    n = len(store)
    if stop is None:
        stop = n - stc007.MIN_DEINT_DATA
    if stop <= start:
        return None, None, None
    shifts = np.arange(start, stop, dtype=np.int64)
    from ..ops import stitch_native as _sn
    fast = backend == "tpu" or _sn.available()
    if fast and not full_aux and not en_cwd and not ignore_crc:
        rows = None  # contiguous shifts resolved natively, no [B,8] build
    else:
        taps = np.arange(8) * stc007.INTERLEAVE_OFS
        rows = shifts[:, None] + taps[None, :]
    batch, cwd_app, aux = eval_rows(store, rows, res_mode,
                                    ignore_crc=ignore_crc,
                                    force_ecc=force_ecc, en_p=en_p,
                                    en_q=en_q, en_cwd=en_cwd, m2=m2,
                                    full_aux=full_aux, start=start,
                                    n_blocks=stop - start, backend=backend)
    aux["shifts"] = shifts
    return batch, cwd_app, aux


def eval_rows(store: LineStore, rows, res_mode, ignore_crc=False,
              force_ecc=True, en_p=True, en_q=True, en_cwd=False, m2=False,
              full_aux=True, start=0, n_blocks=None, backend=None):
    """eval_blocks core over explicit per-block line rows [B, 8].

    rows[b, w] is the absolute line index feeding interleave tap w of
    block b — this lets callers batch MANY padded seam queues into one
    deinterleaver call (each padding is just a different index map,
    reference tryPadding :1417/findPadding :1743).
    """
    n = len(store)
    if ignore_crc:
        crc_ok = (store.coords_valid & store.bw_set)[:, None] \
            & np.ones((1, 8), bool)
    elif hasattr(store, "crc_ok8"):
        crc_ok = store.crc_ok8()
    else:  # _SlimQueue
        crc_ok = store.word_crc[:, :8] & ~store.forced_bad[:, None]
    cwd_line = store.is_fixed_by_cwd() if en_cwd else np.zeros(n, bool)

    if backend == "tpu" and not en_cwd:
        return _eval_rows_tpu(store, rows, crc_ok, res_mode, force_ecc,
                              en_p, en_q, m2, full_aux=full_aux,
                              start=start, n_blocks=n_blocks)
    from ..ops import stitch_native as _sn
    if _sn.available():
        return _eval_rows_native(store, rows, crc_ok, cwd_line, res_mode,
                                 force_ecc, en_p, en_q, en_cwd, m2,
                                 full_aux=full_aux, start=start,
                                 n_blocks=n_blocks)
    if rows is None:
        taps = np.arange(8) * stc007.INTERLEAVE_OFS
        rows = (np.arange(start, start + n_blocks, dtype=np.int64)[:, None]
                + taps[None, :])

    def run(resolution):
        w, c = _assemble_rows(store.words, crc_ok, rows, resolution)
        cwd = cwd_line[rows]
        if en_cwd:
            batch, cwd_app = di.correct_blocks_cwd(
                w, c, cwd, resolution, en_p=en_p, en_q=en_q,
                force_ecc=force_ecc, xp=np)
        else:
            batch = di.correct_blocks(w, c, resolution, en_p=en_p,
                                      en_q=en_q, force_ecc=force_ecc, xp=np)
            cwd_app = np.zeros(rows.shape[0], bool)
        return batch, cwd, cwd_app

    if res_mode == di.RES_MODE_14BIT:
        batch, cwd_in, cwd_app = run(di.RES_14BIT)
    elif res_mode == di.RES_MODE_16BIT:
        batch, cwd_in, cwd_app = run(di.RES_16BIT)
    else:
        first = di.RES_14BIT if res_mode == di.RES_MODE_14BIT_AUTO \
            else di.RES_16BIT
        other = di.RES_16BIT if first == di.RES_14BIT else di.RES_14BIT
        r1, cwd_in, ca1 = run(first)
        r2, _, ca2 = run(other)
        use2 = (r1.stage == di.STG_BAD_BLOCK) & (r2.stage != di.STG_BAD_BLOCK)
        sel = lambda a, b: np.where(
            use2.reshape(use2.shape + (1,) * (a.ndim - 1)), b, a)
        batch = di.BlockBatch(*(sel(a, b) for a, b in zip(r1, r2)))
        cwd_app = np.where(use2, ca2, ca1)

    # Derived per-block quantities used by the stitcher heuristics.
    is16 = batch.resolution == di.RES_16BIT
    lim = np.where(is16, 7, 8)
    widx = np.arange(8)[None, :]
    in_lim = widx < lim[:, None]
    broken = batch.audio_state == di.AUD_BROKEN
    block_valid = batch.valid[:, :6].all(axis=-1)
    # canForceCheck (stc007datablock.cpp): <=1 raw error in 14-bit
    # (<=0 in 16-bit), not broken; CWD-fixed words don't count.
    raw_errs = np.sum((~batch.line_crc & in_lim) & ~(cwd_in & in_lim),
                      axis=-1)
    can_force = ~broken & np.where(is16, raw_errs == 0, raw_errs <= 1)
    # Silence test on output samples (block.isSilent()).
    samples = di.block_samples(batch, m2=m2, xp=np)
    silent = np.all(samples == 0, axis=-1)
    fixed_p = batch.audio_state == di.AUD_FIX_P
    fixed_q = batch.audio_state == di.AUD_FIX_Q
    # Source frame/line of first (L0) and last (Q0/P0) word.
    start_frame = store.frame_number[rows[:, 0]]
    start_line = store.line_number[rows[:, 0]]
    last_tap = np.where(is16, 6, 7)
    stop_rows = rows[np.arange(rows.shape[0]), last_tap]
    stop_frame = store.frame_number[stop_rows]
    stop_line = store.line_number[stop_rows]
    aux = dict(rows=rows, broken=broken, block_valid=block_valid,
               can_force=can_force, silent=silent, fixed_p=fixed_p,
               fixed_q=fixed_q, samples=samples,
               start_frame=start_frame, start_line=start_line,
               stop_frame=stop_frame, stop_line=stop_line,
               errors_audio_fixed=np.sum(~batch.valid[:, :6], axis=-1),
               cwd_in=cwd_in)
    return batch, cwd_app, aux


def _eval_rows_native(store, rows, crc_ok, cwd_line, res_mode, force_ecc,
                      en_p, en_q, en_cwd, m2, full_aux=True, start=0,
                      n_blocks=None):
    """eval_rows via the native core (one C call: gather + correction +
    flags + samples); output contract identical to the numpy path.
    full_aux=False skips the source frame/line gathers (only the final
    deinterleave's seam masking needs them — 10 of 11 evals per frame
    are seam/resolution probes that read the packed flags alone).
    rows=None means contiguous shifts from `start` (resolved in C, no
    [B,8] index build)."""
    from ..ops import stitch_native as _sn
    if rows is None and full_aux:  # safety: the gathers below need rows
        taps = np.arange(8) * stc007.INTERLEAVE_OFS
        rows = (np.arange(start, start + n_blocks,
                          dtype=np.int64)[:, None] + taps[None, :])
    B = rows.shape[0] if rows is not None else int(n_blocks)
    w_src = store.words_i32() if hasattr(store, "words_i32") \
        else store.words  # _SlimQueue has no cache slot
    w, v, lc, state, stage, res, flags, samples = _sn.eval_rows_arrays(
        w_src, crc_ok, cwd_line if en_cwd else None, rows,
        start, B, res_mode, en_p, en_q, force_ecc, en_cwd, m2)
    batch = di.BlockBatch(w, v, lc, state, stage, res)
    cwd_app = (flags & _sn.FLAG_CWD_APP) != 0
    aux = dict(rows=rows, start=start,
               broken=(flags & _sn.FLAG_BROKEN) != 0,
               block_valid=(flags & _sn.FLAG_BLOCK_VALID) != 0,
               can_force=(flags & _sn.FLAG_CAN_FORCE) != 0,
               silent=(flags & _sn.FLAG_SILENT) != 0,
               fixed_p=(flags & _sn.FLAG_FIX_P) != 0,
               fixed_q=(flags & _sn.FLAG_FIX_Q) != 0,
               samples=samples, flags=flags)
    if full_aux:
        is16 = res == di.RES_16BIT
        stop_rows = rows[np.arange(B), np.where(is16, 6, 7)]
        cwd_in = cwd_line[rows] if en_cwd else np.zeros((B, 8), bool)
        aux.update(start_frame=store.frame_number[rows[:, 0]],
                   start_line=store.line_number[rows[:, 0]],
                   stop_frame=store.frame_number[stop_rows],
                   stop_line=store.line_number[stop_rows],
                   errors_audio_fixed=np.sum(~v[:, :6], axis=-1),
                   cwd_in=cwd_in)
    return batch, cwd_app, aux


def _eval_rows_tpu(store, rows, crc_ok, res_mode, force_ecc, en_p, en_q,
                   m2, full_aux=True, start=0, n_blocks=None):
    """eval_rows via the device (ops.device_stitch.eval_rows_arrays):
    gather + ECC + flags + samples in one jitted dispatch, the compute
    path of the --backend tpu stitcher; output contract identical to
    the native/numpy paths (tests/test_device_stitch.py)."""
    from ..ops import device_stitch as _ds
    from ..ops import stitch_native as _sn
    B = rows.shape[0] if rows is not None else int(n_blocks)
    w_src = store.words_i32() if hasattr(store, "words_i32") \
        else store.words
    w, v, lc, state, stage, res, flags, samples = _ds.eval_rows_arrays(
        w_src, crc_ok, rows, start, B, res_mode, en_p, en_q, force_ecc,
        m2)
    batch = di.BlockBatch(w, v, lc, state, stage, res)
    cwd_app = np.zeros(B, bool)
    aux = dict(rows=rows, start=start,
               broken=(flags & _sn.FLAG_BROKEN) != 0,
               block_valid=(flags & _sn.FLAG_BLOCK_VALID) != 0,
               can_force=(flags & _sn.FLAG_CAN_FORCE) != 0,
               silent=(flags & _sn.FLAG_SILENT) != 0,
               fixed_p=(flags & _sn.FLAG_FIX_P) != 0,
               fixed_q=(flags & _sn.FLAG_FIX_Q) != 0,
               samples=samples, flags=flags)
    if full_aux:
        if rows is None:
            taps = np.arange(8) * stc007.INTERLEAVE_OFS
            rows = (np.arange(start, start + B,
                              dtype=np.int64)[:, None] + taps[None, :])
            aux["rows"] = rows
        is16 = res == di.RES_16BIT
        stop_rows = rows[np.arange(B), np.where(is16, 6, 7)]
        aux.update(start_frame=store.frame_number[rows[:, 0]],
                   start_line=store.line_number[rows[:, 0]],
                   stop_frame=store.frame_number[stop_rows],
                   stop_line=store.line_number[stop_rows],
                   errors_audio_fixed=np.sum(~v[:, :6], axis=-1),
                   cwd_in=np.zeros((B, 8), bool))
    return batch, cwd_app, aux


def _assemble_rows(line_words, line_crc_ok, rows, resolution):
    """di.assemble_blocks with explicit per-tap line rows [B, 8]."""
    widx = np.arange(8, dtype=np.int32)[None, :]
    w = line_words[rows, widx]
    c = line_crc_ok[rows, widx]
    if resolution == di.RES_14BIT:
        return w, c
    s_words = line_words[rows[:, :7], di.WORD_Q0]
    s_crc = line_crc_ok[rows[:, :7], di.WORD_Q0]
    shifts = np.array(stc007.F1_S_OFFSETS, dtype=np.int32)[None, :]
    w16 = ((w[:, :7] << stc007.F1_WORD_OFS)
           + ((s_words >> shifts) & stc007.F1_S_MASK))
    c16 = c[:, :7] & s_crc
    zeros = np.zeros_like(w[:, :1])
    return (np.concatenate([w16, zeros], axis=-1),
            np.concatenate([c16, np.ones_like(c[:, :1])], axis=-1))


def _burst_stats(valid_b, silent, unch, broken, unchecked_lim):
    """Vectorized tryPadding burst counters (:1623-1720).

    Serial semantics: valid_run counts valid blocks and is zeroed at every
    step where the silence run >= MAX_BURST_SILENCE, the unchecked run >=
    unchecked_lim, or the cumulative broken count >= MAX_BURST_BROKEN;
    valid_max samples the run (pre-increment of step i, i.e. the run after
    step i-1) at every non-valid block plus the final run.  Expressed with
    cumsums: run_after[i] = cumvalid[i] - cumvalid[last_reset<=i].

    Returns (valid_max, silent_max, unchecked_max, broken_count).
    """
    n = len(valid_b)
    if n == 0:
        return 0, 0, 0, 0
    idx = np.arange(n)

    def runs(mask):
        # consecutive-True run length ending at i
        last_false = np.maximum.accumulate(np.where(~mask, idx, -1))
        return np.where(mask, idx - last_false, 0)

    sil_run = runs(silent)
    unch_run = runs(unch)
    sil_max = int(sil_run.max())
    unch_max = int(unch_run.max())
    broken_count = int(broken.sum())

    reset = ((silent & (sil_run >= MAX_BURST_SILENCE))
             | (unch & (unch_run >= unchecked_lim))
             | (broken & (np.cumsum(broken) >= MAX_BURST_BROKEN)))
    cumv = np.cumsum(valid_b.astype(np.int64))
    last_reset = np.maximum.accumulate(np.where(reset, idx, -1))
    base = np.where(last_reset >= 0, cumv[np.maximum(last_reset, 0)], 0)
    run_after = cumv - base
    prev_run = np.concatenate([[0], run_after[:-1]])
    cand = prev_run[~valid_b]
    valid_max = int(max(cand.max() if len(cand) else 0, run_after[-1]))
    return valid_max, sil_max, unch_max, broken_count


# ---------------------------------------------------------------------------
# The stitcher
# ---------------------------------------------------------------------------
class STC007Stitcher:
    """Two-frame sliding-window reassembler (doFrameReassemble equivalent).

    Feed whole frames of decoded lines via push_frame(); collect SamplePair
    output from pop_samples().
    """

    def __init__(self, en_p=True, en_q=True, en_cwd=False, ignore_crc=False,
                 mode_m2=False, preset_video=VID_UNKNOWN,
                 preset_order=ORDER_UNK, preset_resolution=None,
                 preset_sample_rate=0, mask_seams=True,
                 broken_mask_dur=UNCH_MASK_DURATION // 2,
                 max_unch_14=MAX_BURST_UNCH_14BIT,
                 max_unch_16=MAX_BURST_UNCH_16BIT, fix_cut_above=False,
                 auto_m2=False, record_views=False, seam_backend="auto"):
        # seam_backend: "auto" (native when compiled, else numpy) or
        # "tpu" — the stitcher's compute (padding search scored in one
        # batched dispatch per seam, field resolution counts, and the
        # final deinterleave+ECC block eval) runs on the device
        # (ops.device_stitch, SURVEY §7.5); only the stage machine and
        # the finalize masking tail stay host Python.
        self.seam_backend = seam_backend
        self.en_p, self.en_q, self.en_cwd = en_p, en_q, en_cwd
        self.ignore_crc = ignore_crc
        self.mode_m2 = mode_m2
        self.auto_m2 = auto_m2
        self.preset_video = preset_video
        self.preset_order = preset_order
        self.preset_resolution = preset_resolution
        self.preset_sample_rate = preset_sample_rate
        self.mask_seams = mask_seams
        self.broken_mask_dur = broken_mask_dur
        self.max_unch_14 = max_unch_14
        self.max_unch_16 = max_unch_16
        self.fix_cut_above = fix_cut_above
        # Diagnostic captures for the reassembled/data-block render
        # views (RenderPCM windows 3 and 4, renderpcm.h:123-150).
        self.record_views = record_views
        self.last_blocks = None
        self.last_assembled = None
        # Frame pairs stitched by each path: "round" / "spec_round" (one
        # C round call; spec = replaying the device round), "spec_tail",
        # "native_tail", "device_tail" (one steady pair) and
        # "stage_machine" (the full findFieldStitching path).
        self.pair_paths = Counter()
        self.reset_state()

    def reset_state(self):
        self.frasm_f0 = FrameAsm()
        self.frasm_f1 = FrameAsm()
        self.frasm_f2 = FrameAsm()
        self.stats_field_order = []
        self.stats_resolution = []
        self.broken_countdown = 0
        self.last_pad_counter = 0xFF
        self.pending_frames = []          # queue of (frame_no, LineStore)
        self.conv_queue = LineStore(0)    # persists across frames: the
        # interleave chains fields of adjacent frames together
        # (stc007datastitcher.h:22-25); performDeinterleave leaves the last
        # MIN_DEINT_DATA lines for the next frame's fill to extend.
        self.out_chunks: list[SampleChunk] = []
        self.file_start = False
        self.file_end = False
        self.file_name = ""
        self.frame_log: list[FrameAsm] = []

    # -- input ------------------------------------------------------------
    def _queue_frame(self, store: LineStore):
        store.crc_valid_ignore_forced()  # prime the CRC cache once per frame
        data = store.service == SRV_NO
        frames = store.frame_number[data]
        fno = int(frames[0]) if len(frames) else (
            int(store.frame_number[0]) if len(store) else 0)
        self.pending_frames.append((fno, store))

    def push_frame(self, store: LineStore):
        """Queue one frame's worth of lines (may include service lines)."""
        self._queue_frame(store)
        self._pump()

    def push_frames(self, stores):
        """Queue a whole round of frames, then pump once — with 3+
        frames pending, consecutive steady pairs run through ONE
        stc007_steady_round call instead of a per-pair pump."""
        for store in stores:
            self._queue_frame(store)
        self._pump()

    def finish(self):
        """Flush: append a dummy silent frame and process the tail."""
        if not self.pending_frames:
            return
        last_no = self.pending_frames[-1][0]
        dummy = LineStore.empty_lines(0)
        tail = LineStore(1)
        tail.service[0] = SRV_END_FILE
        tail.frame_number[0] = last_no + 1
        dummy = LineStore.concat([dummy, tail])
        self.pending_frames.append((last_no + 1, dummy))
        self._pump(final=True)

    def pop_samples(self):
        """Compat shim: materialize SamplePair objects (tests/tools)."""
        out = []
        for c in self.pop_sample_chunks():
            out.extend(c.to_pairs())
        return out

    def pop_sample_chunks(self):
        """Batch output path: list of SampleChunk (arrays, no per-sample
        objects) — the production consumers use this."""
        out = self.out_chunks
        self.out_chunks = []
        return out

    # -- main loop --------------------------------------------------------
    def _pump(self, final=False):
        while len(self.pending_frames) >= 2:
            if len(self.pending_frames) >= 3 and self._try_steady_run():
                continue
            (f1_no, f1), (f2_no, f2) = self.pending_frames[0], \
                self.pending_frames[1]
            self.frasm_f1.frame_number = f1_no
            self.frasm_f2.frame_number = f2_no
            self._process_pair(f1, f2)
            self.pending_frames.pop(0)
            # Roll descriptors (doFrameReassemble :7399-7407).
            self.frasm_f0 = self.frasm_f1
            self.frasm_f1 = self.frasm_f2
            self.frasm_f2 = FrameAsm()
            if self.file_end:
                self.out_chunks.append(SampleChunk.tag(SRV_END_FILE))
                self.reset_file_state()
            self.file_start = self.file_end = False

    def reset_file_state(self):
        f0 = FrameAsm()
        self.frasm_f0 = f0
        self.frasm_f1 = FrameAsm(frame_number=self.frasm_f1.frame_number)
        self.broken_countdown = 0

    def _process_pair(self, f1: LineStore, f2: LineStore):
        self.find_frames_trim(f1, f2)
        if self.file_start:
            # resetState on new file (doFrameReassemble :7345-7349) but
            # keep current trim results.
            self.stats_field_order = []
            self.stats_resolution = []
            self.broken_countdown = 0
            self.frasm_f0 = FrameAsm()
        self.split_frames_to_fields(f1, f2)
        if self._try_steady_pair():
            self.frame_log.append(self.frasm_f1.snapshot())
            return
        self.pair_paths["stage_machine"] += 1
        self.find_field_stitching()
        if self.file_start:
            self.conv_queue = LineStore(0)
            self.out_chunks.append(
                SampleChunk.tag(SRV_NEW_FILE, self.file_name))
        carry_n = len(self.conv_queue)
        # The carry rides into the frame assembly's single concat (one
        # materialization of the conv queue per frame, not two).
        conv = self.fill_frame_for_output(prefix=self.conv_queue)
        if self.record_views:
            self.last_assembled = conv.take(slice(carry_n, len(conv)))
        self.conv_queue = self.prescan_frame(conv)
        consumed = self.perform_deinterleave(self.conv_queue)
        if consumed > 0:
            self.conv_queue = self.conv_queue.take(
                slice(consumed, len(self.conv_queue)))
        self.frame_log.append(self.frasm_f1.snapshot())

    # -- trimming (findFramesTrim :259-737) -------------------------------
    def find_frames_trim(self, buf1: LineStore, buf2: LineStore):
        """Operates on the two frame stores directly (no concat): each
        frame's scan only ever touches its own rows, and the service/CB
        scan result is cached on the store so the same frame is not
        re-scanned when it rolls from frame 2 to frame 1 next pair."""
        fa, fb = self.frasm_f1, self.frasm_f2
        for fr in (fa, fb):
            if not fr.trim_ok:
                fr.even_top_data = fr.even_bottom_data = 0
                fr.odd_top_data = fr.odd_bottom_data = 0

        for fr, buf in ((fa, buf1), (fb, buf2)):
            # Service tags + Control Block + per-parity trim candidates,
            # in ONE pass (native) — cached across the f2 -> f1 roll.
            scan = getattr(buf, "_svc_scan", None)
            if scan is None or scan[0] != fr.frame_number:
                scan = self._scan_frame(fr.frame_number, buf)
                buf._svc_scan = scan
            _, new_file, end_file, fields, _ = scan
            if new_file:
                self.file_start = True
            if end_file:
                self.file_end = True
            if fields is not None:
                fr.ctrl_index = fields["index"]
                fr.ctrl_hour = fields["hour"]
                fr.ctrl_minute = fields["minute"]
                fr.ctrl_second = fields["second"]
                fr.ctrl_field = fields["field"]
                fr.ctrl_emphasis = fields["emphasis"]
                fr.ctrl_m2 = fields["m2"]
                fr.ctrl_seen = True
                # Auto M2 sample format from the CB format-ID bits (the
                # reference leaves this to a user setting,
                # setM2SampleFormat stc007datastitcher.cpp:7026; here the
                # tape tells us directly).
                if self.auto_m2 and fields["m2"] != self.mode_m2:
                    self.mode_m2 = fields["m2"]

        for fr, buf in ((fa, buf1), (fb, buf2)):
            if fr.trim_ok:
                continue
            scan = buf._svc_scan
            if scan[0] != fr.frame_number:  # pragma: no cover - safety
                scan = self._scan_frame(fr.frame_number, buf)
            trim = scan[4]
            found = {}
            for parity in ("even", "odd"):
                first, last = trim[parity]
                found[parity] = first >= 0
                if first >= 0:
                    setattr(fr, f"{parity}_top_data",
                            int(buf.line_number[first]))
                    setattr(fr, f"{parity}_bottom_data",
                            int(buf.line_number[last]))
            if found["odd"] and found["even"]:
                fr.trim_ok = True

    def _scan_frame(self, frame_no, buf):
        """One pass over a frame store: service tags, Control Block
        fields and per-parity trim candidate rows (findFramesTrim
        :259-737).  Native when available; the numpy twin is the
        reference semantics (differential-tested)."""
        from ..ops import stitch_native as _sn
        if _sn.available():
            r = _sn.trim_scan(buf.line_number, buf.frame_number,
                              buf.service, buf.crc_valid_ignore_forced(),
                              buf.forced_bad, buf.has_markers, frame_no)
            new_file, end_file = bool(r[8]), bool(r[9])
            fields = None
            if r[10] >= 0 and (r[11] < 0 or r[10] < r[11]):
                fields = stc007.control_block_fields(buf.words[r[10]])
            trim = {}
            for parity, base, good in (("even", 0, 12), ("odd", 4, 13)):
                skip_bad = int(r[good]) > MIN_GOOD_LINES_PF
                o = base if skip_bad else base + 2
                trim[parity] = (int(r[o]), int(r[o + 1]))
            return (frame_no, new_file, end_file, fields, trim)
        svc = buf.service
        mask = buf.frame_number == frame_no
        new_file = bool(np.any((svc == SRV_NEW_FILE) & mask))
        end_file = bool(np.any((svc == SRV_END_FILE) & mask))
        # Control Block at top of field (before any good data line).
        cb = np.nonzero((svc == SRV_CTRL_BLOCK) & mask)[0]
        fields = None
        if len(cb):
            good = np.nonzero(mask & (svc == SRV_NO)
                              & buf.crc_valid())[0]
            if len(good) == 0 or cb[0] < good[0]:
                fields = stc007.control_block_fields(buf.words[cb[0]])
        is_data = svc == SRV_NO
        crc_ok = buf.crc_valid()
        odd = (buf.line_number % 2) != 0
        dmask = mask & is_data
        trim = {}
        for parity, is_odd in (("even", False), ("odd", True)):
            pm = dmask & (odd == is_odd)
            good_cnt = int(np.sum(pm & crc_ok))
            skip_bad = good_cnt > MIN_GOOD_LINES_PF
            if skip_bad:
                pcm = pm & buf.crc_valid_ignore_forced()
            else:
                pcm = pm & (buf.has_markers
                            | buf.crc_valid_ignore_forced())
            hits = np.nonzero(pcm)[0]
            trim[parity] = (int(hits[0]), int(hits[-1])) if len(hits) \
                else (-1, -1)
        return (frame_no, new_file, end_file, fields, trim)

    # -- field split (splitFramesToFields :737-996) -----------------------
    def split_frames_to_fields(self, buf1: LineStore, buf2: LineStore):
        """Split both frame stores into odd/even field buffers.

        The split of a given store is pure in (frame_number, trim tops/
        bottoms), and every frame is split twice — once as frame 2, once
        as frame 1 of the next pair — so the result is cached on the
        store and replayed after the roll (the field LineStores are
        never mutated downstream; every consumer copies via take())."""
        fa, fb = self.frasm_f1, self.frasm_f2
        self.fields = {}
        self.f1_max_line = 0
        self.f2_max_line = 0
        for fr, tag, buf in ((fa, "f1", buf1), (fb, "f2", buf2)):
            key = (fr.frame_number,
                   fr.even_top_data, fr.even_bottom_data,
                   fr.odd_top_data, fr.odd_bottom_data)
            cache = getattr(buf, "_split_cache", None)
            if cache is not None and cache["key"] == key:
                setattr(self, f"{tag}_max_line", cache["max_line"])
                for parity in ("even", "odd"):
                    self.fields[(tag, parity)] = cache[parity]
                    setattr(fr, f"{parity}_data_lines",
                            cache[parity + "_data"])
                    setattr(fr, f"{parity}_valid_lines",
                            cache[parity + "_valid"])
                continue
            cache = self._split_one(fr, buf, key)
            setattr(self, f"{tag}_max_line", cache["max_line"])
            for parity in ("even", "odd"):
                self.fields[(tag, parity)] = cache[parity]
                setattr(fr, f"{parity}_data_lines",
                        cache[parity + "_data"])
                setattr(fr, f"{parity}_valid_lines",
                        cache[parity + "_valid"])
            buf._split_cache = cache
        # Average reference level for Frame A (splitFramesToFields tail).
        for parity in ("odd", "even"):
            fld = self.fields[("f1", parity)]
            v = fld.crc_valid()
            if v.any():
                ref = int(fld.ref_level[v].sum() // v.sum())
            elif len(fld):
                ref = int(fld.ref_level.sum() // len(fld))
            else:
                ref = 0
            setattr(fa, f"{parity}_ref", ref)

    def _split_one(self, fr, buf, key):
        """Field split of one frame store -> cache dict.  Native scan
        (stc007_split_scan) with zero-copy strided views on the common
        evenly-strided row sets; the numpy twin is the reference
        semantics (differential-tested)."""
        from ..ops import stitch_native as _sn
        if _sn.available():
            et, eb = fr.even_top_data, fr.even_bottom_data
            ot, ob = fr.odd_top_data, fr.odd_bottom_data
            r = _sn.split_scan(buf.line_number, buf.frame_number,
                               buf.service, buf.crc_valid_ignore_forced(),
                               buf.forced_bad, fr.frame_number,
                               et, eb, not (et == 0 and eb == 0),
                               ot, ob, True, LINES_PF_PAL)
            cache = {"key": key, "max_line": int(r[0])}
            for parity, base in (("even", 1), ("odd", 7)):
                first, last, count, stp, regular, valid = \
                    (int(x) for x in r[base:base + 6])
                if count == 0:
                    fld = buf.view_slice(0, 0)
                elif regular:
                    fld = buf.view_rows(slice(first, last + 1, stp))
                else:  # irregular row set (damaged capture): numpy pick
                    top = getattr(fr, f"{parity}_top_data")
                    bottom = getattr(fr, f"{parity}_bottom_data")
                    pm = ((buf.frame_number == fr.frame_number)
                          & ((buf.service == SRV_NO)
                             | (buf.service == SRV_FILLER))
                          & (((buf.line_number % 2) != 0)
                             == (parity == "odd"))
                          & (buf.line_number >= top)
                          & (buf.line_number <= bottom))
                    fld = buf.take(np.nonzero(pm)[0][:LINES_PF_PAL])
                cache[parity] = fld
                cache[parity + "_data"] = count
                cache[parity + "_valid"] = valid
            return cache
        svc_keep = (buf.service == SRV_NO) | (buf.service == SRV_FILLER)
        crc_ok = buf.crc_valid()
        odd = (buf.line_number % 2) != 0
        cache = {"key": key, "max_line": 0}
        mask = (buf.frame_number == fr.frame_number) & svc_keep
        if np.any(mask):
            cache["max_line"] = int(buf.line_number[mask].max())
        for parity, is_odd in (("even", False), ("odd", True)):
            top = getattr(fr, f"{parity}_top_data")
            bottom = getattr(fr, f"{parity}_bottom_data")
            pm = mask & (odd == is_odd)
            if not is_odd and top == bottom and top == 0:
                pm = pm & False
            else:
                pm = pm & (buf.line_number >= top) \
                    & (buf.line_number <= bottom)
            idx = np.nonzero(pm)[0][:LINES_PF_PAL]
            fld = buf.take_or_view(idx)
            cache[parity] = fld
            cache[parity + "_data"] = len(idx)
            cache[parity + "_valid"] = int(np.sum(crc_ok[idx]))
        return cache

    # -- resolution (getFieldResolution :996-1214) ------------------------
    def get_field_resolution(self, fld: LineStore):
        if self.preset_resolution == SAMPLE_RES_14BIT:
            return SAMPLE_RES_14BIT
        if self.preset_resolution == SAMPLE_RES_16BIT:
            return SAMPLE_RES_16BIT
        cached = getattr(fld, "_fieldres", None)
        if cached is not None:
            return cached
        f_size = len(fld)
        if f_size <= stc007.MIN_DEINT_DATA:
            return SAMPLE_RES_UNKNOWN
        from ..ops import stitch_native as _sn
        use_native = _sn.available() and self.seam_backend != "tpu"
        # The same field content is seen twice (as frame 2, then frame 1 of
        # the next pair) but the LineStore is rebuilt, so memoize on a
        # content fingerprint across pairs.
        key = (f_size, int(fld.frame_number[0]), int(fld.line_number[0]),
               int(fld.source_crc.sum()), int(fld.words.sum()),
               int(fld.word_crc.sum()), int(fld.forced_bad.sum()))
        memo = getattr(self, "_fieldres_memo", None)
        if memo is None:
            memo = self._fieldres_memo = {}
        if key in memo:
            fld._fieldres = memo[key]
            return memo[key]
        test_size = f_size - stc007.MIN_DEINT_DATA
        counts = {}
        if use_native:
            # Both resolutions + the floored counter in one native call.
            crc_ok = fld.word_crc[:, :8] & ~fld.forced_bad[:, None]
            counts[14], counts[16] = _sn.field_res_counts(
                fld.words, crc_ok, test_size, self.mode_m2)
        else:
            for mode, key in ((di.RES_MODE_14BIT, 14),
                              (di.RES_MODE_16BIT, 16)):
                batch, _, aux = eval_blocks(
                    fld, mode, ignore_crc=False, force_ecc=True, en_p=True,
                    en_q=False, stop=test_size, m2=self.mode_m2,
                    full_aux=False,
                    backend="tpu" if self.seam_backend == "tpu" else None)
                good = aux["block_valid"] & aux["can_force"] \
                    & ~aux["silent"]
                broken = aux["broken"]
                # Count with BROKEN decrement floored at 0 (:1090-1140):
                # c_t = max(c_{t-1} + x_t, 0) vectorizes as the reflected
                # running sum cum_t - min(0, min_{s<=t} cum_s).
                x = good.astype(np.int64) \
                    - (~good & broken).astype(np.int64)
                cum = np.cumsum(x)
                if len(cum):
                    c = int(cum[-1]
                            - min(0, int(np.minimum.accumulate(cum)[-1])))
                else:
                    c = 0
                counts[key] = c
        if counts[14] > stc007.INTERLEAVE_OFS * 2:
            ratio = counts[16] * 128 // counts[14]
            res = SAMPLE_RES_16BIT if ratio > 32 else SAMPLE_RES_14BIT
        else:
            res = SAMPLE_RES_UNKNOWN
        fld._fieldres = res
        if len(memo) > 256:
            memo.clear()
        memo[key] = res
        return res

    @staticmethod
    def resolution_mode_for_seam(r1, r2):
        """getResolutionModeForSeam (:1214-1256)."""
        M14, M14A, M16A, M16 = (di.RES_MODE_14BIT, di.RES_MODE_14BIT_AUTO,
                                di.RES_MODE_16BIT_AUTO, di.RES_MODE_16BIT)
        if r1 == r2:
            if r1 == M14A:
                return M14
            if r1 == M16A:
                return M16
            return r1
        if r1 == M14 and r2 == M14A:
            return M14A
        if r1 == M14A and r2 == M14:
            return M14A
        if r1 == M16 and r2 == M14:
            return M14A
        return M16A

    @classmethod
    def resolution_for_seam(cls, r1, r2):
        mode = cls.resolution_mode_for_seam(r1, r2)
        if mode in (di.RES_MODE_16BIT, di.RES_MODE_16BIT_AUTO):
            return di.RES_16BIT
        return di.RES_14BIT

    def get_data_block_resolution(self, store: LineStore, line_sh=0):
        """getDataBlockResolution (:1272-1417): resolution mode from the
        field membership of the first and last line of the block."""
        if self.mode_m2:
            return di.RES_MODE_14BIT
        if len(store) <= line_sh + stc007.MIN_DEINT_DATA:
            return di.RES_MODE_14BIT_AUTO

        def res_of(row):
            fno = store.frame_number[row]
            is_even = (store.line_number[row] % 2) == 0
            for fr in (self.frasm_f2, self.frasm_f1, self.frasm_f0):
                if fno == fr.frame_number:
                    return fr.even_resolution if is_even \
                        else fr.odd_resolution
            return di.RES_MODE_14BIT

        first = res_of(line_sh)
        last = res_of(line_sh + stc007.LINE_OFFSETS[-1])
        return self.resolution_mode_for_seam(first, last)

    # -- padding (tryPadding :1417-1743) ----------------------------------
    class _SlimQueue:
        """Just the arrays a seam evaluation touches — building a full
        12-array LineStore per tryPadding dominates the steady-state
        frame cost otherwise."""
        __slots__ = ("words", "word_crc", "forced_bad", "frame_number",
                     "line_number", "coords_valid", "bw_set")

        def __len__(self):
            return len(self.words)

        def words_i32(self):
            # Built int32 directly from the fields' cached i32 arrays.
            return self.words

        def is_fixed_by_cwd(self):  # pragma: no cover - en_cwd path
            raise NotImplementedError("slim queue has no CWD state")

    def _slim_padding_queue(self, field1, field2, padding):
        """build_padding_queue without the full LineStore (same rows)."""
        keep = stc007.MIN_DEINT_DATA + stc007.INTERLEAVE_OFS // 2  # 120
        f1_size, f2_size = len(field1), len(field2)
        start1 = max(0, f1_size - (keep - padding))
        count2 = min(f2_size, keep)
        if f1_size:
            line_num = int(field1.line_number[f1_size - 1])
            frame_num = int(field1.frame_number[f1_size - 1])
        else:
            line_num, frame_num = 0, 0
        q = self._SlimQueue()
        sw32 = self._silent_words32()
        p = padding

        def cat(a1, pad, a2):
            return np.concatenate([a1[start1:f1_size], pad, a2[:count2]])

        # The fields are immutable across the roll, so their int32 word
        # cache (words_i32) is computed once per field and reused by
        # every seam eval that includes them.
        q.words = cat(field1.words_i32(), np.tile(sw32, (p, 1)),
                      field2.words_i32())
        q.word_crc = cat(field1.word_crc, np.zeros((p, 9), bool),
                         field2.word_crc)
        q.forced_bad = cat(field1.forced_bad, np.zeros(p, bool),
                           field2.forced_bad)
        q.frame_number = cat(field1.frame_number,
                             np.full(p, frame_num, np.int64),
                             field2.frame_number)
        q.line_number = cat(field1.line_number,
                            line_num + 2 * (np.arange(p) + 1),
                            field2.line_number)
        if self.ignore_crc:
            q.coords_valid = cat(field1.coords_valid, np.zeros(p, bool),
                                 field2.coords_valid)
            q.bw_set = cat(field1.bw_set, np.zeros(p, bool),
                           field2.bw_set)
        return q

    def build_padding_queue(self, field1: LineStore, field2: LineStore,
                            padding: int) -> LineStore:
        f1_size, f2_size = len(field1), len(field2)
        keep = stc007.MIN_DEINT_DATA + stc007.INTERLEAVE_OFS // 2  # 120
        start1 = max(0, f1_size - (keep - padding))
        part1 = field1.take(slice(start1, f1_size))
        if f1_size:
            line_num = int(field1.line_number[f1_size - 1])
            frame_num = int(field1.frame_number[f1_size - 1])
        else:
            line_num, frame_num = 0, 0
        pad_nums = line_num + 2 * (np.arange(padding) + 1)
        pad = LineStore.empty_lines(padding, frame_num, pad_nums,
                                    m2=self.mode_m2)
        count2 = min(f2_size, keep)
        part2 = field2.take(slice(0, count2))
        return LineStore.concat([part1, pad, part2])

    def _seam_flags(self, aux):
        """(valid_b, silent, unch, broken) per-block flags for burst stats
        (tryPadding :1623-1656)."""
        valid_b = aux["block_valid"] & ~aux["silent"] & aux["can_force"]
        if self.en_q:
            unch = ~aux["can_force"] | aux["fixed_q"]
        else:
            unch = aux["fixed_p"]
        return valid_b, aux["silent"], unch, aux["broken"]

    def _stats_verdict(self, stats, unchecked_lim):
        if stats.broken >= MAX_BURST_BROKEN:
            return DS_RET_BROKE
        if stats.silent > MAX_BURST_SILENCE:
            return DS_RET_SILENCE
        if stats.unchecked > unchecked_lim:
            return DS_RET_NO_PAD
        if stats.valid == 0:
            return DS_RET_NO_PAD
        return DS_RET_OK

    def _silent_words32(self):
        sw32 = getattr(self, "_sw32", None)
        if sw32 is None or self._sw32_m2 != self.mode_m2:
            sw32 = np.asarray(stc007.silent_words(m2=self.mode_m2, xp=np),
                              np.int32)
            self._sw32 = sw32
            self._sw32_m2 = self.mode_m2
        return sw32

    def _seam_res_mode(self, field1, field2, padding):
        """getDataBlockResolution for a seam queue [field1 tail | padding
        | field2 head] resolved symbolically (rows 0 and 112 only; no
        queue materialization).  Returns None when the queue is shorter
        than MIN_DEINT_DATA (DS_RET_NO_DATA)."""
        keep = stc007.MIN_DEINT_DATA + stc007.INTERLEAVE_OFS // 2  # 120
        f1_size, f2_size = len(field1), len(field2)
        start1 = max(0, f1_size - (keep - padding))
        count2 = min(f2_size, keep)
        len1 = f1_size - start1
        L = len1 + padding + count2
        if L < stc007.MIN_DEINT_DATA:
            return None
        if self.mode_m2:
            return di.RES_MODE_14BIT
        if L <= stc007.MIN_DEINT_DATA:
            return di.RES_MODE_14BIT_AUTO

        def res_of(r):
            if r < len1:
                i = start1 + r
                fno = int(field1.frame_number[i])
                ln = int(field1.line_number[i])
            elif r < len1 + padding:
                if f1_size:
                    fno = int(field1.frame_number[f1_size - 1])
                    ln = int(field1.line_number[f1_size - 1]) \
                        + 2 * (r - len1 + 1)
                else:
                    fno, ln = 0, 2 * (r - len1 + 1)
            else:
                i = r - len1 - padding
                fno = int(field2.frame_number[i])
                ln = int(field2.line_number[i])
            is_even = (ln % 2) == 0
            for fr in (self.frasm_f2, self.frasm_f1, self.frasm_f0):
                if fno == fr.frame_number:
                    return fr.even_resolution if is_even \
                        else fr.odd_resolution
            return di.RES_MODE_14BIT
        return self.resolution_mode_for_seam(
            res_of(0), res_of(stc007.LINE_OFFSETS[-1]))

    def _try_padding_native(self, field1, field2, padding):
        """try_padding in ONE native call (stc007_eval_seam): the seam
        queue is gathered from the fields' cached int32/crc8 buffers in
        C and only the burst stats come back — no per-call numpy
        concatenation (bit-identical to the queue path, tested)."""
        from ..ops import stitch_native as _sn
        keep = stc007.MIN_DEINT_DATA + stc007.INTERLEAVE_OFS // 2  # 120
        f1_size, f2_size = len(field1), len(field2)
        start1 = max(0, f1_size - (keep - padding))
        count2 = min(f2_size, keep)
        res_mode = self._seam_res_mode(field1, field2, padding)
        if res_mode is None:
            return DS_RET_NO_DATA, None
        unchecked_lim = self.max_unch_14 if self.en_q else self.max_unch_16
        st4 = _sn.eval_seam(
            field1.words_i32()[start1:], field1.crc_ok8()[start1:],
            padding, self._silent_words32(),
            field2.words_i32()[:count2], field2.crc_ok8()[:count2],
            res_mode, self.en_p, self.en_q, True, self.mode_m2,
            unchecked_lim, MAX_BURST_SILENCE, MAX_BURST_BROKEN)
        if st4 is None:
            return DS_RET_NO_DATA, None
        stats = StitchStats(index=padding, valid=int(st4[0]),
                            silent=int(st4[1]), unchecked=int(st4[2]),
                            broken=int(st4[3]))
        return self._stats_verdict(stats, unchecked_lim), stats

    def _device_padding_stats(self, field1, field2, max_padding,
                              only_pad=None):
        """Padding stats on the device (ops.device_stitch): ONE batched
        dispatch scores every padding's seam queue — per-pad semantics
        identical to try_padding (tests/test_device_stitch.py)."""
        from ..ops import device_stitch as _ds
        modes = np.full(max_padding, -1, np.int32)
        for p in (range(max_padding) if only_pad is None else (only_pad,)):
            m = self._seam_res_mode(field1, field2, p)
            if m is not None:
                modes[p] = m
        unch = self.max_unch_14 if self.en_q else self.max_unch_16
        stats, has = _ds.seam_sweep(
            field1.words_i32(), field1.crc_ok8(),
            field2.words_i32(), field2.crc_ok8(),
            self._silent_words32(), modes, self.en_p, self.en_q,
            self.mode_m2, unch)
        return [StitchStats(index=p, valid=int(stats[p, 0]),
                            silent=int(stats[p, 1]),
                            unchecked=int(stats[p, 2]),
                            broken=int(stats[p, 3]))
                if has[p] else None for p in range(max_padding)]

    def try_padding(self, field1, field2, padding, want_stats=False):
        """tryPadding: deinterleave the seam buffer, collect burst stats."""
        from ..ops import stitch_native as _sn
        if self.seam_backend == "tpu" and not self.ignore_crc:
            stats = self._device_padding_stats(field1, field2, padding + 1,
                                               only_pad=padding)[padding]
            if stats is None:
                return DS_RET_NO_DATA, None
            unchecked_lim = self.max_unch_14 if self.en_q \
                else self.max_unch_16
            return self._stats_verdict(stats, unchecked_lim), stats
        if _sn.available() and not self.ignore_crc:
            return self._try_padding_native(field1, field2, padding)
        queue = self._slim_padding_queue(field1, field2, padding)
        if len(queue) < stc007.MIN_DEINT_DATA:
            return DS_RET_NO_DATA, None
        res_mode = self.get_data_block_resolution(queue, 0)
        batch, _, aux = eval_blocks(
            queue, res_mode, ignore_crc=self.ignore_crc, force_ecc=True,
            en_p=self.en_p, en_q=self.en_q, en_cwd=False, m2=self.mode_m2,
            full_aux=False)
        if batch is None:
            return DS_RET_NO_DATA, None
        unchecked_lim = self.max_unch_14 if self.en_q else self.max_unch_16
        vmax, smax, umax, bcnt = self._burst_from_aux(aux, unchecked_lim)
        stats = StitchStats(index=padding, valid=vmax, silent=smax,
                            unchecked=umax, broken=bcnt)
        return self._stats_verdict(stats, unchecked_lim), stats

    def _burst_from_aux(self, aux, unchecked_lim, sl=slice(None)):
        if "flags" in aux:
            from ..ops import stitch_native as _sn
            return _sn.burst_stats(aux["flags"][sl], unchecked_lim,
                                   self.en_q, MAX_BURST_SILENCE,
                                   MAX_BURST_BROKEN)
        valid_b, silent, unch, broken = self._seam_flags(aux)
        return _burst_stats(valid_b[sl], silent[sl], unch[sl], broken[sl],
                            unchecked_lim)

    def batched_padding_stats(self, field1, field2, max_padding):
        """Score ALL paddings 0..max_padding-1 in grouped deinterleaver
        calls (VS the reference's serial per-pad tryPadding sweep).

        Every padding queue is the same master buffer [field1 tail |
        max_padding empties | field2 head] viewed through a different
        index map, so block assembly for the whole sweep is one gather.
        Returns a list of StitchStats (None where the queue is too short),
        bit-identical to calling try_padding(pad) per pad.
        """
        from ..ops import stitch_native as _sn
        if self.seam_backend == "tpu" and not self.ignore_crc:
            return self._device_padding_stats(field1, field2, max_padding)
        if _sn.available() and not self.ignore_crc:
            # Per-padding eval_seam looped C-side (stc007_padding_sweep)
            # — same per-pad semantics as try_padding, so the grouped
            # index-map construction below is only the no-native path.
            modes = np.full(max_padding, -1, np.int32)
            for p in range(max_padding):
                m = self._seam_res_mode(field1, field2, p)
                if m is not None:
                    modes[p] = m
            unch = self.max_unch_14 if self.en_q else self.max_unch_16
            stats, has = _sn.padding_sweep(
                field1.words_i32(), field1.crc_ok8(),
                field2.words_i32(), field2.crc_ok8(),
                self._silent_words32(), max_padding, modes,
                self.en_p, self.en_q, self.mode_m2, unch,
                MAX_BURST_SILENCE, MAX_BURST_BROKEN)
            return [StitchStats(index=p, valid=int(stats[p, 0]),
                                silent=int(stats[p, 1]),
                                unchecked=int(stats[p, 2]),
                                broken=int(stats[p, 3]))
                    if has[p] else None for p in range(max_padding)]
        keep = stc007.MIN_DEINT_DATA + stc007.INTERLEAVE_OFS // 2  # 120
        f1_size, f2_size = len(field1), len(field2)
        f1s = min(f1_size, keep)
        c2 = min(f2_size, keep)
        if f1_size:
            line_num = int(field1.line_number[f1_size - 1])
            frame_num = int(field1.frame_number[f1_size - 1])
        else:
            line_num, frame_num = 0, 0
        pad_nums = line_num + 2 * (np.arange(max_padding) + 1)
        master = LineStore.concat([
            field1.take(slice(f1_size - f1s, f1_size)),
            LineStore.empty_lines(max_padding, frame_num, pad_nums,
                                  m2=self.mode_m2),
            field2.take(slice(0, c2))])
        unchecked_lim = self.max_unch_14 if self.en_q else self.max_unch_16
        taps = np.arange(8) * stc007.INTERLEAVE_OFS

        def res_of(row):
            fno = master.frame_number[row]
            is_even = (master.line_number[row] % 2) == 0
            for fr in (self.frasm_f2, self.frasm_f1, self.frasm_f0):
                if fno == fr.frame_number:
                    return fr.even_resolution if is_even \
                        else fr.odd_resolution
            return di.RES_MODE_14BIT

        queues, modes = [], []
        for p in range(max_padding):
            len1 = min(f1_size, keep - p)
            q = np.concatenate([
                np.arange(f1s - len1, f1s),
                np.arange(f1s, f1s + p),
                np.arange(f1s + max_padding, f1s + max_padding + c2)])
            queues.append(q)
            if self.mode_m2 or len(q) <= stc007.MIN_DEINT_DATA:
                modes.append(di.RES_MODE_14BIT if self.mode_m2
                             else di.RES_MODE_14BIT_AUTO)
            else:
                modes.append(self.resolution_mode_for_seam(
                    res_of(q[0]), res_of(q[stc007.LINE_OFFSETS[-1]])))

        stats_out = [None] * max_padding
        for mode in sorted(set(modes)):
            group = [p for p in range(max_padding)
                     if modes[p] == mode
                     and len(queues[p]) >= stc007.MIN_DEINT_DATA
                     and len(queues[p]) - stc007.MIN_DEINT_DATA > 0]
            if not group:
                continue
            rows_list, counts = [], []
            for p in group:
                q = queues[p]
                b = len(q) - stc007.MIN_DEINT_DATA
                shifts = np.arange(b)
                rows_list.append(q[shifts[:, None] + taps[None, :]])
                counts.append(b)
            rows_all = np.concatenate(rows_list)
            _, _, aux = eval_rows(
                master, rows_all, mode, ignore_crc=self.ignore_crc,
                force_ecc=True, en_p=self.en_p, en_q=self.en_q,
                en_cwd=False, m2=self.mode_m2, full_aux=False)
            ofs = 0
            for p, b in zip(group, counts):
                vmax, smax, umax, bcnt = self._burst_from_aux(
                    aux, unchecked_lim, slice(ofs, ofs + b))
                stats_out[p] = StitchStats(index=p, valid=vmax, silent=smax,
                                           unchecked=umax, broken=bcnt)
                ofs += b
        return stats_out

    def find_padding(self, field1, field2, in_std, in_resolution):
        """findPadding (:1743-2057). Returns (result, padding)."""
        f1_size = len(field1)
        if in_std == VID_PAL:
            fallback = 0 if f1_size > LINES_PF_PAL else LINES_PF_PAL - f1_size
        elif in_std == VID_NTSC:
            fallback = 0 if f1_size > LINES_PF_NTSC \
                else LINES_PF_NTSC - f1_size
        else:
            fallback = 0
        max_padding = MAX_PADDING_14BIT
        unchecked_lim = self.max_unch_14
        if in_resolution == di.RES_16BIT or not self.en_q:
            max_padding = MAX_PADDING_16BIT
            unchecked_lim = self.max_unch_16
        self.last_pad_counter = 0xFF
        if not (self.en_p or self.en_q):
            return DS_RET_NO_PAD, fallback

        # All paddings scored at once; the early-exit replay below keeps
        # the reference's exact stitch_data contents (pads after the break
        # keep their default zero stats, which matters for the sort).
        all_stats = self.batched_padding_stats(field1, field2, max_padding)
        stitch_data = [StitchStats(index=p) for p in range(max_padding)]
        min_broken = 0xFFFF
        no_brk_idx = 0
        for pad in range(max_padding):
            st = all_stats[pad]
            if st is not None:
                stitch_data[pad] = st
            if min_broken > stitch_data[pad].broken:
                min_broken = stitch_data[pad].broken
                if min_broken == 0:
                    no_brk_idx = pad
            elif min_broken == 0:
                sd = stitch_data[no_brk_idx]
                if (sd.valid > 0 and sd.unchecked < unchecked_lim
                        and stitch_data[pad].broken > 0):
                    break
        order = sorted(stitch_data, key=StitchStats.sort_key)
        self.last_pad_counter = order[0].broken
        if order[0].silent < MAX_BURST_SILENCE:
            if order[0].unchecked < unchecked_lim:
                if order[0].broken < 2 and order[0].broken < order[1].broken:
                    return DS_RET_OK, order[0].index
                if (order[0].valid - order[1].valid) > MAX_BURST_UNCH_DELTA \
                        and order[0].broken == 0:
                    return DS_RET_OK, order[0].index
                return DS_RET_NO_PAD, fallback
            return DS_RET_NO_PAD, fallback
        return DS_RET_SILENCE, fallback

    # -- stats helpers (:2057-2207) ---------------------------------------
    def update_field_order_stats(self, order):
        self.stats_field_order.append(order)
        self.stats_field_order = self.stats_field_order[-STATS_DEPTH:]

    def get_probable_field_order(self):
        tff = self.stats_field_order.count(ORDER_TFF)
        bff = self.stats_field_order.count(ORDER_BFF)
        if tff or bff:
            return ORDER_BFF if tff < bff else ORDER_TFF
        return ORDER_UNK

    def update_resolution_stats(self, res):
        self.stats_resolution.append(res)
        self.stats_resolution = self.stats_resolution[-STATS_DEPTH:]

    def get_probable_resolution(self):
        c14 = self.stats_resolution.count(SAMPLE_RES_14BIT)
        c16 = self.stats_resolution.count(SAMPLE_RES_16BIT)
        if c14 or c16:
            return SAMPLE_RES_16BIT if c14 < c16 else SAMPLE_RES_14BIT
        return SAMPLE_RES_UNKNOWN

    # -- detection (detectAudioResolution :2207-2773) ---------------------
    def detect_audio_resolution(self):
        fa, fb = self.frasm_f1, self.frasm_f2
        M14, M14A = di.RES_MODE_14BIT, di.RES_MODE_14BIT_AUTO
        M16, M16A = di.RES_MODE_16BIT, di.RES_MODE_16BIT_AUTO
        if self.mode_m2:
            fa.odd_resolution = fa.even_resolution = M14
            fb.odd_resolution = fb.even_resolution = M14
            return
        res = {k: self.get_field_resolution(self.fields[k])
               for k in (("f1", "odd"), ("f1", "even"),
                         ("f2", "odd"), ("f2", "even"))}
        f1o, f1e = res[("f1", "odd")], res[("f1", "even")]
        f2o, f2e = res[("f2", "odd")], res[("f2", "even")]
        for r in (f1o, f1e):
            if r in (SAMPLE_RES_14BIT, SAMPLE_RES_16BIT):
                self.update_resolution_stats(r)

        def strict(r):
            return M16 if r == SAMPLE_RES_16BIT else M14

        def auto(r):
            return M16A if r == SAMPLE_RES_16BIT else M14A

        if f1o == SAMPLE_RES_UNKNOWN and f1e == SAMPLE_RES_UNKNOWN:
            if f2o == SAMPLE_RES_UNKNOWN and f2e == SAMPLE_RES_UNKNOWN:
                by_stats = self.get_probable_resolution()
                mode = M16A if by_stats == SAMPLE_RES_16BIT else M14A
                fa.odd_resolution = fa.even_resolution = mode
                fb.odd_resolution = fb.even_resolution = mode
            elif f2o == SAMPLE_RES_UNKNOWN:
                fb.even_resolution = strict(f2e)
                rest = auto(f2e)
                fa.odd_resolution = fa.even_resolution = rest
                fb.odd_resolution = rest
            elif f2e == SAMPLE_RES_UNKNOWN:
                fb.odd_resolution = strict(f2o)
                rest = auto(f2o)
                fa.odd_resolution = fa.even_resolution = rest
                fb.even_resolution = rest
            else:
                if f2o == f2e and f2o == SAMPLE_RES_16BIT:
                    fb.odd_resolution = fb.even_resolution = M16
                    fa.odd_resolution = fa.even_resolution = M16A
                else:
                    fb.odd_resolution = strict(f2o)
                    fb.even_resolution = strict(f2e)
                    fa.odd_resolution = fa.even_resolution = M14A
        else:
            if f1o == SAMPLE_RES_UNKNOWN:
                fa.even_resolution = strict(f1e)
                fa.odd_resolution = auto(f1e)
            elif f1e == SAMPLE_RES_UNKNOWN:
                fa.odd_resolution = strict(f1o)
                fa.even_resolution = auto(f1o)
            else:
                fa.odd_resolution = strict(f1o)
                fa.even_resolution = strict(f1e)
            if f2o == SAMPLE_RES_UNKNOWN and f2e == SAMPLE_RES_UNKNOWN:
                by_stats = self.get_probable_resolution()
                mode = M16A if by_stats == SAMPLE_RES_16BIT else M14A
                fb.odd_resolution = fb.even_resolution = mode
            elif f2o == SAMPLE_RES_UNKNOWN:
                fb.even_resolution = strict(f2e)
                fb.odd_resolution = auto(f2e)
            elif f2e == SAMPLE_RES_UNKNOWN:
                fb.odd_resolution = strict(f2o)
                fb.even_resolution = auto(f2o)
            else:
                fb.odd_resolution = strict(f2o)
                fb.even_resolution = strict(f2e)

    # -- video standard (detectVideoStandard :2773-2929) ------------------
    def detect_video_standard(self):
        fa, fb = self.frasm_f1, self.frasm_f2
        fa.video_standard = VID_UNKNOWN
        fa.odd_std_lines = fa.even_std_lines = 0
        if self.preset_video == VID_UNKNOWN:
            fa.vid_std_preset = False
            counts = (fa.odd_data_lines, fa.even_data_lines,
                      fb.odd_data_lines, fb.even_data_lines)
            if max(counts) > LINES_PF_MAX_PAL:
                fa.video_standard = VID_UNKNOWN
            elif max(counts) > LINES_PF_MAX_NTSC:
                fa.video_standard = VID_PAL
            else:
                if self.f1_max_line <= (LINES_PF_PAL
                                        - stc007.INTERLEAVE_OFS) * 2:
                    fa.video_standard = VID_NTSC
                else:
                    fa.video_standard = VID_PAL
        else:
            fa.vid_std_preset = True
            fa.video_standard = self.preset_video
        if fa.video_standard == VID_UNKNOWN:
            fa.video_standard = self.frasm_f0.video_standard
        if fa.video_standard == VID_NTSC:
            fa.odd_std_lines = fa.even_std_lines = LINES_PF_NTSC
        elif fa.video_standard == VID_PAL:
            fa.odd_std_lines = fa.even_std_lines = LINES_PF_PAL
        if self.preset_order == ORDER_TFF:
            fa.preset_tff()
            fb.preset_tff()
        elif self.preset_order == ORDER_BFF:
            fa.preset_bff()
            fb.preset_bff()
        else:
            fb.order_preset = False
            fb.set_order_unknown()

    # -- stitch stage machine (findFieldStitching :2929-4278) -------------
    # -- steady-state fast path -------------------------------------------
    def _try_steady_pair(self):
        """One native call for the whole computational load of a
        TRY_PREVIOUS -> TRY_xFF -> PAD_OK frame (the steady state of
        findFieldStitching stc007datastitcher.cpp:2929 + fillFrameForOutput
        :4588 + performDeinterleave :6675): fresh-field resolution counts,
        both seam evals, conv assembly and the fused deinterleave run in
        stc007_steady_tail; every frasm/stats transition stays HERE and
        replays the stage machine's exact effects.  Returns False (and
        mutates nothing but pure caches) whenever any precondition or
        either seam verdict fails — the full stage machine then runs
        unchanged.  Bit-identity vs the slow path is pinned by
        tests/test_steady_pair.py."""
        from ..ops import stitch_native as _sn
        fa, fb, f0 = self.frasm_f1, self.frasm_f2, self.frasm_f0
        if not self._steady_globals_ok(allow_cwd=True):
            return False
        if self.en_cwd and bool(self.conv_queue.is_fixed_by_cwd().any()):
            return False  # carried CWD fixes: the eval would diverge
        # TRY_PREVIOUS entry conditions.
        if not (f0.odd_data_lines == fa.odd_data_lines
                and f0.even_data_lines == fa.even_data_lines
                and f0.inner_padding_ok and f0.outer_padding_ok):
            return False
        if fa.order_preset and f0.field_order != fa.field_order:
            return False
        if not (f0.is_order_tff() or f0.is_order_bff()):
            return False
        if (fa.odd_data_lines < MIN_FILL_LINES_PF
                and fa.even_data_lines < MIN_FILL_LINES_PF):
            return False
        tff = f0.is_order_tff()
        # TRY_TFF_TO_TFF / TRY_BFF_TO_BFF data gate on frame B.
        if tff and fb.odd_data_lines < MIN_FILL_LINES_PF:
            return False
        if not tff and fb.even_data_lines < MIN_FILL_LINES_PF:
            return False
        if (fa.frame_number == fb.frame_number
                or fa.frame_number == f0.frame_number):
            return False
        f1o = self.fields[("f1", "odd")]
        f1e = self.fields[("f1", "even")]
        f2o = self.fields[("f2", "odd")]
        f2e = self.fields[("f2", "even")]
        fixed = self._fixed_res_mode()
        m2 = self.mode_m2
        if fixed is not None:
            # M2 / a resolution preset fixes every mode.
            fa_odd_mode = fa_even_mode = fixed
        else:
            r1o = getattr(f1o, "_fieldres", None)
            r1e = getattr(f1e, "_fieldres", None)
            if (r1o not in (SAMPLE_RES_14BIT, SAMPLE_RES_16BIT)
                    or r1e not in (SAMPLE_RES_14BIT, SAMPLE_RES_16BIT)):
                return False
            # detectAudioResolution will set frame A strict modes from
            # the known field resolutions; precompute for the seams.
            fa_odd_mode = di.RES_MODE_16BIT if r1o == SAMPLE_RES_16BIT \
                else di.RES_MODE_14BIT
            fa_even_mode = di.RES_MODE_16BIT if r1e == SAMPLE_RES_16BIT \
                else di.RES_MODE_14BIT
        self.detect_video_standard()  # scalar + idempotent
        field1 = f1o if tff else f1e
        field2 = f1e if tff else f1o
        f2f = f2o if tff else f2e
        if fa.video_standard == VID_PAL:
            target = LINES_PF_PAL
        elif fa.video_standard == VID_NTSC:
            target = LINES_PF_NTSC
        else:
            target = LINES_PF_DEFAULT
        c1 = min(len(field1), target)
        c2 = min(len(field2), target)
        padI, padO = f0.inner_padding, f0.outer_padding
        if c1 == 0 or c2 == 0 or padI < 0 or padO < 0:
            return False
        if c1 + c2 + padI + padO != target * 2:
            return False  # fillFrameForOutput would deviate from A&B&C
        conv = self.conv_queue
        n0 = len(conv)
        n_blocks = n0 + target * 2 - stc007.MIN_DEINT_DATA
        if n_blocks <= 0:
            return False

        def mode_of(odd_parity):
            return fa_odd_mode if odd_parity else fa_even_mode

        keep = stc007.MIN_DEINT_DATA + stc007.INTERLEAVE_OFS // 2  # 120
        last = stc007.LINE_OFFSETS[-1]  # 112
        inner_mode = fixed if fixed is not None else di.RES_MODE_14BIT
        outer_first = inner_mode
        outer_full = fixed if fixed is not None else -1
        outer_last_even = False
        if fixed is None:
            # Inner seam resolution mode: every row is frame A.
            s1 = max(0, len(field1) - (keep - padI))
            len1 = len(field1) - s1
            p0 = int(field1.line_number[s1]) % 2 == 1
            if last < len1:
                pl = int(field1.line_number[s1 + last]) % 2 == 1
            elif last < len1 + padI:
                pl = int(field1.line_number[len(field1) - 1]) % 2 == 1
            else:
                i2 = last - len1 - padI
                if i2 >= len(field2):
                    return False
                pl = int(field2.line_number[i2]) % 2 == 1
            inner_mode = self.resolution_mode_for_seam(mode_of(p0),
                                                       mode_of(pl))
            # Outer seam: the first block row is frame A; the last may
            # land in frame B, whose resolution only the native call
            # knows.
            s1o = max(0, len(field2) - (keep - padO))
            len1o = len(field2) - s1o
            p0o = int(field2.line_number[s1o]) % 2 == 1
            outer_first = mode_of(p0o)
            if last < len1o:
                plo = int(field2.line_number[s1o + last]) % 2 == 1
                outer_full = self.resolution_mode_for_seam(outer_first,
                                                           mode_of(plo))
            elif last < len1o + padO:
                plo = int(field2.line_number[len(field2) - 1]) % 2 == 1
                outer_full = self.resolution_mode_for_seam(outer_first,
                                                           mode_of(plo))
            else:
                i2 = last - len1o - padO
                if i2 >= len(f2f):
                    return False
                outer_last_even = int(f2f.line_number[i2]) % 2 == 0

        # getDataBlockResolution(conv, 0) over the assembled queue,
        # resolved symbolically (no conv materialization).
        def conv_row(r):
            if r < n0:
                return int(conv.frame_number[r]), int(conv.line_number[r])
            r -= n0
            if r < c1:
                return fa.frame_number, int(field1.line_number[r])
            r -= c1
            if r < padI:
                return (fa.frame_number,
                        int(field1.line_number[c1 - 1]) + 2 * (r + 1))
            r -= padI
            if r < c2:
                return fa.frame_number, int(field2.line_number[r])
            r -= c2
            return (fa.frame_number,
                    int(field2.line_number[c2 - 1]) + 2 * (r + 1))

        def scalar_res_of(r):
            fno, ln = conv_row(r)
            odd_p = ln % 2 == 1
            if fno == fb.frame_number:
                return None  # depends on the fresh counts
            if fno == fa.frame_number:
                return mode_of(odd_p)
            if fno == f0.frame_number:
                return f0.odd_resolution if odd_p else f0.even_resolution
            return di.RES_MODE_14BIT

        if fixed is not None:
            conv_mode = fixed
        else:
            rm0, rml = scalar_res_of(0), scalar_res_of(last)
            if rm0 is None or rml is None:
                return False
            conv_mode = self.resolution_mode_for_seam(rm0, rml)
        unch_lim = self.max_unch_14 if self.en_q else self.max_unch_16
        fb_unk_mode = di.RES_MODE_16BIT_AUTO \
            if self.get_probable_resolution() == SAMPLE_RES_16BIT \
            else di.RES_MODE_14BIT_AUTO

        on_tpu = self.seam_backend in ("tpu", "tpu-spec")
        entry = self._match_spec_entry(c1, c2, padI, padO, tff,
                                       target, n0, field1, field2,
                                       f2f, f2o, f2e) if on_tpu else None
        if entry is not None and entry["pred_mode"] != conv_mode:
            # The device pre-selected conv samples for a different
            # resolution mode: the speculation is unusable.
            entry = None
        if entry is not None:
            rc, res_counts, _, samples, wvalid, wfixed, bvalid, \
                counters = self._replay_spec_tail(
                    entry, inner_mode, outer_first, outer_full,
                    outer_last_even, fb_unk_mode, unch_lim,
                    conv_mode)
            if rc == -9:
                # A seam mode disagreed with the device's prediction:
                # fall through to a full recompute.
                entry = None
        if entry is not None:
            path = "spec_tail"  # spec replay produced the tail
        elif self.seam_backend == "tpu":
            path = "device_tail"
            rc, res_counts, _, samples, wvalid, wfixed, bvalid, \
                counters = self._steady_tail_tpu(
                    conv, field1, c1, field2, c2, f2f, f2o, f2e,
                    padI, padO, inner_mode, outer_first, outer_full,
                    outer_last_even, fb_unk_mode, unch_lim,
                    conv_mode, n_blocks)
        else:
            # "tpu-spec" spec miss: the transition pair runs the native
            # tail (bit-identical; the device keeps the steady stream).
            path = "native_tail"
            rc, res_counts, _, samples, wvalid, wfixed, bvalid, \
                counters = _sn.steady_tail(
                    conv.words_i32(), conv.crc_ok8(),
                    field1.words_i32(), field1.crc_ok8(), c1,
                    field2.words_i32(), field2.crc_ok8(), c2,
                    f2f.words_i32(), f2f.crc_ok8(),
                    f2o.words_i32(), f2o.crc_ok8(),
                    f2e.words_i32(), f2e.crc_ok8(),
                    self._silent_words32(), padI, padO,
                    inner_mode, outer_first, outer_full, outer_last_even,
                    fb_unk_mode, self.en_p, self.en_q, self.mode_m2,
                    unch_lim, MAX_BURST_SILENCE, MAX_BURST_BROKEN,
                    conv_mode, self.broken_mask_dur, self.broken_countdown,
                    n_blocks)

        if fixed is None:
            # The fresh resolution counts are valid on every return
            # path: cache them so a fallback never re-evaluates.
            f2o._fieldres = _res_of_counts(int(res_counts[0]),
                                           int(res_counts[1]))
            f2e._fieldres = _res_of_counts(int(res_counts[2]),
                                           int(res_counts[3]))
            self._steady_res = (fb.frame_number, f2o._fieldres,
                                f2e._fieldres)
        if rc < 0:
            return False  # a seam verdict failed: full machine decides
        if self.en_cwd and not self._cwd_prescan_is_noop(
                conv, field1, c1, field2, c2, padI, padO, f2f,
                conv_mode):
            return False  # CWD would write fixes: full machine does it

        # Steady frame confirmed: replay the stage machine's state
        # transitions exactly (detect_audio_resolution first, as in
        # find_field_stitching).
        self.detect_audio_resolution()
        fa.inner_silence = fa.outer_silence = True
        fb.inner_silence = fb.outer_silence = True
        fb.inner_padding_ok = fb.outer_padding_ok = False
        fb.inner_padding = fb.outer_padding = 0
        fa.update_vid_std_soft(f0.video_standard)
        fa.field_order = f0.field_order
        fa.inner_padding = f0.inner_padding
        fa.inner_padding_ok = True
        fa.inner_silence = False
        if fa.is_order_tff():
            fa.tff_cnt = self.last_pad_counter
        else:
            fa.bff_cnt = self.last_pad_counter
        fa.outer_padding = f0.outer_padding
        fa.outer_padding_ok = True
        if tff:
            fb.set_order_tff()
        else:
            fb.set_order_bff()
        fa.outer_silence = False
        # fillFrameForOutput bookkeeping (A & B & C, exact fit).
        self.get_assembly_field_order()
        fa.inner_padding = padI
        fa.outer_padding = padO
        # performDeinterleave tail (the _deint_fused bookkeeping).
        rate = self._block_sample_rate()
        fa.blocks_total += n_blocks
        fa.blocks_fix_p += int(counters[0])
        fa.blocks_fix_q += int(counters[1])
        fa.blocks_fix_cwd += int(counters[2])
        fa.blocks_drop += int(counters[3])
        fa.samples_drop += int(counters[4])
        fa.blocks_broken_field += int(counters[5])
        self.broken_countdown = rc
        emphasis = fa.ctrl_emphasis if fa.ctrl_seen \
            else (f0.ctrl_emphasis if f0.ctrl_seen else False)
        self.out_chunks.append(SampleChunk(
            samples=samples.reshape(n_blocks * 3, 2),
            valid=wvalid.reshape(n_blocks * 3, 2),
            fixed=wfixed.reshape(n_blocks * 3, 2),
            block_ok=np.repeat(bvalid, 3),
            sample_rate=rate, emphasis=emphasis))
        # New conv carry: the last MIN_DEINT_DATA rows of the assembled
        # queue, materialized from the segment descriptors (pads get
        # fillFrameForOutput's exact line/frame numbering).
        segs = [(conv, None), (field1.view_slice(0, c1), None)]
        if padI:
            segs.append((self._pad_view(padI),
                         int(field1.line_number[c1 - 1]) + 2))
        segs.append((field2.view_slice(0, c2), None))
        if padO:
            segs.append((self._pad_view(padO),
                         int(field2.line_number[c2 - 1]) + 2))
        self.conv_queue = self._build_carry(segs, fa.frame_number)
        if self.seam_backend in ("tpu", "tpu-spec"):
            # Seed the speculative-round carry chain: the next pair's
            # device-assumed carry is this pair's plain segments.
            store1 = self.pending_frames[0][1]
            lpf_c = len(field1)
            plain = (getattr(store1, "_dev_gid", None) == fa.frame_number
                     and len(field2) == lpf_c
                     and self._plain_field_ok(field1, lpf_c, tff)
                     and self._plain_field_ok(field2, lpf_c, not tff))
            self._steady_chain = (
                fb.frame_number, lpf_c,
                (c1, c2, padI, padO, tff, target)) if plain else None
        self.pair_paths[path] += 1
        return True

    def _steady_globals_ok(self, allow_cwd=False):
        from ..ops import stitch_native as _sn
        if not (self.seam_backend == "tpu" or _sn.available()):
            return False
        if self.en_cwd:
            # en_cwd is admitted to the steady PAIR path (native tail
            # only): the pair defers unless the CWD pre-scan is a
            # provable no-op (_cwd_prescan_is_noop).  The round path and
            # the device replay keep the bail — their C-side carry roll
            # cannot see per-pair CWD candidates.
            if not (allow_cwd and _sn.available()
                    and self.seam_backend not in ("tpu", "tpu-spec")):
                return False
        return (not self.record_views
                and not self.ignore_crc
                and not self.file_start and not self.file_end)

    def _finalize_blocks_steady(self, flags, valid, lcrc, samples):
        """The performDeinterleave finalize tail for the steady state
        (seam gates and file flags all off): BROKEN countdown windows,
        markAsUnsafe reverts, stats counters.  Numpy twin of
        stc007_finalize_blocks under those gates; consumes the device
        eval outputs of the tpu steady tail.  Returns (samples, wvalid,
        wfixed, bvalid, counters, new_countdown)."""
        from ..ops import stitch_native as _sn
        n_blocks = len(flags)
        silent = (flags & _sn.FLAG_SILENT) != 0
        broken = (flags & _sn.FLAG_BROKEN) != 0
        fixed_p = (flags & _sn.FLAG_FIX_P) != 0
        fixed_q = (flags & _sn.FLAG_FIX_Q) != 0
        countdown = self.broken_countdown
        post_broken = np.zeros(n_blocks, bool)
        active = ~silent
        if countdown > 0 or (self.broken_mask_dur > 0
                             and bool((active & broken).any())):
            triggers = np.nonzero(active & broken)[0]
            t_i = 0
            pos = 0
            while pos < n_blocks:
                if countdown > 0:
                    end = min(n_blocks, pos + countdown)
                    post_broken[pos:end] = active[pos:end]
                    countdown -= end - pos
                    pos = end
                else:
                    while t_i < len(triggers) and triggers[t_i] < pos:
                        t_i += 1
                    if t_i >= len(triggers) or self.broken_mask_dur <= 0:
                        break
                    pos = int(triggers[t_i])
                    countdown = self.broken_mask_dur
        mask_blocks = post_broken
        out_valid = np.where(mask_blocks[:, None] & ~broken[:, None],
                             lcrc, valid)
        block_valid = out_valid[:, :6].all(axis=-1)
        counters = np.array([
            np.sum(block_valid & fixed_p & ~mask_blocks),
            np.sum(block_valid & fixed_q & ~mask_blocks),
            0,
            np.sum(~block_valid),
            np.sum(np.sum(~out_valid[:, :6], axis=-1)[~block_valid]),
            np.sum(~block_valid & broken)], np.int64)
        bvalid = block_valid & ~broken
        wvalid = out_valid[:, :6] & ~broken[:, None]
        wfixed = lcrc[:, :6] & bvalid[:, None]
        return samples, wvalid, wfixed, bvalid, counters, countdown

    @staticmethod
    def _res_counts_from_flags(flags, n):
        """getFieldResolution's floored-decrement block counter
        (:1090-1140) from packed device flags."""
        from ..ops import stitch_native as _sn
        if n <= 0:
            return 0
        flags = flags[:n]
        good = (((flags & _sn.FLAG_BLOCK_VALID) != 0)
                & ((flags & _sn.FLAG_CAN_FORCE) != 0)
                & ((flags & _sn.FLAG_SILENT) == 0))
        broken = (flags & _sn.FLAG_BROKEN) != 0
        x = good.astype(np.int64) - (~good & broken).astype(np.int64)
        cum = np.cumsum(x)
        return int(cum[-1] - min(0, int(np.minimum.accumulate(cum)[-1])))

    # -- speculative device-round results (pipeline/device_driver.py) -----
    def _plain_field_ok(self, fld, lpf, odd_parity):
        """A field view equals the device round's assumed plain split:
        full-length, line numbers spanning the whole parity range of a
        tag-free field-sequential frame store."""
        if len(fld) != lpf:
            return False
        first = 1 if odd_parity else 2
        return (int(fld.line_number[0]) == first
                and int(fld.line_number[-1]) == first + 2 * (lpf - 1))

    def _spec_round_meta(self, ctx):
        """Per-pending-pair offsets into the device round's packed
        buffers for stc007_spec_round (-1 rows = no speculation for
        that pair, the C call bails there) plus per-frame device-
        provenance flags.  Returns (None, None, None) when the first
        pending pair has no usable speculation (the C call would
        consume nothing).  Third value: the effective spec carry length
        for pair 0 (-1 = mid-round entry, carry validated through
        _steady_chain exactly as _match_spec_entry's pairs>0 rule)."""
        pairs = ctx["pairs"]
        n_pairs = len(self.pending_frames) - 1
        seam_meta = np.full((n_pairs, 11), -1, np.int64)
        dev_plain = np.zeros(len(self.pending_frames), np.uint8)
        for k, (fno, s) in enumerate(self.pending_frames):
            dev_plain[k] = getattr(s, "_dev_gid", None) == fno
        for i in range(n_pairs):
            key = (self.pending_frames[i][0],
                   self.pending_frames[i + 1][0])
            idx = pairs.get(key)
            if idx is None:
                continue
            m1 = ctx["meta1"][idx]
            oc, nc = m1["conv"]
            # (seam_stats row, inner_nb, seam_stats row, outer_nb,
            #  conv ofs, conv n, conv samples ofs, res/seam row idx)
            seam_meta[i] = (idx, m1["inner_nb"], idx, m1["outer_nb"],
                            oc, nc, oc, idx, 0, 0, 0)
        if seam_meta[0, 0] < 0:
            return None, None, None
        idx0 = pairs[(self.pending_frames[0][0],
                      self.pending_frames[1][0])]
        if idx0 == 0 and ctx["carry_n"] >= 0:
            eff_n0 = ctx["carry_n"]
        else:
            # Mid-round entry: the device assumed the chained MDD-row
            # carry; only valid when the previous pair completed the
            # steady path over plain device frames with this geometry.
            if getattr(self, "_steady_chain", None) != \
                    (self.pending_frames[0][0], ctx["lpf"], ctx["geom"]):
                return None, None, None
            eff_n0 = -1
        return seam_meta, dev_plain, eff_n0

    def _match_spec_entry(self, c1, c2, padI, padO, tff, target, n0,
                          field1, field2, f2f, f2o, f2e):
        """Return the speculative device-round entry for the current
        pair IF every geometry fact the device assumed holds; else
        None.  A matched entry's dual-eval results are bit-identical to
        what _steady_tail_tpu would compute (same math, same inputs)."""
        spec = getattr(self, "_steady_spec", None)
        if not spec:
            return None
        fa, fb = self.frasm_f1, self.frasm_f2
        key = (fa.frame_number, fb.frame_number)
        entry = spec.get(key)
        if entry is None:
            return None
        store1 = self.pending_frames[0][1]
        store2 = self.pending_frames[1][1]
        if (getattr(store1, "_dev_gid", None) != fa.frame_number
                or getattr(store2, "_dev_gid", None) != fb.frame_number):
            return None
        lpf = entry["lpf"]
        if entry["geom"] != (c1, c2, padI, padO, tff, target):
            return None
        if not (self._plain_field_ok(field1, lpf, tff)
                and self._plain_field_ok(field2, lpf, not tff)
                and self._plain_field_ok(f2o, lpf, True)
                and self._plain_field_ok(f2e, lpf, False)):
            return None
        if entry["pair_idx"] == 0 and entry["carry_n"] >= 0:
            conv = self.conv_queue
            if len(conv) != n0 or entry["carry_n"] != n0:
                return None
            if not (np.array_equal(conv.words_i32(),
                                   entry["carry_w"][:n0])
                    and np.array_equal(conv.crc_ok8(),
                                       entry["carry_ok"][:n0])):
                return None
        else:
            # Pairs past the first assume the steady 112-row carry the
            # device derived from the previous pair's own (plain)
            # segments: valid iff the previous pair completed the tpu
            # steady path over plain device frames with this geometry.
            if n0 != stc007.MIN_DEINT_DATA:
                return None
            if getattr(self, "_steady_chain", None) != \
                    (fa.frame_number, lpf, entry["geom"]):
                return None
        return entry

    def _replay_spec_tail(self, entry, inner_mode, outer_first,
                          outer_full, outer_last_even, fb_unk_mode,
                          unch_lim, conv_mode):
        """_steady_tail_tpu with every eval taken from the round
        dispatch's stored dual-resolution results (ops.device_stitch
        .steady_round_packed) — zero device traffic at replay."""
        from ..ops import device_stitch as _ds
        m2 = self.mode_m2
        res_counts = np.zeros(4, np.int64)
        if not m2:
            # [2 fields, 2 resolutions] counts, reduced on device
            # (steady_round_packed) with _res_counts_from_flags' math.
            res_counts[:] = np.asarray(entry["res_counts"],
                                       np.int64).ravel()
        seam_stats = np.zeros(8, np.int32)

        def seam(k, mode):
            # Burst counters were reduced ON DEVICE with pred_mode and
            # the dispatch's unch_lim; valid only when the replay's
            # actual mode agrees (else the whole entry is unusable).
            if mode != entry["pred_mode"]:
                return None, None
            st4 = np.asarray(entry["seam_stats"][k], np.int32)
            st = StitchStats(index=0, valid=int(st4[0]),
                             silent=int(st4[1]), unchecked=int(st4[2]),
                             broken=int(st4[3]))
            return st4, self._stats_verdict(st, unch_lim)

        st4, verdict = seam(0, inner_mode)
        if st4 is None:
            return (-9, res_counts, seam_stats, None, None, None, None,
                    None)
        seam_stats[:4] = st4
        if verdict != DS_RET_OK:
            return (-2, res_counts, seam_stats, None, None, None, None,
                    None)
        outer_mode = self._outer_mode_from_counts(
            outer_full, outer_first, outer_last_even, fb_unk_mode,
            res_counts)
        st4, verdict = seam(1, outer_mode)
        if st4 is None:
            return (-9, res_counts, seam_stats, None, None, None, None,
                    None)
        seam_stats[4:] = st4
        if verdict != DS_RET_OK:
            return (-3, res_counts, seam_stats, None, None, None, None,
                    None)
        # Pack and samples were both pre-selected on device with
        # pred_mode == conv_mode (verified by the caller), so they
        # correspond per block.
        flags, valid, lcrc = _ds.unpack_eval_host(
            np.asarray(entry["conv"]))
        samples = np.asarray(entry["conv_samples"])
        samples, wvalid, wfixed, bvalid, counters, countdown = \
            self._finalize_blocks_steady(flags, valid, lcrc, samples)
        return (countdown, res_counts, seam_stats, samples, wvalid,
                wfixed, bvalid, counters)

    def _outer_mode_from_counts(self, outer_full, outer_first,
                                outer_last_even, fb_unk_mode, res_counts):
        """Outer seam mode (detectAudioResolution's known-frame-A branch
        when the seam's last block row lands in frame B)."""
        if outer_full >= 0:
            return outer_full
        ra = _res_of_counts(int(res_counts[0]), int(res_counts[1]))
        rb = _res_of_counts(int(res_counts[2]), int(res_counts[3]))
        M14, M14A = di.RES_MODE_14BIT, di.RES_MODE_14BIT_AUTO
        M16, M16A = di.RES_MODE_16BIT, di.RES_MODE_16BIT_AUTO
        UNK = SAMPLE_RES_UNKNOWN
        if ra == UNK and rb == UNK:
            fb_odd = fb_even = fb_unk_mode
        elif ra == UNK:
            fb_even = M16 if rb == SAMPLE_RES_16BIT else M14
            fb_odd = M16A if rb == SAMPLE_RES_16BIT else M14A
        elif rb == UNK:
            fb_odd = M16 if ra == SAMPLE_RES_16BIT else M14
            fb_even = M16A if ra == SAMPLE_RES_16BIT else M14A
        else:
            fb_odd = M16 if ra == SAMPLE_RES_16BIT else M14
            fb_even = M16 if rb == SAMPLE_RES_16BIT else M14
        fb_side = fb_even if outer_last_even else fb_odd
        return self.resolution_mode_for_seam(outer_first, fb_side)

    def _seam_eval_tpu(self, a_w, a_c, pad_n, c_w, c_c, res_mode,
                       unch_lim):
        """eval_seam twin on the device: [a tail | silent pad | c head]
        queue, burst stats host-side.  Returns int32[4] stats or None
        when the queue is too short."""
        from ..ops import device_stitch as _ds
        L = a_w.shape[0] + pad_n + c_w.shape[0]
        B = L - stc007.MIN_DEINT_DATA
        if B <= 0:
            return None
        sil = self._silent_words32()
        qw = np.concatenate([a_w, np.tile(sil, (pad_n, 1)), c_w])
        qc = np.concatenate([a_c, np.zeros((pad_n, 8), bool), c_c])
        _, _, _, _, _, _, flags, _ = _ds.eval_rows_arrays(
            qw, qc, None, 0, B, res_mode, self.en_p, self.en_q, True,
            self.mode_m2)
        vmax, smax, umax, bcnt = self._burst_from_aux(
            dict(flags=flags), unch_lim)
        return np.array([vmax, smax, umax, bcnt], np.int32)

    def _steady_tail_tpu(self, conv, field1, c1, field2, c2, f2f, f2o,
                         f2e, padI, padO, inner_mode, outer_first,
                         outer_full, outer_last_even, fb_unk_mode,
                         unch_lim, conv_mode, n_blocks):
        """Device twin of stc007_steady_tail: fresh-field resolution
        counts + both TRY_PREVIOUS seam evals + the fused conv
        deinterleave, computed by ops.device_stitch evals with the
        burst/count/finalize tails host-side.  Output contract
        identical to stitch_native.steady_tail (pinned by
        tests/test_steady_pair.py with seam_backend='tpu')."""
        from ..ops import device_stitch as _ds
        keep = stc007.MIN_DEINT_DATA + stc007.INTERLEAVE_OFS // 2
        m2 = self.mode_m2
        res_counts = np.zeros(4, np.int64)
        for k, fld in ((0, f2o), (2, f2e)):
            Lf = len(fld)
            if m2 or Lf <= stc007.MIN_DEINT_DATA:
                continue
            ts = Lf - stc007.MIN_DEINT_DATA
            for j, mode in ((0, di.RES_MODE_14BIT), (1, di.RES_MODE_16BIT)):
                _, _, _, _, _, _, flags, _ = _ds.eval_rows_arrays(
                    fld.words_i32(), fld.crc_ok8(), None, 0, ts, mode,
                    True, False, True, m2)
                res_counts[k + j] = self._res_counts_from_flags(flags, ts)
        seam_stats = np.zeros(8, np.int32)
        # Inner seam.
        s1 = max(0, len(field1) - (keep - padI))
        cnt2 = min(len(field2), keep)
        st_i = self._seam_eval_tpu(
            field1.words_i32()[s1:], field1.crc_ok8()[s1:], padI,
            field2.words_i32()[:cnt2], field2.crc_ok8()[:cnt2],
            inner_mode, unch_lim)
        if st_i is None:
            return (-2, res_counts, seam_stats, None, None, None, None,
                    None)
        seam_stats[:4] = st_i
        stats = StitchStats(index=0, valid=int(st_i[0]), silent=int(st_i[1]),
                            unchecked=int(st_i[2]), broken=int(st_i[3]))
        if self._stats_verdict(stats, unch_lim) != DS_RET_OK:
            return (-2, res_counts, seam_stats, None, None, None, None,
                    None)
        outer_mode = self._outer_mode_from_counts(
            outer_full, outer_first, outer_last_even, fb_unk_mode,
            res_counts)
        s1o = max(0, len(field2) - (keep - padO))
        cnt2o = min(len(f2f), keep)
        st_o = self._seam_eval_tpu(
            field2.words_i32()[s1o:], field2.crc_ok8()[s1o:], padO,
            f2f.words_i32()[:cnt2o], f2f.crc_ok8()[:cnt2o],
            outer_mode, unch_lim)
        if st_o is None:
            return (-3, res_counts, seam_stats, None, None, None, None,
                    None)
        seam_stats[4:] = st_o
        stats = StitchStats(index=0, valid=int(st_o[0]), silent=int(st_o[1]),
                            unchecked=int(st_o[2]), broken=int(st_o[3]))
        if self._stats_verdict(stats, unch_lim) != DS_RET_OK:
            return (-3, res_counts, seam_stats, None, None, None, None,
                    None)
        # Conv assembly + fused deinterleave + finalize.
        sil = self._silent_words32()
        qw = np.concatenate([
            conv.words_i32(), field1.words_i32()[:c1],
            np.tile(sil, (padI, 1)), field2.words_i32()[:c2],
            np.tile(sil, (padO, 1))])
        qc = np.concatenate([
            conv.crc_ok8(), field1.crc_ok8()[:c1],
            np.zeros((padI, 8), bool), field2.crc_ok8()[:c2],
            np.zeros((padO, 8), bool)])
        B = qw.shape[0] - stc007.MIN_DEINT_DATA
        if B <= 0:
            return (-4, res_counts, seam_stats, None, None, None, None,
                    None)
        _, valid, lcrc, _, _, _, flags, samples = _ds.eval_rows_arrays(
            qw, qc, None, 0, B, conv_mode, self.en_p, self.en_q, True,
            m2)
        samples, wvalid, wfixed, bvalid, counters, countdown = \
            self._finalize_blocks_steady(flags, valid, lcrc, samples)
        return (countdown, res_counts, seam_stats, samples, wvalid,
                wfixed, bvalid, counters)

    def _fixed_res_mode(self):
        """The single resolution mode everything uses when M2 or a
        resolution preset is active (getFieldResolution's preset
        short-circuit / detectAudioResolution's M2 branch), else None."""
        if self.mode_m2:
            return di.RES_MODE_14BIT
        if self.preset_resolution == SAMPLE_RES_14BIT:
            return di.RES_MODE_14BIT
        if self.preset_resolution == SAMPLE_RES_16BIT:
            return di.RES_MODE_16BIT
        return None

    def _build_carry(self, segs, pad_frame):
        """Materialize the last MIN_DEINT_DATA rows of a conv segment
        list [(view, pad_base_ln_or_None), ...] — the next pair's carry —
        patching pad rows with fillFrameForOutput's line/frame
        numbering."""
        picked = []
        need = stc007.MIN_DEINT_DATA
        for view, pad_base in reversed(segs):
            n = len(view)
            if n == 0:
                continue
            k = min(n, need)
            picked.append((view, n - k, n, pad_base))
            need -= k
            if need == 0:
                break
        picked.reverse()
        views = []
        patches = []
        pos = 0
        for view, a, b, pad_base in picked:
            views.append(view.view_slice(a, b))
            if pad_base is not None:
                patches.append((pos, pad_base + 2 * np.arange(a, b)))
            pos += b - a
        carry = LineStore.concat(views)
        for p, nums in patches:
            carry.line_number[p:p + len(nums)] = nums
            carry.frame_number[p:p + len(nums)] = pad_frame
        return carry

    def _rolling_f1_res(self, fno):
        """Field resolutions of the pending head frame, if already
        known: from the steady roll, or from the previous pair's f2
        field objects (the same frame)."""
        sr = getattr(self, "_steady_res", None)
        if sr is not None and sr[0] == fno:
            return sr[1], sr[2]
        flds = getattr(self, "fields", None)
        if flds:
            f2o = flds.get(("f2", "odd"))
            f2e = flds.get(("f2", "even"))
            if (f2o is not None and f2e is not None and len(f2o)
                    and int(f2o.frame_number[0]) == fno):
                ro = getattr(f2o, "_fieldres", None)
                re_ = getattr(f2e, "_fieldres", None)
                if ro is not None and re_ is not None:
                    return ro, re_
        return None

    def _cache_scan_from_rec(self, rec, entry):
        """Install a steady-round trim record as the store's _svc_scan
        cache (the _scan_frame tuple format), so neither the replay nor
        a fallback re-scans the frame."""
        fno, store = entry
        cb = int(rec[_sn_mod().REC_CB])
        if cb == -2:
            return  # the round bailed before this frame's trim scan
        sn = _sn_mod()
        raw = rec[sn.REC_TRIM:sn.REC_TRIM + 14]
        fields = stc007.control_block_fields(store.words[cb]) \
            if cb >= 0 else None
        trim = {}
        for parity, base, good in (("even", 0, 12), ("odd", 4, 13)):
            skip_bad = int(raw[good]) > MIN_GOOD_LINES_PF
            o = base if skip_bad else base + 2
            trim[parity] = (int(raw[o]), int(raw[o + 1]))
        store._svc_scan = (fno, bool(rec[sn.REC_NEW]),
                           bool(rec[sn.REC_END]), fields, trim)

    def _try_steady_run(self):
        """Process as many consecutive steady pairs as possible in ONE
        stc007_steady_round call (per pair: frame-B trim scan, field
        split, fresh-field resolution counts, both seam evals, conv
        assembly and the fused deinterleave run C-side with the frame-A
        facts and conv carry rolled in C).  The stage machine's state
        transitions are replayed here per pair from the returned
        records — identical effects to _try_steady_pair, which remains
        the single-pair form.  Returns False (nothing consumed) when
        the first pair is not steady.

        Under seam_backend='tpu-spec' the SAME round machinery runs as
        ONE stc007_spec_round call consuming the device dispatch's
        packed dual evals (the round context pipeline/device_driver
        installs) — the chip did the binarize/ECC/seam/deint math, C
        verifies the speculation and rolls the state, and the records
        are replayed identically either way."""
        spec_ctx = None
        if self.seam_backend == "tpu-spec":
            spec_ctx = getattr(self, "_steady_round_ctx", None)
            if spec_ctx is None or not _sn_mod().available():
                return False
        elif self.seam_backend == "tpu":
            return False  # per-pair device replay only
        # The native round carries the performCWD write-back fixpoint
        # in C (stc007_cwd_fixpoint), so en_cwd is admitted there; the
        # device spec round still bails on it (allow_cwd gating).
        if not self._steady_globals_ok(allow_cwd=spec_ctx is None):
            return False
        sn = _sn_mod()
        fa, f0 = self.frasm_f1, self.frasm_f0
        if not (f0.odd_data_lines == fa.odd_data_lines
                and f0.even_data_lines == fa.even_data_lines
                and f0.inner_padding_ok and f0.outer_padding_ok
                and (f0.is_order_tff() or f0.is_order_bff())):
            return False
        fno1, store1 = self.pending_frames[0]
        scan1 = getattr(store1, "_svc_scan", None)
        if scan1 is None or scan1[0] != fno1 or scan1[1] or scan1[2]:
            return False
        m2 = self.mode_m2
        fixed = self._fixed_res_mode()
        if fixed is not None:
            r1o = r1e = SAMPLE_RES_16BIT \
                if fixed == di.RES_MODE_16BIT else SAMPLE_RES_14BIT
        else:
            r1 = self._rolling_f1_res(fno1)
            if r1 is None:
                return False
            r1o, r1e = r1
            known = (SAMPLE_RES_14BIT, SAMPLE_RES_16BIT)
            if r1o not in known or r1e not in known:
                return False
        conv = self.conv_queue
        if len(conv) > stc007.MIN_DEINT_DATA:
            return False
        state = np.zeros(23, np.int64)
        state[0] = f0.odd_data_lines
        state[1] = f0.even_data_lines
        state[2] = f0.inner_padding
        state[3] = f0.outer_padding
        state[4] = f0.inner_padding_ok
        state[5] = f0.outer_padding_ok
        state[6] = f0.field_order
        state[7] = f0.video_standard
        state[8] = f0.frame_number
        state[9] = f0.odd_resolution
        state[10] = f0.even_resolution
        state[11] = fno1
        state[12] = fa.trim_ok
        state[13] = fa.even_top_data
        state[14] = fa.even_bottom_data
        state[15] = fa.odd_top_data
        state[16] = fa.odd_bottom_data
        state[17] = 16 if r1o == SAMPLE_RES_16BIT else 14
        state[18] = 16 if r1e == SAMPLE_RES_16BIT else 14
        state[19] = fa.field_order
        state[20] = 0  # fa file tags: checked via scan1 above
        state[21] = 0
        state[22] = self.broken_countdown
        unch_lim = self.max_unch_14 if self.en_q else self.max_unch_16
        order_preset = self.preset_order \
            if self.preset_order in (ORDER_TFF, ORDER_BFF) else 0
        if spec_ctx is not None:
            seam_meta, dev_plain, eff_n0 = self._spec_round_meta(spec_ctx)
            if seam_meta is None:
                return False
            # Chain-verified entry (eff_n0 < 0): C only memcmps the
            # carry under eff_n0 >= 0, so a lazy conv stays lazy — no
            # device readback just to fill an unread argument.
            if eff_n0 < 0 and not conv.words_materialized():
                carry_w32 = np.zeros((len(conv), 8), np.int32)
            else:
                carry_w32 = conv.words_i32()
            n_done, rec, samples, wvalid, wfixed, bvalid = sn.spec_round(
                self.pending_frames, carry_w32, conv.crc_ok8(),
                np.ascontiguousarray(conv.line_number, np.int64),
                np.ascontiguousarray(conv.frame_number, np.int64),
                self._silent_words32(), self.en_q, unch_lim,
                MAX_BURST_SILENCE, MAX_BURST_BROKEN,
                self.broken_mask_dur, self.auto_m2, m2,
                -1 if fixed is None else fixed,
                order_preset, self.preset_video, bool(order_preset),
                spec_ctx["packed1"], spec_ctx["samples_conv"],
                spec_ctx["res_counts"], spec_ctx["seam_stats"],
                seam_meta, dev_plain,
                spec_ctx["geom"], spec_ctx["lpf"],
                spec_ctx["pred_mode"],
                spec_ctx["carry_w"], spec_ctx["carry_ok"],
                eff_n0, state)
        else:
            n_done, rec, samples, wvalid, wfixed, bvalid, cwd_carry = \
                sn.steady_round(
                    self.pending_frames, conv.words_i32(), conv.crc_ok8(),
                    np.ascontiguousarray(conv.line_number, np.int64),
                    np.ascontiguousarray(conv.frame_number, np.int64),
                    self._silent_words32(), self.en_p, self.en_q,
                    unch_lim, MAX_BURST_SILENCE, MAX_BURST_BROKEN,
                    self.broken_mask_dur, self.auto_m2, m2,
                    -1 if fixed is None else fixed,
                    order_preset, self.preset_video,
                    bool(order_preset), state,
                    en_cwd=self.en_cwd, conv_store=conv)
        if n_done < len(rec):
            # cache the bail pair's frame-B trim scan for the fallback
            self._cache_scan_from_rec(rec[n_done],
                                      self.pending_frames[n_done + 1])
        if n_done <= 0:
            return False
        self.pair_paths["round" if spec_ctx is None
                        else "spec_round"] += n_done

        M14, M14A = di.RES_MODE_14BIT, di.RES_MODE_14BIT_AUTO
        M16, M16A = di.RES_MODE_16BIT, di.RES_MODE_16BIT_AUTO

        def strict(rr):
            return M16 if rr == SAMPLE_RES_16BIT else M14

        def auto(rr):
            return M16A if rr == SAMPLE_RES_16BIT else M14A

        r1o_cur, r1e_cur = r1o, r1e
        last = None
        chunk_run = None

        def flush_run():
            o, nb_, rate_, emp_ = chunk_run
            self.out_chunks.append(SampleChunk(
                samples=samples[o:o + nb_].reshape(nb_ * 3, 2),
                valid=wvalid[o:o + nb_].reshape(nb_ * 3, 2),
                fixed=wfixed[o:o + nb_].reshape(nb_ * 3, 2),
                block_ok=np.repeat(bvalid[o:o + nb_], 3),
                sample_rate=rate_, emphasis=emp_))

        for i in range(n_done):
            r = rec[i]
            fno1, store1 = self.pending_frames[0]
            fno2, store2 = self.pending_frames[1]
            fa, fb, f0 = self.frasm_f1, self.frasm_f2, self.frasm_f0
            fa.frame_number = fno1
            fb.frame_number = fno2
            # find_frames_trim replay (frame B; frame A facts carried
            # by the frasm roll).
            self._cache_scan_from_rec(r, self.pending_frames[1])
            _, _, _, cbf, trim = store2._svc_scan
            if cbf is not None:
                fb.ctrl_index = cbf["index"]
                fb.ctrl_hour = cbf["hour"]
                fb.ctrl_minute = cbf["minute"]
                fb.ctrl_second = cbf["second"]
                fb.ctrl_field = cbf["field"]
                fb.ctrl_emphasis = cbf["emphasis"]
                fb.ctrl_m2 = cbf["m2"]
                fb.ctrl_seen = True
            fb.even_top_data = fb.even_bottom_data = 0
            fb.odd_top_data = fb.odd_bottom_data = 0
            found = {}
            for parity in ("even", "odd"):
                first, last_r = trim[parity]
                found[parity] = first >= 0
                if first >= 0:
                    setattr(fb, f"{parity}_top_data",
                            int(store2.line_number[first]))
                    setattr(fb, f"{parity}_bottom_data",
                            int(store2.line_number[last_r]))
            fb.trim_ok = found["odd"] and found["even"]
            # split replay
            sp = r[sn.REC_SPLIT:sn.REC_SPLIT + 13]
            fb.even_data_lines = int(sp[3])
            fb.even_valid_lines = int(sp[6])
            fb.odd_data_lines = int(sp[9])
            fb.odd_valid_lines = int(sp[12])
            self.f1_max_line = getattr(self, "f2_max_line", 0)
            self.f2_max_line = int(sp[0])
            fa.odd_ref = int(r[sn.REC_OREF])
            fa.even_ref = int(r[sn.REC_EREF])
            # detect_video_standard replay
            vstd = int(r[sn.REC_VSTD])
            fa.vid_std_preset = self.preset_video != VID_UNKNOWN
            fa.video_standard = vstd
            if vstd == VID_NTSC:
                fa.odd_std_lines = fa.even_std_lines = LINES_PF_NTSC
            elif vstd == VID_PAL:
                fa.odd_std_lines = fa.even_std_lines = LINES_PF_PAL
            else:
                fa.odd_std_lines = fa.even_std_lines = 0
            if self.preset_order == ORDER_TFF:
                fa.preset_tff()
                fb.preset_tff()
            elif self.preset_order == ORDER_BFF:
                fa.preset_bff()
                fb.preset_bff()
            else:
                fb.order_preset = False
                fb.set_order_unknown()
            # detect_audio_resolution replay (frame-A-known branch;
            # M2 short-circuits with NO stats update, a resolution
            # preset flows through the known branch WITH stats updates)
            if m2:
                ra = rb_ = SAMPLE_RES_14BIT
                fa.odd_resolution = fa.even_resolution = M14
                fb.odd_resolution = fb.even_resolution = M14
            elif fixed is not None:
                ra = rb_ = r1o
                self.update_resolution_stats(r1o)
                self.update_resolution_stats(r1o)
                fa.odd_resolution = fa.even_resolution = fixed
                fb.odd_resolution = fb.even_resolution = fixed
            else:
                self.update_resolution_stats(r1o_cur)
                self.update_resolution_stats(r1e_cur)
                fa.odd_resolution = strict(r1o_cur)
                fa.even_resolution = strict(r1e_cur)
                ra = _res_of_counts(int(r[sn.REC_RES]),
                                    int(r[sn.REC_RES + 1]))
                rb_ = _res_of_counts(int(r[sn.REC_RES + 2]),
                                     int(r[sn.REC_RES + 3]))
                UNK = SAMPLE_RES_UNKNOWN
                if ra == UNK and rb_ == UNK:
                    by = self.get_probable_resolution()
                    mode = M16A if by == SAMPLE_RES_16BIT else M14A
                    fb.odd_resolution = fb.even_resolution = mode
                elif ra == UNK:
                    fb.even_resolution = strict(rb_)
                    fb.odd_resolution = auto(rb_)
                elif rb_ == UNK:
                    fb.odd_resolution = strict(ra)
                    fb.even_resolution = auto(ra)
                else:
                    fb.odd_resolution = strict(ra)
                    fb.even_resolution = strict(rb_)
            # stage machine TRY_PREVIOUS -> PAD_OK transitions
            tff = f0.is_order_tff()
            fa.inner_silence = fa.outer_silence = True
            fb.inner_silence = fb.outer_silence = True
            fb.inner_padding_ok = fb.outer_padding_ok = False
            fb.inner_padding = fb.outer_padding = 0
            fa.update_vid_std_soft(f0.video_standard)
            fa.field_order = f0.field_order
            fa.inner_padding = f0.inner_padding
            fa.inner_padding_ok = True
            fa.inner_silence = False
            if fa.is_order_tff():
                fa.tff_cnt = self.last_pad_counter
            else:
                fa.bff_cnt = self.last_pad_counter
            fa.outer_padding = f0.outer_padding
            fa.outer_padding_ok = True
            if tff:
                fb.set_order_tff()
            else:
                fb.set_order_bff()
            fa.outer_silence = False
            self.get_assembly_field_order()
            # deint bookkeeping (the _deint_fused tail)
            rate = self._block_sample_rate()
            nb = int(r[sn.REC_NBLK])
            ofs = int(r[sn.REC_OFS])
            fa.blocks_total += nb
            fa.blocks_fix_p += int(r[sn.REC_CNT])
            fa.blocks_fix_q += int(r[sn.REC_CNT + 1])
            fa.blocks_fix_cwd += int(r[sn.REC_CNT + 2])
            fa.blocks_drop += int(r[sn.REC_CNT + 3])
            fa.samples_drop += int(r[sn.REC_CNT + 4])
            fa.blocks_broken_field += int(r[sn.REC_CNT + 5])
            self.broken_countdown = int(r[sn.REC_CD])
            emphasis = fa.ctrl_emphasis if fa.ctrl_seen \
                else (f0.ctrl_emphasis if f0.ctrl_seen else False)
            # Coalesce contiguous same-rate/emphasis pairs into ONE
            # SampleChunk (the outputs are offset-packed, so a run is a
            # single slice): a steady round otherwise allocates five
            # arrays per pair just to re-concatenate them in the audio
            # stage.
            if chunk_run is not None and chunk_run[2] == rate \
                    and chunk_run[3] == emphasis \
                    and chunk_run[0] + chunk_run[1] == ofs:
                chunk_run[1] += nb
            else:
                if chunk_run is not None:
                    flush_run()
                chunk_run = [ofs, nb, rate, emphasis]
            # the _pump roll
            self.frame_log.append(fa.snapshot())
            self.pending_frames.pop(0)
            self.frasm_f0 = fa
            self.frasm_f1 = fb
            self.frasm_f2 = FrameAsm()
            self._steady_res = (fno2, ra, rb_)
            r1o_cur, r1e_cur = ra, rb_
            last = (store1, tff, int(r[sn.REC_TARGET]))
        if chunk_run is not None:
            flush_run()

        if spec_ctx is None and self.en_cwd and cwd_carry is not None:
            # The C round's conv carry holds the CWD write-back state
            # (fixed words, freed word_valid flags, false-positive
            # forced marks) — the frame-store segments do NOT; rebuild
            # conv_queue from the exported carry verbatim.
            n_c = len(cwd_carry["ln"])
            cq = LineStore._blank()
            cq.words = cwd_carry["words"]
            cq.source_crc = cwd_carry["src"]
            cq.word_crc = cwd_carry["word_crc"]
            cq.word_valid = cwd_carry["word_valid"]
            cq.forced_bad = cwd_carry["forced"]
            cq.coords_valid = cwd_carry["coords"]
            cq.bw_set = cwd_carry["coords"].copy()
            cq.frame_number = cwd_carry["fn"]
            cq.line_number = cwd_carry["ln"]
            cq.ref_level = np.zeros(n_c, np.int64)
            cq.service = np.zeros(n_c, np.int8)
            cq.has_markers = np.zeros(n_c, bool)
            self.conv_queue = cq
            return True
        # Rebuild the conv carry from the LAST processed pair's frame-A
        # segments (the tail never reaches further back: 2*target rows
        # always exceed MIN_DEINT_DATA).
        store1_last, tff_last, target_last = last
        f0 = self.frasm_f0
        key = (f0.frame_number, f0.even_top_data, f0.even_bottom_data,
               f0.odd_top_data, f0.odd_bottom_data)
        cache = getattr(store1_last, "_split_cache", None)
        if cache is None or cache["key"] != key:
            cache = self._split_one(f0, store1_last, key)
            store1_last._split_cache = cache
        field1 = cache["odd"] if tff_last else cache["even"]
        field2 = cache["even"] if tff_last else cache["odd"]
        c1 = min(len(field1), target_last)
        c2 = min(len(field2), target_last)
        padI, padO = f0.inner_padding, f0.outer_padding
        segs = [(field1.view_slice(0, c1), None)]
        if padI:
            segs.append((self._pad_view(padI),
                         int(field1.line_number[c1 - 1]) + 2))
        segs.append((field2.view_slice(0, c2), None))
        if padO:
            segs.append((self._pad_view(padO),
                         int(field2.line_number[c2 - 1]) + 2))
        self.conv_queue = self._build_carry(segs, f0.frame_number)
        if spec_ctx is not None:
            # The C round verified every processed store as plain device
            # output with this geometry — the next pair may chain.
            self._steady_chain = (self.frasm_f1.frame_number,
                                  spec_ctx["lpf"], spec_ctx["geom"])
        return True

    def find_field_stitching(self):
        fa, fb = self.frasm_f1, self.frasm_f2
        f0 = self.frasm_f0
        self.detect_audio_resolution()
        self.detect_video_standard()
        f1o = self.fields[("f1", "odd")]
        f1e = self.fields[("f1", "even")]
        f2o = self.fields[("f2", "odd")]
        f2e = self.fields[("f2", "even")]

        STG = ("TRY_PREVIOUS TRY_TFF_TO_TFF TRY_BFF_TO_BFF A_PREPARE "
               "A_PAD_TFF A_PAD_BFF AB_UNK_PREPARE AB_TFF_TO_TFF "
               "AB_TFF_TO_BFF AB_BFF_TO_BFF AB_BFF_TO_TFF "
               "PAD_NO_GOOD PAD_SILENCE PAD_OK").split()
        state = "TRY_PREVIOUS"
        en_sw_order = True
        guard = 0

        while True:
            guard += 1
            if guard > 16:
                return DS_RET_NO_PAD
            if state == "TRY_PREVIOUS":
                state = "A_PREPARE"
                if (f0.odd_data_lines == fa.odd_data_lines
                        and f0.even_data_lines == fa.even_data_lines
                        and f0.inner_padding_ok and f0.outer_padding_ok):
                    if (not fa.order_preset
                            or f0.field_order == fa.field_order):
                        fa.inner_silence = fa.outer_silence = True
                        fb.inner_silence = fb.outer_silence = True
                        fb.inner_padding_ok = fb.outer_padding_ok = False
                        fb.inner_padding = fb.outer_padding = 0
                        if (fa.odd_data_lines < MIN_FILL_LINES_PF
                                and fa.even_data_lines < MIN_FILL_LINES_PF):
                            fa.set_order_unknown()
                            fa.inner_padding_ok = False
                            fa.outer_padding_ok = False
                            fa.inner_padding = fa.outer_padding = 0
                            state = "PAD_NO_GOOD"
                        else:
                            if f0.is_order_tff():
                                r, _ = self.try_padding(
                                    f1o, f1e, f0.inner_padding)
                            elif f0.is_order_bff():
                                r, _ = self.try_padding(
                                    f1e, f1o, f0.inner_padding)
                            else:
                                r = DS_RET_NO_PAD
                            if r == DS_RET_OK:
                                fa.update_vid_std_soft(f0.video_standard)
                                fa.field_order = f0.field_order
                                fa.inner_padding = f0.inner_padding
                                fa.inner_padding_ok = True
                                fa.inner_silence = False
                                if fa.is_order_tff():
                                    fa.tff_cnt = self.last_pad_counter
                                    state = "TRY_TFF_TO_TFF"
                                else:
                                    fa.bff_cnt = self.last_pad_counter
                                    state = "TRY_BFF_TO_BFF"
            elif state == "TRY_TFF_TO_TFF":
                r = DS_RET_NO_PAD
                if fb.odd_data_lines >= MIN_FILL_LINES_PF:
                    r, _ = self.try_padding(f1e, f2o, f0.outer_padding)
                if r == DS_RET_OK:
                    fa.outer_padding = f0.outer_padding
                    fa.outer_padding_ok = True
                    fb.set_order_tff()
                    fa.outer_silence = False
                    state = "PAD_OK"
                else:
                    state = "AB_TFF_TO_TFF"
                    en_sw_order = False
            elif state == "TRY_BFF_TO_BFF":
                r = DS_RET_NO_PAD
                if fb.even_data_lines >= MIN_FILL_LINES_PF:
                    r, _ = self.try_padding(f1o, f2e, f0.outer_padding)
                if r == DS_RET_OK:
                    fa.outer_padding = f0.outer_padding
                    fa.outer_padding_ok = True
                    fb.set_order_bff()
                    fa.outer_silence = False
                    state = "PAD_OK"
                else:
                    state = "AB_BFF_TO_BFF"
                    en_sw_order = False
            elif state == "A_PREPARE":
                fa.inner_padding_ok = fa.outer_padding_ok = False
                fa.inner_padding = fa.outer_padding = 0
                fa.tff_cnt = fa.bff_cnt = 0
                if (fa.odd_data_lines < MIN_FILL_LINES_PF
                        and fa.even_data_lines < MIN_FILL_LINES_PF):
                    if not fa.order_preset:
                        fa.set_order_unknown()
                    state = "PAD_NO_GOOD"
                elif fa.even_data_lines < MIN_FILL_LINES_PF:
                    if fa.is_order_tff():
                        fa.outer_padding_ok = False
                        fa.outer_padding = 0
                        state = "PAD_NO_GOOD"
                    else:
                        state = "AB_BFF_TO_BFF"
                        en_sw_order = False
                elif fa.odd_data_lines < MIN_FILL_LINES_PF:
                    if fa.is_order_bff():
                        fa.outer_padding_ok = False
                        fa.outer_padding = 0
                        state = "PAD_NO_GOOD"
                    else:
                        state = "AB_TFF_TO_TFF"
                        en_sw_order = False
                else:
                    if fa.is_order_bff():
                        state = "A_PAD_BFF"
                        en_sw_order = False
                    elif fa.is_order_tff():
                        state = "A_PAD_TFF"
                        en_sw_order = False
                    else:
                        probable = self.get_probable_field_order()
                        state = "A_PAD_BFF" if probable == ORDER_BFF \
                            else "A_PAD_TFF"
                        en_sw_order = True
            elif state in ("A_PAD_TFF", "A_PAD_BFF"):
                tff = state == "A_PAD_TFF"
                fa.inner_padding = 0
                if tff:
                    res = self.resolution_for_seam(fa.odd_resolution,
                                                   fa.even_resolution)
                    r, pad = self.find_padding(f1o, f1e, fa.video_standard,
                                               res)
                    fa.tff_cnt = self.last_pad_counter
                else:
                    res = self.resolution_for_seam(fa.even_resolution,
                                                   fa.odd_resolution)
                    r, pad = self.find_padding(f1e, f1o, fa.video_standard,
                                               res)
                    fa.bff_cnt = self.last_pad_counter
                fa.inner_padding = pad
                fa.inner_silence = False
                if r == DS_RET_OK:
                    (fa.set_order_tff if tff else fa.set_order_bff)()
                    fa.inner_padding_ok = True
                    state = "AB_TFF_TO_TFF" if tff else "AB_BFF_TO_BFF"
                    en_sw_order = False
                elif r == DS_RET_SILENCE:
                    fa.inner_silence = fa.outer_silence = True
                    fa.inner_padding_ok = False
                    fa.inner_padding = 0
                    state = "PAD_SILENCE"
                else:
                    fa.inner_padding = 0
                    if (tff and fa.is_order_tff()) or \
                            (not tff and fa.is_order_bff()):
                        fa.inner_padding_ok = False
                        state = "AB_TFF_TO_TFF" if tff else "AB_BFF_TO_BFF"
                        en_sw_order = False
                    elif en_sw_order:
                        state = "A_PAD_BFF" if tff else "A_PAD_TFF"
                        en_sw_order = False
                    else:
                        state = "AB_UNK_PREPARE"
            elif state == "AB_UNK_PREPARE":
                fa.inner_padding = 0
                fa.inner_padding_ok = False
                fa.set_order_unknown()
                probable = self.get_probable_field_order()
                state = "AB_BFF_TO_BFF" if probable == ORDER_BFF \
                    else "AB_TFF_TO_TFF"
                en_sw_order = True
            elif state in ("AB_TFF_TO_TFF", "AB_BFF_TO_BFF"):
                tff = state == "AB_TFF_TO_TFF"
                first = f1e if tff else f1o
                second = f2o if tff else f2e
                second_lines = fb.odd_data_lines if tff \
                    else fb.even_data_lines
                other_lines = fb.even_data_lines if tff \
                    else fb.odd_data_lines
                if (fb.odd_data_lines < MIN_FILL_LINES_PF
                        and fb.even_data_lines < MIN_FILL_LINES_PF):
                    fa.outer_padding = 0
                    fa.outer_padding_ok = False
                    fb.inner_padding_ok = False
                    state = "PAD_NO_GOOD"
                elif second_lines < MIN_FILL_LINES_PF:
                    if not fa.order_preset:
                        state = "AB_TFF_TO_BFF" if tff else "AB_BFF_TO_TFF"
                    else:
                        fa.outer_padding = 0
                        fa.outer_padding_ok = False
                        fb.inner_padding_ok = False
                        state = "PAD_NO_GOOD"
                else:
                    if tff:
                        res = self.resolution_for_seam(fa.even_resolution,
                                                       fb.odd_resolution)
                    else:
                        res = self.resolution_for_seam(fa.odd_resolution,
                                                       fb.even_resolution)
                    r, pad = self.find_padding(first, second,
                                               fa.video_standard, res)
                    fa.outer_padding = pad
                    fa.outer_silence = False
                    if r == DS_RET_OK:
                        fa.outer_padding_ok = True
                        (fb.set_order_tff if tff else fb.set_order_bff)()
                        state = "PAD_OK"
                        if not fa.is_order_set():
                            (fa.set_order_tff if tff else fa.set_order_bff)()
                        elif (tff and fa.is_order_bff()) or \
                                (not tff and fa.is_order_tff()):
                            fa.outer_padding_ok = False
                            state = "PAD_NO_GOOD"
                    elif r == DS_RET_SILENCE:
                        fa.outer_silence = True
                        fa.outer_padding = 0
                        fa.outer_padding_ok = False
                        state = "PAD_SILENCE"
                    else:
                        if other_lines < MIN_FILL_LINES_PF:
                            fa.outer_padding = 0
                            fa.outer_padding_ok = False
                            fb.inner_padding_ok = False
                            state = "PAD_NO_GOOD"
                        elif not fa.order_preset:
                            state = "AB_TFF_TO_BFF" if tff \
                                else "AB_BFF_TO_TFF"
                        else:
                            fa.outer_padding = 0
                            fa.outer_padding_ok = False
                            state = "PAD_NO_GOOD"
            elif state in ("AB_TFF_TO_BFF", "AB_BFF_TO_TFF"):
                tff = state == "AB_TFF_TO_BFF"
                first = f1e if tff else f1o
                second = f2e if tff else f2o
                if tff:
                    res = self.resolution_for_seam(fa.even_resolution,
                                                   fb.even_resolution)
                else:
                    res = self.resolution_for_seam(fa.odd_resolution,
                                                   fb.odd_resolution)
                r, pad = self.find_padding(first, second, fa.video_standard,
                                           res)
                fa.outer_padding = pad
                fa.outer_silence = False
                if r == DS_RET_OK:
                    fa.outer_padding_ok = True
                    (fb.set_order_bff if tff else fb.set_order_tff)()
                    state = "PAD_OK"
                    if not fa.is_order_set():
                        (fa.set_order_tff if tff else fa.set_order_bff)()
                    elif (tff and fa.is_order_bff()) or \
                            (not tff and fa.is_order_tff()):
                        fa.outer_padding_ok = False
                        state = "PAD_NO_GOOD"
                elif r == DS_RET_SILENCE:
                    fa.outer_silence = True
                    fa.outer_padding = 0
                    fa.outer_padding_ok = False
                    fb.inner_padding_ok = False
                    state = "PAD_SILENCE"
                else:
                    fa.outer_padding = 0
                    fa.outer_padding_ok = False
                    fb.inner_padding_ok = False
                    if en_sw_order \
                            and fa.even_data_lines >= MIN_FILL_LINES_PF:
                        state = "AB_BFF_TO_BFF" if tff else "AB_TFF_TO_TFF"
                        en_sw_order = False
                    else:
                        state = "PAD_NO_GOOD"
            elif state == "PAD_OK":
                return DS_RET_OK
            elif state == "PAD_SILENCE":
                return DS_RET_SILENCE
            else:  # PAD_NO_GOOD
                return DS_RET_NO_PAD

    # -- frame assembly (fillFrameForOutput :4588-5390) -------------------
    def get_assembly_field_order(self):
        fa, fb, f0 = self.frasm_f1, self.frasm_f2, self.frasm_f0
        cur = ORDER_UNK
        if fa.is_order_set():
            cur = fa.field_order
            if not fa.order_preset:
                self.update_field_order_stats(cur)
        else:
            if fb.order_preset and fb.is_order_set():
                cur = fb.field_order
            elif f0.is_order_set() and f0.outer_padding_ok:
                cur = f0.field_order
        if cur not in (ORDER_TFF, ORDER_BFF):
            last_good = self.get_probable_field_order()
            if last_good in (ORDER_TFF, ORDER_BFF):
                cur = last_good
            elif fa.tff_cnt < fa.bff_cnt:
                cur = ORDER_TFF
            elif fa.tff_cnt > fa.bff_cnt:
                cur = ORDER_BFF
            else:
                cur = FLD_ORDER_DEFAULT
        if not fa.is_order_set():
            fa.field_order = cur
            fa.set_order_guessed(True)
        return cur

    def _first_line(self, order):
        return 1 if order == ORDER_TFF else 2

    def _second_line(self, order):
        return 2 if order == ORDER_TFF else 1

    def fill_frame_for_output(self, prefix=None) -> LineStore:
        fa, fb, f0 = self.frasm_f1, self.frasm_f2, self.frasm_f0
        order = self.get_assembly_field_order()
        if order == ORDER_TFF:
            field1 = self.fields[("f1", "odd")]
            field2 = self.fields[("f1", "even")]
            if f0.is_order_set() and not f0.is_order_tff():
                f0.outer_padding_ok = False
        else:
            field1 = self.fields[("f1", "even")]
            field2 = self.fields[("f1", "odd")]
            if f0.is_order_set() and not f0.is_order_bff():
                f0.outer_padding_ok = False
        f1_cnt, f2_cnt = len(field1), len(field2)
        if fa.video_standard == VID_PAL:
            target = LINES_PF_PAL
        elif fa.video_standard == VID_NTSC:
            target = LINES_PF_NTSC
        else:
            target = LINES_PF_DEFAULT
        f1_cnt = min(f1_cnt, target)
        f2_cnt = min(f2_cnt, target)

        # Every assembled part is a CONTIGUOUS row run, so the frame is
        # recorded as zero-copy view segments and materialized with ONE
        # concat at the end (a dozen per-part take/concat passes over
        # 12 arrays otherwise dominate the steady-state frame cost).
        segs = []           # LineStore views into field1/field2/pad master
        pad_spots = []      # (start position, nums, frame_number)
        pos = [0]
        added_inner = added_outer = 0
        last_line = [0]
        if prefix is not None and len(prefix):
            segs.append(prefix)
            pos[0] = len(prefix)

        def add_field(fld, start, count):
            count = max(0, count)
            segs.append(fld.view_slice(start, start + count))
            pos[0] += count
            if count:
                last_line[0] = int(fld.line_number[start + count - 1]) + 2
            return count

        def add_pad(count, frame=None):
            count = max(0, count)
            nums = last_line[0] + 2 * np.arange(count)
            last_line[0] += 2 * count
            segs.append(self._pad_view(count))
            pad_spots.append((pos[0], nums,
                              fa.frame_number if frame is None else frame))
            pos[0] += count
            return count

        if self.file_start:
            # Leading padding at new file (:4680-4714).
            f0.frame_number = 0
            add_count = 5  # LINE_R2
            lead = (target * 2) - (add_count * 2)
            last_line[0] = lead
            add_pad(add_count, frame=0)
            last_line[0] = 0

        A = f0.outer_padding_ok
        B = fa.inner_padding_ok
        C = fa.outer_padding_ok

        def fill_first(cut_start=0, cnt=None):
            last_line[0] = self._first_line(order)
            return add_field(field1, cut_start,
                             (f1_cnt if cnt is None else cnt) - cut_start)

        def fill_second(cut_start=0, cnt=None):
            last_line[0] = self._second_line(order)
            return add_field(field2, cut_start,
                             (f2_cnt if cnt is None else cnt) - cut_start)

        if A and B and C:
            total = f1_cnt + f2_cnt + fa.inner_padding + fa.outer_padding
            if target * 2 >= total:
                fill_first()
                added_inner = add_pad(fa.inner_padding)
                fill_second()
                added_outer = add_pad(fa.outer_padding)
                if target * 2 > total:
                    added_outer += add_pad(target * 2 - total)
                    fa.outer_padding_ok = False
                    fb.set_order_unknown()
            else:
                total = f1_cnt + f2_cnt + fa.inner_padding
                if target * 2 >= total:
                    fill_first()
                    added_inner = add_pad(fa.inner_padding)
                    fill_second()
                    added_outer = add_pad(target * 2 - total)
                else:
                    cut = total - target * 2
                    fill_first()
                    added_inner = add_pad(fa.inner_padding)
                    fill_second(cnt=f2_cnt - cut)
                fa.outer_padding_ok = False
                fb.set_order_unknown()
        elif A and B:
            total = f1_cnt + f2_cnt + fa.inner_padding
            if target * 2 >= total:
                fill_first()
                added_inner = add_pad(fa.inner_padding)
                fill_second()
                added_outer = add_pad(target * 2 - total)
            else:
                cut = total - target * 2
                fill_first()
                added_inner = add_pad(fa.inner_padding)
                fill_second(cnt=f2_cnt - cut)
        elif A and C:
            total = f1_cnt + f2_cnt + fa.outer_padding
            if target * 2 >= total:
                fill_first()
                added_inner = add_pad(target * 2 - total)
                fill_second()
                added_outer = add_pad(fa.outer_padding)
            else:
                cut = total - target * 2
                fill_first()
                fill_second(cut_start=cut)
                added_outer = add_pad(fa.outer_padding)
        elif A:
            total = f1_cnt + f2_cnt
            if target * 2 >= total:
                fill_first()
                added_inner = add_pad(target - f1_cnt)
                fill_second()
                added_outer = add_pad(target - f2_cnt)
            else:
                cut = total - target * 2
                fill_first()
                fill_second(cnt=f2_cnt - cut)
        elif B and C:
            total = f1_cnt + f2_cnt + fa.inner_padding + fa.outer_padding
            if target * 2 >= total:
                last_line[0] = self._first_line(order)
                added_inner = add_pad(target * 2 - total)
                add_field(field1, 0, f1_cnt)
                added_inner += add_pad(fa.inner_padding)
                fill_second()
                added_outer = add_pad(fa.outer_padding)
            else:
                cut = total - target * 2
                fill_first(cut_start=cut)
                added_inner = add_pad(fa.inner_padding)
                fill_second()
                added_outer = add_pad(fa.outer_padding)
        elif B:
            total = f1_cnt + f2_cnt + fa.inner_padding
            if target * 2 >= total:
                fill_first()
                added_inner = add_pad(fa.inner_padding)
                fill_second()
                added_outer = add_pad(target * 2 - total)
            else:
                cut = total - target * 2
                fill_first()
                added_inner = add_pad(fa.inner_padding)
                fill_second(cnt=f2_cnt - cut)
        elif C:
            total = f1_cnt + f2_cnt + fa.outer_padding
            if target * 2 >= total:
                fill_first()
                added_inner = add_pad(target * 2 - total)
                fill_second()
                added_outer = add_pad(fa.outer_padding)
            else:
                cut = total - target * 2
                fill_first(cnt=f1_cnt - cut)
                fill_second()
                added_outer = add_pad(fa.outer_padding)
        else:
            total = f1_cnt + f2_cnt
            if target * 2 >= total:
                insert_top = self.fix_cut_above and f1_cnt > 0 and f2_cnt > 0
                last_line[0] = self._first_line(order)
                if insert_top and order == ORDER_BFF:
                    added_outer = add_pad(1)
                    add_field(field1, 0, f1_cnt)
                    added_inner = add_pad(target - f1_cnt - 1)
                    fill_second()
                    added_outer += add_pad(target - f2_cnt)
                elif insert_top:
                    add_field(field1, 0, f1_cnt)
                    added_inner = add_pad(target - f1_cnt + 1)
                    fill_second()
                    added_outer = add_pad(target - f2_cnt - 1)
                else:
                    add_field(field1, 0, min(f1_cnt, target))
                    if f1_cnt < target:
                        added_inner = add_pad(target - f1_cnt)
                    fill_second(cnt=min(f2_cnt, target))
                    if f2_cnt < target:
                        added_outer = add_pad(target - f2_cnt)
            else:
                fill_first(cnt=min(f1_cnt, target))
                fill_second(cnt=min(f2_cnt, target))

        if self.file_end:
            last_line[0] = 1
            add_pad(stc007.MIN_DEINT_DATA, frame=fb.frame_number)

        fa.inner_padding = added_inner
        fa.outer_padding = added_outer
        if not segs:
            return LineStore(0)
        if len(segs) == 1 and segs[0] is prefix:
            return prefix  # empty frame: the conv queue is just the carry
        out = LineStore.concat(segs)
        for (p, nums, frame) in pad_spots:
            out.line_number[p:p + len(nums)] = nums
            out.frame_number[p:p + len(nums)] = frame
        return out

    def _pad_view(self, count):
        """View of `count` silent filler rows from a cached pad master
        (rebuilt only when it grows or the M2 mode flips) — the caller
        patches line/frame numbers after materialization."""
        master = getattr(self, "_pad_master", None)
        if master is None or len(master) < count \
                or self._pad_master_m2 != self.mode_m2:
            size = max(64, len(master or ()) * 2, count)
            master = LineStore.empty_lines(size, 0, None, m2=self.mode_m2)
            self._pad_master = master
            self._pad_master_m2 = self.mode_m2
        return master.view_slice(0, count)

    def _cwd_prescan_is_noop(self, conv, field1, c1, field2, c2,
                             padI, padO, f2f, conv_mode):
        """True when the slow path's CWD pre-scan (prescan_frame ->
        perform_cwd) would find NO candidate blocks over the assembled
        conv queue extended with frame 2's field head — i.e. the pass
        mutates nothing and the steady fast path stays bit-identical.
        Any valid P/Q-fixed block defers the pair to the full machine,
        which then performs the real write-back fixpoint.  The eval here
        is the exact eval perform_cwd runs (same queue, same single
        res mode from row 0, en_cwd with an all-false fixed mask)."""
        cnt = min(len(f2f), stc007.MIN_DEINT_DATA)
        segs = [conv, field1.view_slice(0, c1)]
        if padI:
            segs.append(self._pad_view(padI))
        segs.append(field2.view_slice(0, c2))
        if padO:
            segs.append(self._pad_view(padO))
        if cnt:
            segs.append(f2f.view_slice(0, cnt))
        q = LineStore.concat(segs)
        batch, _cwd_app, _aux = eval_blocks(
            q, conv_mode, force_ecc=True, en_p=self.en_p, en_q=self.en_q,
            en_cwd=True, m2=self.mode_m2)
        if batch is None:
            return True
        fixed = (batch.audio_state == di.AUD_FIX_P) \
            | (batch.audio_state == di.AUD_FIX_Q)
        block_valid = batch.valid[:, :6].all(axis=-1)
        return not bool((block_valid & fixed).any())

    # -- CWD pre-scan (prescanFrame :6401-6455, performCWD :5905-6401) ----
    def prescan_frame(self, conv: LineStore) -> LineStore:
        if not self.en_cwd:
            return conv
        added = 0
        fa, fb = self.frasm_f1, self.frasm_f2
        if fa.outer_padding_ok and fa.is_order_set():
            fld = self.fields[("f2", "odd")] if fa.is_order_tff() \
                else self.fields[("f2", "even")]
            cnt = min(len(fld), stc007.MIN_DEINT_DATA)
            conv = LineStore.concat([conv, fld.view_slice(0, cnt)])
            added = cnt
        for _ in range(16):  # fixpoint loop (prescanFrame do/while)
            fixes = self.perform_cwd(conv)
            if fixes == 0:
                break
        if added:
            conv = conv.take(slice(0, len(conv) - added))
        return conv

    def perform_cwd(self, conv: LineStore) -> int:
        """One performCWD pass: deinterleave with CWD, write fixed words
        back into source lines, re-CRC, free falsely-bad words."""
        res_mode = self.get_data_block_resolution(conv, 0)
        batch, cwd_app, aux = eval_blocks(
            conv, res_mode, ignore_crc=self.ignore_crc,
            force_ecc=not self.ignore_crc, en_p=self.en_p, en_q=self.en_q,
            en_cwd=True, m2=self.mode_m2)
        if batch is None:
            return 0
        is16 = batch.resolution == di.RES_16BIT
        fixed = (batch.audio_state == di.AUD_FIX_P) \
            | (batch.audio_state == di.AUD_FIX_Q)
        block_valid = batch.valid[:, :6].all(axis=-1)
        candidates = np.nonzero(block_valid & fixed)[0]
        line_fix_cnt = 0
        crc_valid_if = conv.crc_valid_ignore_forced().copy()
        wrote = False

        from ..ops import stitch_native as _sn
        if _sn.available():
            def row_crc(row):
                return _sn.crc_row(conv.words[row])
        else:
            def row_crc(row):
                # Single-row CRC: incremental write-back must not
                # recompute the whole buffer per word write (reference
                # patchBrokenLines re-CRCs only the touched line,
                # stc007datastitcher.cpp:5459).
                return int(stc007.calc_crc(conv.words[row:row + 1],
                                           xp=np)[0])

        for b in candidates:
            max_fix = 6 if (not self.en_q or is16[b]) else 7
            for w in range(max_fix + 1):
                if batch.line_crc[b, w]:
                    continue
                row = int(aux["shifts"][b]) + w * stc007.INTERLEAVE_OFS
                if (not crc_valid_if[row] and conv.coords_valid[row]
                        and not conv.forced_bad[row]
                        and conv.frame_number[row]
                        != self.frasm_f2.frame_number):
                    if not is16[b]:
                        new_word = int(batch.words[b, w])
                        if conv.words[row, w] != new_word:
                            conv.words[row, w] = new_word
                        conv.word_valid[row, w] = True
                        if row_crc(row) == conv.source_crc[row]:
                            conv.word_valid[row, :] = True
                            line_fix_cnt += 1
                        elif conv.word_valid[row, :8].all():
                            # dropout on the CRC word itself
                            conv.source_crc[row] = row_crc(row)
                            conv.word_valid[row, 8] = True
                            line_fix_cnt += 1
                        wrote = True
                        crc_valid_if[row] = \
                            row_crc(row) == conv.source_crc[row]
                    else:
                        full = int(batch.words[b, w])
                        new_word = full >> stc007.F1_WORD_OFS
                        s_bits = full & stc007.F1_S_MASK
                        ofs = stc007.F1_S_OFFSETS[w]
                        if conv.words[row, w] != new_word:
                            conv.words[row, w] = new_word
                            conv.word_valid[row, w] = True
                        if row_crc(row) != conv.source_crc[row]:
                            old_s = int(conv.words[row, 7])
                            new_s = (old_s & ~(stc007.F1_S_MASK << ofs)) \
                                | (s_bits << ofs)
                            conv.words[row, 7] = new_s
                        if row_crc(row) == conv.source_crc[row]:
                            conv.word_valid[row, :] = True
                            line_fix_cnt += 1
                        wrote = True
                        crc_valid_if[row] = \
                            row_crc(row) == conv.source_crc[row]
                else:
                    # False-positive valid line feeding a fixed block:
                    # its word disagrees with the corrected one (:6313-6334).
                    if crc_valid_if[row] and not conv.forced_bad[row] \
                            and not is16[b]:
                        if conv.words[row, w] != int(batch.words[b, w]):
                            conv.forced_bad[row] = True
        if wrote:
            conv.invalidate_crc()
        return line_fix_cnt

    # -- final deinterleave (performDeinterleave :6675-6888) --------------
    def perform_deinterleave(self, conv: LineStore) -> int:
        """Deinterleave all ready blocks; returns lines consumed."""
        fa, fb, f0 = self.frasm_f1, self.frasm_f2, self.frasm_f0
        n_blocks = len(conv) - stc007.MIN_DEINT_DATA
        if n_blocks <= 0:
            return 0
        from ..ops import stitch_native as _sn
        on_tpu = self.seam_backend == "tpu"
        use_native_fin = _sn.available() and not self.record_views \
            and not on_tpu
        res_mode = self.get_data_block_resolution(conv, 0)
        if use_native_fin:
            return self._deint_fused(conv, res_mode, n_blocks)
        batch, cwd_app, aux = eval_blocks(
            conv, res_mode, ignore_crc=self.ignore_crc,
            force_ecc=not self.ignore_crc, en_p=self.en_p, en_q=self.en_q,
            en_cwd=self.en_cwd, m2=self.mode_m2,
            backend="tpu" if on_tpu else None)
        rate = self._block_sample_rate()

        silent = aux["silent"]
        on_seam = aux["start_line"] > aux["stop_line"]
        sf, spf = aux["start_frame"], aux["stop_frame"]
        unsafe = np.zeros(n_blocks, bool)
        if self.mask_seams:
            if not fa.inner_padding_ok and not fa.inner_silence:
                unsafe |= (~silent & on_seam & (sf == fa.frame_number)
                           & (sf == spf))
            if not f0.outer_padding_ok and not f0.outer_silence:
                unsafe |= (~silent & (sf != spf) & (sf == f0.frame_number)
                           & (spf == fa.frame_number))
        # BROKEN masking countdown (:6798-6830).  The countdown decrements
        # every block and can only re-trigger once it hits 0, so coverage
        # is a greedy set of [trigger, trigger+dur) windows — O(#broken)
        # instead of a per-block Python loop.
        broken = aux["broken"]
        countdown = self.broken_countdown
        post_broken = np.zeros(n_blocks, bool)
        active = ~silent & ~unsafe
        if countdown > 0 or (self.broken_mask_dur > 0
                             and bool((active & broken).any())):
            triggers = np.nonzero(active & broken)[0]
            t_i = 0
            pos = 0
            while pos < n_blocks:
                if countdown > 0:
                    end = min(n_blocks, pos + countdown)
                    post_broken[pos:end] = active[pos:end]
                    countdown -= end - pos
                    pos = end
                else:
                    while t_i < len(triggers) and triggers[t_i] < pos:
                        t_i += 1
                    if t_i >= len(triggers) or self.broken_mask_dur <= 0:
                        break
                    pos = int(triggers[t_i])
                    countdown = self.broken_mask_dur
        self.broken_countdown = countdown
        mask_blocks = unsafe | post_broken

        # markAsUnsafe (stc007datablock.cpp): valid reverts to line CRC.
        out_valid = np.where(mask_blocks[:, None] & ~broken[:, None],
                             batch.line_crc, batch.valid)
        block_valid = out_valid[:, :6].all(axis=-1)
        if self.record_views:
            self.last_blocks = dict(
                words=np.asarray(batch.words).copy(),
                valid=out_valid.copy(),
                line_crc=np.asarray(batch.line_crc).copy(),
                fixed_p=np.asarray(aux["fixed_p"]).copy(),
                fixed_q=np.asarray(aux["fixed_q"]).copy(),
                broken=broken.copy(), masked=mask_blocks.copy())
        # Frame stats.
        no_report = ((self.file_start & (sf == f0.frame_number))
                     | (self.file_end & (spf == fb.frame_number)))
        rep = ~no_report
        eff_broken = broken
        fa.blocks_total += n_blocks
        fa.blocks_fix_p += int(np.sum(rep & block_valid & aux["fixed_p"]
                                      & ~mask_blocks))
        fa.blocks_fix_q += int(np.sum(rep & block_valid & aux["fixed_q"]
                                      & ~mask_blocks))
        fa.blocks_fix_cwd += int(np.sum(rep & block_valid & cwd_app))
        fa.blocks_drop += int(np.sum(rep & ~block_valid))
        fa.samples_drop += int(np.sum(
            np.sum(~out_valid[:, :6], axis=-1)[rep & ~block_valid]))
        fa.blocks_broken_field += int(np.sum(rep & ~block_valid & eff_broken))

        samples = aux["samples"]
        # word "fixed" flag for output: line CRC ok on valid blocks.
        bvalid = block_valid & ~broken
        wvalid = out_valid[:, :6] & ~broken[:, None]
        wfixed = batch.line_crc[:, :6] & bvalid[:, None]
        s6 = samples.reshape(n_blocks * 3, 2)
        v6 = wvalid.reshape(n_blocks * 3, 2)
        f6 = wfixed.reshape(n_blocks * 3, 2)
        b3 = np.repeat(bvalid, 3)
        # Emphasis from the field's Control Block control bits
        # (stc007line.cpp:573; CB carried in frasm via findFramesTrim —
        # the reference's block-level emphasis is a TODO at
        # stc007datastitcher.cpp:6719, this wires it through).
        emphasis = fa.ctrl_emphasis if fa.ctrl_seen \
            else (f0.ctrl_emphasis if f0.ctrl_seen else False)
        self.out_chunks.append(SampleChunk(
            samples=s6, valid=v6, fixed=f6, block_ok=b3,
            sample_rate=rate, emphasis=emphasis))
        return n_blocks

    def _block_sample_rate(self):
        """setBlockSampleRate (:6455-6483)."""
        fa = self.frasm_f1
        if self.preset_sample_rate in (SAMPLE_RATE_44100,
                                       SAMPLE_RATE_44056):
            rate = self.preset_sample_rate
        elif fa.video_standard == VID_PAL:
            rate = SAMPLE_RATE_44100
        elif fa.video_standard == VID_NTSC:
            rate = SAMPLE_RATE_44056
        else:
            rate = SAMPLE_RATE_44100
        fa.odd_sample_rate = fa.even_sample_rate = rate
        return rate

    def _deint_fused(self, conv, res_mode, n_blocks):
        """performDeinterleave via stc007_deint_finalize: eval (gather +
        ECC + flags + samples) and the finalize tail (seam masking,
        BROKEN windows, markAsUnsafe, stats counters) in ONE C call per
        frame with the per-block intermediates never crossing the
        ctypes boundary — bit-identical to the numpy tail below
        (tests/test_eval_native.py::test_deint_fused_matches_numpy)."""
        from ..ops import stitch_native as _sn
        fa, fb, f0 = self.frasm_f1, self.frasm_f2, self.frasm_f0
        rate = self._block_sample_rate()
        inner_gate = (self.mask_seams and not fa.inner_padding_ok
                      and not fa.inner_silence)
        outer_gate = (self.mask_seams and not f0.outer_padding_ok
                      and not f0.outer_silence)
        if self.ignore_crc:
            crc_ok = np.ascontiguousarray(np.repeat(
                (conv.coords_valid & conv.bw_set)[:, None], 8, axis=1))
        else:
            crc_ok = conv.crc_ok8()
        cwd_line = conv.is_fixed_by_cwd() if self.en_cwd else None
        samples, wvalid, wfixed, bvalid, counters, self.broken_countdown = \
            _sn.deint_finalize(
                conv.words_i32(), crc_ok, cwd_line, 0, n_blocks,
                res_mode, self.en_p, self.en_q,
                not self.ignore_crc, self.en_cwd, self.mode_m2,
                conv.line_number, conv.frame_number,
                inner_gate, outer_gate,
                fa.frame_number, f0.frame_number, fb.frame_number,
                self.broken_mask_dur, self.broken_countdown,
                self.file_start, self.file_end)
        fa.blocks_total += n_blocks
        fa.blocks_fix_p += int(counters[0])
        fa.blocks_fix_q += int(counters[1])
        fa.blocks_fix_cwd += int(counters[2])
        fa.blocks_drop += int(counters[3])
        fa.samples_drop += int(counters[4])
        fa.blocks_broken_field += int(counters[5])
        emphasis = fa.ctrl_emphasis if fa.ctrl_seen \
            else (f0.ctrl_emphasis if f0.ctrl_seen else False)
        self.out_chunks.append(SampleChunk(
            samples=samples.reshape(n_blocks * 3, 2),
            valid=wvalid.reshape(n_blocks * 3, 2),
            fixed=wfixed.reshape(n_blocks * 3, 2),
            block_ok=np.repeat(bvalid, 3),
            sample_rate=rate, emphasis=emphasis))
        return n_blocks

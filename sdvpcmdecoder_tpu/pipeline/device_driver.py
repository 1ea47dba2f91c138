"""Chip-resident STC-007 batch decoder: pixels live in device memory,
one fused dispatch decodes a whole round, samples/stats come back in KB.

Each round is one dispatch and one read-back per capture, and the
read-back of one capture overlaps the dispatches of the others
(round-robin over captures):

  stage:   each capture's frames are split to fields and device_put
           in bounded chunks (hbm_frames), once per chunk.
  round:   ops.device_stitch.steady_round_packed = binarize +
           duplicate detection + DUAL-resolution eval of every
           speculated seam/res/conv queue for all frame pairs of the
           round, in ONE dispatch on resident data.  Outputs are
           copied back asynchronously while other captures compute.
  replay:  the unchanged host stage machine consumes the speculative
           results through STC007Stitcher._match_spec_entry — every
           geometry fact is verified, so output is bit-identical to
           the host backends or the pair falls back (and the fallback
           itself is the native per-pair tail).  WAV equality vs the
           native driver is pinned by tests/test_device_driver.py.

Reference scope: the full doFrameReassemble chain
(stc007datastitcher.cpp:7250) with findPadding/tryPadding seam scoring
(:1417/:1743) and performDeinterleave (:6675) on device.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..formats import stc007
from ..ops import device_stitch as ds
from . import batch_driver, ingest, v2d
from . import stitcher_stc007 as st

KEEP = ds.KEEP          # 120
MDD = stc007.MIN_DEINT_DATA


def _gather_sample(px, idx):
    return px[:, idx, :]


_gather_sample_j = jax.jit(_gather_sample)


class StagedDeviceDecoder(batch_driver.BatchDecoder):
    """Shared skeleton of the chip-resident drivers (STC-007 and PCM):
    bounded-chunk HBM staging, the capture round-robin visit loop
    (complete pending round → restage at the chunk edge → dispatch the
    next round), and the rounds-never-straddle-a-chunk rounding of
    `hbm_frames`.  Subclasses provide _dispatch/_complete."""

    def _round_hbm_frames(self, frames_per_round, hbm_frames):
        self.hbm_frames = max(frames_per_round,
                              -(-hbm_frames // frames_per_round)
                              * frames_per_round)

    def _init_job_staging(self, j):
        # A checkpoint resume (batch_driver._try_resume, applied before
        # this runs) sets frames_read past 0: stage from there, not
        # from the capture start — otherwise a resume past the first
        # HBM chunk would hit the EOF branch and truncate the WAV.
        j.chunk_base = int(getattr(j, "frames_read", 0) or 0)
        j.chunk_len = 0
        j.stage_next = j.chunk_base
        j.exhausted = False
        j.px_dev = None
        j.nums = None
        j.Ls = j.W = 0
        self._stage_chunk(j, block=False)

    def _await_staging(self):
        """Staging is part of setup, not decode: wait for the uploads so
        the first round's reads don't absorb the staging transfers
        (bench reports staging seconds separately)."""
        for j in self.jobs:
            if j.px_dev is not None:
                jax.block_until_ready(j.px_dev)

    def _stage_chunk(self, j, block=True):
        """Stage the next bounded chunk of frames into HBM.  Returns
        False at EOF (j.exhausted set)."""
        with self._stage("stage_hbm"):
            batch = j.reader.read_frames(j.stage_next, self.hbm_frames)
            if batch.shape[0] == 0:
                j.exhausted = True
                return False
            lines_b, nums = ingest.split_fields_batch(batch)
            j.px_dev = jax.device_put(lines_b)
            j.chunk_base = j.stage_next
            j.chunk_len = lines_b.shape[0]
            j.stage_next += j.chunk_len
            j.nums = nums
            j.Ls = lines_b.shape[1]
            j.W = lines_b.shape[2]
            if block:
                jax.block_until_ready(j.px_dev)
        return True

    def run(self):
        while True:
            live = [j for j in self.jobs if not j.done]
            if not live:
                break
            for j in live:
                self._visit(j)
        return {j.path: j.stats for j in self.jobs}

    def _visit(self, j):
        if j.pending is not None:
            self._complete(j)
        if j.done:
            return
        while j.frames_read >= j.chunk_base + j.chunk_len \
                and not j.exhausted:
            self._stage_chunk(j)
        if j.frames_read >= j.chunk_base + j.chunk_len:
            if j.pending is None:
                self._stitch_and_write(j, [], finish=True)
                self._drain_final(j)
                j.done = True
            return
        self._dispatch(j)


class _RoundRows:
    """Row maps for one round geometry, uploaded to the device once.

    Layout of the combined words buffer (steady_round_packed):
    [prev frame (Ls rows) | round frames (F*Ls) | carry (112) | silent].
    """

    def __init__(self, F, lpf, n0, padI, padO, target, tff):
        Ls = 2 * lpf
        carry_ofs = (F + 1) * Ls
        sil = carry_ofs + MDD
        c1 = min(lpf, target)
        c2 = min(lpf, target)
        # n0 only shapes pair 0's carry rows; pairs >= 1 assume the
        # steady 112-row carry (verified per pair at replay).
        self.geom = (c1, c2, padI, padO, tff, target)
        self.lpf = lpf

        def fields(j):
            o = (j + 1) * Ls
            odd = np.arange(o, o + lpf, dtype=np.int64)
            even = np.arange(o + lpf, o + Ls, dtype=np.int64)
            return (odd, even) if tff else (even, odd)

        def blocks(queue):
            B = len(queue) - MDD
            pos = (np.arange(B, dtype=np.int64)[:, None]
                   + stc007.INTERLEAVE_OFS
                   * np.arange(8, dtype=np.int64)[None, :])
            return queue[pos]

        pad_i = np.full(padI, sil, np.int64)
        pad_o = np.full(padO, sil, np.int64)
        # g1 layout: ALL conv blocks first (their packed evals + device-
        # selected samples are read back), then the seam queues
        # (inner, outer per pair) padded to B_SEAM blocks — their burst
        # stats are reduced ON DEVICE, only [F, 2, 4] counters return.
        from ..ops import device_stitch as _dsx
        B_SEAM = _dsx.B_MAX
        g_conv, g_seam, meta1, ofs = [], [], [], 0
        nb_seam = np.zeros(2 * F, np.int32)
        head = min(lpf, KEEP)
        len1 = min(lpf, KEEP - padI)
        len1o = min(lpf, KEEP - padO)

        def seam_blocks(queue):
            b = blocks(queue) if len(queue) > MDD \
                else np.zeros((0, 8), np.int64)
            full = np.full((B_SEAM, 8), sil, np.int64)
            full[:min(b.shape[0], B_SEAM)] = b[:B_SEAM]
            return full, b.shape[0]

        for i in range(F):
            f1, f2 = fields(i - 1)
            fb1 = fields(i)[0]
            inner = np.concatenate([f1[lpf - len1:], pad_i, f2[:head]])
            outer = np.concatenate([f2[lpf - len1o:], pad_o, fb1[:head]])
            bi, nbi = seam_blocks(inner)
            bo, nbo = seam_blocks(outer)
            g_seam += [bi, bo]
            nb_seam[2 * i], nb_seam[2 * i + 1] = nbi, nbo
            tail = np.concatenate([f1[:c1], pad_i, f2[:c2], pad_o])
            if i == 0:
                carry = np.arange(carry_ofs, carry_ofs + n0,
                                  dtype=np.int64)
            else:
                p1, p2 = fields(i - 2)
                prev_tail = np.concatenate(
                    [p1[:c1], pad_i, p2[:c2], pad_o])
                carry = prev_tail[-MDD:]
            conv = np.concatenate([carry, tail])
            b = blocks(conv)
            meta1.append({"conv": (ofs, b.shape[0]),
                          "inner_nb": nbi, "outer_nb": nbo})
            g_conv.append(b)
            ofs += b.shape[0]
        g1 = g_conv + g_seam
        self.nb_seam = jnp.asarray(nb_seam)
        self.B_conv = ofs
        # The NEXT round's chained pair-0 carry rows: the carry formula
        # at "pair F" (fields(F-2); fields(-1) = this round's prev slot
        # when F == 1) — lets steady chains skip the carry upload AND
        # the host conv materialization entirely.
        np1, np2 = fields(F - 2) if F >= 2 else fields(-1)
        next_tail = np.concatenate([np1[:c1], pad_i, np2[:c2], pad_o])
        self.can_chain = len(next_tail) >= MDD
        self.carry_next_rows = jnp.asarray(
            next_tail[-MDD:] if self.can_chain
            else np.zeros(MDD, np.int64))
        g2, meta2, ofs2 = [], [], 0
        for i in range(F):
            o = (i + 1) * Ls
            m = {}
            for key, lo in (("res_odd", 0), ("res_even", lpf)):
                if lpf > MDD:
                    q = np.arange(o + lo, o + lo + lpf, dtype=np.int64)
                    b = blocks(q)
                    m[key] = (ofs2, b.shape[0])
                    g2.append(b)
                    ofs2 += b.shape[0]
                else:
                    m[key] = (ofs2, 0)
            meta2.append(m)
        self.meta1, self.meta2 = meta1, meta2
        self.g1 = jnp.asarray(np.concatenate(g1).astype(np.int32))
        self.g2 = jnp.asarray(
            np.concatenate(g2).astype(np.int32) if g2
            else np.zeros((1, 8), np.int32))
        # conv blocks lead the g1 layout, so the packed round's samples
        # section is just packed1[:B_conv]'s blocks in order.
        self.meta_conv = [m["conv"] for m in meta1]
        self.B1 = int(self.g1.shape[0])
        self.Bc = self.B_conv
        self.B2 = int(self.g2.shape[0])


class DeviceBatchDecoder(StagedDeviceDecoder):
    """BatchDecoder with the decode chain resident on the device.

    STC-007 only.  Pixels are staged into HBM in bounded chunks of
    `hbm_frames` frames (capture length is unbounded; decode state
    crosses chunk boundaries through the device-resident prev/carry
    arrays, so no pixel halo is needed).  Host work per round: prescan
    medians, store assembly from the read-back facts, stage-machine
    replay, audio masking, WAV.
    """

    def __init__(self, jobs, lines_per_field=294, hyst_limit=2,
                 shift_limit=1, frames_per_round=16, hbm_frames=256,
                 **kw):
        kw.setdefault("backend", "tpu")
        kw.setdefault("fmt", "stc007")
        from ..ops import stitch_native as _sn
        # tpu-spec: steady pairs replay the round dispatch's device
        # results; transition pairs (a handful per capture) use the
        # bit-identical native tail instead of one blocking device call
        # per seam trial.  Pure "tpu" when the C core is unavailable.
        super().__init__(jobs, lines_per_field=lines_per_field,
                         hyst_limit=hyst_limit, shift_limit=shift_limit,
                         frames_per_round=frames_per_round,
                         seam_backend="tpu-spec" if _sn.available()
                         else "tpu", **kw)
        self.hyst_limit = hyst_limit
        self.shift_limit = shift_limit
        self._round_hbm_frames(frames_per_round, hbm_frames)
        self._rows_cache = {}
        self._sil = None
        self._zero_carry = (jnp.zeros((MDD, 8), jnp.int32),
                            jnp.zeros((MDD, 8), bool))
        for j in self.jobs:
            self._init_job_staging(j)
            Ls = j.Ls
            j.prev_words = jnp.zeros((Ls, 8), jnp.int32)
            j.prev_ok8 = jnp.zeros((Ls, 8), bool)
            j.carry_dev = None
            j.carry_key = None
            j.pending = None
            j.round_id = 0
            j.next_sample = None
            j.next_sample_host = None
            if j.chunk_len:
                # Pre-gather round 0's prescan rows now; the async
                # copies complete while the other captures stage.
                F0 = min(frames_per_round, j.chunk_len)
                idx = v2d.prescan_rows(Ls)
                s0 = _gather_sample_j(
                    jax.lax.slice_in_dim(j.px_dev, 0, F0),
                    jnp.asarray(idx))
                s0.copy_to_host_async()
                j.next_sample = (0, s0)
        self._await_staging()

    def _silent_dev(self, m2):
        if self._sil is None or self._sil[0] != m2:
            self._sil = (m2, jnp.asarray(np.asarray(
                stc007.silent_words(m2=m2, xp=np), np.int32)))
        return self._sil[1]

    def _rows(self, F, lpf, n0, padI, padO, target, tff):
        key = (F, lpf, n0, padI, padO, target, tff)
        r = self._rows_cache.get(key)
        if r is None:
            r = self._rows_cache[key] = _RoundRows(F, lpf, n0, padI,
                                                   padO, target, tff)
        return r

    # -- round pipeline (run/_visit inherited from StagedDeviceDecoder) -----
    def _predict_geometry(self, j, lpf):
        sti = j.stitcher
        f0 = sti.frasm_f0
        tff = not f0.is_order_bff()   # TFF unless settled BFF
        if f0.video_standard == st.VID_PAL:
            target = st.LINES_PF_PAL
        elif f0.video_standard == st.VID_NTSC:
            target = st.LINES_PF_NTSC
        else:
            target = lpf
        padI = int(f0.inner_padding) if f0.inner_padding_ok else 0
        padO = int(f0.outer_padding) if f0.outer_padding_ok else 0
        c1 = min(lpf, target)
        c2 = min(lpf, target)
        if not (0 <= padI and 0 <= padO
                and c1 + c2 + padI + padO == 2 * target
                and padI < KEEP and padO < KEEP):
            padI = padO = 0
            target = lpf
        n0 = len(sti.conv_queue)
        if n0 > MDD:
            n0 = 0
        return padI, padO, target, tff, n0

    def _predict_conv_mode(self, sti):
        """The conv resolution mode the steady replay will compute —
        fixed under M2/preset, else the settled majority resolution
        (res_mode_combine of two equal plain modes is that mode).  A
        wrong prediction only costs the speculation: the replay bails
        the pair (BS_SPEC) and the native tail decodes it."""
        from ..ops import deinterleave as di
        fixed = sti._fixed_res_mode()
        if fixed is not None:
            return fixed
        return (di.RES_MODE_16BIT
                if sti.get_probable_resolution() == st.SAMPLE_RES_16BIT
                else di.RES_MODE_14BIT)

    def _dispatch(self, j):
        with self._stage("dispatch"):
            chunk_end = j.chunk_base + j.chunk_len
            F = min(self.frames_per_round, chunk_end - j.frames_read)
            Ls, W = j.Ls, j.W
            lpf = Ls // 2
            lo = j.frames_read - j.chunk_base
            px = jax.lax.slice_in_dim(j.px_dev, lo, lo + F)
            idx = v2d.prescan_rows(Ls)
            with self._stage("prescan"):
                if not j.driver.search_needed():
                    # Good-params skip: no sample gather, no read-back,
                    # no host AGC/marker/sweep this round.
                    prep = j.driver.prepare_frames(None,
                                                   shape=(F, Ls, W))
                else:
                    if j.next_sample_host is not None \
                            and j.next_sample_host[0] == j.frames_read:
                        sample = j.next_sample_host[1]
                    elif j.next_sample is not None \
                            and j.next_sample[0] == j.frames_read:
                        sample = np.asarray(j.next_sample[1])
                    else:
                        sample = np.asarray(
                            _gather_sample_j(px, jnp.asarray(idx)))
                    sample = sample.reshape(F * len(idx), W)
                    prep = j.driver.prepare_frames(None, sample=sample,
                                                   shape=(F, Ls, W))
            sti = j.stitcher
            padI, padO, target, tff, n0 = self._predict_geometry(j, lpf)
            rows = self._rows(F, lpf, n0, padI, padO, target, tff)
            conv = sti.conv_queue
            # Steady chain: the previous round ended on the steady path
            # with this exact geometry, so the device's own carry_next
            # output IS the live conv content — skip the carry upload
            # AND the host-side conv word materialization (the words
            # never leave HBM).  Verified at replay via carry_n = -1
            # (_spec_round_meta / _match_spec_entry chain rule).
            chained = (n0 == MDD and rows.can_chain
                       and j.carry_dev is not None
                       and j.carry_key == (lpf, rows.geom)
                       and getattr(sti, "_steady_chain", None)
                       == (j.frame_no, lpf, rows.geom))
            carry_w = np.zeros((MDD, 8), np.int32)
            carry_ok = np.zeros((MDD, 8), bool)
            if n0 and not chained:
                carry_w[:n0] = conv.words_i32()
                carry_ok[:n0] = conv.crc_ok8()
            layout, n_par = ds.round_param_layout(F)
            params = np.empty(n_par, np.int32)

            def put(key, arr):
                a = np.asarray(arr).ravel()
                params[layout[key]:layout[key] + a.size] = a

            put("coords", prep["coords"])
            put("refs", np.maximum(prep["refs"], 1))
            put("blacks", np.clip(prep["blacks"], 0, 254))
            put("whites", np.clip(prep["whites"], 1, 255))
            put("usable", prep["usable"])
            put("carry_w", carry_w)
            put("carry_ok", carry_ok)
            pred_mode = self._predict_conv_mode(sti)
            put("pred_mode", pred_mode)
            unch_lim = sti.max_unch_14 if sti.en_q else sti.max_unch_16
            put("unch_lim", unch_lim)
            # Frames whose stores the host WILL read words from — the
            # settle-in pairs' head frames (full stage machine, round 0)
            # and the capture's finish tail — get their word rows
            # prefetched asynchronously; a synchronous lazy fetch later
            # would block on one device read-back per store.
            n_total = getattr(j.reader, "n_frames", None)
            chunk_final = (j.frames_read + F >= chunk_end
                           and (j.exhausted
                                or j.chunk_len < self.hbm_frames
                                # exact-multiple captures: EOF hasn't
                                # been read yet but the frame count
                                # says this chunk is the last one
                                or (n_total is not None
                                    and j.stage_next >= n_total)))
            n_head = min(6, F) if j.round_id == 0 else 0
            n_tail = min(2, F) if chunk_final else 0
            cd_w, cd_ok = j.carry_dev if j.carry_dev is not None \
                else self._zero_carry
            (out, wflat, wtail, oktail, cn_w,
             cn_ok) = ds.steady_round_packed(
                px, jnp.asarray(params), j.prev_words, j.prev_ok8,
                cd_w, cd_ok, rows.carry_next_rows,
                rows.g1, rows.g2, rows.nb_seam,
                self._silent_dev(sti.mode_m2), B_conv=rows.B_conv,
                en_p=sti.en_p, en_q=sti.en_q, m2=sti.mode_m2,
                hyst_limit=self.hyst_limit, shift_limit=self.shift_limit,
                chained=chained)
            out.copy_to_host_async()
            prefetch = []
            if n_head:
                hw = jax.lax.slice_in_dim(wflat, 0, n_head * Ls)
                hw.copy_to_host_async()
                prefetch.append((0, n_head, hw))
            if n_tail:
                tw = jax.lax.slice_in_dim(wflat, (F - n_tail) * Ls,
                                          F * Ls)
                tw.copy_to_host_async()
                prefetch.append((F - n_tail, F, tw))
            j.prev_words = wtail
            j.prev_ok8 = oktail
            j.carry_dev = (cn_w, cn_ok)
            j.carry_key = (lpf, rows.geom)
            j.pending = dict(F=F, px=px, prep=prep,
                             out=out, wflat=wflat, rows=rows,
                             round_id=j.round_id, prefetch=prefetch,
                             carry_w=carry_w, carry_ok=carry_ok,
                             n0=-1 if chained else n0,
                             pred_mode=pred_mode)
            j.round_id += 1
            j.frames_read += F
            nxt = j.frames_read
            d = j.driver
            search_next = (d.search_needed()
                           or d._frames_prepared + self.frames_per_round
                           >= d._next_search)
            # Prefetch stops at the staging chunk's edge — the next
            # chunk isn't resident yet; its round gathers at dispatch.
            if nxt < chunk_end and search_next:
                F2 = min(self.frames_per_round, chunk_end - nxt)
                px2 = jax.lax.slice_in_dim(
                    j.px_dev, nxt - j.chunk_base,
                    nxt - j.chunk_base + F2)
                s2 = _gather_sample_j(px2, jnp.asarray(idx))
                s2.copy_to_host_async()
                j.next_sample = (nxt, s2)
            else:
                j.next_sample = None

    def _build_stores_device(self, j, F, Ls, usable, fb_res, crc_read,
                             valid, dup, cb, crcm, wflat, prep,
                             w_pre=None):
        """_build_stores_stc007 for the packed round: steady frames
        become LAZY stores (from_decoded_spec over the resident words;
        nothing is read back unless a fallback materializes),
        fallback/unusable frames take the eager paths.  Frames in
        `w_pre` ({frame -> prefetched [Ls, 8] host words}) come out
        eager — the settle-in/finish frames the stage machine reads."""
        stores = []
        w_pre = w_pre or {}
        nums64 = np.asarray(j.nums, np.int64)
        for f in range(F):
            j.frame_no += 1
            if not usable[f]:
                j.stats.frames_no_pcm += 1
                store = st.LineStore(Ls)
                store.frame_number[:] = j.frame_no
                store.line_number = nums64.copy()
                j.stats.lines_total += Ls
            elif f in fb_res:
                res = fb_res[f]
                store = st.LineStore.from_decoded(
                    res.words, res.crc_read, res.valid,
                    np.full(Ls, j.frame_no), j.nums,
                    ref_level=np.full(Ls, res.ref_level),
                    forced_bad=res.forced_bad)
                j.stats.lines_total += Ls
                j.stats.lines_valid += int(res.valid.sum())
                j.stats.lines_dup += int(res.duplicates.sum())
            else:
                a = f * Ls
                store = st.LineStore.from_decoded_spec(
                    (lambda dev=wflat, a=a, b=a + Ls:
                     np.asarray(dev[a:b])),
                    crc_read[f], valid[f], cb[f], crcm[f],
                    np.full(Ls, j.frame_no), j.nums,
                    ref_level=np.full(Ls, int(prep["refs"][f])),
                    forced_bad=dup[f])
                if f in w_pre:
                    store.words = w_pre[f]
                j.stats.lines_total += Ls
                j.stats.lines_valid += int(valid[f].sum())
                j.stats.lines_dup += int(dup[f].sum())
            if j.first:
                tag = st.LineStore(1)
                tag.service[0] = st.SRV_NEW_FILE
                tag.frame_number[0] = j.frame_no
                # Prime the 1-row CRC cache so the concat's composed
                # _crcv survives — else the first frame's lazy store
                # materializes just to re-CRC the tag row.
                tag._crcv = tag.calc_crc() == tag.source_crc
                store = st.LineStore.concat([tag, store])
                j.first = False
            stores.append(store)
        return stores

    def _complete(self, j):
        p = j.pending
        j.pending = None
        with self._stage("materialize"):
            rows_ = p["rows"]
            (crc_read, valid, dup, cb, crcm, packed1, samples_conv,
             res_counts, seam_stats) = ds.unpack_round(
                np.asarray(p["out"]), p["F"], j.Ls, rows_.Bc)
            # Read the next round's prescan sample HERE: its copy was
            # requested a full cycle ago (right after this round's
            # outputs), so it is local by now — reading it at dispatch
            # time raced the transfer and stalled ~80ms per round.
            if j.next_sample is not None:
                j.next_sample_host = (j.next_sample[0],
                                      np.asarray(j.next_sample[1]))
                j.next_sample = None
        F, Ls = p["F"], j.Ls
        wflat = p["wflat"]   # resident [F*Ls, 8] i32, CB-rewritten
        prep, usable = p["prep"], p["prep"]["usable"]
        j.driver.note_feedback(bool((~valid[usable]).any())
                               if usable.any() else True)
        with self._stage("finalize"):
            # INSANE quality (full ref-level sweep): every usable frame
            # takes the host finalize path, whose _ref_sweep_merge runs
            # the sweep grid on the device — --quality insane composes
            # with the chip-resident driver instead of excluding it
            # (sweepRefLevel scope, binarizer.cpp:3551).
            insane = getattr(j.driver, "ref_sweep", False)
            fb_frames = [f for f in range(F)
                         if usable[f]
                         and (insane or 0 < int((~valid[f]).sum()) < Ls)]
            fb_res = {}
            j.stats.frames_line_fallback += len(fb_frames)
            if fb_frames:
                # Some lines failed: fetch those frames' pixels AND
                # words, and run the host finalize path (marker fallback
                # + dup rebuild) exactly as the streaming driver would.
                sel = jnp.asarray(np.asarray(fb_frames))
                px_host = np.asarray(jnp.take(p["px"], sel, axis=0))
                w_fb = np.asarray(jnp.take(
                    wflat.reshape(F, Ls, 8), sel, axis=0)) \
                    .astype(np.int64)
                crc_fb = crc_read[fb_frames].astype(np.int64)
                cb_fb = cb[fb_frames]
                if cb_fb.any():
                    # The resident words are CB-rewritten; the finalize
                    # path (and from_decoded after it) expects the RAW
                    # read.  Exact reconstruction: the cue words are
                    # format constants and the raw source CRC of a
                    # valid line is its calc CRC.
                    w_fb[cb_fb, 0] = stc007.CB_CUE1
                    w_fb[cb_fb, 1] = stc007.CB_CUE2
                    w_fb[cb_fb, 2] = stc007.CB_CUE1
                    w_fb[cb_fb, 3] = stc007.CB_CUE2
                    crc_fb[cb_fb] = stc007.calc_crc(w_fb[cb_fb], xp=np)
                sub_prep = {k: prep[k][np.asarray(fb_frames)]
                            for k in ("coords", "refs", "blacks",
                                      "whites", "usable")}
                v_fb = valid[fb_frames]
                forced = np.zeros((len(fb_frames), Ls), bool)
                if insane:
                    w_fb, crc_fb, v_fb, forced = j.driver._ref_sweep_merge(
                        px_host, sub_prep["coords"], sub_prep["blacks"],
                        sub_prep["whites"], w_fb, crc_fb, v_fb)
                sub = j.driver.finalize_frames(
                    px_host, sub_prep, w_fb, crc_fb, v_fb, forced)
                fb_res = dict(zip(fb_frames, sub))
        with self._stage("assemble"):
            fno_before = j.frame_no
            w_pre = {}
            for a, b, arr in p.get("prefetch", ()):
                # Prefetched at dispatch: this asarray reads local data.
                host = np.asarray(arr).astype(np.int64)
                for f in range(a, b):
                    w_pre[f] = host[(f - a) * Ls:(f - a + 1) * Ls]
            stores = self._build_stores_device(
                j, F, Ls, usable, fb_res, crc_read, valid, dup, cb,
                crcm, wflat, prep, w_pre=w_pre)
            for k, store in enumerate(stores):
                if len(store) == Ls and usable[k] and k not in fb_res:
                    store._dev_gid = fno_before + 1 + k
            spec = {}
            rows = p["rows"]
            for i in range(F):
                m1 = rows.meta1[i]
                oc, nc = m1["conv"]
                spec[(fno_before + i, fno_before + 1 + i)] = dict(
                    round_id=p["round_id"], pair_idx=i, lpf=rows.lpf,
                    geom=rows.geom, pred_mode=p["pred_mode"],
                    carry_n=p["n0"], carry_w=p["carry_w"],
                    carry_ok=p["carry_ok"],
                    seam_stats=seam_stats[i],
                    seam_nb=(m1["inner_nb"], m1["outer_nb"]),
                    conv=packed1[oc:oc + nc],
                    conv_samples=samples_conv[oc:oc + nc],
                    res_counts=res_counts[i])
            j.stitcher._steady_spec = spec
            # Round context for the C-side spec replay (ONE
            # stc007_spec_round call per round instead of per-pair
            # Python replays; stitcher_stc007._try_steady_run).
            j.stitcher._steady_round_ctx = dict(
                pairs={k: i for i, k in enumerate(spec)},
                meta1=rows.meta1, meta_conv=rows.meta_conv,
                packed1=packed1, samples_conv=samples_conv,
                res_counts=res_counts, seam_stats=seam_stats,
                geom=rows.geom, lpf=rows.lpf,
                pred_mode=p["pred_mode"],
                carry_n=p["n0"], carry_w=p["carry_w"],
                carry_ok=p["carry_ok"])
        self._stitch_and_write(j, stores)

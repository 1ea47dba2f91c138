"""Chip-resident PCM-1 / PCM-16x0 batch decoder.

The PCM formats' counterpart of pipeline/device_driver.DeviceBatchDecoder:
each capture's pixels are split to fields and device_put ONCE, every
round of frames decodes with ONE fused dispatch
(ops/device_pcm.pcm_round_packed — the trial-grid binarize + packing),
and ONE async i32 readback carries words/CRCs/validity/control bits
back.  These formats stitch per frame (no cross-frame interleave), so
the host replay is simply the existing stitchers — their native
steady-frame calls (pcm1_steady_frame / pcm16x0_steady_frame,
stitchcore.cpp) consume the device words and emit samples, bit-identical
to the streaming backends by construction (pinned by
tests/test_device_pcm.py).

Host work per round: AGC + coordinate search over prefetched prescan
rows (4/frame, copied back asynchronously a round ahead), per-line
refinement/Bit Picker for failed lines (pixels fetched per failed frame
only), store assembly, steady-frame replay, audio masking, WAV.

Reference scope: the V2D loop feeding the per-format stitcher threads
(videotodigital.cpp:698 routing, pcm1datastitcher.cpp:1578,
pcm16x0datastitcher.cpp:5652 doFrameReassemble).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import device_pcm as dp
from .device_driver import StagedDeviceDecoder, _gather_sample_j


class DevicePCMBatchDecoder(StagedDeviceDecoder):
    """BatchDecoder with the PCM-1/16x0 binarize resident on device.

    fmt in ("pcm1", "pcm16x0", "pcm1630"); pixels are staged into HBM
    in bounded chunks of `hbm_frames` frames, so capture length is
    unbounded (these formats stitch per frame — no cross-chunk state
    beyond the stitcher's own host-side histories).
    """

    def __init__(self, jobs, fmt, hyst_limit=0, shift_limit=2,
                 frames_per_round=16, hbm_frames=256, **kw):
        if fmt not in ("pcm1", "pcm16x0", "pcm1630"):
            raise ValueError(f"DevicePCMBatchDecoder: unsupported {fmt!r}")
        super().__init__(jobs, fmt=fmt, hyst_limit=hyst_limit,
                         shift_limit=shift_limit,
                         frames_per_round=frames_per_round, **kw)
        self.dec_fmt = "pcm1" if fmt == "pcm1" else "pcm16x0"
        self.hyst_limit = hyst_limit
        self.shift_limit = shift_limit
        self._round_hbm_frames(frames_per_round, hbm_frames)
        for j in self.jobs:
            self._init_job_staging(j)
            j.pending = None
            j.next_sample = None
            if j.chunk_len:
                self._prefetch_sample(j, 0)
        self._await_staging()

    def _prefetch_sample(self, j, start):
        """Request the prescan rows of the round starting at `start`;
        the async copy completes while other work proceeds.  Stops at
        the staging chunk's edge."""
        F = min(self.frames_per_round, j.chunk_base + j.chunk_len - start)
        if F <= 0:
            j.next_sample = None
            return
        idx = type(j.driver).prescan_rows(j.Ls)
        lo = start - j.chunk_base
        s = _gather_sample_j(
            jax.lax.slice_in_dim(j.px_dev, lo, lo + F),
            jnp.asarray(idx))
        s.copy_to_host_async()
        j.next_sample = (start, s)

    # run/_visit/_stage_chunk inherited from StagedDeviceDecoder.
    def _dispatch(self, j):
        with self._stage("dispatch"):
            F = min(self.frames_per_round,
                    j.chunk_base + j.chunk_len - j.frames_read)
            Ls, W = j.Ls, j.W
            lo = j.frames_read - j.chunk_base
            px = jax.lax.slice_in_dim(j.px_dev, lo, lo + F)
            with self._stage("prescan"):
                if j.next_sample is not None \
                        and j.next_sample[0] == j.frames_read:
                    sample = np.asarray(j.next_sample[1])
                else:
                    idx = type(j.driver).prescan_rows(Ls)
                    sample = np.asarray(
                        _gather_sample_j(px, jnp.asarray(idx)))
                sample = sample.reshape(F * sample.shape[1], W) \
                    if sample.ndim == 3 else sample
                prep = j.driver.prepare_frames(None, sample=sample,
                                               shape=(F, Ls, W))
            layout, n_par = dp.round_param_layout(F)
            params = np.empty(n_par, np.int32)

            def put(key, arr):
                a = np.asarray(arr).ravel()
                params[layout[key]:layout[key] + a.size] = a

            put("coords", prep["coords"])
            put("refs", np.maximum(prep["refs"], 1))
            put("blacks", np.clip(prep["blacks"], 0, 254))
            put("whites", np.clip(prep["whites"], 1, 255))
            put("usable", prep["usable"])
            out = dp.pcm_round_packed(
                px, jnp.asarray(params), fmt=self.dec_fmt,
                shift_limit=self.shift_limit,
                hyst_limit=self.hyst_limit)
            out.copy_to_host_async()
            j.pending = dict(F=F, px=px, prep=prep, out=out)
            j.frames_read += F
            self._prefetch_sample(j, j.frames_read)

    def _complete(self, j):
        p = j.pending
        j.pending = None
        F, Ls = p["F"], j.Ls
        with self._stage("materialize"):
            words, crc, valid, ctrl = dp.unpack_round(
                np.asarray(p["out"]), F, Ls, self.dec_fmt)

        def px_fetch(f, px=p["px"]):
            j.stats.frames_line_fallback += 1
            return np.asarray(
                jax.lax.slice_in_dim(px, f, f + 1))[0]

        with self._stage("finalize"):
            results = j.driver.finalize_decoded(
                p["prep"], words, crc, valid, ctrl, px_fetch, j.W)
        with self._stage("assemble"):
            stores = self._build_stores_other(j, results, j.nums)
        self._stitch_and_write(j, stores)

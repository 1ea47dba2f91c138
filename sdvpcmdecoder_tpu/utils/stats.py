"""Aggregate decode statistics (the GUI counter panel analog).

The reference MainWindow keeps ~30 counters updated by stat slots
(mainwindow.h:434-467); here a DecodeStats object aggregates the frame
descriptors the stitchers already produce plus audio-chain masking counts,
and renders the end-of-run summary.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DecodeStats:
    frames_total: int = 0
    frames_no_pcm: int = 0
    lines_total: int = 0
    lines_valid: int = 0
    blocks_total: int = 0
    blocks_fix_p: int = 0
    blocks_fix_q: int = 0
    blocks_fix_cwd: int = 0
    blocks_broken: int = 0
    blocks_drop: int = 0
    samples_drop: int = 0
    samples_masked: int = 0
    samples_out: int = 0
    peak_level: int = 0          # VU analog: max |sample| seen
    lines_dup: int = 0           # stat_dup_err_cnt: head-switch copies
    frames_bad_stitch: int = 0   # stat_bad_stitch_cnt: padding not found
    frames_dropped: int = 0      # stat_drop_frame_cnt: capture drops
    # Chip-resident drivers: frames whose failed lines were re-read on
    # the host (pixels fetched back for the marker fallback/refinement).
    frames_line_fallback: int = 0
    # Reassembly loop time telemetry (stat_min/max_di_time,
    # mainwindow.h:448-450; loopTime signals).
    di_time_min_us: int = 0
    di_time_max_us: int = 0
    di_time_total_us: int = 0
    di_time_frames: int = 0

    def add_frame(self, frasm, lines_total=0, lines_valid=0):
        self.frames_total += 1
        self.lines_total += lines_total
        self.lines_valid += lines_valid
        self.blocks_total += getattr(frasm, "blocks_total", 0)
        self.blocks_fix_p += getattr(frasm, "blocks_fix_p", 0)
        self.blocks_fix_q += getattr(frasm, "blocks_fix_q", 0)
        self.blocks_fix_cwd += getattr(frasm, "blocks_fix_cwd", 0)
        self.blocks_broken += (getattr(frasm, "blocks_broken_field", 0)
                               + getattr(frasm, "blocks_broken", 0))
        self.blocks_drop += getattr(frasm, "blocks_drop", 0)
        self.samples_drop += getattr(frasm, "samples_drop", 0)
        # Bad stitch: a processed frame whose padding search failed
        # outright (flag_bad_stitch_cnt semantics) — only counted when
        # the frame actually carried PCM data (leaders/no-PCM dummies
        # never ran a padding search).
        has_data = (getattr(frasm, "odd_data_lines", 0)
                    + getattr(frasm, "even_data_lines", 0)) > 0
        if hasattr(frasm, "inner_padding_ok"):
            if has_data and not (
                    frasm.inner_padding_ok or frasm.outer_padding_ok
                    or frasm.inner_silence or frasm.outer_silence):
                self.frames_bad_stitch += 1
        elif hasattr(frasm, "padding_ok"):
            if has_data and not (frasm.padding_ok
                                 or getattr(frasm, "silence", False)):
                self.frames_bad_stitch += 1

    def add_di_time(self, us: int, frames: int = 1):
        """Record one reassembly pass's wall time (microseconds)."""
        if frames <= 0:
            return
        per = us // frames
        if self.di_time_frames == 0 or per < self.di_time_min_us:
            self.di_time_min_us = per
        if per > self.di_time_max_us:
            self.di_time_max_us = per
        self.di_time_total_us += us
        self.di_time_frames += frames

    def add_audio(self, samples, masked):
        import numpy as np
        self.samples_out += len(samples)
        self.samples_masked += masked
        if len(samples):
            self.peak_level = max(self.peak_level,
                                  int(np.abs(samples).max()))

    def summary(self) -> str:
        lv = (100.0 * self.lines_valid / self.lines_total
              if self.lines_total else 0.0)
        return (
            f"frames: {self.frames_total} ({self.frames_no_pcm} no PCM, "
            f"{self.frames_dropped} dropped, "
            f"{self.frames_bad_stitch} bad stitch)\n"
            f"lines:  {self.lines_valid}/{self.lines_total} valid "
            f"({lv:.1f}%)\n"
            f"blocks: {self.blocks_total} total, "
            f"P-fix {self.blocks_fix_p}, Q-fix {self.blocks_fix_q}, "
            f"CWD {self.blocks_fix_cwd}, broken {self.blocks_broken}, "
            f"dropped {self.blocks_drop}\n"
            f"dup lines: {self.lines_dup}\n"
            f"samples: {self.samples_out} out, "
            f"{self.samples_drop} damaged, {self.samples_masked} masked, "
            f"peak {self.peak_level} ({self.peak_dbfs():+.1f} dBFS)\n"
            f"DI time/frame: min {self.di_time_min_us} us, "
            f"max {self.di_time_max_us} us, avg "
            f"{self.di_time_total_us // max(self.di_time_frames, 1)} us")

    def peak_dbfs(self) -> float:
        """Peak level in dBFS (the VU meter analog; sample2vu lookup.h:30
        feeds the reference's GUI bars from the same max-abs value)."""
        import math
        if self.peak_level <= 0:
            return -96.0
        return 20.0 * math.log10(self.peak_level / 32768.0)

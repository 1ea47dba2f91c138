#!/usr/bin/env python
"""Smoke run of the chip-resident decode path on an NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # four cards: the multi-card phase

Everything runs in this one process, which must be the only JAX process
on the card: the CLI is driven in-process through
sdvpcmdecoder_tpu.__main__.main, never as a child.  Each phase prints its
own lines; any failure exits non-zero before the result line.

  1. device   the GPU JAX sees, `nvidia-smi` name and power limit, and
              the compile-cache directory.  No GPU: exit non-zero.
  2. parity   the device kernels at real widths against the host
              references, exact equality (PAL 588 x 1152, one round of
              64 frames, hyst 4 / shift 2; PCM-1 and PCM-16x0 rounds;
              the P/Q correction at both resolutions).
  3. e2e      the CLI on a 600-frame PAL capture (--backend device, which
              crosses two device-memory chunk edges at hbm_frames=256,
              against --backend native), the 8-capture fleet and the PCM
              engines, half of each fleet at noise sigma 30 so the
              failed-line, P/Q and replay fall-back paths run; every WAV
              byte-identical to the host-native one, and the P/Q/broken
              block counts equal to the native engine's.
  4. timings  median device time of the trial grid alone, of the whole
              round dispatch, and of the P/Q correction.

With --four-cards only the multi-card phase runs: ShardedBatchDecoder
over 4 cards against a 1-card run, and the (2 data x 2 seq) mesh decode
against the single-device decode.

The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np

HYST, SHIFT = 4, 2          # NORMAL-like limits (binarizer.h:235-241)

# Why parity is EXACT equality: every product on the device path is of
# integers — bf16 one-hot x uint8 pixels (binarize bit sampling) and 0/1
# bits x a 0/1 table (CRC syndromes, GF(2) parity), accumulated in f32
# or int32.  Every value and partial sum is an integer below 2^24, so the
# card's tensor cores round nothing, and words, CRCs, validity,
# hyst/shift and samples must equal the host references bit for bit.


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit` for every card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return "; ".join(ln.strip() for ln in r.stdout.splitlines()
                     if ln.strip())


def peak_bytes(dev):
    """Peak device memory of this process on `dev` (None off the GPU)."""
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def check_equal(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (np.argwhere(got != want)[:3].tolist()
               if got.shape == want.shape else "shape")
        raise AssertionError(f"{what}: device != reference "
                             f"(shapes {got.shape} vs {want.shape}, "
                             f"first differences {bad})")


def median_seconds(fn, n=20):
    """Median wall time of fn() after two warm-up calls, each call
    ending in block_until_ready (so it is the device's time plus one
    dispatch)."""
    import jax
    for _ in range(2):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


@contextlib.contextmanager
def compile_log():
    """Yields a list that collects the duration of every XLA backend
    compile made inside the block."""
    from jax import monitoring
    durations = []

    def listen(event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            durations.append(duration)

    monitoring.register_event_duration_secs_listener(listen)
    try:
        yield durations
    finally:
        monitoring.unregister_event_duration_listener(listen)


@contextlib.contextmanager
def numpy_reference_only():
    """Run the host code with the native core switched off, so
    deinterleave.correct_blocks(xp=np) takes its numpy reference path."""
    from sdvpcmdecoder_tpu.ops import stitch_native as sn
    saved = sn._LIB, sn._TRIED
    sn._LIB, sn._TRIED = None, True
    try:
        yield
    finally:
        sn._LIB, sn._TRIED = saved


# -- phase 1 ------------------------------------------------------------------
def phase_device(n_cards):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"[device] FAIL: JAX platform is "
                         f"{devs[0].platform!r}, not a GPU")
    if len(devs) < n_cards:
        raise SystemExit(f"[device] FAIL: {len(devs)} GPUs, need {n_cards}")
    from sdvpcmdecoder_tpu.utils import jaxcache
    cache = jaxcache.enable()
    card = card_line()
    log("device", f"platform={devs[0].platform} "
                  f"kind={devs[0].device_kind} count={len(devs)} | "
                  f"card: {card} | compile cache: {cache}")
    return devs, card


# -- phase 2 ------------------------------------------------------------------
def stc007_round(n_frames, noise, seed):
    """One round of PAL fields with the V2D prescan's own parameters,
    clipped exactly as the device driver uploads them."""
    from sdvpcmdecoder_tpu.pipeline import ingest, v2d
    from sdvpcmdecoder_tpu.synth import captures
    frames = captures.stc007_pal_frames(n_frames, seed, noise)
    lines, _ = ingest.split_fields_batch(frames)
    prep = v2d.V2DDriver(hyst_limit=HYST,
                         shift_limit=SHIFT).prepare_frames(lines)
    params = (prep["coords"].astype(np.int32),
              np.maximum(prep["refs"], 1).astype(np.int32),
              np.clip(prep["blacks"], 0, 254).astype(np.int32),
              np.clip(prep["whites"], 1, 255).astype(np.int32))
    return lines, params, prep["usable"]


def parity_stc007(tag, lines, params, usable, n_numpy):
    """Trial grid on the device vs the native grid (every line) and the
    numpy twin (n_numpy lines, half of them lines no trial validated).
    Returns the device words/validity."""
    import jax.numpy as jnp
    from sdvpcmdecoder_tpu.ops import binarize as bz
    from sdvpcmdecoder_tpu.ops import line_decode_np as ld
    from sdvpcmdecoder_tpu.ops import stitch_native as sn
    if usable.sum() * 2 < len(usable):
        raise AssertionError(f"{tag}: prescan found PCM in only "
                             f"{usable.sum()}/{len(usable)} frames")
    out = bz.stc007_frame_decode(jnp.asarray(lines),
                                 *(jnp.asarray(p) for p in params),
                                 hyst_limit=HYST, shift_limit=SHIFT)
    dev = [np.asarray(a) for a in (out.words, out.crc_read, out.valid,
                                   out.hyst, out.shift)]
    names = ("words", "crc", "valid", "hyst", "shift")
    if sn.available():
        nat = sn.binarize_frames(lines, *params, HYST, SHIFT)
        for name, d, n in zip(names, dev, nat):
            check_equal(f"{tag} grid {name} vs native", d[usable], n[usable])
    F, L, W = lines.shape
    u_idx = np.flatnonzero(usable)
    valid = dev[2]
    rng = np.random.default_rng(0)
    bad = np.argwhere(~valid[u_idx])
    good = np.argwhere(valid[u_idx])
    picks = [bad[rng.permutation(len(bad))[:n_numpy // 2]],
             good[rng.permutation(len(good))[:n_numpy - n_numpy // 2]]]
    coords, refs, blacks, whites = params
    n_checked = 0
    for fi, li in np.concatenate(picks):
        f = u_idx[fi]
        w, crc, _calc, v, h, s = ld.read_pcm_grid(
            ld.decode_trial_stc007, lines[f, li], int(coords[f, 0]),
            int(coords[f, 1]), int(refs[f]), int(blacks[f]),
            int(whites[f]), W, HYST, SHIFT)
        got = (dev[0][f, li], dev[1][f, li], dev[2][f, li], dev[3][f, li],
               dev[4][f, li])
        for name, g, want in zip(names, got, (w, crc, v, h, s)):
            check_equal(f"{tag} grid {name} vs numpy twin "
                        f"(frame {f}, line {li})", g, want)
        n_checked += 1
    n_lines = int(usable.sum()) * L
    n_valid = int(valid[usable].sum())
    log("parity", f"{tag}: trial grid {F}x{L}x{W} == native on "
                  f"{n_lines} lines ({n_valid} valid, "
                  f"{n_lines - n_valid} not) and == numpy twin on "
                  f"{n_checked} lines")
    return dev[0], dev[2], usable


def parity_correct_blocks(tag, words, valid, usable):
    """deinterleave.correct_blocks on the device vs its xp=np path (the
    native core) and the pure numpy reference, at both resolutions."""
    import jax
    import jax.numpy as jnp
    from sdvpcmdecoder_tpu.ops import deinterleave as di
    lw = words[usable].reshape(-1, 8).astype(np.int32)
    ok = np.repeat(valid[usable].reshape(-1, 1), 8, axis=1)
    n_blocks = lw.shape[0] - di.stc007.MIN_DEINT_DATA
    cb = jax.jit(di.correct_blocks, static_argnames=("resolution",))
    counts = []
    for res, rname in ((di.RES_14BIT, "14-bit"), (di.RES_16BIT, "16-bit")):
        bw, bc = di.assemble_blocks_contiguous(lw, ok, n_blocks, res, xp=np)
        dev = cb(jnp.asarray(bw), jnp.asarray(bc), resolution=res)
        refs = [("xp=np", di.correct_blocks(bw, bc, res, xp=np))]
        with numpy_reference_only():
            refs.append(("numpy", di.correct_blocks(bw, bc, res, xp=np)))
        for rtag, ref in refs:
            for field in di.BlockBatch._fields:
                check_equal(f"{tag} correct_blocks {rname} {field} vs "
                            f"{rtag}", getattr(dev, field),
                            getattr(ref, field))
        st = np.asarray(dev.audio_state)
        counts.append(f"{rname}: {n_blocks} blocks, "
                      f"{int((st == di.AUD_FIX_P).sum())} fixed by P, "
                      f"{int((st == di.AUD_FIX_Q).sum())} by Q, "
                      f"{int((st == di.AUD_BROKEN).sum())} broken")
    log("parity", f"{tag}: correct_blocks == xp=np and numpy reference "
                  f"({'; '.join(counts)})")


def parity_pcm(fmt, frames_fn, n_frames, noise, seed):
    """One ops.device_pcm round dispatch vs the native PCM grid."""
    import jax.numpy as jnp
    from sdvpcmdecoder_tpu.ops import device_pcm as dp
    from sdvpcmdecoder_tpu.ops import stitch_native as sn
    from sdvpcmdecoder_tpu.pipeline import ingest, v2d_other
    lines, _ = ingest.split_fields_batch(frames_fn(n_frames, seed, noise))
    F, L, W = lines.shape
    prep = v2d_other.PCMFrameDriver(fmt, shift_limit=SHIFT,
                                    hyst_limit=HYST).prepare_frames(lines)
    usable = prep["usable"]
    if usable.sum() * 2 < F:
        raise AssertionError(f"{fmt}: prescan found PCM in only "
                             f"{usable.sum()}/{F} frames")
    args = (prep["coords"].astype(np.int32),
            np.maximum(prep["refs"], 1).astype(np.int32),
            np.clip(prep["blacks"], 0, 254).astype(np.int32),
            np.clip(prep["whites"], 1, 255).astype(np.int32))
    layout, n_par = dp.round_param_layout(F)
    params = np.zeros(n_par, np.int32)
    for key, a in zip(("coords", "refs", "blacks", "whites", "usable"),
                      args + (usable,)):
        params[layout[key]:layout[key] + a.size] = np.ravel(a)
    buf = dp.pcm_round_packed(jnp.asarray(lines), jnp.asarray(params),
                              fmt=fmt, shift_limit=SHIFT, hyst_limit=HYST)
    dev = dp.unpack_round(np.asarray(buf), F, L, fmt)
    native = (sn.pcm1_binarize_frames if fmt == "pcm1"
              else sn.pcm16x0_binarize_frames)
    nat = native(lines, *args, SHIFT, HYST)
    names = ("words", "crc", "valid", "ctrl")
    for name, d, n in zip(names, dev, nat):
        if d is None:
            continue
        check_equal(f"{fmt} round {name} vs native", d[usable], n[usable])
        check_equal(f"{fmt} round {name} of unusable frames", d[~usable],
                    np.zeros_like(d[~usable]))
    v = dev[2][usable]
    log("parity", f"{fmt} noise {noise:g}: round dispatch {F}x{L}x{W} == "
                  f"native ({int(v.sum())}/{v.size} objects valid)")


def phase_parity(n_frames=64, n_numpy=256):
    """Phase 2.  Returns the noise-10 round for the timings."""
    from sdvpcmdecoder_tpu.ops import stitch_native as sn
    from sdvpcmdecoder_tpu.synth import captures
    if not sn.available():
        raise AssertionError("native core unavailable: no host reference")
    rounds = {}
    for noise, seed in ((10.0, 1), (30.0, 2)):
        tag = f"stc007 noise {noise:g}"
        rounds[noise] = stc007_round(n_frames, noise, seed)
        words, valid, usable = parity_stc007(tag, *rounds[noise], n_numpy)
        parity_correct_blocks(tag, words, valid, usable)
    for fmt, fn in (("pcm1", captures.pcm1_frames),
                    ("pcm16x0", captures.pcm16x0_frames)):
        for noise, seed in ((10.0, 3), (30.0, 4)):
            parity_pcm(fmt, fn, n_frames, noise, seed)
    return rounds[10.0]


# -- phase 3 ------------------------------------------------------------------
NOISY = 30.0    # sigma of the noisy half of every phase-3 fleet


def fleet_jobs(workdir, frames_fn, n_caps, n_frames, seed0, prefix):
    """n_caps captures; the second half carry sigma-30 noise, so the WAV
    comparison also covers the host re-read of failed lines, the P/Q
    correction and the replay's fall-back from the device round to the
    native tail and the full stage machine."""
    from sdvpcmdecoder_tpu.synth import captures
    n_noisy = n_caps // 2
    return (captures.write_captures(workdir, frames_fn, n_caps - n_noisy,
                                    n_frames, seed0=seed0, prefix=prefix)
            + captures.write_captures(workdir, frames_fn, n_noisy,
                                      n_frames, seed0=seed0 + 50,
                                      prefix=f"{prefix}noisy",
                                      noise_sigma=NOISY))


def decode_counts(dec, stats):
    """Summed over a run's captures: block fixes and failures, frames
    re-read on the host, and frame pairs per stitch path."""
    total = {k: sum(getattr(s, k) for s in stats)
             for k in ("lines_valid", "lines_total", "frames_line_fallback",
                       "blocks_fix_p", "blocks_fix_q", "blocks_broken")}
    paths = Counter()
    for j in dec.jobs:
        paths.update(getattr(j.stitcher, "pair_paths", {}))
    total["pair_paths"] = dict(sorted(paths.items()))
    return total


def counts_text(c):
    paths = (f", pairs by stitch path {c['pair_paths']}"
             if c["pair_paths"] else "")
    return (f"{c['lines_valid']}/{c['lines_total']} lines valid, "
            f"{c['frames_line_fallback']} frames re-read on the host, "
            f"{c['blocks_fix_p']} blocks fixed by P, {c['blocks_fix_q']} "
            f"by Q, {c['blocks_broken']} broken{paths}")


def _wavs(jobs):
    return [open(o, "rb").read() for _, o in jobs]


def _same_wavs(what, got, want):
    if not all(len(w) > 44 for w in want):
        raise AssertionError(f"{what}: native engine wrote no audio")
    if got != want:
        bad = [k for k, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"{what}: WAVs {bad} differ from native")


def phase_e2e(card, workdir, cli_frames=600, fleet=(8, 128), pcm=(4, 48)):
    import jax
    from sdvpcmdecoder_tpu.__main__ import main as cli
    from sdvpcmdecoder_tpu.pipeline import (batch_driver, device_driver,
                                            device_pcm, ingest)
    from sdvpcmdecoder_tpu.synth import captures
    dev0 = jax.devices()[0]

    cap = os.path.join(workdir, "long.y4m")
    ingest.write_y4m(cap, captures.stc007_pal_frames(cli_frames, 11))
    # The device backend runs twice: the first run compiles, the second
    # finds every program compiled.
    wavs = {"device": [], "native": []}
    for k, be in enumerate(("device", "device", "native")):
        wav_path = os.path.join(workdir, f"long{k}.{be}.wav")
        with compile_log() as compiles:
            t0 = time.perf_counter()
            rc = cli([cap, "-o", wav_path, "--backend", be])
            dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"CLI --backend {be} exited {rc}")
        wavs[be].append(open(wav_path, "rb").read())
        log("e2e", f"CLI --backend {be}: {cli_frames} PAL frames in "
                   f"{dt:.3f} s = {cli_frames / dt:.1f} frames/s incl. "
                   f"staging; {len(compiles)} XLA compiles took "
                   f"{sum(compiles):.3f} s of it | peak_bytes_in_use "
                   f"{peak_bytes(dev0)} | {card}")
    _same_wavs(f"CLI {cli_frames}-frame capture", wavs["device"],
               wavs["native"] * 2)
    log("e2e", f"CLI --backend device WAV == --backend native WAV "
               f"({len(wavs['native'][0])} bytes)")

    def run(tag, jobs, make):
        jobs = [(p, f"{o[:-4]}.{tag}.wav") for p, o in jobs]
        t0 = time.perf_counter()
        dec = make(jobs)
        t1 = time.perf_counter()
        stats = list(dec.run().values())
        t2 = time.perf_counter()
        return _wavs(jobs), t1 - t0, t2 - t1, decode_counts(dec, stats)

    def compare(what, make_dev, make_nat, jobs):
        for tag in ("warm", "dev"):   # the first run compiles
            dev, stage_s, run_s, counts = run(tag, jobs, make_dev)
        nat, _, nat_s, nat_counts = run("nat", jobs, make_nat)
        _same_wavs(what, dev, nat)
        for k in ("blocks_fix_p", "blocks_fix_q", "blocks_broken"):
            check_equal(f"{what} {k}", counts[k], nat_counts[k])
        total = len(jobs) * n_frames
        log("e2e", f"{what}: {total / run_s:.1f} frames/s, staging "
                   f"{stage_s:.3f} s, native engine {total / nat_s:.1f} "
                   f"frames/s, WAVs identical; device engine "
                   f"{counts_text(counts)} | peak_bytes_in_use "
                   f"{peak_bytes(dev0)} | {card}")
        return counts

    n_caps, n_frames = fleet
    jobs = fleet_jobs(workdir, captures.stc007_pal_frames, n_caps,
                      n_frames, 0, "fleet")
    kw = dict(hyst_limit=HYST, shift_limit=SHIFT, frames_per_round=64)
    counts = compare(
        f"DeviceBatchDecoder {n_caps}x{n_frames} PAL frames ({n_caps // 2} "
        f"at noise {NOISY:g}), 64 per round",
        lambda j: device_driver.DeviceBatchDecoder(j, **kw),
        lambda j: batch_driver.BatchDecoder(j, backend="native", **kw),
        jobs)
    paths = counts["pair_paths"]
    replayed = paths.get("spec_round", 0) + paths.get("spec_tail", 0)
    fell_back = paths.get("native_tail", 0) + paths.get("stage_machine", 0)
    if not (replayed and fell_back and counts["frames_line_fallback"]
            and counts["blocks_fix_p"] and counts["blocks_fix_q"]):
        raise AssertionError("the noisy fleet missed a decode path: "
                             + counts_text(counts))

    n_caps, n_frames = pcm
    for fmt, fn, seed0 in (("pcm1", captures.pcm1_frames, 200),
                           ("pcm16x0", captures.pcm16x0_frames, 300)):
        jobs = fleet_jobs(workdir, fn, n_caps, n_frames, seed0, fmt)
        kw = dict(fmt=fmt, hyst_limit=2, shift_limit=1,
                  frames_per_round=16)
        counts = compare(
            f"DevicePCMBatchDecoder {fmt} {n_caps}x{n_frames} frames "
            f"({n_caps // 2} at noise {NOISY:g})",
            lambda j: device_pcm.DevicePCMBatchDecoder(j, **kw),
            lambda j: batch_driver.BatchDecoder(j, backend="native", **kw),
            jobs)
        if not counts["frames_line_fallback"]:
            raise AssertionError(f"the noisy {fmt} fleet re-read no line "
                                 f"on the host: {counts_text(counts)}")


# -- phase 4 ------------------------------------------------------------------
def phase_timings(card, stc_round, n=20):
    """Device time of the XLA trial grid (what the removed fused kernel
    replaced), of the whole steady_round_packed dispatch, and of the
    int32 GF(2) products inside the P/Q correction."""
    import jax
    import jax.numpy as jnp
    from sdvpcmdecoder_tpu.formats import stc007
    from sdvpcmdecoder_tpu.ops import binarize as bz
    from sdvpcmdecoder_tpu.ops import deinterleave as di
    from sdvpcmdecoder_tpu.ops import device_stitch as ds
    from sdvpcmdecoder_tpu.pipeline import device_driver
    lines, (coords, refs, blacks, whites), usable = stc_round
    F, Ls, W = lines.shape
    px = jnp.asarray(lines)
    p = [jnp.asarray(a) for a in (coords, refs, blacks, whites)]
    t_grid = median_seconds(lambda: bz.stc007_frame_decode(
        px, *p, hyst_limit=HYST, shift_limit=SHIFT), n)

    lpf = Ls // 2
    rows = device_driver._RoundRows(F, lpf, 0, 0, 0, lpf, True)
    layout, n_par = ds.round_param_layout(F)
    params = np.zeros(n_par, np.int32)
    for key, a in (("coords", coords), ("refs", refs), ("blacks", blacks),
                   ("whites", whites), ("usable", usable),
                   ("pred_mode", [di.RES_MODE_14BIT]), ("unch_lim", [3])):
        a = np.ravel(a)
        params[layout[key]:layout[key] + a.size] = a
    params = jnp.asarray(params)
    zw = jnp.zeros((Ls, 8), jnp.int32)
    zo = jnp.zeros((Ls, 8), bool)
    cw = jnp.zeros((stc007.MIN_DEINT_DATA, 8), jnp.int32)
    co = jnp.zeros((stc007.MIN_DEINT_DATA, 8), bool)
    silent = jnp.asarray(stc007.silent_words(xp=np))
    t_round = median_seconds(lambda: ds.steady_round_packed(
        px, params, zw, zo, cw, co, rows.carry_next_rows, rows.g1, rows.g2,
        rows.nb_seam, silent, B_conv=rows.B_conv, en_p=True, en_q=True,
        m2=False, hyst_limit=HYST, shift_limit=SHIFT), n)

    out = bz.stc007_frame_decode(px, *p, hyst_limit=HYST,
                                 shift_limit=SHIFT)
    lw = out.words.reshape(-1, 8)
    ok = jnp.repeat(out.valid.reshape(-1, 1), 8, axis=1)
    n_blocks = lw.shape[0] - stc007.MIN_DEINT_DATA
    cb = jax.jit(lambda w, c, res: di.correct_blocks(
        *di.assemble_blocks_contiguous(w, c, n_blocks, res), res),
        static_argnums=2)
    t_cb = {res: median_seconds(lambda: cb(lw, ok, res), n)
            for res in (di.RES_14BIT, di.RES_16BIT)}
    log("timings", f"{F} frames x {Ls} lines x {W} px, hyst {HYST} / shift "
                   f"{SHIFT}, median of {n}: XLA trial grid "
                   f"{t_grid * 1e3:.3f} ms ({F / t_grid:.1f} frames/s); "
                   f"whole steady_round_packed {t_round * 1e3:.3f} ms "
                   f"({F / t_round:.1f} frames/s); P/Q correction "
                   f"({n_blocks} blocks) 14-bit "
                   f"{t_cb[di.RES_14BIT] * 1e3:.3f} ms, 16-bit "
                   f"{t_cb[di.RES_16BIT] * 1e3:.3f} ms | {card}")


# -- four cards ---------------------------------------------------------------
def phase_four_cards(devs, card, workdir, n_caps=8, n_frames=32,
                     mesh_chunk=4 * 588):
    """ShardedBatchDecoder(device_resident=True) over the cards against a
    1-card run, and mesh.multichip_decode_step on a (2 data x 2 seq)
    mesh against the single-device decode."""
    import jax
    import jax.numpy as jnp
    from sdvpcmdecoder_tpu.parallel import mesh as pm
    from sdvpcmdecoder_tpu.parallel.multichip import ShardedBatchDecoder
    from sdvpcmdecoder_tpu.pipeline import decoder, device_driver
    from sdvpcmdecoder_tpu.synth import captures, encoder as enc

    jobs = captures.write_captures(workdir, captures.stc007_pal_frames,
                                   n_caps, n_frames, prefix="shard")
    kw = dict(hyst_limit=HYST, shift_limit=SHIFT, frames_per_round=16)
    sh_jobs = [(p, f"{o[:-4]}.sharded.wav") for p, o in jobs]
    t0 = time.perf_counter()
    ShardedBatchDecoder(sh_jobs, devices=devs, device_resident=True,
                        **kw).run()
    t_sh = time.perf_counter() - t0
    peaks = [peak_bytes(d) for d in devs]
    one_jobs = [(p, f"{o[:-4]}.one.wav") for p, o in jobs]
    t0 = time.perf_counter()
    with jax.default_device(devs[0]):
        device_driver.DeviceBatchDecoder(one_jobs, **kw).run()
    t_one = time.perf_counter() - t0
    _same_wavs(f"{len(devs)}-card sharded fleet", _wavs(sh_jobs),
               _wavs(one_jobs))
    if devs[0].platform == "gpu" and not all(peaks):
        raise AssertionError(f"a card did no work: peak bytes {peaks}")
    log("4-card", f"ShardedBatchDecoder(device_resident=True) "
                  f"{n_caps}x{n_frames} PAL frames over {len(devs)} cards "
                  f"({t_sh:.3f} s incl. compile) == 1-card run "
                  f"({t_one:.3f} s) byte for byte | peak_bytes_in_use per "
                  f"card {peaks} | {card}")

    mesh = pm.decode_mesh(len(devs), seq=2)
    D, S = mesh.devices.shape
    n_lines = S * mesh_chunk + pm.HALO
    rng = np.random.default_rng(5)
    full, chunks = [], []
    for _ in range(D):
        n = 3 * n_lines
        px, cd, *_ = enc.encode_stream(
            rng.integers(1, 1 << 14, n), rng.integers(1, 1 << 14, n),
            width=captures.PAL_WIDTH, ppb=8.0, n_lines=n_lines,
            noise_sigma=10.0, rng=rng)
        full.append((px, cd))
        chunks.append((pm.chunk_lines_with_halo(px, S)[0],
                       pm.chunk_lines_with_halo(cd, S)[0]))
    px = np.stack([c[0] for c in chunks])
    cd = np.stack([c[1] for c in chunks]).astype(np.int32)
    lv = np.full(px.shape[:3], 110, np.int32)
    bk = np.full(px.shape[:3], 20, np.int32)
    wt = np.full(px.shape[:3], 200, np.int32)
    step = pm.multichip_decode_step(mesh, hyst_limit=HYST,
                                    shift_limit=SHIFT)
    gathered, n_valid = step(*(pm.shard_captures(a, mesh)
                               for a in (px, cd, lv, bk, wt)))
    gathered = np.asarray(gathered)

    def single(p, c):
        n = p.shape[0]
        with jax.default_device(devs[0]):
            return decoder.decode_stream(
                jnp.asarray(p), jnp.asarray(c, jnp.int32),
                jnp.full(n, 110, jnp.int32), jnp.full(n, 20, jnp.int32),
                jnp.full(n, 200, jnp.int32), hyst_limit=HYST,
                shift_limit=SHIFT)

    want_valid = sum(int(np.asarray(single(px[d, s], cd[d, s])
                                    .line_valid).sum())
                     for d in range(D) for s in range(S))
    check_equal("mesh psum of valid lines", np.asarray(n_valid).ravel()[0],
                want_valid)
    for d in range(D):
        ref = np.asarray(single(*full[d]).samples)
        stitched = np.concatenate([gathered[d, 0, s, :3 * mesh_chunk]
                                   for s in range(S)])
        check_equal(f"mesh capture {d} samples", stitched,
                    ref[:len(stitched)])
    log("4-card", f"multichip_decode_step on a ({D} data x {S} seq) mesh, "
                  f"{D} captures x {n_lines} lines == single-device decode "
                  f"({want_valid} valid lines) | peak_bytes_in_use per "
                  f"card {[peak_bytes(d) for d in devs]} | {card}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card phase (sharded drivers and "
                         "the data x seq mesh)")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    devs, card = phase_device(n_cards)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four_cards:
            phase_four_cards(devs[:4], card, tmp)
        else:
            stc_round = phase_parity()
            phase_e2e(card, tmp)
            phase_timings(card, stc_round)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

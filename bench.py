#!/usr/bin/env python
"""Headline benchmark: STC-007 PAL end-to-end decode on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
Baseline = the reference's realtime watermark (~25 fps PAL on one x86 core;
renderpcm.h:76-80 pacing, BASELINE.md).

Two numbers are measured:
  * stc007_pal_e2e_frames_per_sec (the headline): 8 concurrent synthetic
    PAL captures through the FULL pipeline — Y4M ingest, V2D prescan +
    batched trial-grid binarize, host stitcher (padding search,
    field order/res detection), P/Q ECC, audio masking, WAV out
    (pipeline/batch_driver.py, BASELINE config 5).
  * device_decode_frames_per_sec (extra): the device-only binarize +
    deinterleave chain (chained dispatches, one scalar readback), the
    round-1 metric.

The device benches run in one child process (the only JAX process on
the card); the parent stays on JAX_PLATFORMS=cpu for the host cells.  A
device phase that fails, or finds no GPU, makes the whole run exit
non-zero.  The warm-up pass populates the persistent XLA compile cache
(utils/jaxcache.py).
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from sdvpcmdecoder_tpu.synth import captures
from sdvpcmdecoder_tpu.utils import jaxcache

BASELINE_FPS = 25.0  # reference realtime watermark (PAL), BASELINE.md
PAL_FIELD_LINES = captures.PAL_FIELD_LINES
PAL_LINES_PER_FRAME = 2 * PAL_FIELD_LINES
WIDTH = captures.PAL_WIDTH


def device_only_fps():
    import jax
    import jax.numpy as jnp
    from sdvpcmdecoder_tpu.synth import encoder as enc
    from sdvpcmdecoder_tpu.pipeline import decoder

    frames_per_call = int(os.environ.get("BENCH_FRAMES", "128"))
    n_lines = frames_per_call * PAL_LINES_PER_FRAME
    rng = np.random.default_rng(0)
    n_samp = 3 * n_lines
    left = rng.integers(0, 1 << 14, size=n_samp)
    right = rng.integers(0, 1 << 14, size=n_samp)
    pixels, coords, *_ = enc.encode_stream(
        left, right, width=WIDTH, ppb=8.0, n_lines=n_lines,
        noise_sigma=10.0, rng=rng)

    px = jnp.asarray(pixels.reshape(frames_per_call, PAL_LINES_PER_FRAME,
                                    WIDTH))
    cd = jnp.asarray(coords[::PAL_LINES_PER_FRAME], jnp.int32)
    F = frames_per_call
    ref = jnp.full((F,), 110, jnp.int32)
    blk = jnp.full((F,), 20, jnp.int32)
    wht = jnp.full((F,), 200, jnp.int32)
    kw = dict(hyst_limit=4, shift_limit=2)  # NORMAL-mode-like limits

    def step(px_in, carry):
        # Chain the previous result into the input so every step truly
        # serializes on device (carry & 0 == 0, but XLA can't elide the
        # data dependency across dispatches).
        pxx = px_in ^ (carry & 0).astype(jnp.uint8)
        out = decoder.decode_frames(pxx, cd, ref, blk, wht, **kw)
        return (jnp.sum(out.samples.astype(jnp.int32))
                + jnp.sum(out.line_valid.astype(jnp.int32)))

    step_j = jax.jit(step)
    carry = jnp.int32(0)
    carry = step_j(px, carry)
    _ = float(carry)  # warm-up: compile + execute

    n_iter = int(os.environ.get("BENCH_ITERS", "20"))
    t0 = time.perf_counter()
    for _ in range(n_iter):
        carry = step_j(px, carry)
    total = float(carry)  # one readback drains the chained queue
    dt = time.perf_counter() - t0
    return frames_per_call * n_iter / dt


def device_smoke():
    """Seconds-fast sanity pass of the chip-resident driver (2 captures
    x 8 frames through DeviceBatchDecoder, WAV-identical to native), so
    a broken flagship fails before the long benches.  Raises on any
    failure."""
    from sdvpcmdecoder_tpu.pipeline import batch_driver, device_driver
    with tempfile.TemporaryDirectory() as tmp:
        jobs = make_captures(tmp, 2, 8)

        def run(tag, cls, **kw):
            dec = cls(jobs, hyst_limit=4, shift_limit=2,
                      frames_per_round=4, **kw)
            for k, j in enumerate(dec.jobs):
                j.out_path = os.path.join(tmp, f"{tag}{k}.wav")
            dec.run()
            return [open(j.out_path, "rb").read() for j in dec.jobs]

        dev = run("d", device_driver.DeviceBatchDecoder)
        nat = run("n", batch_driver.BatchDecoder, backend="native")
        if dev != nat:
            raise AssertionError("device smoke WAVs differ from native")


def _med_cv(vals):
    med = float(np.median(vals))
    cv = float(np.std(vals) / np.mean(vals)) if len(vals) > 1 else 0.0
    return round(med, 2), round(cv, 3)


def device_e2e_fps():
    """Chip-resident e2e: pixels staged in HBM once, the full decode
    (binarize + seam scoring + deinterleave/ECC + sample assembly) runs
    as one fused dispatch per round (pipeline/device_driver), samples
    and stats come back in KB/frame, host writes the WAV.  Returns the
    fps median/best/CV and staging seconds; raises when a WAV differs
    from the native engine's."""
    import tempfile
    from sdvpcmdecoder_tpu.pipeline import batch_driver, device_driver

    n_caps = int(os.environ.get("BENCH_E2E_CAPS", "8"))
    n_frames = int(os.environ.get("BENCH_DEV_FRAMES", "128"))
    with tempfile.TemporaryDirectory() as tmp:
        jobs = make_captures(tmp, n_caps, n_frames)

        def run(tag, cls, **kw):
            t0 = time.perf_counter()
            dec = cls(jobs, hyst_limit=4, shift_limit=2,
                      frames_per_round=64, **kw)
            stage_s = time.perf_counter() - t0
            for k, j in enumerate(dec.jobs):
                j.out_path = os.path.join(tmp, f"{tag}{k}.wav")
            t0 = time.perf_counter()
            dec.run()
            fps = n_caps * n_frames / (time.perf_counter() - t0)
            return fps, stage_s, [open(j.out_path, "rb").read()
                                  for j in dec.jobs]

        run("w", device_driver.DeviceBatchDecoder)  # compile warm-up
        best, stage_s, dev_wavs, fpss = 0.0, 0.0, None, []
        for t in "abc":
            fps, ss, wavs = run(t, device_driver.DeviceBatchDecoder)
            fpss.append(fps)
            if fps > best:
                best, stage_s, dev_wavs = fps, ss, wavs
        _, _, nat_wavs = run("n", batch_driver.BatchDecoder,
                             backend="native")
        if dev_wavs != nat_wavs:
            raise AssertionError("device e2e WAVs differ from native")
        med, cv = _med_cv(fpss)
        return dict(best=round(best, 2), median=med, cv=cv,
                    staging_seconds=round(stage_s, 3))


def device_pcm_fps(fmt, make, n_caps=4, n_frames=48):
    """Chip-resident PCM-1/16x0 e2e (pipeline/device_pcm): fps median
    over 3 runs; raises unless the WAVs equal the native batch driver's.
    48 frames per capture keep the per-capture warm-up from dominating
    the steady rate this measures."""
    from sdvpcmdecoder_tpu.pipeline import batch_driver, device_pcm
    with tempfile.TemporaryDirectory() as tmp:
        jobs = make(tmp, n_caps, n_frames)

        def run(tag, cls, **kw):
            # hyst_limit pinned for BOTH engines: the class defaults
            # differ (DevicePCMBatchDecoder 0 vs BatchDecoder 2), and a
            # mismatch would invalidate the WAV-identity check below.
            dec = cls(jobs, hyst_limit=2, shift_limit=1,
                      frames_per_round=16, fmt=fmt, **kw)
            for k, j in enumerate(dec.jobs):
                j.out_path = os.path.join(tmp, f"{fmt}{tag}{k}.wav")
            t0 = time.perf_counter()
            dec.run()
            fps = n_caps * n_frames / (time.perf_counter() - t0)
            return fps, [open(j.out_path, "rb").read()
                         for j in dec.jobs]

        run("w", device_pcm.DevicePCMBatchDecoder)   # warm-up
        fpss, wavs = [], None
        for t in "abc":
            fps, wavs = run(t, device_pcm.DevicePCMBatchDecoder)
            fpss.append(fps)
        _, nat = run("n", batch_driver.BatchDecoder, backend="native")
        if wavs != nat:
            raise AssertionError(f"device {fmt} WAVs differ from native")
        med, cv = _med_cv(fpss)
        return dict(median=med, cv=cv)


def make_captures(tmp, n_caps, n_frames):
    return captures.write_captures(tmp, captures.stc007_pal_frames,
                                   n_caps, n_frames)


def e2e_fps(tmp):
    from sdvpcmdecoder_tpu.pipeline import batch_driver
    n_caps = int(os.environ.get("BENCH_E2E_CAPS", "8"))
    n_frames = int(os.environ.get("BENCH_E2E_FRAMES", "32"))
    jobs = make_captures(tmp, n_caps, n_frames)
    stage = {}

    def run(tag, record=True):
        dec = batch_driver.BatchDecoder(jobs, hyst_limit=4, shift_limit=2,
                                        frames_per_round=16)
        for k, j in enumerate(dec.jobs):
            j.out_path = os.path.join(tmp, f"out_{tag}_{k}.wav")
        t0 = time.perf_counter()
        dec.run()
        fps = n_caps * n_frames / (time.perf_counter() - t0)
        # Only measured runs feed the stage table, so the reported
        # breakdown always belongs to the run behind the headline fps.
        if record and fps > stage.get("_fps", 0.0):
            stage.clear()
            stage.update({k: round(v, 4) for k, v in dec.stage_t.items()})
            stage["_fps"] = fps
            stage["_backend"] = dec.backend
        return fps

    run("warm", record=False)          # compile / cache warm-up
    # Median-of-5 is the recorded number (this 1-core host shows big
    # run-to-run noise; a best-of hides regressions); best + CV ride
    # along so round-over-round comparisons carry their error bars.
    fpss = [run(t) for t in "abcde"]
    med, cv = _med_cv(fpss)
    backend = stage.pop("_backend", "?")
    stage.pop("_fps", None)
    return dict(median=med, cv=cv, best=round(max(fpss), 2),
                backend=backend, stage=stage)


def make_pcm1_captures(tmp, n_caps, n_frames):
    return captures.write_captures(tmp, captures.pcm1_frames, n_caps,
                                   n_frames, seed0=200, prefix="p1_")


def make_pcm16x0_captures(tmp, n_caps, n_frames):
    return captures.write_captures(tmp, captures.pcm16x0_frames, n_caps,
                                   n_frames, seed0=300, prefix="p16_")


def other_fmt_fps(tmp, fmt, make, n_caps=4, n_frames=24):
    # 24 frames/capture: the per-capture coordinate-search warm-up (2
    # searched frames before the agreement skip engages) stops dominating
    # the steady-state rate it is supposed to measure.
    from sdvpcmdecoder_tpu.pipeline import batch_driver
    jobs = make(tmp, n_caps, n_frames)

    def run(tag):
        dec = batch_driver.BatchDecoder(jobs, shift_limit=1,
                                        frames_per_round=8, fmt=fmt)
        for k, j in enumerate(dec.jobs):
            j.out_path = os.path.join(tmp, f"{fmt}_{tag}_{k}.wav")
        t0 = time.perf_counter()
        dec.run()
        return n_caps * n_frames / (time.perf_counter() - t0)

    run("warm")
    return max(run(t) for t in "abcde")


def device_fps_subprocess(timeout=1800, env=None):
    """Run the device benches in one child process with a hard timeout
    (the parent never touches the card).  Returns the child's JSON
    dict; a failed, timed-out or non-GPU child raises SystemExit."""
    import subprocess
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--device-bench"],
            capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        raise SystemExit("device bench timed out")
    if r.returncode != 0:
        sys.stderr.write(r.stderr)
        raise SystemExit(f"device bench failed (rc {r.returncode})")
    try:
        return json.loads(r.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        raise SystemExit("device bench produced no JSON")


def device_info():
    """platform / device_kind / count of the card; exits non-zero when
    JAX finds no GPU (no CPU fallback for device numbers)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {devs[0].platform!r}")
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind, "device_count": len(devs)}


def main():
    if "--device-only" in sys.argv:
        jaxcache.enable()
        info = device_info()
        print(json.dumps(dict(info, device_decode_frames_per_sec=round(
            device_only_fps(), 2))))
        return
    if "--device-bench" in sys.argv:
        jaxcache.enable()
        out = device_info()
        device_smoke()
        dev = device_only_fps()
        e2e = device_e2e_fps()
        out.update({
            "device_decode_frames_per_sec": round(dev, 2),
            "device_e2e_frames_per_sec": e2e["median"],
            "device_e2e_best_frames_per_sec": e2e["best"],
            "device_e2e_cv": e2e["cv"],
            "device_e2e_staging_seconds": e2e["staging_seconds"],
        })
        p1 = device_pcm_fps("pcm1", make_pcm1_captures)
        p16 = device_pcm_fps("pcm16x0", make_pcm16x0_captures)
        out.update({
            "device_pcm1_e2e_frames_per_sec": p1["median"],
            "device_pcm1_e2e_cv": p1["cv"],
            "device_pcm16x0_e2e_frames_per_sec": p16["median"],
            "device_pcm16x0_e2e_cv": p16["cv"],
        })
        print(json.dumps(out))
        return
    # The host cells run in this process on the CPU backend; the device
    # child gets the original environment and is the one process on
    # the card.
    device_env = dict(os.environ)
    os.environ["JAX_PLATFORMS"] = "cpu"
    jaxcache.enable()
    dev_fps = device_fps_subprocess(env=device_env)
    with tempfile.TemporaryDirectory() as tmp:
        host = e2e_fps(tmp)
        p1_fps = other_fmt_fps(tmp, "pcm1", make_pcm1_captures)
        p16_fps = other_fmt_fps(tmp, "pcm16x0", make_pcm16x0_captures)
    extra = {"pcm1_e2e_frames_per_sec": round(p1_fps, 2),
             "pcm16x0_e2e_frames_per_sec": round(p16_fps, 2),
             "host_e2e_frames_per_sec": host["median"],
             "host_e2e_best_frames_per_sec": host["best"],
             "host_e2e_cv": host["cv"],
             "host_backend": host["backend"],
             "stage_seconds": host["stage"],
             "e2e_scope": "y4m ingest + v2d prescan + trial-grid "
                          "binarize + host stitch + P/Q ECC + audio "
                          "mask + wav, 8 concurrent captures"}
    extra.update(dev_fps)
    # Headline: the better full-pipeline e2e of the two engines (the
    # device child exits non-zero unless its WAVs equal the native
    # engine's).  Both are medians with CV recorded in extra.
    fps, backend = host["median"], host["backend"]
    dev_e2e = dev_fps["device_e2e_frames_per_sec"]
    if dev_e2e > fps:
        fps, backend = dev_e2e, "device"
    extra["backend"] = backend
    print(json.dumps({
        "metric": "stc007_pal_e2e_frames_per_sec",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()

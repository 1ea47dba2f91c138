"""CLI: decode PCM-adapter captures to WAV.

    python -m sdvpcmdecoder_tpu input.y4m -o out.wav [--format stc007]

The batch-decoder equivalent of the reference desktop app's decode flow
(open video -> binarize -> reassemble -> mask -> WAV) with the work-log
style per-frame stats print (mainwindow.h:108-194 analog).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="sdvpcmdecoder_tpu",
        description="Decoder for PCM adapter audio on video captures "
                    "(STC-007/PCM-F1/M2, PCM-1, PCM-16x0), with the "
                    "trial-grid decode on an accelerator or the host")
    p.add_argument("input", help="input capture (.y4m or raw gray8)")
    p.add_argument("-o", "--output", default=None, help="output WAV path")
    p.add_argument("--format", default="stc007",
                   choices=["stc007", "m2", "pcm1", "pcm16x0",
                            "pcm1630", "arvid", "auto"],
                   help="PCM format (default stc007; auto probes the "
                        "capture's format signature; arvid is the "
                        "prototype word-dump path, no audio out — "
                        "matching the reference's debug-only support)")
    p.add_argument("--raw-size", default=None,
                   help="WxH for raw input, e.g. 1152x588")
    p.add_argument("--standard", default="auto",
                   choices=["auto", "pal", "ntsc"])
    p.add_argument("--field-order", default="auto",
                   choices=["auto", "tff", "bff"])
    p.add_argument("--resolution", default="auto",
                   choices=["auto", "14bit", "16bit"])
    p.add_argument("--mask", default="interpolate",
                   choices=["ignore", "mute", "hold", "interpolate"])
    p.add_argument("--mask-scope", default="word", choices=["word", "block"])
    p.add_argument("--quality", default="normal",
                   choices=["draft", "fast", "normal", "insane"],
                   help="binarization effort (hysteresis/shift limits)")
    p.add_argument("--sample-rate", default=0, type=int,
                   choices=[0, 44100, 44056],
                   help="force output sample rate (0 = by standard)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file: save stitcher state every "
                        "batch; if it exists, resume the decode from it")
    p.add_argument("--render-dir", default=None,
                   help="write per-frame PCM visualization PPMs "
                        "(RenderPCM analog) into this directory")
    p.add_argument("--force-coords", default=None, metavar="START:STOP",
                   help="force horizontal data coordinates in pixels, "
                        "skipping marker search (bin_preset "
                        "en_force_coords)")
    p.add_argument("--no-ecc", action="store_true",
                   help="disable P/Q error correction")
    p.add_argument("--cwd", action="store_true",
                   help="enable Cross-Word-Decoding assist")
    p.add_argument("--frames", type=int, default=None,
                   help="limit number of frames")
    p.add_argument("--batch", type=int, default=16,
                   help="frames per device batch")
    p.add_argument("--stats", action="store_true",
                   help="print per-frame work log")
    p.add_argument("--dump-lines", type=int, default=0, metavar="N",
                   help="print the first N decoded lines of every frame "
                        "as CRC-annotated bit dumps (dumpWordsString "
                        "analog, pcmline.h DUMP_* legend)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "native", "tpu", "device"],
                   help="binarizer backend: 'native', the in-place host "
                        "trial grid; 'tpu', the streaming accelerator "
                        "grid (pixels sent to the device every batch); "
                        "'auto' (default), native when its C++ core "
                        "builds, else the accelerator grid; or 'device', "
                        "the chip-resident drivers (pixels staged in "
                        "device-memory chunks, one fused dispatch per "
                        "round; pipeline/device_driver, device_pcm)")
    p.add_argument("--per-line-agc", action="store_true",
                   help="per-LINE black/white/reference via the "
                        "format-aware histogram AGC (findSTC007BW) "
                        "instead of one frame-level AGC from 4 sampled "
                        "lines; tracks brightness drift (head switching, "
                        "AGC pumping)")
    p.add_argument("--live-audio", default=None, metavar="SINK",
                   help="also stream decoded audio live (SamplesToAudio "
                        "analog): 'alsa[:device]', '-' for raw s16le on "
                        "stdout, or a path/FIFO (pipe to `aplay -f cd`)")
    return p


def _ensure_decodable_input(args):
    """Auto-transcode non-Y4M/raw containers through FFmpeg (the
    reference opens any FFmpeg-decodable input, ffmpegwrapper.cpp:543
    slotOpenInput) with the `.pts` drop sidecar harvested from container
    timestamps.  Returns the path to decode or None on failure."""
    src = args.input
    if src.lower().endswith(".y4m") or args.raw_size:
        return src
    from .pipeline import ingest
    if ingest._is_stream(src):
        return src  # live FIFO/device: StreamReader pulls it directly
    if src.lower().endswith((".avi", ".mkv", ".mka", ".webm")):
        # AVI and Matroska decode in-process (pipeline/avi.py,
        # pipeline/mkv.py) unless the codec is outside the built-in
        # set, in which case fall through to the FFmpeg transcode path.
        from .pipeline import avi
        try:
            with ingest.open_capture(src) as rd:
                if rd.dropped_frames:
                    print(f"capture: {rd.dropped_frames} dropped "
                          "frames re-inserted from the container index")
            return src
        except avi.AVIError as e:
            print(f"in-process container decode unavailable ({e}); "
                  "trying FFmpeg transcode", file=sys.stderr)
    import os
    import tempfile
    from .pipeline import ingest
    dst = os.path.join(tempfile.mkdtemp(prefix="sdvpcm_"),
                       os.path.basename(src).rsplit(".", 1)[0] + ".y4m")
    try:
        drops = ingest.transcode_with_ffmpeg(src, dst)
    except FileNotFoundError as e:
        print(f"error: cannot open {src!r}: {e}", file=sys.stderr)
        return None
    except Exception as e:
        print(f"error: FFmpeg transcode of {src!r} failed: {e}",
              file=sys.stderr)
        return None
    print(f"transcoded {src} -> {dst} ({drops} dropped frames "
          f"re-inserted via .pts sidecar)")
    return dst



def _decode_device(args, raw_size, mask_map, hyst, shift, out_path):
    """--backend device: the chip-resident batch drivers through the
    single-capture CLI — pixels staged into HBM in bounded chunks, one
    fused dispatch per round (pipeline/device_driver.DeviceBatchDecoder
    for STC-007/M2, pipeline/device_pcm.DevicePCMBatchDecoder for
    PCM-1/16x0)."""
    unsupported = [flag for flag, on in (
        ("--raw-size", bool(raw_size)),
        ("--no-ecc", args.no_ecc), ("--cwd", args.cwd),
        ("--render-dir", bool(args.render_dir)),
        ("--frames", args.frames is not None),
        ("--force-coords", bool(args.force_coords)),
        ("--live-audio", args.live_audio is not None),
        ("--checkpoint", bool(args.checkpoint)),
        ("--dump-lines", bool(args.dump_lines)),
        ("--stats", args.stats)) if on]
    if args.format not in ("stc007", "m2"):
        # the PCM device drivers run their own fixed stage machines;
        # reject rather than silently ignore these
        unsupported += [flag for flag, on in (
            ("--standard", args.standard != "auto"),
            ("--field-order", args.field_order != "auto"),
            ("--resolution", args.resolution != "auto"),
            ("--sample-rate", bool(args.sample_rate)),
            ("--per-line-agc", args.per_line_agc)) if on]
    if args.format == "arvid" or unsupported:
        why = "arvid format" if args.format == "arvid" else \
            " ".join(unsupported)
        print(f"error: --backend device does not support {why}; "
              "use --backend auto/native/tpu", file=sys.stderr)
        return 2
    mask_mode = mask_map[(args.mask, args.mask_scope)]
    t0 = time.perf_counter()
    jobs = [(args.input, out_path)]
    if args.format in ("stc007", "m2"):
        from .pipeline import device_driver
        from .pipeline import stitcher_stc007 as st
        # lines_per_field=None: derived from the driver's own reader —
        # opening the input here just to read the height would consume
        # a FIFO/stream input's header before the decoder reopens it.
        preset_video = {"auto": None, "pal": st.VID_PAL,
                        "ntsc": st.VID_NTSC}[args.standard]
        dec = device_driver.DeviceBatchDecoder(
            jobs, lines_per_field=None, hyst_limit=hyst,
            shift_limit=shift, frames_per_round=args.batch,
            mask_mode=mask_mode,
            ref_sweep=args.quality == "insane",
            ref_sweep_fallback=args.quality == "normal",
            normal_sweep_prescan=args.quality in ("normal", "insane"),
            per_line_agc=args.per_line_agc,
            mode_m2=args.format == "m2",
            preset_video=preset_video,
            preset_order={"auto": None, "tff": st.ORDER_TFF,
                          "bff": st.ORDER_BFF}[args.field_order],
            preset_resolution={"auto": None, "14bit": 1, "16bit": 2}[
                args.resolution],
            preset_sample_rate=args.sample_rate)
    else:
        from .pipeline import device_pcm
        dec = device_pcm.DevicePCMBatchDecoder(
            jobs, fmt=args.format, hyst_limit=hyst, shift_limit=shift,
            frames_per_round=args.batch, mask_mode=mask_mode,
            refine=args.quality in ("normal", "insane"))
    stats = dec.run()
    s = list(stats.values())[0]
    dt = max(time.perf_counter() - t0, 1e-9)
    frames = s.frames_total
    print(f"decoded {frames} frames in {dt:.2f}s "
          f"({frames / dt:.1f} fps, chip-resident), "
          f"{s.lines_valid}/{s.lines_total} lines valid, "
          f"{s.samples_out} samples ({s.samples_masked} masked) "
          f"-> {out_path}")
    return 0


def _frame_batches(rd, start, frames_arg, batch):
    """(base, frame_batch) pairs; handles live streams whose n_frames is
    unknown (ingest.StreamReader) by pulling until EOF."""
    if rd.n_frames is None:
        base = start
        while frames_arg is None or base < frames_arg:
            cnt = batch if frames_arg is None \
                else min(batch, frames_arg - base)
            b = rd.read_frames(base, cnt)
            if b.shape[0] == 0:
                return
            yield base, b
            base += b.shape[0]
        return
    n_frames = rd.n_frames if frames_arg is None \
        else min(frames_arg, rd.n_frames)
    for base in range(start, n_frames, batch):
        yield base, rd.read_frames(base, min(batch, n_frames - base))


QUALITY_LIMITS = {  # (hyst_limit, shift_limit); binarizer.h:207-241
    "draft": (0, 0), "fast": (2, 1), "normal": (4, 2), "insane": (10, 4),
}


def _decode_arvid(args, raw_size):
    """ArVid prototype path: binarize frames, dump words (no audio —
    the reference's debug-only ArVid surface, videotodigital.cpp:857)."""
    from .pipeline import arvid_pipe, ingest
    out_path = args.output or (args.input.rsplit(".", 1)[0]
                               + ".arvid.txt")
    bin_path = out_path.rsplit(".", 1)[0] + ".bin"
    open(out_path, "w").close()
    open(bin_path, "wb").close()
    fcoords = None
    if args.force_coords:
        a, b = args.force_coords.split(":")
        fcoords = (int(a), int(b))
    done = 0
    with ingest.open_capture(args.input, raw_size=raw_size) as rd:
        print(f"input: {rd.width}x{rd.height}, {rd.n_frames} frames")
        for base, batch in _frame_batches(rd, 0, args.frames,
                                          args.batch):
            if batch.shape[0] == 0:
                continue
            lines_b, _nums = ingest.split_fields_batch(batch)
            done += arvid_pipe.decode_to_dump(
                lines_b, out_path, first_frame_number=base + 1,
                coords=fcoords, bin_path=bin_path)
    print(f"dumped {done} ArVid frames -> {out_path}")
    return 0


def _make_live(spec, rate):
    """Start the live-audio pump for --live-audio, or None."""
    if not spec:
        return None
    from .pipeline import live_audio as la
    try:
        pump = la.SamplesToAudio(la.make_sink(spec), rate=rate)
        pump.start()
        return pump
    except OSError as e:
        print(f"live audio disabled: {e}", file=sys.stderr)
        return None


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .utils import jaxcache
    jaxcache.enable()
    from .pipeline import ingest, v2d, audio as ap, wav
    from .pipeline import stitcher_stc007 as st

    raw_size = None
    if args.raw_size:
        w, h = args.raw_size.lower().split("x")
        raw_size = (int(w), int(h))

    mask_map = {
        ("ignore", "word"): ap.DROP_IGNORE,
        ("ignore", "block"): ap.DROP_IGNORE,
        ("mute", "word"): ap.DROP_MUTE_WORD,
        ("mute", "block"): ap.DROP_MUTE_BLOCK,
        ("hold", "word"): ap.DROP_HOLD_WORD,
        ("hold", "block"): ap.DROP_HOLD_BLOCK,
        ("interpolate", "word"): ap.DROP_INTER_LIN_WORD,
        ("interpolate", "block"): ap.DROP_INTER_LIN_BLOCK,
    }
    hyst, shift = QUALITY_LIMITS[args.quality]

    out_path = args.output or (args.input.rsplit(".", 1)[0] + ".wav")
    decodable = _ensure_decodable_input(args)
    if decodable is None:
        return 2
    args.input = decodable

    if args.format == "auto":
        from .pipeline import probe
        fmt, scores = probe.probe_capture(args.input, raw_size=raw_size)
        if fmt is None:
            print(f"error: cannot detect PCM format of {args.input!r} "
                  f"(scores {scores}); pass --format explicitly",
                  file=sys.stderr)
            return 2
        print(f"format probe: {fmt} "
              f"({', '.join(f'{k}={v:.2f}' for k, v in scores.items())})")
        args.format = fmt

    if args.format == "arvid":
        return _decode_arvid(args, raw_size)

    if args.backend == "device":
        return _decode_device(args, raw_size, mask_map, hyst, shift,
                              out_path)

    if args.format in ("pcm1", "pcm16x0", "pcm1630"):
        return _decode_other_format(args, raw_size, mask_map, hyst, shift,
                                    out_path)

    t0 = time.perf_counter()
    with ingest.open_capture(args.input, raw_size=raw_size) as rd:
        print(f"input: {rd.width}x{rd.height}, "
              f"{'live stream' if rd.n_frames is None else rd.n_frames} "
              "frames")
        preset_video = {"auto": st.VID_UNKNOWN, "pal": st.VID_PAL,
                        "ntsc": st.VID_NTSC}[args.standard]
        if preset_video == st.VID_UNKNOWN:
            # Guess by field height like detectVideoStandard.
            preset_video = st.VID_PAL if rd.height // 2 > 260 else \
                st.VID_NTSC
        stitcher = st.STC007Stitcher(
            en_p=not args.no_ecc, en_q=not args.no_ecc, en_cwd=args.cwd,
            record_views=bool(args.render_dir),
            mode_m2=args.format == "m2",
            auto_m2=args.format == "stc007",  # CB format-ID auto-detect
            preset_video=preset_video,
            preset_order={"auto": st.ORDER_UNK, "tff": st.ORDER_TFF,
                          "bff": st.ORDER_BFF}[args.field_order],
            preset_resolution={"auto": None, "14bit": 1, "16bit": 2}[
                args.resolution],
            preset_sample_rate=args.sample_rate)
        fcoords = None
        if args.force_coords:
            a, b = args.force_coords.split(":")
            fcoords = (int(a), int(b))
        driver = v2d.V2DDriver(hyst_limit=hyst, shift_limit=shift,
                               ref_sweep=args.quality == "insane",
                               ref_sweep_fallback=args.quality == "normal",
                               normal_sweep_prescan=args.quality
                               in ("normal", "insane"),
                               forced_coords=fcoords,
                               per_line_agc=args.per_line_agc,
                               m2=args.format == "m2")
        backend = args.backend
        from .ops import stitch_native as _sn
        if backend == "auto":
            backend = "native" if _sn.available() else "tpu"
        elif backend == "native" and not _sn.available():
            print("warning: native core unavailable (no compiler?); "
                  "falling back to the device backend", file=sys.stderr)
            backend = "tpu"
        proc = ap.AudioProcessor(mask_mode=mask_map[(args.mask,
                                                     args.mask_scope)])
        writer = None
        live = None
        frame_no = 0
        first = True
        audio_out = 0
        audio_peak = 0
        frames_no_pcm = 0
        line_counts = [0, 0]
        start_base = 0
        if args.checkpoint:
            from .utils import resume as ckpt
            import os as _os
            if _os.path.exists(args.checkpoint + ".json"):
                frame_no, audio_out, ck_rate = ckpt.load_checkpoint(
                    args.checkpoint, stitcher, audio=proc, driver=driver)
                start_base = frame_no
                first = False
                writer = wav.WavWriter(out_path, ck_rate,
                                       resume_at=audio_out)
                print(f"resuming at frame {frame_no}, "
                      f"{audio_out} samples written")

        # Per-stage wall-time aggregates (the QElapsedTimer stage splits
        # of processLine / loopTime signals, batch-granular here).
        stage_t = {"read": 0.0, "decode": 0.0, "stitch": 0.0,
                   "audio": 0.0}

        from .utils.stats import DecodeStats
        agg = DecodeStats()

        def consume(split, results):
            # Runs on the single stitch worker: the host reassembly for
            # batch N overlaps the device decode of batch N+1.
            nonlocal frame_no, first, audio_out, audio_peak, \
                frames_no_pcm, writer, live
            t_st = time.perf_counter()
            # Whole-batch queueing routes consecutive steady pairs
            # through one stc007_steady_round call; per-frame pushes
            # stay when the render/stats paths need per-frame state.
            batch_push = not args.render_dir and not args.stats
            round_stores = []
            for (lines, nums), res in zip(split, results):
                frame_no += 1
                if res is None:
                    # Dropped/no-PCM frame: push an all-invalid frame so
                    # the interleave timing holds and the gap masks as
                    # silence (the reference inserts dummy frames for
                    # drops, ffmpegwrapper.cpp:898-907).
                    line_counts[0] += len(nums)
                    frames_no_pcm += 1
                    store = st.LineStore(len(nums))
                    store.frame_number[:] = frame_no
                    store.line_number = np.asarray(nums, np.int64).copy()
                else:
                    line_counts[0] += len(nums)
                    line_counts[1] += int(res.valid.sum())
                    store = st.LineStore.from_decoded(
                        res.words, res.crc_read, res.valid,
                        np.full(len(nums), frame_no), nums,
                        ref_level=np.full(len(nums), res.ref_level),
                        forced_bad=res.forced_bad)
                if first:
                    tag = st.LineStore(1)
                    tag.service[0] = st.SRV_NEW_FILE
                    tag.frame_number[0] = frame_no
                    store = st.LineStore.concat([tag, store])
                    first = False
                if batch_push:
                    round_stores.append(store)
                else:
                    stitcher.push_frame(store)
                if args.dump_lines and res is not None:
                    from .utils import dump
                    for row in dump.dump_lines(
                            res.words, res.crc_read, res.valid,
                            fmt="stc007", line_numbers=nums,
                            limit=args.dump_lines):
                        print(f"F[{frame_no:04d}] {row}")
                if args.render_dir and res is not None:
                    from .pipeline import render as rn
                    import os
                    os.makedirs(args.render_dir, exist_ok=True)
                    img = rn.render_stc007_lines(res.words, res.crc_read,
                                                 res.valid)
                    rn.write_ppm(os.path.join(
                        args.render_dir, f"frame_{frame_no:05d}.ppm"), img)
                    # Source view (the reference's first frame_vis
                    # window).
                    rn.write_ppm(os.path.join(
                        args.render_dir, f"source_{frame_no:05d}.ppm"),
                        rn.render_source_lines(lines))
                    # Reassembled-frame + data-block views (frame_vis
                    # windows 3 and 4, mainwindow.h:393-396).
                    if stitcher.last_assembled is not None:
                        asm = stitcher.last_assembled
                        rn.write_ppm(os.path.join(
                            args.render_dir,
                            f"assembled_{frame_no:05d}.ppm"),
                            rn.render_stc007_lines(
                                asm.words, asm.source_crc,
                                asm.crc_valid()))
                        stitcher.last_assembled = None
                    if stitcher.last_blocks is not None:
                        lb = stitcher.last_blocks
                        rn.write_ppm(os.path.join(
                            args.render_dir,
                            f"blocks_{frame_no:05d}.ppm"),
                            rn.render_stc007_blocks(
                                lb["words"], lb["valid"], lb["line_crc"],
                                lb["fixed_p"], lb["fixed_q"],
                                lb["broken"], lb["masked"]))
                        stitcher.last_blocks = None
                if args.stats and stitcher.frame_log:
                    fr = stitcher.frame_log[-1]
                    print(f"F[{fr.frame_number:04d}] "
                          f"ord={'-TB'[fr.field_order]} "
                          f"pad[{fr.inner_padding:02d}/"
                          f"{fr.outer_padding:02d}] "
                          f"blk[{fr.blocks_total:4d}] "
                          f"P[{fr.blocks_fix_p:3d}] "
                          f"Q[{fr.blocks_fix_q:3d}] "
                          f"brk[{fr.blocks_broken_field:3d}] "
                          f"drop[{fr.blocks_drop:3d}]")
            if round_stores:
                stitcher.push_frames(round_stores)
            # Aggregate + drain the work log every batch: the log
            # otherwise grows without bound over archive-length tapes.
            for fr in stitcher.frame_log:
                agg.add_frame(fr)
            del stitcher.frame_log[:]
            stage_t["stitch"] += time.perf_counter() - t_st
            t_au = time.perf_counter()
            # Drain periodically to bound memory.
            arrs = st.chunks_to_arrays(stitcher.pop_sample_chunks())
            if arrs is not None:
                samples, valid, blk, rate = arrs
                out = proc.process(samples, valid, blk, file_end=False)
                audio_out += len(out)
                if len(out):
                    audio_peak = max(audio_peak, int(np.abs(out).max()))
                if writer is None:
                    writer = wav.WavWriter(out_path, rate)
                    live = _make_live(args.live_audio, rate)
                writer.write(out)
                writer.flush()
                if live is not None and len(out):
                    live.save_audio(out)
            stage_t["audio"] += time.perf_counter() - t_au
            if args.checkpoint:
                from .utils import resume as ckpt
                ckpt.save_checkpoint(
                    args.checkpoint, frame_no, stitcher, audio_out,
                    writer.sample_rate if writer else 44100,
                    audio=proc, driver=driver)

        from concurrent.futures import ThreadPoolExecutor
        stitch_pool = ThreadPoolExecutor(1)
        pending = []
        for base, batch in _frame_batches(rd, start_base, args.frames,
                                          args.batch):
            t_rd = time.perf_counter()
            if batch.shape[0] == 0:
                stage_t["read"] += time.perf_counter() - t_rd
                continue
            lines_b, nums_all = ingest.split_fields_batch(batch)
            split = [(lines_b[f], nums_all) for f in range(batch.shape[0])]
            stage_t["read"] += time.perf_counter() - t_rd
            t_dc = time.perf_counter()
            # Pad the tail batch to the full batch size so the device
            # sees one compiled shape (the native grid takes any shape).
            pad_frames = 0
            if backend != "native" and lines_b.shape[0] < args.batch:
                pad_frames = args.batch - lines_b.shape[0]
                lines_b = np.concatenate(
                    [lines_b, np.zeros((pad_frames,) + lines_b.shape[1:],
                                       np.uint8)])
            if backend == "native":
                results = driver.decode_frames_host(lines_b)
            else:
                results = driver.decode_frames(lines_b)
            if pad_frames:
                results = results[:-pad_frames]
            stage_t["decode"] += time.perf_counter() - t_dc
            pending.append(stitch_pool.submit(consume, split, results))
        for f in pending:
            f.result()
        stitch_pool.shutdown(wait=True)
        stitcher.finish()
        arrs = st.chunks_to_arrays(stitcher.pop_sample_chunks())
        if arrs is not None:
            samples, valid, blk, rate = arrs
            out = proc.process(samples, valid, blk, file_end=True)
        else:
            out, rate = proc.flush(), 44100
        if len(out):
            audio_out += len(out)
            audio_peak = max(audio_peak, int(np.abs(out).max()))
            if writer is None:
                writer = wav.WavWriter(out_path, rate)
                live = _make_live(args.live_audio, rate)
            writer.write(out)
            if live is not None:
                live.save_audio(out)
        if writer is not None:
            writer.close()
        if live is not None:
            live.stop_output()
    dt = time.perf_counter() - t0
    for fr in stitcher.frame_log:  # entries since the last batch drain
        agg.add_frame(fr)
    agg.lines_total, agg.lines_valid = line_counts
    agg.samples_masked = proc.total_masked
    agg.samples_out = audio_out
    agg.peak_level = audio_peak
    agg.frames_no_pcm = frames_no_pcm
    print(agg.summary())
    print("timings: " + ", ".join(f"{k} {v:.2f}s"
                                  for k, v in stage_t.items()))
    print(f"decoded {frame_no} frames in {dt:.2f}s "
          f"({frame_no / dt:.1f} fps) -> {out_path}")
    return 0


def _decode_other_format(args, raw_size, mask_map, hyst, shift, out_path):
    """PCM-1 / PCM-16x0 CLI decode path (pixels -> format stitcher)."""
    import jax.numpy as jnp
    from .pipeline import ingest, audio as ap, wav
    from .ops import binarize as bz, agc, markers  # noqa: F401
    from .pipeline import stitcher_pcm1 as sp1
    from .pipeline import stitcher_pcm16x0 as sp16
    from .pipeline.stitcher_stc007 import (ORDER_TFF, ORDER_BFF, ORDER_UNK,
                                           chunks_to_arrays)

    proc = ap.AudioProcessor(mask_mode=mask_map[(args.mask,
                                                 args.mask_scope)])
    order = {"auto": ORDER_TFF, "tff": ORDER_TFF, "bff": ORDER_BFF}[
        args.field_order]
    if args.format == "pcm1":
        stitcher = sp1.PCM1Stitcher(field_order=order)
    else:
        fmt16 = sp16.FORMAT_EI if args.format == "pcm1630" \
            else sp16.FORMAT_SI
        # EI auto-detects field order through the padding sweep.
        order16 = ORDER_UNK if (args.field_order == "auto"
                                and fmt16 == sp16.FORMAT_EI) else order
        # --format pcm16x0 auto-switches SI->EI from the control-bit
        # stream (BIT_FORMAT_OFS, collectCtrlBitStats :4745); pcm1630
        # pins EI explicitly.
        stitcher = sp16.PCM16X0Stitcher(field_order=order16, fmt=fmt16,
                                        en_p=not args.no_ecc,
                                        preset_sample_rate=args.sample_rate,
                                        auto_fmt=args.format == "pcm16x0")
    fmt_drv = "pcm1" if args.format == "pcm1" else "pcm16x0"
    from .pipeline import v2d_other
    driver = v2d_other.PCMFrameDriver(
        fmt_drv, shift_limit=shift, hyst_limit=hyst,
        refine=args.quality in ("normal", "insane"),
        backend="tpu" if args.backend == "tpu" else "auto")
    writer = None
    live = None
    frame_no = 0
    start_base = 0
    if args.checkpoint:
        from .utils import resume as ckpt
        import os as _os
        if _os.path.exists(args.checkpoint + ".json"):
            frame_no, audio_out, ck_rate = ckpt.load_checkpoint(
                args.checkpoint, stitcher, audio=proc, driver=driver)
            start_base = frame_no
            writer = wav.WavWriter(out_path, ck_rate, resume_at=audio_out)
            print(f"resuming at frame {frame_no}, "
                  f"{audio_out} samples written")
    with ingest.open_capture(args.input, raw_size=raw_size) as rd:
        print(f"input: {rd.width}x{rd.height}, {rd.n_frames} frames")
        for base, batch in _frame_batches(rd, start_base, args.frames,
                                          args.batch):
            if batch.shape[0] == 0:
                continue
            lines_b, nums = ingest.split_fields_batch(batch)
            L = lines_b.shape[1]
            results = driver.decode_frames(lines_b)
            for f, res in enumerate(results):
                frame_no += 1
                if res is None:
                    continue
                wl1 = res.words
                cl1 = res.crc_read
                if args.dump_lines:
                    from .utils import dump
                    fmt_d = "pcm1" if args.format == "pcm1" else "pcm16x0"
                    w_d = wl1 if fmt_d == "pcm1" \
                        else np.asarray(wl1).reshape(-1, 3)
                    c_d = cl1 if fmt_d == "pcm1" \
                        else np.asarray(cl1).reshape(-1)
                    v_d = res.valid if fmt_d == "pcm1" \
                        else np.asarray(res.valid).reshape(-1)
                    for row in dump.dump_lines(w_d, c_d, v_d, fmt=fmt_d,
                                               limit=args.dump_lines):
                        print(f"F[{frame_no:04d}] {row}")
                if args.format == "pcm1":
                    store = sp1.PCM1LineStore.from_decoded(
                        wl1, cl1, np.full(L, frame_no), nums,
                        ref_level=np.full(L, res.ref_level),
                        valid=res.valid)
                    if args.render_dir:
                        from .pipeline import render as rn
                        import os as _os
                        _os.makedirs(args.render_dir, exist_ok=True)
                        rn.write_ppm(_os.path.join(
                            args.render_dir, f"frame_{frame_no:05d}.ppm"),
                            rn.render_pcm1_lines(
                                wl1, cl1, store.crc_valid()))
                        rn.write_ppm(_os.path.join(
                            args.render_dir,
                            f"source_{frame_no:05d}.ppm"),
                            rn.render_source_lines(lines_b[f]))
                    if frame_no == 1:
                        tag = sp1.PCM1LineStore(1)
                        tag.service[0] = sp1.SRV_NEW_FILE
                        tag.frame_number[0] = frame_no
                        store = sp1.PCM1LineStore.concat([tag, store])
                    stitcher.push_frame(store)
                else:
                    store = sp16.PCM16X0LineStore.from_decoded(
                        wl1, cl1, np.full(L * 3, frame_no),
                        np.repeat(nums, 3), np.tile(np.arange(3), L),
                        control_bit=np.repeat(res.ctrl, 3),
                        picked_left=res.picked_left,
                        picked_right=res.picked_right, valid=res.valid)
                    if args.render_dir:
                        from .pipeline import render as rn
                        import os as _os
                        _os.makedirs(args.render_dir, exist_ok=True)
                        rn.write_ppm(_os.path.join(
                            args.render_dir, f"frame_{frame_no:05d}.ppm"),
                            rn.render_pcm16x0_sublines(
                                wl1, cl1, store.crc_valid(),
                                control_bit=store.control_bit))
                        rn.write_ppm(_os.path.join(
                            args.render_dir,
                            f"source_{frame_no:05d}.ppm"),
                            rn.render_source_lines(lines_b[f]))
                    if frame_no == 1:
                        tag = sp16.PCM16X0LineStore(1)
                        tag.service[0] = sp16.SRV_NEW_FILE
                        tag.frame_number[0] = frame_no
                        store = sp16.PCM16X0LineStore.concat([tag, store])
                    stitcher.push_frame(store)
            if args.stats:
                # Per-frame work log (the MainWindow column log analog,
                # mainwindow.h:115-194) for the PCM-1/16x0 paths.
                for fr in stitcher.frame_log[-batch.shape[0]:]:
                    if args.format == "pcm1":
                        print(f"F[{fr.frame_number:04d}] "
                              f"ord={'-TB'[fr.field_order]} "
                              f"hdr[{int(getattr(fr, 'header', 0))}] "
                              f"emph[{int(fr.emphasis)}] "
                              f"blk[{fr.blocks_total:4d}] "
                              f"drop[{fr.blocks_drop:3d}]")
                    else:
                        print(f"F[{fr.frame_number:04d}] "
                              f"ord={'-TB'[fr.field_order]} "
                              f"{'EI' if fr.ei_format else 'SI'} "
                              f"pad[{fr.odd_padding:02d}/"
                              f"{fr.even_padding:02d}/"
                              f"{fr.inner_padding:02d}] "
                              f"rate[{fr.sample_rate}] "
                              f"emph[{int(fr.emphasis)}] "
                              f"blk[{fr.blocks_total:4d}] "
                              f"P[{fr.blocks_fix_p:3d}] "
                              f"brk[{fr.blocks_broken:3d}] "
                              f"drop[{fr.blocks_drop:3d}]")
            # Bound the work log over archive-length tapes (nothing
            # reads past-batch entries on this path).
            del stitcher.frame_log[:]
            arrs = chunks_to_arrays(stitcher.pop_sample_chunks())
            if arrs is not None:
                samples, valid2, blk2, rate = arrs
                out = proc.process(samples, valid2, blk2, file_end=False)
                if writer is None:
                    writer = wav.WavWriter(out_path, rate)
                    live = _make_live(args.live_audio, rate)
                writer.write(out)
                writer.flush()
                if live is not None and len(out):
                    live.save_audio(out)
            if args.checkpoint:
                from .utils import resume as ckpt
                ckpt.save_checkpoint(
                    args.checkpoint, frame_no, stitcher,
                    writer.samples_written if writer else 0,
                    writer.sample_rate if writer else 44100, audio=proc,
                    driver=driver)
    stitcher.finish()
    arrs = chunks_to_arrays(stitcher.pop_sample_chunks())
    if arrs is not None:
        samples, valid2, blk2, rate = arrs
        out = proc.process(samples, valid2, blk2, file_end=True)
    else:
        out, rate = proc.flush(), 44100
    if len(out):
        if writer is None:
            writer = wav.WavWriter(out_path, rate)
            live = _make_live(args.live_audio, rate)
        writer.write(out)
        if live is not None:
            live.save_audio(out)
    if writer is not None:
        writer.close()
    else:
        print("warning: no decodable PCM found", file=sys.stderr)
    if live is not None:
        live.stop_output()
    print(f"decoded {frame_no} frames -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

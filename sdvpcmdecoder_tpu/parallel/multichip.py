"""Batch parallelism across chips: the FULL pipeline, sharded by capture.

SURVEY.md §2 "batch parallelism across chips": multiple captures are
sharded over the device mesh's data axis and each shard runs the real
batch decoder — ingest, prescan, trial-grid binarize (device), stitch
stage machine (host, embarrassingly parallel per capture), P/Q ECC,
audio masking, WAV — on its own chip.  Host stitching needs no
cross-capture state, so the only collectives are the end-of-run stats
reduction (a real psum over the mesh, the analog of the reference's
GUI stat counters, mainwindow.h:434-467) and ordered WAV collection.

The decode math is deterministic, so sharded output is byte-identical
to a single-device run — pinned by tests/test_multichip_driver.py and
asserted by __graft_entry__.dryrun_multichip on every driver round.
"""
from __future__ import annotations

import threading

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


class ShardedBatchDecoder:
    """Run the production BatchDecoder with captures sharded over chips.

    jobs: [(in_path, out_path), ...]; devices: defaults to all local
    devices.  Capture k runs on device k % n_devices; each shard is a
    real BatchDecoder on the device ("tpu") backend pinned to its chip
    via jax.default_device (thread-local, so shards run concurrently).
    """

    def __init__(self, jobs, devices=None, fmt="stc007",
                 device_resident=False, **kw):
        self.devices = list(devices if devices is not None
                            else jax.devices())
        self.jobs = list(jobs)
        self.fmt = fmt
        # device_resident=True shards the CHIP-RESIDENT drivers
        # (pipeline/device_driver / device_pcm: HBM-staged pixels, one
        # fused dispatch per round) instead of the streaming backend.
        self.device_resident = device_resident
        self.kw = dict(kw)
        if not device_resident:
            self.kw.setdefault("backend", "tpu")
        self.stats = None
        self.shard_stats = None

    def _make_decoder(self, shard_jobs):
        from ..pipeline import batch_driver
        if not self.device_resident:
            return batch_driver.BatchDecoder(shard_jobs, fmt=self.fmt,
                                             **self.kw)
        if self.fmt == "stc007":
            from ..pipeline import device_driver
            return device_driver.DeviceBatchDecoder(shard_jobs,
                                                    **self.kw)
        from ..pipeline import device_pcm
        return device_pcm.DevicePCMBatchDecoder(shard_jobs,
                                                fmt=self.fmt, **self.kw)

    def _run_shard(self, dev, shard_jobs, out, idx):
        try:
            with jax.default_device(dev):
                dec = self._make_decoder(shard_jobs)
                res = dec.run()
            frames = sum(j.stats.frames_total for j in dec.jobs)
            samples = sum(j.stats.samples_out for j in dec.jobs)
            masked = sum(j.stats.samples_masked for j in dec.jobs)
            out[idx] = (res, np.array([frames, samples, masked],
                                      np.int64))
        except BaseException as e:   # noqa: BLE001 — re-raised in run()
            out[idx] = e

    def run(self):
        n = max(1, min(len(self.devices), len(self.jobs)))
        shards = [[] for _ in range(n)]
        for k, job in enumerate(self.jobs):
            shards[k % n].append(job)
        out = [None] * n
        threads = [threading.Thread(
            target=self._run_shard,
            args=(self.devices[i], shards[i], out, i))
            for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, o in enumerate(out):
            if isinstance(o, BaseException):
                raise RuntimeError(
                    f"shard {i} ({shards[i]}) failed: {o!r}") from o
            if o is None:
                raise RuntimeError(f"shard {i} produced no result")
        self.shard_stats = np.stack([o[1] for o in out])
        self.stats = self._reduce_stats(self.shard_stats, n)
        merged = {}
        for o in out:
            merged.update(o[0])
        return merged

    def _reduce_stats(self, per_shard, n):
        """psum the per-shard counters over a 1D mesh — the cross-chip
        stats reduction (SURVEY.md §2 collectives)."""
        mesh = Mesh(np.array(self.devices[:n]), ("data",))

        def local(x):
            return jax.lax.psum(x, "data")

        step = jax.jit(jax.shard_map(local, mesh=mesh,
                                     in_specs=P("data"),
                                     out_specs=P()))
        pad = per_shard.reshape(n, -1)
        total = step(jnp.asarray(pad))
        return np.asarray(total).reshape(per_shard.shape[1:])

"""Multi-chip scale-out: captures x line-chunks over a 2D device mesh.

The reference's only parallelism is a 6-thread pipeline (SURVEY.md section
2); this design shards the *batch* instead:

  * "data" axis: independent captures / tapes (replaces running the app
    N times);
  * "seq" axis: line-chunks of one capture with a MIN_DEINT_DATA-line halo
    so the diagonal interleave crosses chunk boundaries intact — the
    context-parallel halo-exchange analog (SURVEY.md section 5);
  * collectives: psum for stats, all_gather along "seq" for ordered WAV
    assembly.  The mesh follows the algorithm alone: every card reaches
    every other at the same rate, so no device-topology layout applies.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..formats import stc007

HALO = stc007.MIN_DEINT_DATA  # 112 lines of interleave context


def decode_mesh(n_devices=None, seq=None):
    """Build a (data x seq) mesh over available devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if seq is None:
        seq = 2 if n % 2 == 0 and n > 1 else 1
    data = n // seq
    return Mesh(np.array(devs[:data * seq]).reshape(data, seq),
                ("data", "seq"))


def chunk_lines_with_halo(lines: np.ndarray, n_chunks: int,
                          halo: int = HALO):
    """[L, ...] -> [n_chunks, chunk+halo, ...] with trailing overlap.

    Each chunk carries `halo` extra lines from the next chunk so every
    block whose taps straddle the boundary is complete.
    """
    L = lines.shape[0]
    chunk = (L - halo) // n_chunks
    out = np.stack([lines[k * chunk:k * chunk + chunk + halo]
                    for k in range(n_chunks)])
    return out, chunk


def shard_captures(arr: np.ndarray, mesh: Mesh):
    """Place [captures, chunks, ...] onto the (data, seq) mesh."""
    spec = P("data", "seq")
    return jax.device_put(
        arr, jax.sharding.NamedSharding(mesh, spec))


def multichip_decode_step(mesh: Mesh, hyst_limit=1, shift_limit=1):
    """Build a jitted per-device decode step over the mesh.

    Inputs are [D, S, Lc, W] pixels plus coords/levels; each device
    decodes its chunk locally, stats psum over the whole mesh, samples
    all_gather along "seq" for in-order assembly.
    """
    from ..pipeline import decoder

    def local_step(px, cd, ref, blk, wht):
        r = decoder.decode_stream(px[0, 0], cd[0, 0], ref[0, 0], blk[0, 0],
                                  wht[0, 0], hyst_limit=hyst_limit,
                                  shift_limit=shift_limit)
        n_valid = jax.lax.psum(jnp.sum(r.line_valid.astype(jnp.int32)),
                               ("data", "seq"))
        gathered = jax.lax.all_gather(r.samples, "seq")
        return gathered[None, None], n_valid[None, None]

    spec = P("data", "seq")
    step = jax.shard_map(local_step, mesh=mesh, in_specs=(spec,) * 5,
                         out_specs=(spec, spec))
    return jax.jit(step)

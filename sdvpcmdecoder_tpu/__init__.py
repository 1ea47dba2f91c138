"""sdvpcmdecoder_tpu — accelerator batch decoder for vintage PCM-adapter audio.

A ground-up JAX/XLA re-architecture of the capabilities of
Fagear/SDVPCMdecoder (C++/Qt desktop decoder for Sony PCM-1, PCM-1600/1610/1630,
EIAJ STC-007 / PCM-F1 / M2 and ArVid digital audio recorded on video tape).

Design stance (not a port):
  * All per-line bit math (CRC checks, word extraction, ECC syndromes) is
    GF(2)-linear, so it is expressed as batched integer matmuls.
  * The reference's serial early-exit searches (reference-level sweep,
    hysteresis depth, pixel shift, coordinate sweep) become dense trial grids
    evaluated in one jitted dispatch with argmin-style selection.
  * The stitcher's padding/field-order search scores all candidates in one
    batched deinterleave; only the tiny stage machine stays on host.
  * Multi-chip scaling shards the batch (captures x frame-chunks) over a
    jax.sharding.Mesh; halo exchange carries interleave state across chunks.

Layer map (mirrors SURVEY.md section 2 of this repo):
  formats/   - data model: bit layouts, CRC, GF(2) algebra, sample expansion
  ops/       - device kernels: binarizer trial grid, deinterleave + ECC
  pipeline/  - host orchestration: ingest, V2D, stitchers, audio, WAV
  synth/     - synthetic encoders (inverse pipeline) for conformance testing
  parallel/  - device mesh / sharding utilities
  utils/     - config presets, stats, logging
"""

__version__ = "0.1.0"

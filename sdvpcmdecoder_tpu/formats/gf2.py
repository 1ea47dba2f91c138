"""GF(2) matrix algebra for the STC-007 Q-code (b-adjacent erasure code).

The reference keeps 18 precomputed 14x14 bit-matrices as uint16 row masks
(stc007deinterleaver.cpp:4-75): I, T^1..T^6, T^-1..T^-6, (T^k+I)^-1 for
k=1..5, applied by `multMatrix` (row-mask AND + parity, :2052-2088).

Here a matrix is a numpy bool array M[out_bit, in_bit]; applying it to a batch
of 14-bit words is one int matmul mod 2, batched over every
data block at once instead of per-block serial loops.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

BITS = 14  # STC007Line::BITS_PER_WORD

# Row-mask tables transcribed from stc007deinterleaver.cpp:4-75.
# matrix[row] is a mask over input bits for output bit `row`.
_ROW_MASKS = {
    "I":    [0x0001, 0x0002, 0x0004, 0x0008, 0x0010, 0x0020, 0x0040, 0x0080,
             0x0100, 0x0200, 0x0400, 0x0800, 0x1000, 0x2000],
    "T1":   [0x2000, 0x0001, 0x0002, 0x0004, 0x0008, 0x0010, 0x0020, 0x0040,
             0x2080, 0x0100, 0x0200, 0x0400, 0x0800, 0x1000],
    "T2":   [0x1000, 0x2000, 0x0001, 0x0002, 0x0004, 0x0008, 0x0010, 0x0020,
             0x1040, 0x2080, 0x0100, 0x0200, 0x0400, 0x0800],
    "T3":   [0x0800, 0x1000, 0x2000, 0x0001, 0x0002, 0x0004, 0x0008, 0x0010,
             0x0820, 0x1040, 0x2080, 0x0100, 0x0200, 0x0400],
    "T4":   [0x0400, 0x0800, 0x1000, 0x2000, 0x0001, 0x0002, 0x0004, 0x0008,
             0x0410, 0x0820, 0x1040, 0x2080, 0x0100, 0x0200],
    "T5":   [0x0200, 0x0400, 0x0800, 0x1000, 0x2000, 0x0001, 0x0002, 0x0004,
             0x0208, 0x0410, 0x0820, 0x1040, 0x2080, 0x0100],
    "T6":   [0x0100, 0x0200, 0x0400, 0x0800, 0x1000, 0x2000, 0x0001, 0x0002,
             0x0104, 0x0208, 0x0410, 0x0820, 0x1040, 0x2080],
    "TN1":  [0x0002, 0x0004, 0x0008, 0x0010, 0x0020, 0x0040, 0x0080, 0x0101,
             0x0200, 0x0400, 0x0800, 0x1000, 0x2000, 0x0001],
    "TN2":  [0x0004, 0x0008, 0x0010, 0x0020, 0x0040, 0x0080, 0x0101, 0x0202,
             0x0400, 0x0800, 0x1000, 0x2000, 0x0001, 0x0002],
    "TN3":  [0x0008, 0x0010, 0x0020, 0x0040, 0x0080, 0x0101, 0x0202, 0x0404,
             0x0800, 0x1000, 0x2000, 0x0001, 0x0002, 0x0004],
    "TN4":  [0x0010, 0x0020, 0x0040, 0x0080, 0x0101, 0x0202, 0x0404, 0x0808,
             0x1000, 0x2000, 0x0001, 0x0002, 0x0004, 0x0008],
    "TN5":  [0x0020, 0x0040, 0x0080, 0x0101, 0x0202, 0x0404, 0x0808, 0x1010,
             0x2000, 0x0001, 0x0002, 0x0004, 0x0008, 0x0010],
    "TN6":  [0x0040, 0x0080, 0x0101, 0x0202, 0x0404, 0x0808, 0x1010, 0x2020,
             0x0001, 0x0002, 0x0004, 0x0008, 0x0010, 0x0020],
    "T1I_INV": [0x3FFE, 0x3FFC, 0x3FF8, 0x3FF0, 0x3FE0, 0x3FC0, 0x3F80,
                0x3F00, 0x01FF, 0x03FF, 0x07FF, 0x0FFF, 0x1FFF, 0x3FFF],
    "T2I_INV": [0x1554, 0x2AA8, 0x1550, 0x2AA0, 0x1540, 0x2A80, 0x1500,
                0x2A00, 0x0155, 0x02AA, 0x0555, 0x0AAA, 0x1555, 0x2AAA],
    "T3I_INV": [0x1248, 0x2490, 0x0920, 0x1240, 0x2480, 0x0900, 0x1200,
                0x2400, 0x1A49, 0x3492, 0x2924, 0x1249, 0x2492, 0x0924],
    "T4I_INV": [0x0445, 0x088A, 0x1115, 0x222A, 0x0455, 0x08AA, 0x1155,
                0x22AA, 0x0111, 0x0222, 0x0444, 0x0888, 0x1111, 0x2222],
    "T5I_INV": [0x1AD7, 0x35AF, 0x2B5E, 0x16BD, 0x2D7B, 0x1AF7, 0x35EF,
                0x2BDE, 0x0D6B, 0x1AD6, 0x35AD, 0x2B5A, 0x16B5, 0x2D6B],
}


def _to_matrix(rows) -> np.ndarray:
    m = np.zeros((BITS, BITS), dtype=np.uint8)
    for r, mask in enumerate(rows):
        for c in range(BITS):
            m[r, c] = (mask >> c) & 1
    return m


MATRICES = {name: _to_matrix(rows) for name, rows in _ROW_MASKS.items()}


def tpow(k: int) -> np.ndarray:
    """T^k for k in -6..6 (as used by the Q-code)."""
    if k == 0:
        return MATRICES["I"]
    if k > 0:
        return MATRICES[f"T{k}"]
    return MATRICES[f"TN{-k}"]


def tk_plus_i_inv(k: int) -> np.ndarray:
    """(T^k + I)^-1 for k in 1..5 (Q-code double-erasure solve)."""
    return MATRICES[f"T{k}I_INV"]


def mat_apply_scalar(matrix: np.ndarray, word: int) -> int:
    """Reference-equivalent multMatrix: word -> word (both 14-bit)."""
    out = 0
    for r in range(BITS):
        bits = matrix[r] & np.array([(word >> c) & 1 for c in range(BITS)],
                                    dtype=np.uint8)
        if int(bits.sum()) & 1:
            out |= 1 << r
    return out


def matmul_gf2(m: np.ndarray, n: np.ndarray) -> np.ndarray:
    """GF(2) matrix product (host-side, for table construction/verification)."""
    return (m.astype(np.int64) @ n.astype(np.int64) & 1).astype(np.uint8)


def word_to_bits(words, xp=jnp):
    """[...,] int words -> [..., 14] bit matrix, LSB at index 0."""
    shifts = np.arange(BITS)
    return (words[..., None].astype(xp.int32) >> shifts) & 1


def bits_to_word(bits, xp=jnp):
    weights = (1 << np.arange(BITS)).astype(np.int32)
    return xp.sum(bits.astype(xp.int32) * weights, axis=-1)


def apply_gf2(matrix, words, xp=jnp):
    """Apply one 14x14 GF(2) matrix to a batch of 14-bit words.

    out_bits = bits @ matrix.T mod 2 -> one batched integer matmul.
    """
    bits = word_to_bits(words, xp=xp)
    if xp is jnp:
        out = jnp.matmul(bits.astype(jnp.int32),
                         jnp.asarray(matrix.T, dtype=jnp.int32),
                         preferred_element_type=jnp.int32) & 1
    else:
        out = (bits.astype(np.int64) @ matrix.T.astype(np.int64)) & 1
    return bits_to_word(out, xp=xp)


def apply_gf2_indexed(matrix_bank, index, words, xp=jnp):
    """Apply per-row-selected matrices: matrix_bank [K,14,14], index [...].

    Used by the vectorized Q-fix where the (first_bad, second_bad) pair
    selects the solve matrices. Implemented as gather + batched matmul.
    """
    bank = xp.asarray(np.stack(matrix_bank).astype(np.int32))  # [K,14,14]
    sel = bank[index]                                          # [...,14,14]
    bits = word_to_bits(words, xp=xp)                          # [...,14]
    out = xp.einsum("...i,...oi->...o", bits.astype(xp.int32), sel) & 1
    return bits_to_word(out, xp=xp)

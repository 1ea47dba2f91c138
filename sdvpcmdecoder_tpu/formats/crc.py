"""CRC-16/CCITT-FALSE as GF(2)-linear algebra (batched-matmul formulation).

The reference decoder (pcmline.cpp:461-487 `PCMLine::getCalcCRC16`) runs a
bit-serial CRC-16 shift register: poly 0x1021, init 0xFFFF, data fed MSB-first.
That loop is linear over GF(2) in (state, input bit), so for a fixed message
length the final CRC is an affine function of the message bits:

    crc(bits) = CONST  ^  XOR_{i : bits[i]=1} MASK[i]

where CONST = crc of the all-zero message (carries the 0xFFFF init through)
and MASK[i] = crc contribution of message bit i alone with zero init.

This turns per-line CRC checking into ONE batched matmul:
    crc_bits[N, 16] = (bits[N, n] @ TABLE[n, 16]) mod 2
which runs for thousands of lines at once — replacing the
reference's per-line 112..128-step serial loop.  Moreover the *syndrome*
(calculated CRC xor read CRC) of a whole 128-bit line payload is itself linear
in all 128 bits, so "is this line valid" is a single matmul + compare.

Scalar reference implementation is kept for golden tests
(pcmtester.cpp:9-99 test vectors).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

CRC_POLY = 0x1021
CRC_INIT = 0xFFFF
CRC_MAX_BIT = 0x8000


def crc16_update_scalar(crc: int, data: int, bit_cnt: int = 16) -> int:
    """Bit-exact port of the reference shift register (pcmline.cpp:461).

    Feeds `bit_cnt` bits of `data` MSB-first (bit bit_cnt-1 down to bit 0).
    """
    for _ in range(bit_cnt):
        msb = (crc >> 15) & 1
        in_bit = (data >> (bit_cnt - 1)) & 1
        crc = (crc << 1) & 0xFFFF
        if msb != in_bit:
            crc ^= CRC_POLY
        data = (data << 1) & 0xFFFF
    return crc


def crc16_words_scalar(words, bits_per_word: int, init: int = CRC_INIT) -> int:
    """CRC over a sequence of words, each contributing bits_per_word bits."""
    crc = init
    for w in words:
        crc = crc16_update_scalar(crc, int(w) & ((1 << bits_per_word) - 1),
                                  bits_per_word)
    return crc


@functools.lru_cache(maxsize=None)
def crc16_linear_table(n_bits: int, init: int = CRC_INIT):
    """Build (TABLE [n_bits,16] uint8, CONST uint16) for an n_bits message.

    TABLE[i, j] = bit j (LSB=0) of the CRC contribution of message bit i
    (message bit 0 is the FIRST bit fed, i.e. the stream MSB).
    """
    # Constant term: all-zero message with the real init.
    const = CRC_INIT if init == CRC_INIT else init
    c = init
    for _ in range(n_bits):
        msb = (c >> 15) & 1
        c = (c << 1) & 0xFFFF
        if msb:
            c ^= CRC_POLY
    const = c
    # Contribution masks: single bit set, zero init.
    table = np.zeros((n_bits, 16), dtype=np.uint8)
    # CRC state evolution of an impulse: feeding bit=1 at step i then zeros.
    # Equivalent: start state poly-xor at step i; simulate remaining steps.
    for i in range(n_bits):
        c = 0
        # Steps before i: state stays 0 (zero bits, zero state).
        # Step i: msb=0, bit=1 -> c = poly.
        c = CRC_POLY
        for _ in range(i + 1, n_bits):
            msb = (c >> 15) & 1
            c = (c << 1) & 0xFFFF
            if msb:
                c ^= CRC_POLY
        table[i] = [(c >> j) & 1 for j in range(16)]
    return table, const


def words_to_bits(words: np.ndarray | jnp.ndarray, bits_per_word,
                  xp=jnp):
    """Unpack words [..., n_words] into a bit matrix [..., total_bits].

    bits_per_word: int (uniform) or sequence per word. MSB-first per word,
    matching the reference feed order.
    """
    n_words = words.shape[-1]
    if isinstance(bits_per_word, int):
        bits_per_word = [bits_per_word] * n_words
    cols = []
    for w, nb in enumerate(bits_per_word):
        word = words[..., w]
        shifts = np.arange(nb - 1, -1, -1)
        cols.append(((word[..., None].astype(xp.int32) >> shifts) & 1))
    return xp.concatenate(cols, axis=-1)


def pack_bits_to_u16(bits, xp=jnp):
    """Pack [..., 16] bit matrix (LSB at index 0) into uint16-valued int32."""
    weights = (1 << np.arange(16)).astype(np.int32)
    return xp.sum(bits.astype(xp.int32) * weights, axis=-1)


def crc16_batch(bits: jnp.ndarray, n_bits: int, init: int = CRC_INIT,
                ) -> jnp.ndarray:
    """Batched CRC over bit matrices [..., n_bits] -> int32 CRC values.

    One integer matmul: (bits @ TABLE) mod 2, then pack + xor const.
    """
    table, const = crc16_linear_table(n_bits, init)
    t = jnp.asarray(table, dtype=jnp.int32)
    crc_bits = jnp.matmul(bits.astype(jnp.int32), t,
                          preferred_element_type=jnp.int32) & 1
    return pack_bits_to_u16(crc_bits) ^ const


@functools.lru_cache(maxsize=None)
def _table_f32(n_bits: int, init: int):
    table, const = crc16_linear_table(n_bits, init)
    return np.ascontiguousarray(table, dtype=np.float32), const


def crc16_batch_np(bits: np.ndarray, n_bits: int, init: int = CRC_INIT,
                   ) -> np.ndarray:
    """NumPy twin of crc16_batch for host-side checks.

    float32 BLAS matmul: 0/1 inputs, sums <= n_bits < 2^24 so exact."""
    table, const = _table_f32(n_bits, init)
    crc_bits = (bits.astype(np.float32) @ table).astype(np.int64) & 1
    weights = (1 << np.arange(16)).astype(np.int64)
    return ((crc_bits * weights).sum(axis=-1) ^ const).astype(np.int64)

"""Quantization utilities for the TrIM CNN path (paper §III-A precision).

A numpy copy of ``repro/core/trim/quant.py`` (the port imports nothing of
the JAX package): the uint8/int8 quantizers, the psum width, and the int5
MSR lane's codecs — ``msr_compress`` / ``msr_decompress`` /
``msr_operand``, ``fold_shift_into_requant``, ``pack_int5`` /
``unpack_int5``, ``packed_nbytes`` and ``wire_checksum``.

The paper's PEs consume B-bit *unsigned* integer inputs and B-bit *signed*
integer weights (B = 8 on the FPGA), producing signed psums whose width grows
as 2B+K (slice bottom row) + ceil(log2 K) (slice adder tree) + ceil(log2 P_M)
(core tree) + ceil(log2 M) (engine temporal accumulation). Final activations
are re-quantized to B bits before leaving the engine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class QuantParams:
    scale: float
    zero_point: int = 0


def quantize_activations_u8(x: np.ndarray) -> Tuple[np.ndarray, QuantParams]:
    """Asymmetric uint8 quantization (inputs are unsigned in the paper)."""
    lo, hi = float(x.min()), float(x.max())
    hi = max(hi, lo + 1e-8)
    scale = (hi - lo) / 255.0
    zp = int(round(-lo / scale))
    q = np.clip(np.round(x / scale) + zp, 0, 255).astype(np.uint8)
    return q, QuantParams(scale, zp)


def quantize_weights_i8(w: np.ndarray) -> Tuple[np.ndarray, QuantParams]:
    """Symmetric int8 quantization (weights are signed in the paper)."""
    amax = max(float(np.abs(w).max()), 1e-8)
    scale = amax / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, QuantParams(scale, 0)


def dequantize_psums(psums: np.ndarray, act: QuantParams, wgt: QuantParams,
                     w_int: np.ndarray) -> np.ndarray:
    """int32 psums -> float, correcting for the activation zero point.

    conv(q_x, q_w) = conv(x, w)/(s_x*s_w) + zp * sum(q_w); the correction term
    is per-output-channel.
    """
    corr = w_int.astype(np.int64).sum(axis=tuple(range(1, w_int.ndim)))
    shaped = corr.reshape((-1,) + (1,) * (psums.ndim - 1))
    return (psums.astype(np.float64) - act.zero_point * shaped) * (
        act.scale * wgt.scale)


def requantize_u8(psums: np.ndarray, out_scale: float,
                  act: QuantParams, wgt: QuantParams,
                  w_int: np.ndarray) -> np.ndarray:
    """Engine output stage: psums -> B-bit activations for the next layer."""
    f = dequantize_psums(psums, act, wgt, w_int)
    return np.clip(np.round(f / out_scale), 0, 255).astype(np.uint8)


def psum_bit_width(B: int, K: int, P_M: int, M: int) -> int:
    """The paper's worst-case engine-output width (§III-A/§III-C)."""
    return (2 * B + K + math.ceil(math.log2(K))
            + math.ceil(math.log2(max(M, 2))))


# ---------------------------------------------------------------------------
# MSR (most-significant-run) 8 -> 5-bit weight compression  (DESIGN.md §9.3)
#
# Trained int8 conv weights concentrate their information in a short run of
# most-significant bits: within one output channel, every magnitude fits in
# ``bitlength(max|w|)`` bits, and keeping only the top MSR_CODE_BITS of that
# run loses at most the channel's bottom ``t`` bits.  We therefore store, per
# weight, a sign + 4-bit code (int5), plus one shared 2-bit shift ``t`` per
# output channel:
#
#     t_c   = max(0, bitlength(max |w| over channel c) - 4)      # 0..3
#     code  = sign(w) * (|w| >> t_c)                             # in [-15, 15]
#
# Decompression applies the expect-value compensation: the discarded low
# ``t`` bits are uniform in [0, 2^t), so adding their expectation ~2^(t-1)
# (a single 1 bit just below the kept run) halves the truncation bias:
#
#     |w^| = (|code| << t) | (1 << (t-1))     if |code| > 0 and t > 0
#          = |code| << t                      otherwise
#
# The compensated magnitude is odd, so |w^| = |w5| << e factors exactly with
#     e  = t - 1,  w5 = sign * (2*|code| + 1)        (t > 0, code != 0)
#     e  = 0,      w5 = code                         (t == 0 or code == 0)
# giving a small operand |w5| <= 31 plus a per-channel power-of-two exponent
# that the requant stage absorbs losslessly (`fold_shift_into_requant`).
# ---------------------------------------------------------------------------

#: Bits kept from each weight's most-significant run (excluding sign).
MSR_CODE_BITS = 4
#: Stored bits per weight: sign + MSR_CODE_BITS.
MSR_STORAGE_BITS = MSR_CODE_BITS + 1
#: Largest decompressed-operand magnitude: 2 * (2^4 - 1) + 1.
MSR_OPERAND_MAX = 2 * ((1 << MSR_CODE_BITS) - 1) + 1


def msr_compress(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Compress int8 weights to signed 4-bit MSR codes + per-channel shifts.

    ``w`` is any integer array whose **last axis** is the output channel
    (conv kernels are HWIO).  Returns ``(codes, shifts)``: ``codes`` is int8
    in [-15, 15] with ``w``'s shape, ``shifts`` is int32 of shape
    ``(w.shape[-1],)`` with values in [0, 3] for int8 inputs.
    """
    w = np.asarray(w)
    if not np.issubdtype(w.dtype, np.integer):
        raise TypeError(f"msr_compress expects integer weights, got {w.dtype}")
    mag = np.abs(w.astype(np.int32))
    if mag.size and int(mag.max()) > 127:
        raise ValueError("msr_compress expects int8-range weights (|w|<=127)")
    ch_max = mag.reshape(-1, w.shape[-1]).max(axis=0) if w.size else \
        np.zeros((w.shape[-1],), np.int32)
    bitlen = np.zeros_like(ch_max)  # bitlength(m): index of top set bit + 1
    nz = ch_max > 0
    bitlen[nz] = np.floor(np.log2(ch_max[nz])).astype(np.int32) + 1
    shifts = np.maximum(bitlen - MSR_CODE_BITS, 0).astype(np.int32)
    codes = np.sign(w.astype(np.int32)) * (mag >> shifts)
    return codes.astype(np.int8), shifts


def msr_decompress(codes: np.ndarray, shifts: np.ndarray,
                   compensate: bool = True) -> np.ndarray:
    """Reconstruct int8 weight estimates from MSR codes.

    With ``compensate=True`` (the lane's default) a single 1 bit is appended
    just below the kept run — the expected value of the truncated low bits —
    whenever the code is nonzero and the channel shift is positive.  With
    ``compensate=False`` this is plain truncation (the ablation baseline).
    """
    codes = codes.astype(np.int32)
    t = np.asarray(shifts, np.int32)
    mag = np.abs(codes) << t
    if compensate:
        comp = np.where((np.abs(codes) > 0) & (t > 0), 1 << np.maximum(t - 1, 0), 0)
        mag = mag | comp
    return (np.sign(codes) * mag).astype(np.int8)


def msr_operand(codes: np.ndarray, shifts: np.ndarray,
                compensate: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Factor the decompressed weights as ``w_hat == w5 << e`` exactly.

    Returns ``(w5, e)``: ``w5`` int8 with ``|w5| <= MSR_OPERAND_MAX`` (31)
    and ``e`` int32 per output channel.  ``w5`` is the operand the conv
    kernels multiply by — its small magnitude is what widens the f32exact
    channel chunks ~4x (kernels/ref.py) — and ``e`` folds into the requant
    shift (`fold_shift_into_requant`) or an explicit left-shift on the last
    layer's raw psums.
    """
    codes = codes.astype(np.int32)
    t = np.asarray(shifts, np.int32)
    e = np.maximum(t - 1, 0).astype(np.int32)
    mag = np.abs(codes)
    if compensate:
        w5 = np.where(t > 0, np.sign(codes) * (2 * mag + (mag > 0)),
                      codes)
    else:
        w5 = np.where(t > 0, np.sign(codes) * (2 * mag), codes)
    return w5.astype(np.int8), e


def fold_shift_into_requant(mult: np.ndarray, shift: np.ndarray,
                            e: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Absorb the per-channel MSR exponent into (mult, shift) requant pairs.

    For psums computed against the small operand ``w5`` the full-precision
    psum is ``psum << e``, and

        requant(psum << e, m, s) == requant(psum, m, s - e)

    exactly: both equal ``clip(floor((psum * m * 2^e + 2^(s-1)) / 2^s))``.
    (Left-shifting the accumulator multiplies the numerator by 2^e; dropping
    ``e`` from the shift divides the denominator and the rounding constant by
    the same factor.)  When ``s - e`` would leave the kernel's domain
    (shift >= 1), the residue moves into the multiplier with saturation at
    the int16 domain bound — psum magnitudes that large are out of the
    calibrated range anyway.
    """
    m = np.asarray(mult, np.int64)
    s = np.asarray(shift, np.int64) - np.asarray(e, np.int64)
    short = np.maximum(1 - s, 0)
    m = np.minimum(m << short, 32767)
    s = np.maximum(s, 1)
    return m.astype(np.int32), s.astype(np.int32)


def pack_int5(codes: np.ndarray) -> np.ndarray:
    """Pack signed 4-bit MSR codes into a dense 5-bit/weight byte stream.

    Each code becomes ``(sign << 4) | |code|``; the 5-bit fields are
    concatenated MSB-first and packed 8-codes-per-5-bytes.  Returns a uint8
    array of ``ceil(5 * n / 8)`` bytes.  Exact inverse: `unpack_int5`.
    """
    flat = np.asarray(codes, np.int32).reshape(-1)
    if flat.size and int(np.abs(flat).max()) >= (1 << MSR_CODE_BITS):
        raise ValueError("codes exceed the 4-bit MSR magnitude range")
    five = ((flat < 0).astype(np.uint8) << MSR_CODE_BITS) | \
        np.abs(flat).astype(np.uint8)
    bits = np.unpackbits(five[:, None], axis=1)[:, -MSR_STORAGE_BITS:]
    return np.packbits(bits.reshape(-1))


def unpack_int5(packed: np.ndarray, count: int) -> np.ndarray:
    """Inverse of `pack_int5`: recover ``count`` signed codes (flat int8)."""
    bits = np.unpackbits(np.asarray(packed, np.uint8))
    need = count * MSR_STORAGE_BITS
    if bits.size < need:
        raise ValueError(f"packed stream too short for {count} codes")
    fields = bits[:need].reshape(count, MSR_STORAGE_BITS)
    weights = 1 << np.arange(MSR_CODE_BITS - 1, -1, -1)
    mag = fields[:, 1:].astype(np.int32) @ weights
    sign = np.where(fields[:, 0] > 0, -1, 1).astype(np.int32)
    return (sign * mag.astype(np.int32)).astype(np.int8)


def packed_nbytes(n_weights: int) -> int:
    """Storage for ``n_weights`` packed int5 codes, in bytes."""
    return (n_weights * MSR_STORAGE_BITS + 7) // 8


def wire_checksum(packed: np.ndarray) -> int:
    """CRC-32 over a packed int5 byte stream (`pack_int5` output).

    The integrity word a deployment stores next to each layer's BRAM
    weight image: a soft-error bit-flip anywhere in the packed payload
    changes the checksum, so a consumer that verifies before decoding
    (``serve.faults.PackedWire``) can never materialize
    flipped weights.
    """
    import zlib

    return zlib.crc32(np.ascontiguousarray(
        np.asarray(packed, np.uint8)).tobytes()) & 0xFFFFFFFF

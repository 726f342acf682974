"""Bit-faithful functional emulator of the TrIM Slice/Core/Engine hierarchy.

This module executes a convolutional layer exactly the way the paper's
hardware does — same arithmetic (uint8 inputs x int8 weights -> signed int32
psums), same hierarchical reduction order (slice column psums -> slice adder
tree -> core adder tree -> engine temporal accumulation into psum buffers),
and the same ceil(N/P_N) x ceil(M/P_M) step schedule (paper §III).

Because integer addition is associative, the final tensor must equal a plain
int32 convolution — the *faithfulness* validated here is the schedule, the
psum-buffer contents per step, the bit-width growth contract
(2B+K -> +ceil(log2 K) -> +ceil(log2 P_M) -> +ceil(log2 M) bits), and the
memory-access counters, all of which tests compare against the paper.

Implementation is numpy (integer-exact, deterministic).  A copy of
``repro.core.trim.engine``; the same dataflow on the card is the conv
kernel's u8 x s8 lane (``repro_torch.kernels.trim_conv2d``), which takes
NHWC images and (K, K, C, F) weights where this emulator takes one
(M, H, W) image and (N, M, K, K) weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.model import (ConvLayerSpec, TrimEngineConfig,
                                   PAPER_ENGINE, trim_input_fetches)


# ---------------------------------------------------------------------------
# Slice: one 2-D K x K convolution, column-psum + adder-tree order
# ---------------------------------------------------------------------------


def _slice_conv2d(x_pad: np.ndarray, w: np.ndarray, check_widths: bool,
                  B: int) -> np.ndarray:
    """Stride-1 valid conv of one padded ifmap with one K x K kernel.

    Reduction order matches the slice hardware: per output pixel, each PE
    column accumulates K products vertically (bottom-row psum, 2B+K bits),
    then the adder tree reduces the K column psums (+ceil(log2 K) bits).
    """
    K = w.shape[0]
    H_p, W_p = x_pad.shape
    H_s, W_s = H_p - K + 1, W_p - K + 1
    windows = np.lib.stride_tricks.sliding_window_view(x_pad, (K, K))
    # (H_s, W_s, K, K) * (K, K) -> column psums then tree: sum over axis -2
    # (vertical/PE-column) first, then axis -1 (adder tree over columns).
    prods = windows.astype(np.int64) * w.astype(np.int64)
    col_psums = prods.sum(axis=-2)           # (H_s, W_s, K) bottom-row psums
    out = col_psums.sum(axis=-1)             # adder tree
    if check_widths:
        lim_col = 2 ** (2 * B + K - 1)
        lim_out = 2 ** (2 * B + K + math.ceil(math.log2(K)) - 1)
        assert np.abs(col_psums).max(initial=0) < lim_col, "2B+K width violated"
        assert np.abs(out).max(initial=0) < lim_out, "slice output width violated"
    return out


@dataclass
class EngineTrace:
    """Counters and per-step artifacts produced by one layer execution."""

    steps: int = 0
    weight_load_cycles: int = 0
    compute_cycles: int = 0
    ifmap_fetches: int = 0          # off-chip input element reads (modelled)
    weight_fetches: int = 0
    ofmap_writebacks: int = 0
    psum_buffer_accesses: int = 0   # on-chip RMW element accesses
    psum_buffer_snapshots: List[np.ndarray] = field(default_factory=list)
    max_abs_psum: int = 0


class TrimEngine:
    """Functional TrIM engine: P_N cores x P_M slices (paper Fig. 6)."""

    def __init__(self, config: TrimEngineConfig = PAPER_ENGINE,
                 check_widths: bool = True, record_snapshots: bool = False):
        self.cfg = config
        self.check_widths = check_widths
        self.record_snapshots = record_snapshots

    # -- core: P_M slices + adder tree ------------------------------------
    def _core_step(self, x_pad: np.ndarray, w_group: np.ndarray) -> np.ndarray:
        """3-D conv of a channel group: sum of per-slice 2-D convs.

        x_pad:   (m_g, H_p, W_p) uint8 ifmaps of this channel group
        w_group: (m_g, K, K) int8 kernels (one filter, this channel group)
        """
        cfg = self.cfg
        acc = None
        for m in range(x_pad.shape[0]):
            s = _slice_conv2d(x_pad[m], w_group[m], self.check_widths, cfg.B)
            acc = s if acc is None else acc + s
        if self.check_widths and acc is not None:
            lim = 2 ** (2 * cfg.B + cfg.K + math.ceil(math.log2(cfg.K))
                        + math.ceil(math.log2(max(cfg.P_M, 2))) - 1)
            assert np.abs(acc).max(initial=0) < lim, "core output width violated"
        return acc

    # -- engine ------------------------------------------------------------
    def run_layer(self, ifmaps: np.ndarray, weights: np.ndarray,
                  layer: Optional[ConvLayerSpec] = None,
                  ) -> Tuple[np.ndarray, EngineTrace]:
        """Execute one CL. ifmaps (M,H,W) uint8; weights (N,M,K,K) int8.

        Returns (ofmaps (N,H_O,W_O) int32, trace). Kernels with K larger than
        the native slice size are decomposed into 3x3 tiles (§V) and strides
        are applied by decimating the stride-1 sweep.
        """
        cfg = self.cfg
        M, H, W = ifmaps.shape
        N, M_w, K, K2 = weights.shape
        assert M == M_w and K == K2
        if layer is None:
            layer = ConvLayerSpec("layer", H, W, K, M, N)
        assert ifmaps.dtype == np.uint8 and weights.dtype == np.int8
        pad = layer.padding
        native = cfg.K
        t_side = math.ceil(K / native)
        # Tail padding so every tile's stride-1 sweep covers all output
        # positions (the zero-padded tile-kernel rows/cols multiply it away).
        extra = t_side * native - K
        x_pad = np.pad(ifmaps, ((0, 0), (pad, pad + extra),
                                (pad, pad + extra))).astype(np.int64)

        trace = EngineTrace()
        H_O, W_O = layer.H_O, layer.W_O
        out = np.zeros((N, H_O, W_O), dtype=np.int64)

        tiles = [(th * native, tw * native)
                 for th in range(t_side) for tw in range(t_side)]
        n_steps_m = math.ceil(M / cfg.P_M)

        # (filter, tile) pairs are the engine's unit of core assignment (§V);
        # for K<=3 there is a single tile and this is the plain schedule.
        pairs = [(f, t) for f in range(N) for t in range(len(tiles))]
        for pg in range(math.ceil(len(pairs) / cfg.P_N)):
            group = pairs[pg * cfg.P_N:(pg + 1) * cfg.P_N]
            psum_buffers = np.zeros((len(group), H_O, W_O), dtype=np.int64)
            for cg in range(n_steps_m):
                m0, m1 = cg * cfg.P_M, min((cg + 1) * cfg.P_M, M)
                for slot, (f, t) in enumerate(group):
                    oy, ox = tiles[t]
                    # tile kernel, zero-padded to native x native
                    wt = np.zeros((m1 - m0, native, native), dtype=np.int8)
                    sub = weights[f, m0:m1, oy:min(oy + native, K),
                                  ox:min(ox + native, K)]
                    wt[:, :sub.shape[1], :sub.shape[2]] = sub
                    # tile sweep: stride-1 over the padded map, offset (oy,ox)
                    xp = x_pad[m0:m1, oy:, ox:]
                    core_out = self._core_step(xp, wt)
                    # decimate to the layer's stride on the output grid
                    core_out = core_out[: layer.stride * H_O:layer.stride,
                                        : layer.stride * W_O:layer.stride]
                    psum_buffers[slot] += core_out
                    # RMW accounting: first step writes, middle steps R+W,
                    # last step reads out (matches model.py's 2S-2 rule).
                    if n_steps_m > 1:
                        trace.psum_buffer_accesses += (
                            H_O * W_O if cg in (0, n_steps_m - 1) else 2 * H_O * W_O)
                trace.steps += 1
                trace.weight_load_cycles += cfg.P_N * cfg.K
                trace.compute_cycles += (x_pad.shape[1] - native + 1) * (
                    x_pad.shape[2] - native + 1) if (K > native or layer.stride > 1) \
                    else H_O * W_O
                if self.record_snapshots:
                    trace.psum_buffer_snapshots.append(psum_buffers.copy())
            for slot, (f, t) in enumerate(group):
                out[f] += psum_buffers[slot]
            trace.ifmap_fetches += M * int(trim_input_fetches(layer, native))
            trace.max_abs_psum = max(trace.max_abs_psum,
                                     int(np.abs(psum_buffers).max(initial=0)))
        trace.weight_fetches = N * M * K * K
        trace.ofmap_writebacks = N * H_O * W_O

        if self.check_widths:
            lim = 2 ** (2 * cfg.B + cfg.K + math.ceil(math.log2(cfg.K))
                        + math.ceil(math.log2(max(M * len(tiles), 2))) + 1 - 1)
            assert np.abs(out).max(initial=0) < lim, "engine accum width violated"
        return out.astype(np.int32), trace


def trim_conv_layer(ifmaps: np.ndarray, weights: np.ndarray,
                    stride: int = 1, pad: Optional[int] = None,
                    config: TrimEngineConfig = PAPER_ENGINE) -> np.ndarray:
    """Convenience wrapper: run one layer through the emulator, outputs only."""
    M, H, W = ifmaps.shape
    N, _, K, _ = weights.shape
    layer = ConvLayerSpec("layer", H, W, K, M, N, stride=stride, pad=pad)
    out, _ = TrimEngine(config).run_layer(ifmaps, weights, layer)
    return out


def reference_conv_layer(ifmaps: np.ndarray, weights: np.ndarray,
                         stride: int = 1, pad: Optional[int] = None) -> np.ndarray:
    """Plain int conv oracle (numpy) for the emulator tests."""
    M, H, W = ifmaps.shape
    N, _, K, _ = weights.shape
    p = K // 2 if pad is None else pad
    x = np.pad(ifmaps.astype(np.int64), ((0, 0), (p, p), (p, p)))
    H_O = (H + 2 * p - K) // stride + 1
    W_O = (W + 2 * p - K) // stride + 1
    out = np.zeros((N, H_O, W_O), dtype=np.int64)
    for n in range(N):
        for i in range(K):
            for j in range(K):
                patch = x[:, i:i + stride * H_O:stride, j:j + stride * W_O:stride]
                out[n] += (patch * weights[n, :, i, j, None, None].astype(np.int64)
                           ).sum(axis=0)
    return out.astype(np.int32)

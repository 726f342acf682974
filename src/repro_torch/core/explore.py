"""Design-space exploration (paper §IV, Fig. 7).

Sweeps the parallelism parameters (P_N cores x P_M slices/core) and reports
throughput (eq. 1-2), psum-buffer size (eq. 3) and I/O bandwidth (eq. 4) —
reproducing Fig. 7 including the 1243 GOPs/s best case at P_N = P_M = 24 and
the P_N-vs-P_M efficiency asymmetry discussed in the text (576-PE example).

Also provides ``derive_fpga_parameters``: the §V procedure that picks
P_N = 7 from the BRAM budget and P_M = 24 from the DDR4 I/O budget.

A copy of ``repro.core.trim.explore`` over :mod:`repro_torch.core.model`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Sequence, Tuple

from repro_torch.core.model import (
    ConvLayerSpec,
    TrimEngineConfig,
    VGG16_LAYERS,
    io_bandwidth_bits,
    network_gops,
    psum_buffer_bits,
)

FIG7_GRID: Tuple[int, ...] = (1, 4, 8, 16, 24)


@dataclass(frozen=True)
class DesignPoint:
    P_N: int
    P_M: int
    n_pes: int
    gops: float
    psum_buffer_Mb: float
    io_bandwidth_bits: int


def explore(layers: Sequence[ConvLayerSpec] = VGG16_LAYERS,
            grid: Sequence[int] = FIG7_GRID,
            base: TrimEngineConfig = TrimEngineConfig(),
            H_OM: int = 224, W_OM: int = 224) -> List[DesignPoint]:
    points = []
    for pn in grid:
        for pm in grid:
            eng = replace(base, P_N=pn, P_M=pm)
            points.append(DesignPoint(
                P_N=pn, P_M=pm, n_pes=eng.n_pes,
                gops=network_gops(layers, eng),
                psum_buffer_Mb=psum_buffer_bits(eng, H_OM, W_OM) / 1e6,
                io_bandwidth_bits=io_bandwidth_bits(eng),
            ))
    return points


def derive_fpga_parameters(bram_bits: float = 312 * 36 * 1024,
                           ddr_peak_bytes_s: float = 19200e6,
                           f_clk_hz: float = 150e6,
                           H_OM: int = 224, W_OM: int = 224,
                           B: int = 8, K: int = 3) -> Tuple[int, int]:
    """§V sizing: P_N from on-chip memory, P_M from I/O bandwidth.

    The XCZU7EV's "11 Mb of BRAMs" is 312 36-Kb blocks = 11.50e6 bits —
    with the paper's rounded 11e6 the floor lands at 6, with the actual
    block count it lands at the paper's P_N = 7.

    P_N = floor(BRAM_bits / (H_OM*W_OM*32));   (eq. 3)
    BW_io = DDR bits per engine cycle, rounded down to a power of two;
    P_M = floor((BW_io - P_N*B) / (5*B)).      (eq. 4)
    """
    p_n = int(bram_bits // (H_OM * W_OM * 32))
    bits_per_cycle = ddr_peak_bytes_s * 8 / f_clk_hz
    bw = 2 ** int(math.floor(math.log2(bits_per_cycle)))
    p_m = int((bw - p_n * B) // (5 * B))
    return p_n, p_m

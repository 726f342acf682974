"""The paper's own models: the conv layer tables, the cycle model of
eqs. (1)-(4) and the memory-access models.

A copy of ``repro.core.trim.model`` (numpy-free arithmetic): the layer
descriptors (``ConvLayerSpec``, the VGG-16 / AlexNet stacks of Tables I
and II), the engine's architectural parameters (``TrimEngineConfig``,
``PAPER_ENGINE``), the closed-form models the paper uses for its
design-space exploration (Fig. 7) and for the throughput / utilization /
memory-access columns of Tables I and II (``layer_ops``,
``engine_cycles``, ``layer_gops``, ``pe_utilization``,
``trim_memory_accesses`` with its ``weight_bits`` for the int5 lane,
``ws_im2col_memory_accesses``, ``eyeriss_rs_memory_accesses``,
``network_report``).  The bit-faithful emulator is
:mod:`repro_torch.core.engine`, the slice simulator
:mod:`repro_torch.core.slice_sim`, the exploration
:mod:`repro_torch.core.explore`.

Modelling notes (divergences from the paper are *documented*, not hidden):

* Cycle model (eq. 2) is implemented verbatim and is EXACT for every
  K=3 / stride-1 layer of Tables I-II (all 13 VGG-16 CLs and AlexNet CL3-5).
* Large kernels (K>3) are decomposed into ceil(K/3)^2 tiles of 3x3, as §V
  describes for AlexNet. The paper does not give the full cycle equation for
  the tiled/strided path; we model it as (filter x tile) pairs scheduled over
  the P_N cores with stride-1 slice sweeps, which lands within ~25% of the
  printed CL1/CL2 AlexNet numbers.
* The memory-access counting methodology comes from the companion dataflow
  paper (arXiv:2408.01254) and is not fully specified here; the
  first-principles model (inputs fetched once per engine pass + triangular
  warm-up overhead; weights once; outputs once) reproduces the printed
  off-chip column within ~5% on VGG-16.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ConvLayerSpec:
    """One convolutional layer, in the paper's nomenclature.

    H_I, W_I : input feature-map height/width (pre-padding)
    K        : kernel size (square)
    M        : input channels  (# ifmaps)
    N        : output channels (# filters / ofmaps)
    stride   : convolution stride
    pad      : symmetric zero padding
    """

    name: str
    H_I: int
    W_I: int
    K: int
    M: int
    N: int
    stride: int = 1
    pad: Optional[int] = None  # default: 'same' for stride 1 -> K//2

    @property
    def padding(self) -> int:
        return self.K // 2 if self.pad is None else self.pad

    @property
    def H_O(self) -> int:
        return (self.H_I + 2 * self.padding - self.K) // self.stride + 1

    @property
    def W_O(self) -> int:
        return (self.W_I + 2 * self.padding - self.K) // self.stride + 1


@dataclass(frozen=True)
class TrimEngineConfig:
    """The TrIM engine's architectural parameters (paper §III-§V)."""

    P_N: int = 7      # parallel cores (filters / ofmaps)
    P_M: int = 24     # parallel slices per core (ifmaps)
    K: int = 3        # native slice kernel size
    B: int = 8        # operand bit width (uint8 inputs, int8 weights)
    f_clk_hz: float = 150e6
    L_I: int = 9      # engine pipeline depth (5 slice + 3 core tree + 1 accum)

    @property
    def n_pes(self) -> int:
        return self.P_N * self.P_M * self.K * self.K

    @property
    def peak_gops(self) -> float:
        """Peak throughput: 2 ops (mul+add) per PE per cycle."""
        return 2.0 * self.n_pes * self.f_clk_hz / 1e9


#: The configuration implemented on the XCZU7EV FPGA in §V.
PAPER_ENGINE = TrimEngineConfig()

VGG16_LAYERS: Tuple[ConvLayerSpec, ...] = (
    ConvLayerSpec("CL1", 224, 224, 3, 3, 64),
    ConvLayerSpec("CL2", 224, 224, 3, 64, 64),
    ConvLayerSpec("CL3", 112, 112, 3, 64, 128),
    ConvLayerSpec("CL4", 112, 112, 3, 128, 128),
    ConvLayerSpec("CL5", 56, 56, 3, 128, 256),
    ConvLayerSpec("CL6", 56, 56, 3, 256, 256),
    ConvLayerSpec("CL7", 56, 56, 3, 256, 256),
    ConvLayerSpec("CL8", 28, 28, 3, 256, 512),
    ConvLayerSpec("CL9", 28, 28, 3, 512, 512),
    ConvLayerSpec("CL10", 28, 28, 3, 512, 512),
    ConvLayerSpec("CL11", 14, 14, 3, 512, 512),
    ConvLayerSpec("CL12", 14, 14, 3, 512, 512),
    ConvLayerSpec("CL13", 14, 14, 3, 512, 512),
)

ALEXNET_LAYERS: Tuple[ConvLayerSpec, ...] = (
    ConvLayerSpec("CL1", 227, 227, 11, 3, 96, stride=4, pad=0),
    ConvLayerSpec("CL2", 27, 27, 5, 48, 256, pad=2),
    ConvLayerSpec("CL3", 13, 13, 3, 256, 384, pad=1),
    ConvLayerSpec("CL4", 13, 13, 3, 192, 384, pad=1),
    ConvLayerSpec("CL5", 13, 13, 3, 192, 256, pad=1),
)

#: Paper Table I / II reference values (TrIM columns), used by the benchmarks
#: for side-by-side validation. (GOPs/s, PE util, on-chip M, off-chip M).
PAPER_TABLE1_TRIM: Dict[str, Tuple[float, float, float, float]] = {
    "CL1": (51.8, 0.13, 0.00, 13.57),
    "CL2": (368.0, 1.00, 0.57, 102.79),
    "CL3": (387.0, 1.00, 0.27, 49.96),
    "CL4": (387.0, 1.00, 0.68, 95.33),
    "CL5": (396.0, 1.00, 0.33, 48.51),
    "CL6": (432.0, 1.00, 0.66, 94.71),
    "CL7": (432.0, 1.00, 0.66, 94.71),
    "CL8": (422.0, 1.00, 0.33, 52.44),
    "CL9": (422.0, 1.00, 0.70, 103.72),
    "CL10": (422.0, 1.00, 0.70, 103.72),
    "CL11": (389.0, 1.00, 0.17, 33.05),
    "CL12": (389.0, 1.00, 0.17, 33.05),
    "CL13": (389.0, 1.00, 0.17, 33.05),
}
PAPER_TABLE1_EYERISS_TOTALS = {"on_chip_M": 2427.63, "off_chip_M": 160.65,
                               "total_M": 2588.28, "gops": 24.5}
PAPER_TABLE1_TRIM_TOTALS = {"on_chip_M": 5.44, "off_chip_M": 858.63,
                            "total_M": 864.06, "gops": 391.0}

PAPER_TABLE2_TRIM: Dict[str, Tuple[float, float, float, float]] = {
    "CL1": (2.13, 1.00, 0.08, 8.44),
    "CL2": (179.0, 0.57, 0.21, 3.50),
    "CL3": (390.0, 1.00, 0.11, 14.85),
    "CL4": (402.0, 1.00, 0.07, 11.20),
    "CL5": (399.0, 1.00, 0.05, 7.52),
}
PAPER_TABLE2_TRIM_TOTALS = {"on_chip_M": 0.53, "off_chip_M": 45.50,
                            "total_M": 46.03, "gops": 12.9}
PAPER_TABLE2_EYERISS_TOTALS = {"on_chip_M": 77.45, "off_chip_M": 7.70,
                               "total_M": 85.15, "gops": 51.5}

#: Batch sizes used by the paper's normalization footnotes.
VGG16_BATCH = 3
ALEXNET_BATCH = 4

# ---------------------------------------------------------------------------
# Paper equations (1)-(4)
# ---------------------------------------------------------------------------


def layer_ops(layer: ConvLayerSpec) -> int:
    """Eq. (1): OPs = 2 * K^2 * H_O * W_O * M * N (multiply + add)."""
    return 2 * layer.K * layer.K * layer.H_O * layer.W_O * layer.M * layer.N


def _kernel_tiles(K: int, native_k: int) -> int:
    """Number of native_k x native_k tiles covering a K x K kernel (§V)."""
    t = math.ceil(K / native_k)
    return t * t


def engine_cycles(layer: ConvLayerSpec, eng: TrimEngineConfig = PAPER_ENGINE) -> int:
    """Eq. (2): clock cycles to execute one CL on the engine.

    NC = L_I + ceil(N/P_N) * ceil(M/P_M) * (P_N*K + H_O*W_O)

    For K > native slice size, the kernel is decomposed into ceil(K/3)^2
    3x3 tiles and *cores cooperate on one filter* (paper §V: "P_M 5x5
    kernels are split in 4 groups of P_M tiles each. Each group is
    processed by a TrIM Core"):

    - concurrent filters = max(1, floor(P_N / tiles)); a filter whose tile
      count exceeds P_N takes ceil(tiles/P_N) rounds (AlexNet 11x11: 16
      tiles over 7 cores -> 3 rounds);
    - stride-1 tile sweeps cover H_O*W_O positions; *strided* layers must
      stream the full stride-1 extent and decimate downstream, which is why
      AlexNet CL1 shows full PE activity but only 2.13 useful GOPs/s.

    This reproduces Table II within ~2.5% on CL1/CL2 and exactly on CL3-5.
    """
    if layer.K <= eng.K and layer.stride == 1:
        steps = math.ceil(layer.N / eng.P_N) * math.ceil(layer.M / eng.P_M)
        return eng.L_I + steps * (eng.P_N * eng.K + layer.H_O * layer.W_O)
    # Tiled / strided path (§V, AlexNet).
    tiles = _kernel_tiles(layer.K, eng.K)
    concurrent = max(1, eng.P_N // tiles)
    tile_rounds = math.ceil(tiles / min(tiles, eng.P_N))
    filter_rounds = math.ceil(layer.N / concurrent) * tile_rounds
    steps = filter_rounds * math.ceil(layer.M / eng.P_M)
    if layer.stride == 1:
        sweep = layer.H_O * layer.W_O
    else:  # stream the full stride-1 extent, decimate downstream
        h_sweep = layer.H_I + 2 * layer.padding - eng.K + 1
        w_sweep = layer.W_I + 2 * layer.padding - eng.K + 1
        sweep = h_sweep * w_sweep
    return eng.L_I + steps * (eng.P_N * eng.K + sweep)


def steady_pe_activity(layer: ConvLayerSpec,
                       eng: TrimEngineConfig = PAPER_ENGINE) -> float:
    """Fraction of PEs busy during steady-state compute steps.

    This matches the paper's "PE Util." column definition: full groups count
    as fully busy; under-filled *structural* parallelism shows up here.

    - untiled layers (K <= native): slices hold channels -> activity is
      min(1, M/P_M). VGG CL1: 3 of 24 slices -> 0.13 (paper: 0.13).
    - tiled layers with M >= P_M: each filter's P_M-channel group needs
      `tiles` cores. AlexNet CL2 (5x5, 4 tiles): 4 of 7 cores -> 0.57
      (paper: 0.57).
    - tiled layers with M < P_M: (channel x tile) pairs PACK into a core's
      slices (the hardware re-purposes idle slices for other tiles), and
      filters stagger across rounds. AlexNet CL1 (11x11, M=3): 3*16 = 48
      slice-jobs per filter over 96 filters saturate the array -> 1.00
      (paper: 1.00).
    """
    tiles = _kernel_tiles(layer.K, eng.K) if layer.K > eng.K else 1
    if tiles == 1:
        return min(1.0, layer.M / eng.P_M)
    if layer.M < eng.P_M:
        total_jobs = layer.N * layer.M * tiles
        return min(1.0, total_jobs / (eng.P_N * eng.P_M))
    core_act = (max(1, eng.P_N // tiles) * min(tiles, eng.P_N)) / eng.P_N
    return min(1.0, layer.M / eng.P_M) * core_act


def layer_time_s(layer: ConvLayerSpec, eng: TrimEngineConfig = PAPER_ENGINE) -> float:
    return engine_cycles(layer, eng) / eng.f_clk_hz


def layer_gops(layer: ConvLayerSpec, eng: TrimEngineConfig = PAPER_ENGINE) -> float:
    """Sustained throughput for one layer, GOPs/s (useful operations only)."""
    return layer_ops(layer) / layer_time_s(layer, eng) / 1e9


def pe_utilization(layer: ConvLayerSpec, eng: TrimEngineConfig = PAPER_ENGINE) -> float:
    """Useful MACs per cycle over peak MACs per cycle."""
    return layer_gops(layer, eng) / eng.peak_gops


def psum_buffer_bits(eng: TrimEngineConfig, H_OM: int, W_OM: int,
                     act_bits: int = 32) -> int:
    """Eq. (3): total psum buffer size = P_N * H_OM * W_OM * 32 bits."""
    return eng.P_N * H_OM * W_OM * act_bits


def io_bandwidth_bits(eng: TrimEngineConfig) -> int:
    """Eq. (4): BW_I/O = (P_M * 5 + P_N) * B bits per cycle (K=3 peak)."""
    return (eng.P_M * 5 + eng.P_N) * eng.B


def network_cycles(layers: Sequence[ConvLayerSpec],
                   eng: TrimEngineConfig = PAPER_ENGINE) -> int:
    return sum(engine_cycles(l, eng) for l in layers)


def network_gops(layers: Sequence[ConvLayerSpec],
                 eng: TrimEngineConfig = PAPER_ENGINE) -> float:
    ops = sum(layer_ops(l) for l in layers)
    t = network_cycles(layers, eng) / eng.f_clk_hz
    return ops / t / 1e9


# ---------------------------------------------------------------------------
# Memory-access models
# ---------------------------------------------------------------------------
# All counts are in element accesses (one access = one B-bit operand), per
# batch of `batch` images, matching the paper's footnote normalization.


@dataclass(frozen=True)
class MemoryAccesses:
    """Access counts, in millions of element accesses."""

    ifmap_reads: float
    weight_reads: float
    ofmap_writes: float
    onchip_raw: float          # raw on-chip (psum buffer / scratchpad) accesses
    onchip_equiv: float        # energy-normalized to off-chip units (/128)

    @property
    def off_chip(self) -> float:
        return self.ifmap_reads + self.weight_reads + self.ofmap_writes

    @property
    def total(self) -> float:
        return self.off_chip + self.onchip_equiv


#: 32-bit DRAM read ~640 pJ vs 32-bit SRAM read ~5 pJ (paper §I, Horowitz) —
#: the factor used to express on-chip accesses in off-chip-equivalent units.
DRAM_OVER_SRAM_ENERGY = 128.0


def trim_input_fetches(layer: ConvLayerSpec, native_k: int = 3) -> float:
    """External (off-chip) fetches for ONE ifmap, one engine pass.

    The triangular movement's single-fetch guarantee: every *padded* input
    element is fetched exactly once per pass (validated operand-by-operand by
    ``slice_sim.simulate_slice``). The overhead over the useful H*W elements
    is therefore just the padded boundary: 900/50176 = 1.79% for a 3x3
    kernel over 224x224 — the "negligible 1.8% overhead" quoted in §II.
    """
    H_p = layer.H_I + 2 * layer.padding
    W_p = layer.W_I + 2 * layer.padding
    return H_p * W_p


def trim_memory_accesses(layer: ConvLayerSpec,
                         eng: TrimEngineConfig = PAPER_ENGINE,
                         batch: int = 1,
                         weight_bits: Optional[int] = None) -> MemoryAccesses:
    """First-principles TrIM access model (see module docstring).

    ``weight_bits`` models a sub-``B``-bit stored weight lane: accesses are
    counted in ``B``-bit element units, so storing each weight in
    ``weight_bits`` bits scales ``weight_reads`` by ``weight_bits / B`` —
    the int5 MSR lane (DESIGN.md §9.3) ships 5/8 of the int8 lane's weight
    traffic (its 4-bit magnitude plane alone is exactly half; the sign
    plane is the remaining 1/8).  ``None`` keeps full-width weights.
    """
    tiles = _kernel_tiles(layer.K, eng.K) if layer.K > eng.K else 1
    # Every group of P_N filters requires one full pass over the ifmaps
    # (broadcast to all cores); weights are fetched exactly once overall.
    # For tiled kernels (K>3) we assume tile rounds within a filter group
    # re-circulate the stream from the on-chip sub-buffers — a conservative
    # *upper bound* on the paper's (unspecified) large-K accounting.
    passes = math.ceil(layer.N / eng.P_N)
    ifmap_reads = batch * passes * layer.M * trim_input_fetches(layer, eng.K)
    weight_reads = layer.N * layer.M * layer.K * layer.K
    if weight_bits is not None:
        if not 0 < weight_bits <= eng.B:
            raise ValueError(
                f"weight_bits must be in (0, {eng.B}], got {weight_bits}")
        weight_reads *= weight_bits / eng.B
    ofmap_writes = batch * layer.N * layer.H_O * layer.W_O
    # Psum-buffer traffic: per (filter-group pass, core): S = ceil(M/P_M)
    # temporal steps; step 1 write-only, steps 2..S-1 read+write, step S
    # read-only -> 2S-2 buffer accesses per output activation (S>1), else 0
    # (single-step layers bypass the buffer).
    S = math.ceil(layer.M / eng.P_M)
    rmw = max(2 * S - 2, 0) if S > 1 else 0
    # one psum-buffer slot per (filter, tile) pair actually scheduled
    onchip_raw = batch * layer.N * tiles * rmw * layer.H_O * layer.W_O
    # Psums are 32-bit vs B-bit operands: count in B-bit equivalents first.
    onchip_raw_equiv_width = onchip_raw * (32 / eng.B)
    onchip_equiv = onchip_raw_equiv_width / DRAM_OVER_SRAM_ENERGY
    return MemoryAccesses(
        ifmap_reads=ifmap_reads / 1e6,
        weight_reads=weight_reads / 1e6,
        ofmap_writes=ofmap_writes / 1e6,
        onchip_raw=onchip_raw / 1e6,
        onchip_equiv=onchip_equiv / 1e6,
    )


def ws_im2col_memory_accesses(layer: ConvLayerSpec, batch: int = 1,
                              array_cols: int = 256) -> MemoryAccesses:
    """GeMM-based weight-stationary baseline (TPU-style, paper §II).

    Conv-to-GeMM materializes each input element K^2 times (sliding-window
    redundancy): the im2col operand is (H_O*W_O) x (K^2*M) and is streamed
    once per group of `array_cols` filters held stationary.
    """
    passes = math.ceil(layer.N / array_cols)
    im2col_elems = layer.H_O * layer.W_O * layer.K * layer.K * layer.M
    ifmap_reads = batch * passes * im2col_elems
    weight_reads = layer.N * layer.M * layer.K * layer.K
    ofmap_writes = batch * layer.N * layer.H_O * layer.W_O
    return MemoryAccesses(ifmap_reads / 1e6, weight_reads / 1e6,
                          ofmap_writes / 1e6, 0.0, 0.0)


def eyeriss_rs_memory_accesses(layer: ConvLayerSpec, batch: int = 1,
                               pe_rows: int = 12, pe_cols: int = 14,
                               spad_per_mac: float = 4.0,
                               ) -> MemoryAccesses:
    """Row-stationary (Eyeriss) access model, first-principles.

    Each PE circulates one ifmap row against one kernel row in scratchpads:
    every MAC touches >= (ifmap spad + weight spad + psum spad read&write)
    = 4 scratchpad accesses — this is why §V reports ~94% of Eyeriss'
    equivalent on-chip accesses coming from PE scratchpads. The paper's
    printed Table-I Eyeriss column corresponds to ~6.8 accesses/MAC
    (their count also folds in spad refills and GLB traffic; the exact
    methodology comes from the Eyeriss energy model and is not specified
    here) — pass ``spad_per_mac=6.8`` to reproduce the printed ~3x ratio;
    the default 4.0 is the conservative lower bound and still preserves
    the TrIM < Eyeriss total-access ordering. Off-chip: the global buffer
    + RLC compression lets Eyeriss fetch ifmaps ~once and weights once per
    row-tile pass (the paper credits Eyeriss with 5.3x fewer off-chip
    accesses than TrIM on VGG-16).
    """
    macs = layer.K * layer.K * layer.H_O * layer.W_O * layer.M * layer.N
    onchip_raw = batch * spad_per_mac * macs
    onchip_equiv = onchip_raw / DRAM_OVER_SRAM_ENERGY
    # Off-chip: ifmaps once + weights re-fetched per spatial fold + ofmaps.
    folds = math.ceil(layer.H_O / pe_rows)
    ifmap_reads = batch * layer.M * layer.H_I * layer.W_I
    weight_reads = folds * layer.N * layer.M * layer.K * layer.K
    ofmap_writes = batch * layer.N * layer.H_O * layer.W_O
    return MemoryAccesses(ifmap_reads / 1e6, weight_reads / 1e6,
                          ofmap_writes / 1e6, onchip_raw / 1e6, onchip_equiv / 1e6)


# ---------------------------------------------------------------------------
# Whole-network report (drives the Table I/II benchmarks)
# ---------------------------------------------------------------------------


def network_report(layers: Sequence[ConvLayerSpec],
                   eng: TrimEngineConfig = PAPER_ENGINE,
                   batch: int = 1,
                   weight_bits: Optional[int] = None) -> List[Dict[str, float]]:
    """Per-layer model outputs in the shape of the paper's Tables I/II.

    ``weight_bits`` scales the weight-read column for sub-8-bit stored
    weight lanes (see :func:`trim_memory_accesses`)."""
    rows: List[Dict[str, float]] = []
    for l in layers:
        acc = trim_memory_accesses(l, eng, batch=batch,
                                   weight_bits=weight_bits)
        rows.append({
            "name": l.name,
            "ops_G": layer_ops(l) / 1e9,
            "cycles": engine_cycles(l, eng),
            "time_ms": layer_time_s(l, eng) * 1e3,
            "gops": layer_gops(l, eng),
            "pe_util": pe_utilization(l, eng),
            "pe_activity": steady_pe_activity(l, eng),
            "offchip_M": acc.off_chip,
            "onchip_M": acc.onchip_equiv,
            "total_M": acc.total,
        })
    return rows

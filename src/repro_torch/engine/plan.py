"""Static execution plans: resolve each conv layer's schedule once.

Port of ``repro/engine/plan.py``.  A :class:`ConvLayerPlan` is the static
schedule of one conv layer — its shape, epilogue descriptor, substrate
choice and the integer lane's launch geometry (``kernels.trim_conv2d.
u8_tile``, per conv group, at batch 1 in ``tile`` and at any batch from
``launch``) — and :func:`plan_model` walks a ``CNNConfig`` into a
:class:`ModelPlan` whose entry points run the whole network through
``repro_torch.engine.execute``.  Both are frozen dataclasses of plain
values: hashable, comparable by value and cached.

The substrate stays unresolved in the plan ("auto" | "kernel" |
"oracle" | "f32exact"): the dispatch rule reads the device of the tensor
at run time (``policy.resolve_substrate``).  Under the policy's
``emulate_hw`` a strided layer's plan replays the FPGA's schedule
(:attr:`ConvLayerPlan.decimate`: a stride-1 sweep, planned as such, then
decimation and the unfused epilogue).  The int5 lane's plans carry
``w_bits=5``, which widens the f32exact substrate's exact channel chunks.
Plan-time tuning is not ported yet (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.engine.policy import ExecutionPolicy
from repro_torch.kernels.trim_conv2d import U8Tile, u8_tile

#: The model datapaths: the float lane, the int8 lane and the int5 MSR
#: lane (int8 operands with ``|w| <= 31`` and a per-channel exponent).
DATAPATHS = ("float", "int8", "int5")


@dataclass(frozen=True)
class ConvLayerPlan:
    """Static schedule for one TrIM conv layer.

    ``c_in``/``c_out`` count all groups; ``tile_h``/``tile_w``/
    ``block_c``/``block_f`` are the policy's knobs (the last two limited
    to one group's channels/filters), kept as the JAX package's plan keeps
    them and read by no CUDA launch.  ``tile`` is the geometry the integer
    lane launches for one group at batch 1 (``u8_tile``); its path and
    split follow the batch, so :meth:`launch` gives any batch's.  The fp32
    lane plans its own (``f32_tile``).  Where :attr:`decimate` holds, both
    are the stride-1 sweep's.  ``w_bits`` is the stored weight width: 8,
    or 5 on the int5 MSR lane, whose operands keep ``|w| <= 31``.
    """

    x_hw: Tuple[int, int]
    c_in: int
    k: int
    c_out: int
    stride: int
    padding: Optional[int]
    groups: int
    relu: bool
    pool: bool
    has_bias: bool
    requant_kind: Optional[str]
    substrate: str
    tile_h: int
    tile_w: int
    block_c: int
    block_f: int
    epilogue: str
    tile: U8Tile
    emulate_hw: bool = False
    w_bits: int = 8

    @property
    def decimate(self) -> bool:
        """FPGA-faithful strided-layer replay: stride-1 sweep + decimation
        + unfused epilogue (paper §V)."""
        return self.emulate_hw and self.stride > 1

    def launch(self, batch: int = 1) -> U8Tile:
        """The integer lane's launch geometry for one group at ``batch``."""
        if batch == 1:
            return self.tile
        return u8_tile(self.x_hw, self.c_in // self.groups, self.k,
                       self.c_out // self.groups,
                       stride=1 if self.decimate else self.stride,
                       padding=self.padding, batch=batch)

    def describe(self, batches: Tuple[int, ...] = (1,)) -> Dict[str, object]:
        """Compact schedule record (serve artifacts): per batch of
        ``batches``, the integer lane's launch: path, output tile, k32
        steps an item, items, ranges and stages."""
        def launch(b):
            t = self.launch(b)
            return {"batch": int(b),
                    "path": ("window", "gather", "slide")[t.path],
                    "tile": [t.TH, t.TW], "steps": t.steps,
                    "items": t.n_items, "split": t.n_split,
                    "stages": t.stages}

        d = {"substrate": self.substrate, "epilogue": self.epilogue,
             "launches": [launch(b) for b in batches]}
        if self.w_bits != 8:
            d["w_bits"] = self.w_bits
        return d


@functools.lru_cache(maxsize=None)
def plan_conv_layer(
    x_hw: Tuple[int, int],
    c_in: int,
    k: int,
    c_out: int,
    *,
    stride: int = 1,
    padding: Optional[int] = None,
    groups: int = 1,
    relu: bool = False,
    pool: bool = False,
    has_bias: bool = False,
    requant_kind: Optional[str] = None,
    w_bits: int = 8,
    policy: ExecutionPolicy = ExecutionPolicy(),
) -> ConvLayerPlan:
    """One layer's static schedule under ``policy`` (cached).

    ``requant_kind`` is None | "shift" | "mult_shift"; the multiplier and
    shift values stay runtime arguments.  ``w_bits`` is 8, or 5 for the
    int5 lane's ``|w| <= 31`` operands.
    """
    if c_in % groups or c_out % groups:
        raise ValueError(f"groups={groups} does not divide c_in={c_in} "
                         f"and c_out={c_out}")
    cg, fg = c_in // groups, c_out // groups
    block_c = min(policy.block_c, cg)
    block_f = min(policy.block_f, fg)
    decimate = policy.emulate_hw and stride > 1
    tile = u8_tile(tuple(x_hw), cg, k, fg, stride=1 if decimate else stride,
                   padding=padding)
    parts = []
    if has_bias:
        parts.append("bias")
    if relu:
        parts.append("relu")
    if requant_kind == "shift":
        parts.append("requant_shift")
    elif requant_kind == "mult_shift":
        parts.append("requant")
    epilogue = "+".join(parts) if parts else "linear"
    if decimate:
        epilogue = f"decimate->{epilogue}"
    return ConvLayerPlan(
        x_hw=tuple(x_hw), c_in=c_in, k=k, c_out=c_out, stride=stride,
        padding=padding, groups=groups, relu=relu, pool=pool,
        has_bias=has_bias, requant_kind=requant_kind,
        substrate=policy.substrate, tile_h=policy.tile_h,
        tile_w=policy.tile_w, block_c=block_c, block_f=block_f,
        epilogue=epilogue, tile=tile, emulate_hw=policy.emulate_hw,
        w_bits=int(w_bits))


@dataclass(frozen=True)
class ModelPlan:
    """Per-layer plans + entry points for one CNN under one policy."""

    cfg: object
    policy: ExecutionPolicy
    layers: Tuple[ConvLayerPlan, ...]
    datapath: str = "float"

    def init(self, generator, device="cuda"):
        from repro_torch.nn.conv import init_cnn

        return init_cnn(generator, self.cfg, device)

    def forward(self, params, images):
        from repro_torch.engine import execute

        return execute.forward(self, params, images)

    def serve_forward(self, params, images):
        from repro_torch.engine import execute

        return execute.serve_forward(self, params, images)

    def loss(self, params, batch):
        from repro_torch.engine import execute

        return execute.loss(self, params, batch)

    def quantize(self, params):
        from repro_torch.nn.conv import quantize_cnn

        return quantize_cnn(params, self.cfg)

    def forward_int8(self, qparams, images_u8, requant_shifts=None,
                     requant=None):
        from repro_torch.engine import execute

        return execute.forward_int8(self, qparams, images_u8,
                                    requant_shifts=requant_shifts,
                                    requant=requant)

    def calibrate_requant_shifts(self, qparams, sample_u8):
        from repro_torch.engine import execute

        return execute.calibrate_requant_shifts(self, qparams, sample_u8)

    def calibrate_requant(self, qparams, sample_u8, per_channel=True):
        from repro_torch.engine import execute

        return execute.calibrate_requant(self, qparams, sample_u8,
                                         per_channel=per_channel)

    def quantize_int5(self, params, compensate=True):
        from repro_torch.nn.conv import quantize_cnn_int5

        return quantize_cnn_int5(params, self.cfg, compensate=compensate)

    def forward_int5(self, qparams, images_u8, requant=None):
        from repro_torch.engine import execute

        return execute.forward_int5(self, qparams, images_u8,
                                    requant=requant)

    def calibrate_requant_int5(self, qparams, sample_u8, per_channel=True):
        from repro_torch.engine import execute

        return execute.calibrate_requant_int5(self, qparams, sample_u8,
                                              per_channel=per_channel)

    @property
    def int8(self) -> "ModelPlan":
        """The integer-datapath sibling plan (bias-free, fused requant on
        every non-last layer) — what ``forward_int8`` runs."""
        return plan_model(self.cfg, self.policy, c_in=self.layers[0].c_in,
                          datapath="int8")

    @property
    def int5(self) -> "ModelPlan":
        """The int5 MSR lane's sibling plan: :attr:`int8` with ``w_bits=5``
        on every layer — what ``forward_int5`` runs."""
        return plan_model(self.cfg, self.policy, c_in=self.layers[0].c_in,
                          datapath="int5")

    def executable_for(self, batch: int, datapath: str = "float",
                       device="cuda"):
        """The serving callable for one static batch size (cached per
        (plan, batch, datapath, device) in ``execute.executable_for``)."""
        from repro_torch.engine import execute

        return execute.executable_for(self, batch, datapath, device)

    def describe(self, batches: Tuple[int, ...] = (1,)
                 ) -> Tuple[Dict[str, object], ...]:
        return tuple(lp.describe(batches) for lp in self.layers)


@functools.lru_cache(maxsize=None)
def plan_model(
    cfg,
    policy: ExecutionPolicy = ExecutionPolicy(),
    c_in: Optional[int] = None,
    datapath: str = "float",
) -> ModelPlan:
    """Compile a ``CNNConfig`` into a :class:`ModelPlan` (cached).

    ``datapath`` is "float" (biased convs, fused bias+ReLU), "int8"
    (bias-free, fused ReLU + multiplier+shift requant on every non-last
    layer; the last layer emits its ReLU'd int32 psums) or "int5" (the
    int8 plans with ``w_bits=5``).  ``c_in`` overrides the first layer's
    input channel count.
    """
    if datapath not in DATAPATHS:
        raise ValueError(f"datapath {datapath!r} not in {DATAPATHS}")
    int8 = datapath in ("int8", "int5")
    plans = []
    c = cfg.layers[0].M if c_in is None else int(c_in)
    last_i = len(cfg.layers) - 1
    for i, l in enumerate(cfg.layers):
        plans.append(plan_conv_layer(
            (l.H_I, l.W_I), c, l.K, l.N, stride=l.stride,
            padding=l.padding, groups=c // l.M, relu=True,
            pool=i in cfg.pool_after, has_bias=not int8,
            requant_kind="mult_shift" if int8 and i != last_i else None,
            w_bits=5 if datapath == "int5" else 8, policy=policy))
        c = l.N
    return ModelPlan(cfg=cfg, policy=policy, layers=tuple(plans),
                     datapath=datapath)

"""Static execution plans: resolve each conv layer's schedule once.

Port of ``repro/engine/plan.py``.  A :class:`ConvLayerPlan` is the static
schedule of one conv layer — its shape, epilogue descriptor, substrate
choice and its kernel launch overrides (``schedule``, a
``kernels.trim_conv2d.Schedule``), with the integer lane's launch
geometry (``kernels.trim_conv2d.u8_tile``, per conv group, at batch 1 in
``tile`` and at any batch from ``launch``) — and :func:`plan_model`
walks a ``CNNConfig`` into a :class:`ModelPlan` whose entry points run the
whole network through ``repro_torch.engine.execute``.  Both are frozen
dataclasses of plain values: hashable, comparable by value and cached.

The substrate stays unresolved in the plan ("auto" | "kernel" |
"oracle" | "f32exact"): the dispatch rule reads the device of the tensor
at run time (``policy.resolve_substrate``).  Under the policy's
``emulate_hw`` a strided layer's plan replays the FPGA's schedule
(:attr:`ConvLayerPlan.decimate`: a stride-1 sweep, planned as such, then
decimation and the unfused epilogue).  The int5 lane's plans carry
``w_bits=5``, which widens the f32exact substrate's exact channel chunks.
Under ``policy.tuning`` "cached" / "auto" each layer planned with
``substrate="auto"`` takes the autotuner's persisted winner for its key
(``engine/autotune.py``): its substrate and schedule, ``tuned=True``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.engine.policy import ExecutionPolicy
from repro_torch.kernels.trim_conv2d import (U8_PATH_NAMES, F32Tile,
                                             Schedule, U8Tile, bf16_tile,
                                             f32_tile, u8_tile)

#: The model datapaths: the float lane, the int8 lane and the int5 MSR
#: lane (int8 operands with ``|w| <= 31`` and a per-channel exponent).
DATAPATHS = ("float", "int8", "int5")


@dataclass(frozen=True)
class ConvLayerPlan:
    """Static schedule for one TrIM conv layer.

    ``c_in``/``c_out`` count all groups.  ``schedule`` holds the launch
    overrides of the layer's lane (the policy's knobs, or the tuned
    winner's), checked at plan time; ``in_sz`` names the lane (1: u8 x s8,
    2: bf16, 4: fp32).  ``tile`` is the geometry the integer lane launches for one
    group at batch 1 (``u8_tile``, with ``schedule`` on an integer plan);
    its path and split follow the batch, so :meth:`launch` gives any
    batch's.  :meth:`f32` is the fp32 lane's (``f32_tile``, the same at
    every batch).  Where :attr:`decimate` holds, both are the stride-1
    sweep's.  ``w_bits`` is the stored weight width: 8, or 5 on the int5
    MSR lane, whose operands keep ``|w| <= 31``.  ``tuned`` marks a
    schedule from the autotuner's cache: metadata, not schedule
    (``compare=False``), so a tuned plan whose winner is the default
    equals the default plan and shares its executables.
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
    epilogue: str
    tile: U8Tile
    emulate_hw: bool = False
    w_bits: int = 8
    in_sz: int = 4
    schedule: Schedule = Schedule()
    tuned: bool = field(default=False, compare=False)

    @property
    def decimate(self) -> bool:
        """FPGA-faithful strided-layer replay: stride-1 sweep + decimation
        + unfused epilogue (paper §V)."""
        return self.emulate_hw and self.stride > 1

    def _shape(self):
        return ((self.x_hw, self.c_in // self.groups, self.k,
                 self.c_out // self.groups),
                dict(stride=1 if self.decimate else self.stride,
                     padding=self.padding))

    def launch(self, batch: int = 1) -> U8Tile:
        """The integer lane's launch geometry for one group at ``batch``."""
        if batch == 1:
            return self.tile
        args, kw = self._shape()
        sched = self.schedule.u8() if self.in_sz == 1 else {}
        return u8_tile(*args, **kw, batch=batch, **sched)

    def f32(self) -> F32Tile:
        """The fp32 lane's launch geometry for one group (every batch)."""
        args, kw = self._shape()
        sched = self.schedule.f32() if self.in_sz != 1 else {}
        return f32_tile(*args, **kw, **sched)

    def describe(self, batches: Tuple[int, ...] = (1,)) -> Dict[str, object]:
        """Compact schedule record (serve artifacts): per batch of
        ``batches``, the integer lane's launch: path, output tile, k32
        steps an item, items, ranges and stages; the overrides where the
        schedule has any, and ``tuned`` where it came from the cache."""
        def launch(b):
            t = self.launch(b)
            return {"batch": int(b), "path": U8_PATH_NAMES[t.path],
                    "tile": [t.TH, t.TW], "steps": t.steps,
                    "items": t.n_items, "split": t.n_split,
                    "stages": t.stages}

        d = {"substrate": self.substrate, "epilogue": self.epilogue,
             "launches": [launch(b) for b in batches]}
        if not self.schedule.default:
            d["schedule"] = {k: v for k, v in
                             vars(self.schedule).items() if v is not None}
            if self.in_sz != 1:
                t = self.f32()
                d["f32"] = {"tile": [t.TH, t.TW], "block_c": t.Cb,
                            "split": t.n_split, "stages": t.stages}
        if self.w_bits != 8:
            d["w_bits"] = self.w_bits
        if self.tuned:
            d["tuned"] = True
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
    in_sz: int = 4,
    w_sz: int = 4,
    out_sz: int = 4,
    w_bits: int = 8,
    policy: ExecutionPolicy = ExecutionPolicy(),
    batch: int = 1,
) -> ConvLayerPlan:
    """One layer's static schedule under ``policy`` (cached).

    ``requant_kind`` is None | "shift" | "mult_shift"; the multiplier and
    shift values stay runtime arguments.  ``in_sz``/``w_sz``/``out_sz``
    are the element byte sizes (1, 1, 1 or 4 on the integer lanes, 4 on
    the float lane): ``in_sz`` picks the lane the schedule applies to, and
    all three key the autotuner's cache.  ``w_bits`` is 8, or 5 for the
    int5 lane's ``|w| <= 31`` operands.  ``batch`` only selects which
    batch's tuned winner applies; the kernels take the batch from the
    tensor.

    Under ``policy.tuning`` "cached" / "auto" with ``substrate="auto"`` the
    autotuner's persisted winner for the layer's key replaces the policy's
    substrate and schedule (``tuned=True``); a miss plans from the policy
    under "cached" and tunes once (measures) under "auto".  A pinned
    substrate is a stronger request than the cache and plans as if tuning
    were off.  Every override is checked against the layer's lane here.
    """
    if c_in % groups or c_out % groups:
        raise ValueError(f"groups={groups} does not divide c_in={c_in} "
                         f"and c_out={c_out}")
    pol = policy
    tuned = False
    if policy.tuning != "off" and policy.substrate == "auto":
        from repro_torch.engine import autotune  # it imports this module

        schedule = autotune.tuned_schedule(
            tuple(x_hw), c_in, k, c_out, stride=stride, padding=padding,
            groups=groups, relu=relu, has_bias=has_bias,
            requant_kind=requant_kind, in_sz=in_sz, w_sz=w_sz,
            out_sz=out_sz, w_bits=w_bits, policy=policy, batch=batch)
        pol = pol.with_overrides(tuning="off")
        if schedule is not None:
            pol = pol.with_overrides(**schedule)
            tuned = True
    cg, fg = c_in // groups, c_out // groups
    decimate = pol.emulate_hw and stride > 1
    shape = dict(stride=1 if decimate else stride, padding=padding)
    sched = pol.schedule
    if in_sz == 1:
        tile = u8_tile(tuple(x_hw), cg, k, fg, **shape, **sched.u8())
    elif in_sz == 2:
        bf16_tile(tuple(x_hw), cg, k, fg, **shape, **sched.bf16())
        tile = u8_tile(tuple(x_hw), cg, k, fg, **shape)
    else:
        f32_tile(tuple(x_hw), cg, k, fg, **shape, **sched.f32())
        tile = u8_tile(tuple(x_hw), cg, k, fg, **shape)
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
        substrate=pol.substrate, epilogue=epilogue, tile=tile,
        emulate_hw=pol.emulate_hw, w_bits=int(w_bits), in_sz=int(in_sz),
        schedule=sched, tuned=tuned)


@dataclass(frozen=True)
class ModelPlan:
    """Per-layer plans + entry points for one CNN under one policy.
    ``batch`` is the batch whose tuned winners the layers took (a serving
    bucket's plan may differ from batch 1's); the kernels take the batch
    from the tensor."""

    cfg: object
    policy: ExecutionPolicy
    layers: Tuple[ConvLayerPlan, ...]
    datapath: str = "float"
    batch: int = 1

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
                          datapath="int8", batch=self.batch)

    @property
    def int5(self) -> "ModelPlan":
        """The int5 MSR lane's sibling plan: :attr:`int8` with ``w_bits=5``
        on every layer — what ``forward_int5`` runs."""
        return plan_model(self.cfg, self.policy, c_in=self.layers[0].c_in,
                          datapath="int5", batch=self.batch)

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
    layer_substrates: Optional[Tuple[Optional[str], ...]] = None,
    batch: int = 1,
) -> ModelPlan:
    """Compile a ``CNNConfig`` into a :class:`ModelPlan` (cached).

    ``datapath`` is "float" (biased convs, fused bias+ReLU), "int8"
    (bias-free, fused ReLU + multiplier+shift requant on every non-last
    layer; the last layer emits its ReLU'd int32 psums) or "int5" (the
    int8 plans with ``w_bits=5``).  ``c_in`` overrides the first layer's
    input channel count.  ``layer_substrates`` pins per-layer substrates
    (one entry per conv layer, None keeping the policy's; a pinned layer
    plans as if tuning were off).  ``batch`` selects the batch-specific
    tuned winners (a serving bucket plans at its own batch).
    """
    if datapath not in DATAPATHS:
        raise ValueError(f"datapath {datapath!r} not in {DATAPATHS}")
    if layer_substrates is not None and len(layer_substrates) != len(
            cfg.layers):
        raise ValueError(
            f"layer_substrates has {len(layer_substrates)} entries for "
            f"{len(cfg.layers)} conv layers")
    int8 = datapath in ("int8", "int5")
    plans = []
    c = cfg.layers[0].M if c_in is None else int(c_in)
    last_i = len(cfg.layers) - 1
    for i, l in enumerate(cfg.layers):
        lpol = policy
        if layer_substrates is not None and layer_substrates[i] is not None:
            lpol = policy.with_overrides(substrate=layer_substrates[i])
        plans.append(plan_conv_layer(
            (l.H_I, l.W_I), c, l.K, l.N, stride=l.stride,
            padding=l.padding, groups=c // l.M, relu=True,
            pool=i in cfg.pool_after, has_bias=not int8,
            requant_kind="mult_shift" if int8 and i != last_i else None,
            in_sz=1 if int8 else 4, w_sz=1 if int8 else 4,
            out_sz=(4 if i == last_i else 1) if int8 else 4,
            w_bits=5 if datapath == "int5" else 8, policy=lpol,
            batch=int(batch)))
        c = l.N
    return ModelPlan(cfg=cfg, policy=policy, layers=tuple(plans),
                     datapath=datapath, batch=int(batch))

"""Execute planned TrIM conv layers and planned CNN models.

Port of ``repro/engine/execute.py``.  :func:`run_conv2d` is the ONLY
kernel dispatch site of the port: it takes a
:class:`~repro_torch.engine.plan.ConvLayerPlan`, resolves its substrate
against the input's device (``policy.resolve_substrate``) and runs the
CUDA kernel's wrapper — per conv group —, the plain oracle with the
unfused epilogue, or the f32exact arm: an integer conv cut into channel
chunks that the fp32 wrapper computes exactly (``ref.conv2d_exact_f32``),
then the unfused epilogue.  A plan that decimates (``emulate_hw`` on a
strided layer) runs the stride-1 sweep on its substrate with no epilogue,
keeps every stride-th output and applies the unfused epilogue.  On the
float lane the kernel arm is
:class:`~repro_torch.kernels.trim_conv2d_vjp.TrimConv2dFn`, so autograd
runs the TrIM backward (dx through the forward kernel, dw through the
weight-gradient kernel); the integer lanes call the wrapper directly.  The
model-level entry points iterate a
:class:`~repro_torch.engine.plan.ModelPlan`'s layers, on the float, int8
and int5 lanes (:func:`forward_int5`: the kernel multiplies by the MSR
operand ``w5``, and the per-channel exponent ``e`` is folded into the
requant pairs or shifted into the psums).

Three places decide bit-exactness against the JAX package, and mirror it:

- the int8 lane returns the LAST layer's ReLU'd int32 psums before its
  pool (:func:`_int8_forward`);
- :func:`serve_forward` runs the FC head per image, so a bucketed batch
  gives each image the same bits as an unbatched run;
- :func:`calibrate_requant` takes each channel's amax as float64 and
  propagates every layer through the exact requant before calibrating the
  next.
"""
from __future__ import annotations

import functools
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quant import fold_shift_into_requant
from repro_torch.distributed.sharding import (axis_rank, is_dtensor,
                                              replicated_call, row_placements,
                                              shard)
from repro_torch.engine.plan import DATAPATHS, ConvLayerPlan, ModelPlan
from repro_torch.engine.policy import resolve_device, resolve_substrate
from repro_torch.kernels import ref
from repro_torch.kernels._autograd import needs_grad
from repro_torch.kernels.requant import requant_mult_shift, scale_to_mult_shift
from repro_torch.kernels.trim_conv2d import (apply_epilogue, load_library,
                                             trim_conv2d)
from repro_torch.kernels.trim_conv2d_vjp import TrimConv2dFn

__all__ = [
    "EXECUTABLE_COMPILES",
    "apply_epilogue",
    "calibrate_requant",
    "calibrate_requant_int5",
    "calibrate_requant_shifts",
    "executable_for",
    "forward",
    "forward_int5",
    "forward_int8",
    "loss",
    "max_pool2x2",
    "run_conv2d",
    "run_conv_layer",
    "serve_forward",
]


def max_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool over NHWC (VALID)."""
    B, H, W, C = x.shape
    x = x[:, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def _kernel_call(plan: ConvLayerPlan, x, w, bias, requant, requant_shift):
    """One conv group on the kernel: the autograd Function on the float
    lane (mirrors ``repro/engine/execute.py:_group_call``), the wrapper
    on the integer lanes."""
    if x.is_floating_point():
        return TrimConv2dFn.apply(x, w, bias, plan)
    return trim_conv2d(
        x, w, stride=plan.stride, padding=plan.padding, bias=bias,
        relu=plan.relu, requant_shift=requant_shift, requant=requant,
        schedule=plan.schedule)


def _sweep(plan: ConvLayerPlan, x, w, sub: str):
    """The decimating plan's stride-1 sweep on substrate ``sub``, no
    epilogue (forward only on the kernel, as in the JAX package)."""
    kw = dict(padding=plan.padding, groups=plan.groups)
    if sub == "oracle":
        return ref.conv2d(x, w, stride=1, **kw)
    if sub == "f32exact":
        return ref.conv2d_exact_f32(x, w, stride=1, w_abs_max=_w_abs_max(plan),
                                    conv=trim_conv2d, **kw)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            "emulate_hw's decimated conv is forward-only on the kernel "
            "substrate: it has no backward")
    cg, fg = x.shape[-1] // plan.groups, w.shape[-1] // plan.groups
    return torch.cat([
        trim_conv2d(x[..., g * cg:(g + 1) * cg].contiguous(),
                    w[..., g * fg:(g + 1) * fg].contiguous(), stride=1,
                    padding=plan.padding, schedule=plan.schedule)
        for g in range(plan.groups)], dim=-1)


def _w_abs_max(plan: ConvLayerPlan) -> Optional[int]:
    """The f32exact bound's weight term of a sub-8-bit plan (31 at 5)."""
    return (1 << plan.w_bits) - 1 if plan.w_bits < 8 else None


#: id(tensor) -> (a weak reference to it, {(groups, F): ((version,
#: address), its per-group pieces)}): :func:`group_parts`' kept slices
_PARTS: dict = {}
#: Tensors :func:`group_parts` has cut into pieces since the last reset (a
#: plain counter: a call that finds kept pieces cuts nothing)
GROUP_CUTS = 0


def group_parts(t: torch.Tensor, groups: int, F: int
                ) -> Tuple[torch.Tensor, ...]:
    """``t``'s last axis (``F`` wide; a 0-dim ``t`` broadcast to F) cut
    into ``groups`` contiguous pieces.

    The pieces are kept per tensor, as ``u8_weights`` keeps the u8 x s8
    transposed weights: while ``t`` lives and its version counter and
    address stand, later calls get the same pieces, so a grouped conv of
    fixed weights (AlexNet's) slices its weights, bias and requant pairs
    once, and a captured bucket replays no slice copy and no weight
    pre-pass of a new slice.  A tensor that autograd records (the float
    lane in training) or an inference tensor (no version counter) is cut
    anew on every call."""
    def cut():
        global GROUP_CUTS
        GROUP_CUTS += 1
        full = t.expand(F) if t.dim() == 0 else t
        n = F // groups
        # normal tensors even under inference mode (the serving
        # executables'), so the u8 x s8 lane keeps their transposed copy
        with torch.inference_mode(False):
            return tuple(full[..., g * n:(g + 1) * n].contiguous()
                         for g in range(groups))

    if t.is_inference() or needs_grad(t):
        return cut()
    key, stamp = (groups, F), (t._version, t.data_ptr())
    ent = _PARTS.get(id(t))
    if ent is None or ent[0]() is not t:
        k = id(t)

        def drop(ref, k=k):
            if _PARTS.get(k, (None,))[0] is ref:
                del _PARTS[k]
        ent = (weakref.ref(t, drop), {})
        _PARTS[k] = ent
    hit = ent[1].get(key)
    if hit is None or hit[0] != stamp:
        hit = ent[1][key] = (stamp, cut())
    return hit[1]


def run_conv2d(plan: ConvLayerPlan, x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               requant: Optional[Tuple] = None, *,
               requant_shift: Optional[int] = None) -> torch.Tensor:
    """Run one planned conv (+ its epilogue).  THE dispatch site.

    x (N,H,W,C), w (K,K,C/groups,F) -> (N,H_O,W_O,F).  ``bias`` /
    ``requant_shift`` / ``requant=(mult, shift)`` are the runtime epilogue
    inputs (per-channel pairs are (F,) int32 tensors).
    """
    sub = resolve_substrate(plan.substrate, x.device)
    if plan.decimate:
        s = plan.stride
        out = _sweep(plan, x, w, sub)[:, ::s, ::s, :].contiguous()
        return apply_epilogue(out, bias, plan.relu, requant_shift, requant)
    if sub == "oracle":
        out = ref.conv2d(x, w, stride=plan.stride, padding=plan.padding,
                         groups=plan.groups)
        return apply_epilogue(out, bias, plan.relu, requant_shift, requant)
    if sub == "f32exact":
        # each chunk through the fp32 wrapper: the kernel's fp32 lane on a
        # CUDA tensor, the plain fp32 conv on a CPU tensor; float inputs
        # take the oracle inside conv2d_exact_f32
        out = ref.conv2d_exact_f32(
            x, w, stride=plan.stride, padding=plan.padding,
            groups=plan.groups, w_abs_max=_w_abs_max(plan), conv=trim_conv2d)
        return apply_epilogue(out, bias, plan.relu, requant_shift, requant)
    if plan.groups == 1:
        return _kernel_call(plan, x, w, bias, requant, requant_shift)
    G, F = plan.groups, w.shape[-1]
    # the activations are cut per call (data); the weights, bias and the
    # per-channel or broadcast per-tensor requant pairs once per tensor
    cg = x.shape[-1] // G
    xs = [x[..., g * cg:(g + 1) * cg].contiguous() for g in range(G)]
    ws = group_parts(w, G, F)
    bs = (None,) * G if bias is None else group_parts(bias, G, F)
    rqs = ((None,) * G if requant is None else tuple(zip(*(
        group_parts(torch.as_tensor(v, dtype=torch.int32, device=x.device),
                    G, F) for v in requant))))
    return torch.cat([_kernel_call(plan, xs[g], ws[g], bs[g], rqs[g],
                                   requant_shift)
                      for g in range(G)], dim=-1)


def run_conv_layer(plan: ConvLayerPlan, p, x: torch.Tensor) -> torch.Tensor:
    """One model conv block: planned conv -> optional 2x2 pool.

    ``p``: {"kernel": (K,K,C/groups,F) [, "bias": (F,), "requant":
    ((F,), (F,))]}.  On DTensors (:func:`_conv_layer_on_mesh`) each rank
    runs its local filters.
    """
    if is_dtensor(x):
        return _conv_layer_on_mesh(plan, p, x)
    w = p["kernel"]
    if x.is_floating_point():
        w = w.to(x.dtype)
    x = run_conv2d(plan, x, w, p.get("bias"), p.get("requant"))
    if plan.pool:
        x = max_pool2x2(x)
    return x


def _conv_layer_on_mesh(plan: ConvLayerPlan, p, x) -> torch.Tensor:
    """One float-lane conv block on DTensors: the input gathered over
    "model", the kernel (its ``cout`` sharded over "model", as
    ``param_pspec`` has it) run through ``local_map`` on each rank's local
    filters, bias sliced to them; the output sharded on its channels
    (``shard(x, "batch", "img_h", "img_w", "cout")``, the JAX package's
    ``nn/blocks.py:345``), then pooled."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = tuple(x.device_mesh.mesh_dim_names)
    w, bias = p["kernel"], p.get("bias")
    F_out = w.shape[-1]
    mi, m = axis_rank(x.device_mesh, "model")
    split = plan.groups == 1 and F_out % m == 0
    w_pl = [Shard(3) if (n == "model" and split) else Replicate()
            for n in names]
    rep = [Replicate()] * len(names)
    f_lo, f_n = (mi * F_out // m, F_out // m) if split else (0, F_out)

    def conv_fn(xl, wl, bl):
        if bl is not None:
            bl = bl[f_lo:f_lo + f_n].to(xl.dtype)
        return run_conv2d(plan, xl, wl.to(xl.dtype), bl)
    y = local_map(conv_fn,
                  out_placements=row_placements(x, 3 if split else None),
                  in_placements=(row_placements(x), w_pl,
                                 None if bias is None else rep),
                  redistribute_inputs=True)(x, w, bias)
    y = shard(y, "batch", "img_h", "img_w", "cout")
    if plan.pool:
        y = max_pool2x2(y)
    return y


def _head(params, x: torch.Tensor) -> torch.Tensor:
    for j, fc in enumerate(params["fc"]):
        x = torch.matmul(x, fc["kernel"].to(x.dtype)) + fc["bias"].to(x.dtype)
        if j < len(params["fc"]) - 1:
            x = torch.relu(x)
    return x


def _conv_stack(plan: ModelPlan, params, images: torch.Tensor):
    x = images
    for i, lp in enumerate(plan.layers):
        x = run_conv_layer(lp, params["conv"][i], x)
    # on a mesh the channels are cut over "model": DTensor does not
    # flatten a cut dim that is not the first, so they are gathered first
    return replicated_call("cnn_flatten", lambda t: t.reshape(t.shape[0], -1),
                           x)


def forward(plan: ModelPlan, params, images: torch.Tensor) -> torch.Tensor:
    """images (B,H,W,C) float -> logits (B, n_classes)."""
    return _head(params, _conv_stack(plan, params, images))


def loss(plan: ModelPlan, params, batch) -> Tuple[torch.Tensor, Dict]:
    """Mean cross-entropy of the logits against ``batch["labels"]``;
    returns (ce, {"ce", "acc"}).  ``batch["images"]`` (B,H,W,C) float."""
    logits = forward(plan, params, batch["images"])
    nll, hit = replicated_call("cnn_xent", _xent_rows, logits,
                               batch["labels"])
    ce = nll.mean()
    acc = hit.mean()
    return ce, {"ce": ce, "acc": acc}


def _xent_rows(logits: torch.Tensor, labels: torch.Tensor):
    """Each row's CE and whether its argmax is its label (fp32)."""
    labels = labels.long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    return (-logp.gather(-1, labels[:, None])[:, 0],
            (logits.argmax(-1) == labels).float())


def serve_forward(plan: ModelPlan, params,
                  images: torch.Tensor) -> torch.Tensor:
    """Batch-invariant :func:`forward` for serving.

    The conv stack is batch-invariant: each image's kernel blocks see only
    that image.  Where the fp32 lane splits a deep layer's channel sum,
    the split and the order of its merge follow from the per-image shape
    alone (``f32_tile``), never from the batch; the u8 x s8 lane's sums
    are exact integers whatever their split.  A batched GEMM is not
    batch-invariant: its algorithm can change with the row count.  So the
    FC head runs on (1, K) rows, one image at a time, giving every image
    the same bits at every batch size.
    """
    x = _conv_stack(plan, params, images)
    return torch.cat([_head(params, x[i:i + 1]) for i in range(x.shape[0])])


def _pow2_requant(psum: torch.Tensor):
    """The dynamic path's power-of-two requantize back to uint8, off the
    whole batch's maximum: ``shift = max(ceil(log2(amax / 255)), 0)`` in
    float32, as the JAX package takes it.  Returns (uint8 x, shift)."""
    amax = psum.max().to(torch.float32).clamp_min(1.0)
    shift = torch.ceil(torch.log2(amax / 255.0)).clamp_min(0)
    shift = shift.to(torch.int32)
    return (psum >> shift).clamp(0, 255).to(torch.uint8), shift


def _int8_forward(
    plan: ModelPlan,
    qparams,
    images_u8: torch.Tensor,
    requant_shifts: Optional[Sequence[int]] = None,
    requant: Optional[Sequence[Tuple]] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Shared int8 datapath: returns (final int32 psums, dynamic shifts)."""
    if requant_shifts is not None and requant is not None:
        raise ValueError("requant_shifts and requant are exclusive")
    x = images_u8
    shifts: List[torch.Tensor] = []
    layers = plan.int8.layers
    n = len(layers)
    for i, lp in enumerate(layers):
        w = qparams["conv"][i]["kernel"]
        last = i == n - 1
        if requant is not None and not last:
            x = run_conv2d(lp, x, w, None, tuple(requant[i]))
        elif requant_shifts is not None and not last:
            x = run_conv2d(lp, x, w, None, None,
                           requant_shift=int(requant_shifts[i]))
        else:
            psum = run_conv2d(lp, x, w, None, None)
            if last:
                return psum, shifts
            x, shift = _pow2_requant(psum)
            shifts.append(shift)
        if lp.pool:
            x = max_pool2x2(x)
    return x, shifts


def forward_int8(
    plan: ModelPlan,
    qparams,
    images_u8: torch.Tensor,
    requant_shifts: Optional[Sequence[int]] = None,
    requant: Optional[Sequence[Tuple]] = None,
) -> torch.Tensor:
    """uint8 NHWC images through the integer TrIM datapath; returns the
    last layer's int32 feature map (pre-classifier, before its pool)."""
    return _int8_forward(plan, qparams, images_u8, requant_shifts, requant)[0]


def calibrate_requant_shifts(plan: ModelPlan, qparams,
                             sample_u8: torch.Tensor) -> List[int]:
    """Static per-layer power-of-two requant shifts from a sample batch."""
    return [int(s) for s in _int8_forward(plan, qparams, sample_u8)[1]]


def calibrate_requant(plan: ModelPlan, qparams, sample_u8: torch.Tensor,
                      per_channel: bool = True) -> List[Tuple]:
    """Per-layer (mult, shift) pairs mapping each non-last layer's observed
    post-ReLU psum range [0, amax] onto [0, 255] (``scale = 255 / amax``,
    amax per output channel as float64).  Returns (F,) int32 tensors on
    the sample's device."""
    x = sample_u8
    pairs: List[Tuple] = []
    for i, lp in enumerate(plan.int8.layers[:-1]):
        w = qparams["conv"][i]["kernel"]
        psum = run_conv2d(lp, x, w, None, None)
        mx = psum.amax(dim=(0, 1, 2)) if per_channel else psum.max()
        amax = np.maximum(mx.cpu().numpy().astype(np.float64), 1.0)
        m, s = scale_to_mult_shift(255.0 / amax)
        F = w.shape[-1]
        m = torch.as_tensor(np.broadcast_to(m, (F,)).copy(),
                            device=psum.device)
        s = torch.as_tensor(np.broadcast_to(s, (F,)).copy(),
                            device=psum.device)
        pairs.append((m, s))
        # propagate through the exact datapath the fused forward runs
        x = requant_mult_shift(psum, m, s).to(torch.uint8)
        if lp.pool:
            x = max_pool2x2(x)
    return pairs


def forward_int5(
    plan: ModelPlan,
    qparams,
    images_u8: torch.Tensor,
    requant: Optional[Sequence[Tuple]] = None,
) -> torch.Tensor:
    """uint8 NHWC images through the int5 MSR lane; returns the last
    layer's full-scale int32 feature map (before its pool).

    ``qparams["conv"][i]`` is ``{"kernel": w5, "shift": e}`` from
    ``nn.conv.quantize_cnn_int5``: the int8 operand ``|w5| <= 31`` and the
    per-output-channel exponent with ``w_hat == w5 << e``.  The kernel
    multiplies by ``w5`` as it is (so its transposed copy is written once
    per weight tensor), and ``e`` is applied losslessly after the sum:
    folded into the calibrated pairs (:func:`calibrate_requant_int5`) on
    the non-last layers, or shifted into the psums (``psum << e``) on the
    dynamic path and on the last layer.  With calibrated pairs this
    equals :func:`forward_int8` on ``w5 << e`` bit for bit.
    """
    x = images_u8
    layers = plan.int5.layers
    n = len(layers)
    for i, lp in enumerate(layers):
        p = qparams["conv"][i]
        w5 = p["kernel"]
        last = i == n - 1
        if requant is not None and not last:
            x = run_conv2d(lp, x, w5, None, tuple(requant[i]))
        else:
            psum = run_conv2d(lp, x, w5, None, None)
            psum = torch.bitwise_left_shift(psum, _exponent(p, psum.device))
            if last:
                return psum
            x, _ = _pow2_requant(psum)
        if lp.pool:
            x = max_pool2x2(x)
    return x


def _exponent(p, device) -> torch.Tensor:
    """A layer's per-channel MSR exponent as int32 on ``device`` (it
    broadcasts on the psums' last axis)."""
    return torch.as_tensor(p["shift"], dtype=torch.int32, device=device)


def calibrate_requant_int5(plan: ModelPlan, qparams,
                           sample_u8: torch.Tensor,
                           per_channel: bool = True) -> List[Tuple]:
    """(mult, shift) pairs for the int5 lane, the exponent folded in.

    :func:`calibrate_requant` on the full-scale psums ``psum5 << e``, then
    each pair takes ``e`` back (``core.quant.fold_shift_into_requant``, in
    int64 numpy, saturating in the kernel's domain), so the fused kernel
    requantizes the raw ``w5`` psums: ``requant(psum5, m, s - e) ==
    requant(psum5 << e, m, s)``.  Returns (F,) int32 tensors on the
    sample's device."""
    x = sample_u8
    pairs: List[Tuple] = []
    for i, lp in enumerate(plan.int5.layers[:-1]):
        p = qparams["conv"][i]
        w5 = p["kernel"]
        e = _exponent(p, "cpu").numpy()
        psum5 = run_conv2d(lp, x, w5, None, None)
        full = torch.bitwise_left_shift(psum5, _exponent(p, psum5.device))
        mx = full.amax(dim=(0, 1, 2)) if per_channel else full.max()
        amax = np.maximum(mx.cpu().numpy().astype(np.float64), 1.0)
        m, s = scale_to_mult_shift(255.0 / amax)
        F = w5.shape[-1]
        mf, sf = fold_shift_into_requant(np.broadcast_to(m, (F,)),
                                         np.broadcast_to(s, (F,)), e)
        mf = torch.as_tensor(mf, device=psum5.device)
        sf = torch.as_tensor(sf, device=psum5.device)
        pairs.append((mf, sf))
        x = requant_mult_shift(psum5, mf, sf).to(torch.uint8)
        if lp.pool:
            x = max_pool2x2(x)
    return pairs


# ---------------------------------------------------------------------------
# Serving executables: one per (plan, batch, datapath, device)
# ---------------------------------------------------------------------------

#: Build ledger: (plan, batch, datapath, device) -> number of builds, on
#: either device.  Cache hits never touch it, and neither do the card's
#: captures and replays (an engine counts its captures itself,
#: ``ServeEngine.capture_counts``), so serving can assert compile-once.
EXECUTABLE_COMPILES: Dict[Tuple[ModelPlan, int, str, str], int] = {}

#: Fault-injection seam of the serving chaos plane: when set, called as
#: ``hook(plan, batch, datapath)`` at the top of :func:`executable_for`,
#: before any work; raising there stands for a failed build.
#: ``lru_cache`` caches no call that raised, so a bounded retry after a
#: transient fault builds cleanly.  Set and cleared by
#: ``ServeEngine.warmup`` only; ``None`` otherwise.
COMPILE_FAULT_HOOK = None


class Executable:
    """The serving program for one static (batch, H, W, C) input.

    ``float``: ``forward(params, images_f32) -> logits``
    (:func:`serve_forward`); ``int8``: ``forward(qparams, images_u8,
    requant) -> int32 features``, with the calibrated per-layer pairs
    required (the dynamic-shift path depends on the whole batch and cannot
    serve padded buckets); ``int5``: the same, ``qparams`` from
    ``quantize_cnn_int5`` and ``requant`` from
    :func:`calibrate_requant_int5` (:func:`forward_int5`).

    On the CPU the executable is that callable, eager.  On the card it
    runs only as the CUDA graph :meth:`capture` records for one set of
    params (:class:`BucketGraphs`); calling it there raises, so nothing on
    the card gives way to the eager path.  :meth:`forward` is the eager
    program itself, which the capture records (and a caller may run as a
    reference).
    """

    def __init__(self, plan: ModelPlan, batch: int, datapath: str,
                 device: torch.device):
        H, W = plan.cfg.input_hw
        self.plan = plan
        self.batch = batch
        self.datapath = datapath
        self.device = device
        self.shape = (batch, H, W, plan.layers[0].c_in)
        self.dtype = torch.float32 if datapath == "float" else torch.uint8

    def check(self, images: torch.Tensor, device=None) -> None:
        """Raise unless ``images`` is this executable's static input (on
        ``device``, by default the executable's)."""
        device = self.device if device is None else device
        if tuple(images.shape) != self.shape or images.dtype != self.dtype \
                or images.device != device:
            raise ValueError(
                f"executable takes {self.shape} {self.dtype} on "
                f"{device}, got {tuple(images.shape)} {images.dtype} "
                f"on {images.device}")

    @torch.inference_mode()
    def forward(self, params, images: torch.Tensor, requant=None):
        """The eager program on ``images``."""
        self.check(images)
        if self.datapath == "float":
            return serve_forward(self.plan, params, images)
        if requant is None:
            raise ValueError(
                f"the {self.datapath} executable needs calibrated requant")
        if self.datapath == "int5":
            return forward_int5(self.plan, params, images, requant=requant)
        return forward_int8(self.plan, params, images, requant=requant)

    def __call__(self, params, images: torch.Tensor, requant=None):
        if self.device.type == "cuda":
            raise RuntimeError(
                "on the card an executable runs as the CUDA graph "
                "Executable.capture(params, requant, pool=) records")
        return self.forward(params, images, requant)

    def capture(self, params, requant=None, *, pool) -> "BucketGraphs":
        """Capture this executable for ``params`` (and ``requant``) on
        ``pool`` (a ``graphs.GraphPool``): two instances, each with its own
        static images and output."""
        return BucketGraphs(self, params, requant, pool)


class _Instance:
    """One captured copy of an executable: its static images, its graph,
    the event of its last staging copy and the event after its last
    replay."""

    def __init__(self, images: torch.Tensor):
        self.images = images
        self.graph = None
        self.staged: Optional[torch.cuda.Event] = None
        self.done: Optional[torch.cuda.Event] = None


class BucketGraphs:
    """An :class:`Executable` captured on the card for one set of params.

    Two instances, used in turn, so that a batch's staging copy overlaps
    the replay before it: the server stages batch k+1 of a bucket while
    batch k is still in flight (``Server._dispatch``).  :meth:`stage`
    copies a pinned host batch into the next instance's static images on
    the pool's copy stream, behind that instance's last replay, and
    records an event; calling the graphs on those images replays that
    instance once the event is reached (the counterpart of the JAX
    executable's donated image buffer).  Other images are copied into the
    next instance on the current stream.  The output returned is a copy
    of the static output, made on the current stream right after the
    replay: no later replay of this bucket or of any graph on the pool
    (whose intermediates may share the static output's memory) overwrites
    it, whatever order the server's retries replay in.

    The int8 and int5 lanes' weights must not be inference tensors: the
    u8 x s8 lane keeps no transposed copy of those, so the weight
    pre-pass would be recorded into the graph and run on every replay.
    """

    def __init__(self, ex: Executable, params, requant, pool):
        from repro_torch.engine import graphs

        if ex.datapath != "float" and any(
                p["kernel"].is_inference() for p in params["conv"]):
            raise ValueError(
                f"the {ex.datapath} params are inference tensors: make them "
                "outside torch.inference_mode, so that their transposed "
                "weights are written once before the capture")
        self.ex, self.params, self.requant, self.pool = (
            ex, params, requant, pool)
        label = (f"{ex.plan.cfg.name} {ex.datapath} batch {ex.batch} "
                 f"{ex.plan.policy.substrate}")
        self._insts = []
        for i in range(2):
            inst = _Instance(torch.zeros(ex.shape, dtype=ex.dtype,
                                         device=ex.device))
            inst.graph = graphs.capture(
                lambda x=inst.images: ex.forward(params, x, requant), pool,
                label=f"{label} (instance {i})", warm=i == 0)
            self._insts.append(inst)
        self._next = 0

    @property
    def launches(self) -> Dict[str, int]:
        """The kernel launches of one replay, by kernel name."""
        return dict(self._insts[0].graph.launches)

    @property
    def warm_launches(self) -> Dict[str, int]:
        """The launches of the warm call the capture made."""
        return dict(self._insts[0].graph.warm_launches)

    def _take(self) -> _Instance:
        inst = self._insts[self._next]
        self._next ^= 1
        return inst

    def stage(self, host: torch.Tensor) -> torch.Tensor:
        """Copy one pinned host batch into the next instance's static
        images on the copy stream; returns those images."""
        self.ex.check(host, device=host.device)
        inst = self._take()
        cs = self.pool.copy_stream
        with torch.cuda.stream(cs):
            if inst.done is not None:
                cs.wait_event(inst.done)  # its last replay read them
            inst.images.copy_(host, non_blocking=True)
            inst.staged = torch.cuda.Event()
            inst.staged.record(cs)
        return inst.images

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """Replay on ``images``: a batch :meth:`stage` returned, or any
        device tensor of the executable's shape (copied in first)."""
        cur = torch.cuda.current_stream(self.ex.device)
        inst = next((i for i in self._insts if i.images is images), None)
        if inst is None:
            self.ex.check(images)
            inst = self._take()
        if inst.staged is not None:
            cur.wait_event(inst.staged)
            inst.staged = None
        if images is not inst.images:
            inst.images.copy_(images)
        out = inst.graph.replay().clone()
        inst.done = torch.cuda.Event()
        inst.done.record(cur)
        return out


@functools.lru_cache(maxsize=None)
def _executable(plan: ModelPlan, batch: int, datapath: str,
                device: torch.device) -> Executable:
    if device.type == "cuda" and resolve_substrate(
            plan.policy.substrate, device) != "oracle":
        load_library()  # the build, paid before the first request
    ex = Executable(plan, batch, datapath, device)
    key = (plan, batch, datapath, str(device))
    EXECUTABLE_COMPILES[key] = EXECUTABLE_COMPILES.get(key, 0) + 1
    return ex


def executable_for(plan: ModelPlan, batch: int, datapath: str = "float",
                   device="cuda") -> Executable:
    """The cached serving program for ``plan`` at one static batch size.
    Building it loads (and if needed compiles) the kernel library; the
    caller makes the warm call with its params, on the card by capturing
    it (``ServeEngine``)."""
    if COMPILE_FAULT_HOOK is not None:
        COMPILE_FAULT_HOOK(plan, batch, datapath)
    if datapath not in DATAPATHS:
        raise ValueError(f"datapath {datapath!r} not in {DATAPATHS}")
    batch = int(batch)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _executable(plan, batch, datapath, dev)

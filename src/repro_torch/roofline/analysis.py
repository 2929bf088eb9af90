"""Roofline analysis from a counted trace (port of `repro/roofline/analysis.py`;
no card needed).

Three terms per (arch x shape x mesh), in seconds:
    compute    = dot FLOPs per device / peak FLOP/s (each dtype at its rate)
    memory     = bytes per device / HBM bandwidth
    collective = collective bytes per device / link bandwidth

The reference reads them from XLA's compiled program.  The port runs the
step itself, eagerly, on each device's share: `counting()` is a dispatch
mode that sees every aten op of the run, and the dry run
(`launch.steps.lower_spec`) runs the step on fake tensors
(`FakeTensorMode`) laid out as DTensors on a fake process group of 256 or
512 ranks, so nothing is allocated and no card is needed.

What it counts, per device:
  * **Dot FLOPs**: `mm`/`addmm` 2 * M * N * K, `bmm`/`baddbmm` times the
    batch, convolutions 2 * out * (in channels / groups) * kernel, by the
    output's dtype.  An op on DTensors is counted at its local shapes: the
    mode lets DTensor run it and counts the local ops that DTensor issues
    (`_Local`), never the global-shape runs of its sharding propagation,
    which would count every op at the whole mesh's size.  Attention is
    counted through its plain version's operations (off the card the flash
    wrapper runs `flash_attention_plain`); the card's kernel skips the
    masked tiles, so on causal attention it does about half of them.
  * **Collective bytes** by op, the reference's names: all-reduce at 2x its
    output (reduce and broadcast phases), all-gather, reduce-scatter,
    all-to-all and collective-permute at their output.
  * **Memory bytes**: every op's inputs and outputs, views excluded, with
    no fusion: the traffic of the eager program the port runs.  XLA's
    "bytes accessed" is counted after fusion, so the two memory terms are
    not the same quantity.
  * **Peak**: live local bytes, tracked by storage from the step's inputs
    and every output the mode sees until the last tensor of a storage dies.

Hardware: `H100`, NVIDIA's H100 SXM5 datasheet: 989.4 TFLOP/s dense bf16,
66.9 TFLOP/s f32 (the port runs f32 products with TF32 off,
`utils.resolve_device`, so on the FP32 units), 3.35 TB/s HBM3, and 50 GB/s
a GPU on the link (400 Gb/s InfiniBand NDR).  The link term prices every
collective at the slowest link it crosses: laid out row-major over 8-GPU
nodes, every mesh axis of 16 spans two nodes, so every collective of both
production meshes crosses InfiniBand, not NVLink.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import utils


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989.4e12     # dense bf16 a GPU (H100 SXM5 datasheet)
    peak_flops_f32: float = 66.9e12  # f32 on the FP32 units (TF32 off)
    hbm_bw: float = 3.35e12          # bytes/s a GPU
    ici_bw: float = 50e9             # bytes/s a GPU on the slowest link: 400 Gb/s IB NDR


H100 = HW()

# dtypes the tensor cores run at the dense low-precision rate; everything
# else (f32 master-weight products above all) is priced at `peak_flops_f32`
_FULL_RATE_DTYPES = ("bf16", "f16", "f8e4m3fn", "f8e5m2", "s8", "u8")

_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int64: "s64", torch.int32: "s32", torch.int16: "s16", torch.int8: "s8",
    torch.uint8: "u8", torch.bool: "pred", torch.complex64: "c64",
}

# aten / c10d op names -> the reference's collective names
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "all-gather",
}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_name(t: torch.Tensor) -> str:
    return _DTYPE_NAMES.get(t.dtype, str(t.dtype).replace("torch.", ""))


def _dot_flops(name: str, args, out) -> float:
    if name in ("mm", "addmm", "bmm", "baddbmm"):
        a = args[1] if name in ("addmm", "baddbmm") else args[0]
        return 2.0 * math.prod(out.shape) * a.shape[-1]
    if name in ("convolution", "_convolution", "cudnn_convolution", "mkldnn_convolution"):
        # weight (out channels, in channels / groups, *kernel)
        return 2.0 * math.prod(out.shape) * math.prod(args[1].shape[1:])
    return 0.0


@dataclasses.dataclass
class Trace:
    """What `counting()` saw: one event per counted op (`events`, tuples
    of op, flops, dtype, input bytes, output bytes, output shape, the
    named-scope path, collective kind, collective bytes), and the memory
    of the run: its input and output bytes and the peak of live bytes."""

    events: list = dataclasses.field(default_factory=list)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    live_bytes: int = 0
    _refs: dict = dataclasses.field(default_factory=dict)
    _sizes: dict = dataclasses.field(default_factory=dict)

    # -- liveness by storage -------------------------------------------------
    def _hold(self, t: torch.Tensor) -> None:
        local = getattr(t, "_local_tensor", None)
        if local is not None:
            t = local
        try:
            key = t.untyped_storage()._cdata
            size = t.untyped_storage().nbytes()
        except (NotImplementedError, RuntimeError):
            return
        if key not in self._refs:
            self._refs[key] = 0
            self._sizes[key] = size
            self.live_bytes += size
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live_bytes -= self._sizes.pop(key)

    def add_inputs(self, tree) -> None:
        for t in _tensors(tree):
            self.argument_bytes += _nbytes(getattr(t, "_local_tensor", t))
            self._hold(t)

    def add_outputs(self, tree) -> None:
        self.output_bytes += sum(_nbytes(getattr(t, "_local_tensor", t)) for t in _tensors(tree))

    # -- events ------------------------------------------------------------------
    def record(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        if func.is_view:
            return
        ins = _tensors(args) + _tensors(kwargs)
        coll = _COLLECTIVE_OPS.get(name) if func.namespace in (
            "_c10d_functional", "_c10d_functional_autograd", "c10d") else None
        scope = "/".join(utils.SCOPES)
        if coll is not None:
            if _OVERRIDE:
                return  # billed by `billed_as`
            # c10d ops write their outputs in place: price the written list
            written = outs if func.namespace != "c10d" else _tensors(args[0])
            b = sum(_nbytes(t) for t in written) * (2.0 if coll == "all-reduce" else 1.0)
            shape = tuple(written[0].shape) if written else ()
            self.events.append((name, 0.0, "", 0, 0, shape, scope, coll, b))
            return
        flops = _dot_flops(name, args, outs[0]) if outs else 0.0
        self.events.append((name, flops, _dtype_name(outs[0]) if outs else "",
                            sum(_nbytes(t) for t in ins), sum(_nbytes(t) for t in outs),
                            tuple(outs[0].shape) if outs else (), scope, None, 0.0))


_OVERRIDE: list = []
_ACTIVE: list = []


@contextlib.contextmanager
def billed_as(kind: str, nbytes: float):
    """Bill the collectives run inside the block as one `kind` of `nbytes`
    (a pod-axis permutation the port runs as a gather, say)."""
    if _ACTIVE:
        _ACTIVE[-1].events.append(("billed_as", 0.0, "", 0, 0, (), "/".join(utils.SCOPES),
                                   kind, float(nbytes)))
    _OVERRIDE.append(kind)
    try:
        yield
    finally:
        _OVERRIDE.pop()


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor" and hasattr(x, "_local_tensor")


class _Local(TorchDispatchMode):
    """Inside one DTensor op: counts the local ops, those with an input
    that is a tracked local tensor (a DTensor's shard or a tensor computed
    from one), and tracks their outputs."""

    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace
        self.tracked: weakref.WeakValueDictionary = weakref.WeakValueDictionary()

    def track(self, tree) -> None:
        for t in _tensors(tree):
            t = getattr(t, "_local_tensor", t)
            self.tracked[id(t)] = t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors(args) + _tensors(kwargs)
        if any(_is_dtensor(t) for t in ins):
            # DTensor's own dispatch runs the op, with this mode active for
            # the local ops it issues
            self.track(ins)
            return NotImplemented
        out = func(*args, **kwargs)
        if any(self.tracked.get(id(t)) is t for t in ins):
            self.trace.record(func, args, kwargs, out)
            self.track(out)
        return out


class _Counter(TorchDispatchMode):
    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace
        self.local = _Local(trace)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = _tensors(args) + _tensors(kwargs)
        if any(_is_dtensor(t) for t in flat):
            self.local.track(flat)
            with self.local:
                out = func(*args, **kwargs)
            self.local.track(out)
            for t in _tensors(out):
                self.trace._hold(t)
            return out
        out = func(*args, **kwargs)
        self.trace.record(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def counting(inputs: Any = ()):
    """Count every op run inside the block, per device; yields the `Trace`.
    `inputs` (a tree of the step's inputs) start the live bytes."""
    tr = Trace()
    tr.add_inputs(inputs)
    _ACTIVE.append(tr)
    try:
        with _Counter(tr):
            yield tr
    finally:
        _ACTIVE.pop()


def analyze_trace(trace: Trace) -> dict:
    """The reference's record for one lowering (per-device numbers), from a
    counted trace instead of a compiled XLA program.  The eager trace
    repeats every layer, so nothing is loop-scaled (`loop_scale_ratio` 1)."""
    flops, nbytes = 0.0, 0.0
    by_dtype: dict = defaultdict(float)
    coll: dict = defaultdict(float)
    for _, f, dt, b_in, b_out, _, _, kind, b_coll in trace.events:
        if kind is not None:
            coll[kind] += b_coll
            continue
        if f:
            flops += f
            by_dtype[dt] += f
        nbytes += b_in + b_out
    total_coll = float(sum(coll.values()))
    peak = max(trace.peak_bytes, trace.argument_bytes)
    return {
        "raw_flops_per_device": flops,
        "dot_flops_per_device": flops,
        "dot_flops_by_dtype": dict(by_dtype),
        "raw_bytes_per_device": nbytes,
        "scaled_bytes_per_device": nbytes,
        "loop_scale_ratio": 1.0,
        "collectives": dict(coll),
        "collective_bytes_per_device": total_coll,
        "collective_total_bytes": total_coll,
        "memory": {
            "argument_bytes": int(trace.argument_bytes),
            "output_bytes": int(trace.output_bytes),
            "temp_bytes": int(max(peak - trace.argument_bytes - trace.output_bytes, 0)),
            "alias_bytes": 0,
            "peak_bytes": int(peak),
        },
    }


def compute_seconds(record: dict, *, hw: HW = H100) -> float:
    """Dtype-aware compute term: each dot's flops at the rate its OUTPUT
    dtype runs at: bf16/f16/f8 at `peak_flops`, f32 (and anything else) at
    `peak_flops_f32`.  Records without the dtype breakdown fall back to the
    flat bf16 rate."""
    by_dtype = record.get("dot_flops_by_dtype")
    if not by_dtype:
        return record["dot_flops_per_device"] / hw.peak_flops
    return sum(f / (hw.peak_flops if dt in _FULL_RATE_DTYPES else hw.peak_flops_f32)
               for dt, f in by_dtype.items())


def arithmetic_intensity(record: dict) -> float:
    """FLOPs per memory byte; against the machine balance
    (`hw.peak_flops / hw.hbm_bw`) it says which side of the ridge the step
    sits on."""
    b = record.get("scaled_bytes_per_device") or record.get("raw_bytes_per_device", 0.0)
    return record["dot_flops_per_device"] / b if b else float("inf")


def roofline_terms(record: dict, *, hw: HW = H100) -> dict:
    """Seconds per term + the dominant bottleneck."""
    compute = compute_seconds(record, hw=hw)
    memory = record["scaled_bytes_per_device"] / hw.hbm_bw
    collective = record["collective_bytes_per_device"] / hw.ici_bw
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    return {**terms, "bound": dom.replace("_s", ""),
            "intensity_flops_per_byte": arithmetic_intensity(record)}


def model_flops(param_count: int, tokens: float, *, kind: str = "train") -> float:
    """Analytic MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D forward-only."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * float(param_count) * float(tokens)

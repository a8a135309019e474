"""Roofline terms of a sharded step: collective wire bytes, FLOPs and
memory (the port of the JAX package's parallel/hlo_analysis.py).

The reference parses the compiled HLO's collectives. The port has no
HLO: its stand-in is the step itself, run once under ``StepTrace``, a
``TorchDispatchMode`` below DTensor that sees each op on the local
shards. It records

  * the collectives DTensor and ``parallel/compression`` issue
    (``_c10d_functional.{all_reduce, all_gather_into_tensor,
    reduce_scatter_tensor, all_to_all_single}`` and the c10d ``*_`` ops)
    as (op, result bytes, group size) triples, which
    ``collectives_of_trace`` turns into per-device wire bytes with the
    reference's ring formulas:

        all-gather         (g-1)/g * result_bytes
        all-reduce         2 (g-1)/g * result_bytes
        reduce-scatter     (g-1) * result_bytes      (operand = g * result)
        all-to-all         (g-1)/g * result_bytes
        collective-permute result_bytes

  * FLOPs of the matrix products on the local shards
    (``torch.utils.flop_counter``'s formulas: 2·M·N·K a product; the
    elementwise ops are not counted);
  * bytes: each compute op's input and output bytes (unfused traffic,
    views and collectives excluded);
  * memory: the live bytes of the storages the step allocates, sampled
    at every allocation, their peak, and the largest live storages near
    it (``peak_top``: by the op that made them, its shape and dtype).

``parse_collectives`` on HLO text is kept as the reference has it (pure
regex), so both packages read the same HLO the same way.
"""
from __future__ import annotations

import collections
import dataclasses
import re
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLL_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_LINE_RE = re.compile(
    r"=\s+(?P<shapes>\(?[\w\[\],{}\s/*]+?\)?)\s+"
    r"(?P<op>all-reduce-start|all-gather-start|reduce-scatter|all-to-all|"
    r"collective-permute-start|all-reduce|all-gather|collective-permute)\(",
)
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")


def _shape_bytes(shapes_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shapes_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        ids = [x for x in m.group(1).split(",") if x.strip() != ""]
        return max(len(ids), 1)
    return default


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0            # per-device ring wire bytes
    result_bytes: float = 0.0
    count: int = 0
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    ops: List[Tuple[str, int, int]] = dataclasses.field(default_factory=list)


def parse_collectives(hlo_text: str, n_devices: int) -> CollectiveStats:
    ops = []
    for line in hlo_text.splitlines():
        m = _LINE_RE.search(line)
        if m is None:
            continue
        ops.append((m.group("op").replace("-start", ""),
                    _shape_bytes(m.group("shapes")),
                    _group_size(line, n_devices)))
    return collectives_of_trace(ops, n_devices)



# the c10d ops a trace records, by the HLO name of their collective
_TRACE_OPS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
}


def _wire(op: str, rb: float, g: int) -> float:
    if op == "all-reduce":
        return 2.0 * rb * (g - 1) / max(g, 1)
    if op == "all-gather":
        return rb * (g - 1) / max(g, 1)
    if op == "reduce-scatter":
        return rb * (g - 1)
    if op == "all-to-all":
        return rb * (g - 1) / max(g, 1)
    return float(rb)   # collective-permute


def collectives_of_trace(records: Iterable[Tuple[str, int, int]],
                         n_devices: int) -> CollectiveStats:
    """Wire bytes of recorded collectives: (op, result bytes, group size)
    triples, the op a c10d name (``all_gather_into_tensor``, ...) or an
    HLO one (``all-gather``, ...); a group size of 0 means the whole
    world of ``n_devices``."""
    stats = CollectiveStats()
    for op, rb, g in records:
        op = _TRACE_OPS.get(op, op)
        g = g or n_devices
        wire = _wire(op, rb, g)
        stats.wire_bytes += wire
        stats.result_bytes += rb
        stats.count += 1
        stats.by_op[op] = stats.by_op.get(op, 0.0) + wire
        stats.ops.append((op, rb, g))
    return stats


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a nest of lists, tuples and dicts, in order. A loop,
    not a recursive closure: a closure that calls itself is a reference
    cycle, and it would hold every tensor it gathered until the cycle
    collector ran, inflating the live bytes the trace measures."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# peak_top: the TOP_N largest groups of live storages, taken at a new
# peak at least TOP_STEP above the last one taken
TOP_N = 8
TOP_STEP = 64 << 20

# DTensor's propagation of a new op's output shapes, which runs the op on
# global-shaped fake tensors under the active fake mode; StepTrace wraps
# it to leave those ops out
_PROPAGATION_HOOK = "_propagate_tensor_meta_non_cached"


class StepTrace(TorchDispatchMode):
    """Counts what one rank's local shards do: the collectives
    (``records``), matrix-product FLOPs, unfused bytes and the peak of
    live allocated bytes. Entered inside DTensor (it passes DTensor ops
    on, and sees the local ops they run). ``fake_mode``: the step's
    ``FakeTensorMode`` (the dry-run's), whose tensors count. DTensor's own
    shape propagation (each new op run once on global-shaped fake
    tensors, under the active fake mode) is not counted."""

    def __init__(self, fake_mode=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.fake_mode = fake_mode
        self.flop_registry = flop_registry
        self.records: List[Tuple[str, int, int]] = []
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._storages: "collections.OrderedDict" = collections.OrderedDict()
        self._in_propagation = 0
        self.peak_top: List[Dict] = []
        self._top_at = 0

    def _group_size(self, args) -> int:
        """The collective's group size: its group (the functional ops'
        last argument, a group name; the c10d ops', a ProcessGroup)."""
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        for a in reversed(args):
            if isinstance(a, dist.ProcessGroup):
                return a.size()
            if isinstance(a, str):
                return dist.get_world_size(_resolve_process_group(a))
        return 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = getattr(ShardingPropagator, _PROPAGATION_HOOK, None)
        if orig is None:
            # without the hook every new op's propagation on global-shaped
            # fake tensors would count as the step's (3x gemma's FLOPs)
            raise RuntimeError(
                f"StepTrace: ShardingPropagator.{_PROPAGATION_HOOK} is "
                f"missing in torch {torch.__version__}; DTensor's shape "
                "propagation cannot be told from the step")
        trace = self

        def wrapped(prop, *a, **k):
            trace._in_propagation += 1
            try:
                return orig(prop, *a, **k)
            finally:
                trace._in_propagation -= 1

        setattr(ShardingPropagator, _PROPAGATION_HOOK, wrapped)
        self._unpatch = lambda: setattr(ShardingPropagator,
                                        _PROPAGATION_HOOK, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        self._unpatch()
        return super().__exit__(*exc)

    def _counts(self, args) -> bool:
        if self._in_propagation:
            return False
        from torch._subclasses.fake_tensor import FakeTensor

        for t in _tensors(args):
            if t.device.type == "meta":
                return False
            if isinstance(t, FakeTensor) and t.fake_mode is not self.fake_mode:
                return False
        return True

    def _sweep(self):
        dead = [k for k, (ref, _, _) in self._storages.items()
                if ref.expired()]
        for k in dead:
            self.live -= self._storages.pop(k)[1]

    def _snapshot(self):
        """``peak_top``: the live bytes by (op, shape, dtype), largest
        first, taken again whenever the peak has grown by TOP_STEP."""
        by = collections.Counter()
        n = collections.Counter()
        for _, nb, origin in self._storages.values():
            by[origin] += nb
            n[origin] += 1
        self.peak_top = [
            {"op": o[0], "shape": list(o[1]), "dtype": o[2], "bytes": b,
             "count": n[o]} for o, b in by.most_common(TOP_N)]
        self._top_at = self.peak

    def _track(self, name, out, inputs):
        """Count the storages ``out`` allocated: not those it shares with
        ``inputs`` (an in-place op's result, such as a decode step's
        write into its cache, an argument already counted)."""
        from torch.multiprocessing.reductions import StorageWeakRef

        held = {StorageWeakRef(t.untyped_storage()).cdata
                for t in _tensors(inputs)}
        for t in _tensors(out):
            st = t.untyped_storage()
            ref = StorageWeakRef(st)
            if ref.cdata in self._storages or ref.cdata in held:
                continue
            nb = st.nbytes()
            if self.live + nb > self.peak:
                self._sweep()       # a new peak counts live storages only
            self._storages[ref.cdata] = (
                ref, nb, (name, tuple(t.shape), str(t.dtype)))
            self.live += nb
            if self.live > self.peak:
                self.peak = self.live
                if self.peak >= self._top_at + TOP_STEP:
                    self._snapshot()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._counts(args):
            return out      # DTensor's shape propagation, not the step
        name = func._schema.name.split("::")[-1]
        if name in _TRACE_OPS:
            res = _tensors(out)
            rb = sum(_nbytes(t) for t in res)
            self.records.append((name, rb, self._group_size(args)))
        elif name == "wait_tensor":
            return out
        else:
            self.n_ops += 1
            packet = func.overloadpacket
            if packet in self.flop_registry:
                self.flops += self.flop_registry[packet](*args, **kwargs,
                                                         out_val=out)
            if not func.is_view:
                self.bytes += sum(_nbytes(t) for t in _tensors(args)) + sum(
                    _nbytes(t) for t in _tensors(out))
        if not func.is_view:
            self._track(name, out, (args, kwargs))
        return out


def summarize(trace: StepTrace, n_devices: int, argument_bytes: int
              ) -> Dict:
    """The reference's summary keys from one traced step: per-device
    FLOPs and bytes, collectives, and memory = the step's arguments (the
    local shards of params, optimizer state, batch or cache) plus the
    peak of the bytes it allocated while running, and what was live
    within TOP_STEP of that peak (``peak_top``)."""
    coll = collectives_of_trace(trace.records, n_devices)
    mem = {"argument_bytes": int(argument_bytes),
           "temp_bytes": int(trace.peak), "peak_top": trace.peak_top}
    mem["peak_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    return {
        "flops_per_device": float(trace.flops),
        "bytes_per_device": float(trace.bytes),
        "collective_wire_bytes_per_device": coll.wire_bytes,
        "collective_result_bytes": coll.result_bytes,
        "collective_count": coll.count,
        "collective_by_op": coll.by_op,
        "memory": mem,
    }

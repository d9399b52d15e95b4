"""Cost analysis of one call on the ``meta`` device: the port's
counterpart of ``repro.launch.hlo_analysis``.

The reference compiles a step, then re-derives FLOPs, bytes and
collectives from the HLO text, multiplying each ``while`` body by its
trip count, because XLA's own ``cost_analysis`` counts a scanned layer
once.  The port makes no HLO and scans nothing: its layers are a Python
loop and every op is dispatched eagerly.  So there is no text to parse;
a ``TorchDispatchMode`` sees each aten op as it runs on ``meta`` tensors
and counts it there, on the reference's terms:

- FLOPs: products exactly, by torch's FLOP registry
  (``torch.utils.flop_counter``); the model kernels, which launch
  nothing on ``meta``, by their formulas (``kernels/work.py``, through
  :func:`work.credit`); every other op at one FLOP per output element.
  Views, metadata and bare allocations (``empty``) are free.  An op
  whose one aten call hides a temporary (``logsumexp``) is counted as
  the native implementation's ops;
- bytes: operand plus output bytes of each op, as the eager port moves
  them (nothing is fused);
- collectives: the ``torch.distributed`` calls of the MoE layer on a
  mesh, by kind, from their call shapes (each call's output bytes, as
  the reference's ``hlo_collective_bytes`` sums them); nothing is sent:
  the calls are replaced for the duration, so no process group is
  needed;
- ``peak_bytes``: the largest total of live ``meta`` storages that the
  call allocated, the port's counterpart of XLA's
  ``temp_size_in_bytes``: a storage counts once however many views
  share it, and stops counting when its last reference dies (what
  autograd saves for the backward included).

Remat's recomputation runs in the backward, so it is counted, as the
reference's HLO counts it.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
_ALLOC = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
          torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _logsumexp(x, dim, keepdim=False):
    """ATen's ``logsumexp_out_impl`` op for op: its ``(x - max).exp_()``
    is a temporary of x's size that the one aten call hides."""
    maxes = torch.amax(x, dim, keepdim=True)
    m = maxes if keepdim else maxes.squeeze(dim)      # a view: filled too
    m.masked_fill_(m.abs() == float("inf"), 0)
    out = torch.sum((x - maxes).exp_(), dim, keepdim=keepdim)
    return out.log_().add_(m)


# ops whose one aten call allocates temporaries inside it: run as the
# native implementation's ops, so that the count sees them
_OPENED = {torch.ops.aten.logsumexp.default: _logsumexp}


class ShapeGroup:
    """A process group that holds only its size: what the replaced
    collectives read of a group."""

    def __init__(self, size: int):
        self._size = size

    def size(self) -> int:
        return self._size


class _Modules(TorchFunctionMode):
    """Which module runs: a stack kept by global forward hooks, and each
    autograd node made in a module's forward tagged with the module's
    path (``metadata["module"]``), which its backward reads.  Nothing
    here holds a tensor (``torch.utils.module_tracker`` does, through
    its gradient hooks, and would keep activations alive past their
    time)."""

    def __init__(self, model=None):
        super().__init__()
        self.names = {} if model is None else {
            id(m): (type(model).__name__ + "." + n).rstrip(".")
            for n, m in model.named_modules()}
        self.stack: list[str] = []

    def _pre(self, mod, args):
        self.stack.append(self.names.get(id(mod), type(mod).__name__))

    def _post(self, mod, args, out):
        self.stack.pop()

    def __enter__(self):
        self._hooks = (
            torch.nn.modules.module.register_module_forward_pre_hook(
                self._pre),
            torch.nn.modules.module.register_module_forward_hook(
                self._post, always_call=True))
        return super().__enter__()

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        return super().__exit__(*exc)

    def where(self) -> str:
        """The innermost module running: ``(remat)`` when the backward
        recomputes its forward, ``(backward)`` for a node's backward."""
        in_bw = torch._C._current_graph_task_id() != -1
        if self.stack:
            return self.stack[-1] + (" (remat)" if in_bw else "")
        node = torch._C._current_autograd_node() if in_bw else None
        if node is not None:
            return node.metadata.get("module", "Global") + " (backward)"
        return "Global"

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.is_grad_enabled():
            # the call's new nodes: from its outputs' back to the nodes
            # made before it, all tagged already
            here = self.stack[-1] if self.stack else "Global"
            todo = [t.grad_fn for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            while todo:
                fn = todo.pop()
                if fn is None or "module" in fn.metadata:
                    continue
                fn.metadata["module"] = here
                todo.extend(f for f, _ in fn.next_functions)
        return out


class _Counter(TorchDispatchMode):
    def __init__(self, modules: _Modules):
        super().__init__()
        self.modules = modules
        self.flops = 0.0
        self.dots = 0.0
        self.bytes = 0.0
        self.dots_by = defaultdict(float)
        self.bytes_by = defaultdict(float)
        self.coll_bytes = dict.fromkeys(COLLECTIVE_OPS, 0)
        self.coll_count = dict.fromkeys(COLLECTIVE_OPS, 0)
        self.coll_by = defaultdict(float)
        self.credited = defaultdict(lambda: {"calls": 0, "flops": 0.0,
                                             "bytes": 0.0})
        self.live: dict = {}
        self.total = 0
        self.peak = 0
        self.host_bytes = 0

    def where(self) -> str:
        return self.modules.where()

    def _born(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st.device.type != "meta":
            self.host_bytes += st.nbytes()
            return
        ref = StorageWeakRef(st)
        if ref in self.live:
            return
        for r in [r for r in self.live if r.expired()]:
            self.total -= self.live.pop(r)
        self.live[ref] = st.nbytes()
        self.total += st.nbytes()
        self.peak = max(self.peak, self.total)

    def credit(self, name: str, flops: float, nbytes: float,
               products: bool = True) -> None:
        c = self.credited[name]
        c["calls"] += 1
        c["flops"] += flops
        c["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        here = self.where()
        self.bytes_by[f"{name}:{here}"] += nbytes
        if products:
            self.dots += flops
            self.dots_by[f"{here}:{name}"] += flops

    def collective(self, kind: str, nbytes: int) -> None:
        self.coll_bytes[kind] += nbytes
        self.coll_count[kind] += 1
        self.coll_by[f"{kind}:{self.where()}"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _OPENED:
            with self:
                return _OPENED[func](*args, **kwargs)
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        held = {StorageWeakRef(t.untyped_storage()) for t in ins}
        for t in outs:
            if StorageWeakRef(t.untyped_storage()) not in held:
                self._born(t)
        if func.is_view or func in _ALLOC:
            return out
        nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += nb
        here, packet = self.where(), func.overloadpacket
        self.bytes_by[f"{packet.__name__}:{here}"] += nb
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.dots += f
            self.dots_by[f"{here}:{packet.__name__}"] += f
        else:
            f = sum(t.numel() for t in outs)
        self.flops += f
        return out


@contextlib.contextmanager
def _collectives(counter: _Counter, world: int):
    """``torch.distributed``'s calls replaced by recorders of their
    shapes; a group that is None (the default) has ``world`` ranks."""
    def size(group=None):
        return world if group is None else group.size()

    def all_to_all_single(out, inp, *a, group=None, **kw):
        counter.collective("all-to-all", _nbytes(out))

    def all_gather(out, inp, group=None, **kw):
        counter.collective("all-gather", _nbytes(out))

    def all_reduce(t, *a, group=None, **kw):
        counter.collective("all-reduce", _nbytes(t))

    fakes = {"get_world_size": size, "all_to_all_single": all_to_all_single,
             "all_gather_into_tensor": all_gather,
             "all_gather_single": all_gather, "all_reduce": all_reduce}
    saved = {k: getattr(dist, k) for k in fakes if hasattr(dist, k)}
    for k, f in fakes.items():
        setattr(dist, k, f)
    try:
        yield
    finally:
        for k in fakes:
            if k in saved:
                setattr(dist, k, saved[k])
            else:
                delattr(dist, k)


def analyze(fn, *args, world: int = 1, model=None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` (on ``meta`` tensors) and count its
    cost.  The keys of the reference's ``analyze`` (``flops_corrected``,
    ``bytes_corrected``, ``collective_bytes`` / ``collective_counts`` by
    kind, ``collective_bytes_total``), then ``peak_bytes``, ``flops_dots``
    (the products alone: the registry's and the kernels'), the kernels'
    and the Mamba scan's credited work (``credited``, by name: calls,
    FLOPs, bytes), ``host_bytes`` (storages the call made off ``meta``),
    the attribution tables :func:`attribute_dots`, :func:`attribute_bytes`
    and :func:`attribute_collectives` read, and ``out``, what ``fn``
    returned.  ``world`` is the rank count a collective on the default
    group spans.  Rows are labelled by module path, under ``model``'s
    names when it is given."""
    modules = _Modules(model)
    counter = _Counter(modules)
    with modules, counter, work.listen(counter.credit), \
            _collectives(counter, world):
        out = fn(*args, **kwargs)
    return {
        "flops_corrected": counter.flops,
        "bytes_corrected": counter.bytes,
        "collective_bytes": dict(counter.coll_bytes),
        "collective_counts": dict(counter.coll_count),
        "collective_bytes_total": sum(counter.coll_bytes.values()),
        "peak_bytes": counter.peak,
        "flops_dots": counter.dots,
        "credited": {k: dict(v) for k, v in counter.credited.items()},
        "host_bytes": counter.host_bytes,
        "dots_by": dict(counter.dots_by),
        "bytes_by": dict(counter.bytes_by),
        "collectives_by": dict(counter.coll_by),
        "out": out,
    }


def _top(table: dict, key: str, top: int | None) -> list[dict]:
    rows = [{"op": k, key: v} for k, v in
            sorted(table.items(), key=lambda kv: -kv[1])]
    return rows if top is None else rows[:top]


def attribute_dots(cost: dict, top: int | None = 12) -> list[dict]:
    """Product FLOPs by module path and op (the kernels' by name), the
    largest first: the reference's rows by ``op_name``."""
    return _top(cost["dots_by"], "flops", top)


def attribute_bytes(cost: dict, top: int | None = 15) -> list[dict]:
    """Bytes by op kind and module path, the largest first."""
    return _top(cost["bytes_by"], "bytes", top)


def attribute_collectives(cost: dict, top: int | None = 12) -> list[dict]:
    """Collective bytes by kind and module path, the largest first."""
    return _top(cost["collectives_by"], "bytes", top)


"""The work and the memory of a step, counted op by op on the meta device
(the port's counterpart of ``repro/roofline/hlo_parse.py``).

The reference walks the HLO of a compiled step; eager PyTorch has no
compiled program, so ``analyze(fn, *args)`` runs ``fn`` under a
``TorchDispatchMode`` on meta tensors and counts every aten op as it is
dispatched. It returns the reference's keys:

* ``flops``: 2 M N K of every matmul (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``mv``, ``addmv``, ``dot``: what ``linear``, ``matmul``
  and ``einsum`` reach), plus each kernel region's work;
* ``hbm_bytes``: the eager model of ``hlo_parse``'s boundary model
  (``:327-340``). Eager PyTorch has no fusions, so every aten op reads its
  inputs and writes its outputs once; views (an op whose outputs share an
  input's storage, as ``view``, ``t``, ``transpose``, ``expand``,
  ``slice``, ``as_strided``) and allocations are free, the counterpart of
  ``_FREE_OPS``; a gather or an indexed write moves the rows it touches
  (twice their bytes, as ``_op_bytes``), an expanded input its distinct
  elements. ``hbm_bytes_kernel_adj`` equals it (``roofline/model.py``);
* ``collective_bytes`` by kind and ``collective_bytes_total``: the
  inputs of ``_c10d_functional`` collectives (none on one card);
* ``unknown_trip_loops``: always 0. Eager dispatch sees every op as it
  runs, remat's recompute included, so there is no loop to multiply and
  no trip count to miss; the key stays for the reference's records;
* ``memory``: live bytes by storage, added when an op's output brings a
  new storage and taken off when the storage dies (``weakref`` callbacks,
  as ``torch.distributed._tools.mem_tracker`` tracks them), with
  ``peak_bytes_per_device`` and its split at the peak into the params,
  grads, optimizer state, cache and activations (transients included),
  the counterpart of the ``memory_analysis`` the reference's dry-run
  reads. Grads are the ``.grad`` of the views of the params (the leaves
  ``train_step.trainable`` hands autograd) when a backward ends, and the
  whole-leaf copies made of them (the microbatch accumulators).

A kernel region is counted once, by its ``launch/compat.py`` entry, not
by the ops inside it: each wrapper of ``WRAPPERS`` has a branch that runs
only when its inputs lie on ``"meta"``, returns empty outputs of the
kernel's shapes and dtypes, calls ``record_region`` (a no-op with no count
active) and leaves ``.launches`` alone. Its work is counted twice, and
never mixed: ``flops`` the function's, ``launched_flops`` the schedule's
(``compat``'s docstring); ``launched_flops`` adds the matmuls too, so it
is what the reference's HLO walk counts.
"""

from __future__ import annotations

import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# the counts that record_region adds to (innermost last)
_ACTIVE: List["_Count"] = []

_MATMUL = {aten.mm.default, aten.bmm.default, aten.addmm.default,
           aten.baddbmm.default, aten.mv.default, aten.addmv.default,
           aten.dot.default}
# allocations: no traffic until written
_ALLOC = {aten.empty.memory_format, aten.empty_strided.default,
          aten.empty_like.default, aten.new_empty.default,
          aten.new_empty_strided.default}
# read only the rows they gather: twice the output, plus the index
_GATHER = {aten.embedding.default, aten.index.Tensor, aten.gather.default,
           aten.index_select.default}
# write only the rows they touch: twice the source, plus the index
_SCATTER = {aten.index_add_.default, aten.index_put_.default,
            aten._index_put_impl_.default, aten.index_copy_.default,
            aten.scatter_.src, aten.scatter_add_.default,
            aten.index_add.default, aten.index_put.default,
            aten.scatter_add.default}

_CATEGORIES = ("params", "grads", "optimizer", "err_state", "cache",
               "activations")
_MUTABLE: Dict[object, bool] = {}  # an op's schema mutates an argument


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts, in order (an aten
    op's arguments and outputs; faster than a pytree walk, which the
    count would pay at every op)."""
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


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: its distinct elements (an expanded dim,
    stride 0, read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(func, args) -> float:
    if func in (aten.addmm.default, aten.baddbmm.default,
                aten.addmv.default):
        args = args[1:]
    a, b = args[0], args[1]
    if func is aten.dot.default:
        return 2.0 * a.shape[0]
    if func in (aten.mv.default, aten.addmv.default):
        return 2.0 * a.shape[0] * a.shape[1]
    k = a.shape[-1]
    out = a.shape[:-1].numel() * b.shape[-1]
    return 2.0 * out * k


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Record:
    __slots__ = ("nbytes", "cat", "ref")

    def __init__(self, nbytes: int, cat):
        self.nbytes, self.cat = nbytes, cat
        self.ref = None  # the storage's weakref, whose callback frees it


class _Count:
    def __init__(self):
        self.matmul_flops = 0.0
        self.op_bytes = 0.0
        self.ops = 0
        self.regions: Dict[str, dict] = {}
        self.coll: Dict[str, float] = {}
        self.coll_count: Dict[str, int] = {}
        # memory: live storages, and the totals by category of those
        # whose category is settled
        self.live: Dict[int, _Record] = {}
        self.settled = dict.fromkeys(_CATEGORIES, 0)
        self.pending: Dict[int, _Record] = {}  # allocated in a backward
        self.live_bytes = 0
        self.peak = 0
        self.peak_settled = dict(self.settled)
        self.peak_pending: List[_Record] = []
        self.was_in_bwd = False
        # views of the params (the leaves autograd differentiates), whose
        # .grad a backward fills
        self.param_views: List[weakref.ref] = []

    # ---- memory ---------------------------------------------------------
    def track(self, t: torch.Tensor, cat=None, in_bwd: bool = False):
        """Start tracking ``t``'s storage (no-op when tracked already)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        rec = _Record(st.nbytes(), cat)
        self.live[key] = rec
        if in_bwd and cat is None:  # settled when its backward ends
            self.pending[key] = rec
        else:
            rec.cat = rec.cat or "activations"
            self.settled[rec.cat] += rec.nbytes
        self.live_bytes += rec.nbytes
        rec.ref = weakref.ref(st, lambda _, key=key: self._free(key))
        if self.live_bytes > self.peak:
            self.peak = self.live_bytes
            self.peak_settled = dict(self.settled)
            self.peak_pending = list(self.pending.values())

    def _free(self, key: int):
        rec = self.live.pop(key, None)
        if rec is None:
            return
        self.live_bytes -= rec.nbytes
        if self.pending.pop(key, None) is None:
            self.settled[rec.cat] -= rec.nbytes
        else:  # died inside its backward: a transient
            rec.cat = "activations"

    def end_backward(self):
        """A backward ended: of what it allocated and still lives, the
        .grad of a view of the params is a grad, the rest (a graph kept
        alive by a loss the caller holds) activations."""
        grads = set()
        for ref in self.param_views:
            v = ref()
            if v is not None and v.grad is not None:
                grads.add(_storage_key(v.grad))
        self.param_views = [r for r in self.param_views if r() is not None]
        for key, rec in self.pending.items():
            rec.cat = "grads" if key in grads else "activations"
            self.settled[rec.cat] += rec.nbytes
        self.pending.clear()

    def memory(self) -> dict:
        split = dict(self.peak_settled)
        for rec in self.peak_pending:
            split[rec.cat or "activations"] += rec.nbytes
        return {"peak_bytes_per_device": self.peak, "peak_split": split}

    # ---- ops ------------------------------------------------------------
    def on_op(self, func, args, kwargs, out):
        self.ops += 1
        in_bwd = torch._C._current_graph_task_id() != -1
        if self.was_in_bwd and not in_bwd:
            self.end_backward()
        self.was_in_bwd = in_bwd
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_storage_key(t) for t in ins}
        if func in _MATMUL:
            self.matmul_flops += _matmul_flops(func, args)
        if func.namespace == "_c10d_functional":
            kind = func._schema.name.split("::")[-1]
            self.coll[kind] = self.coll.get(kind, 0.0) + sum(
                _nbytes(t) for t in ins)
            self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
        mutable = _MUTABLE.get(func)
        if mutable is None:
            mutable = _MUTABLE[func] = func._schema.is_mutable
        new = [t for t in outs if _storage_key(t) not in in_keys]
        if func in _ALLOC:
            pass
        elif func in _GATHER:
            self.op_bytes += 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif func in _SCATTER:
            src = [t for t in ins[1:] if t.is_floating_point()]
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            self.op_bytes += 2 * sum(_read_bytes(t) for t in src) + sum(
                _read_bytes(t) for t in idx)
        elif new or mutable:
            reads = ins[1:] if func is aten.copy_.default else ins
            self.op_bytes += sum(_read_bytes(t) for t in reads) + sum(
                _nbytes(t) for t in outs)
        elif any(self.live.get(k) is not None and
                 self.live[k].cat == "params" for k in in_keys):
            # a view of the params: maybe a leaf that autograd fills
            self.param_views.extend(weakref.ref(t) for t in outs)
        # else: a view, free
        for t in new:
            self.track(t, self._inherited(func, ins, t, in_bwd), in_bwd)

    def _inherited(self, func, ins, t, in_bwd):
        """"grads" for a whole-leaf copy of a grad made outside a backward
        (``.float()`` of a grad, an accumulator divided by M), else None."""
        if in_bwd or len(ins) != 1 or func in _ALLOC:
            return None
        src = ins[0]
        rec = self.live.get(_storage_key(src))
        whole = src.numel() * src.element_size() == \
            src.untyped_storage().nbytes()
        if rec is not None and rec.cat == "grads" and whole and \
                src.numel() == t.numel():
            return "grads"
        return None

    def add_region(self, name: str, work):
        r = self.regions.setdefault(name, {"count": 0, "flops": 0.0,
                                           "launched_flops": 0.0,
                                           "bytes": 0.0, "bound_ms": 0.0})
        r["count"] += 1
        r["flops"] += work.flops
        r["launched_flops"] += work.launched_flops
        r["bytes"] += work.bytes
        r["bound_ms"] += work.bound_ms

    def result(self) -> dict:
        reg_flops = sum(r["flops"] for r in self.regions.values())
        reg_launched = sum(r["launched_flops"]
                           for r in self.regions.values())
        reg_bytes = sum(r["bytes"] for r in self.regions.values())
        hbm = self.op_bytes + reg_bytes
        return {
            "flops": self.matmul_flops + reg_flops,
            "launched_flops": self.matmul_flops + reg_launched,
            "matmul_flops": self.matmul_flops,
            "hbm_bytes": hbm,
            "hbm_bytes_kernel_adj": hbm,
            "regions": self.regions,
            "collective_bytes": dict(self.coll),
            "collective_bytes_total": sum(self.coll.values()),
            "collective_counts": dict(self.coll_count),
            "unknown_trip_loops": 0,
            "n_ops": self.ops,
            "memory": self.memory(),
        }


class _Mode(TorchDispatchMode):
    def __init__(self, count: _Count):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.count.on_op(func, args, kwargs, out)
        return out


def record_region(name: str, *args, **kw):
    """Add one launch of kernel region ``name`` (its ``compat`` work at
    these arguments) to every active count; a no-op with none active."""
    if not _ACTIVE:
        return
    from repro_torch.launch import compat

    w = compat.work(name, *args, **kw)
    for c in _ACTIVE:
        c.add_region(name, w)


def analyze(fn, *args, categories=None, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under the count and return its
    work and memory (module docstring). ``categories`` maps a category of
    the memory split ("params", "optimizer", "cache", ...) to a tree of
    tensors that exist before the call; every other tensor of ``args``
    counts as activations (the batch)."""
    count = _Count()
    for cat, tree in (categories or {}).items():
        if cat not in _CATEGORIES:
            raise ValueError(f"unknown category {cat!r}; known "
                             f"{_CATEGORIES}")
        for t in _tensors(tree):
            count.track(t, cat)
    for t in _tensors((args, kwargs)):
        count.track(t, "activations")
    _ACTIVE.append(count)
    try:
        with _Mode(count):
            fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(count)
    if count.was_in_bwd:
        count.end_backward()
    return count.result()

"""Per-op cost of a program run on ``meta`` tensors: the port's counterpart
of the reference's loop-aware HLO cost model.

Reference: ``repro/launch/hlo_cost.py`` (``_dot_flops`` :171,
``_trip_count`` :146, ``ModuleCost`` :224, ``analyze`` :464). The reference
parses the optimised HLO of a compiled step; the port has no HLO. Here
``OpCost`` is a ``TorchDispatchMode``: every ATen op that runs under it
(forward, autograd's backward, a checkpoint's recompute, the optimizer)
is counted as it is dispatched. Run on ``meta`` tensors, a step of any
size costs no memory and no device.

Eager execution visits every loop iteration: a Python loop over seven
blocks dispatches the body's ops seven times, and each remat recompute
dispatches the block's forward again, as XLA's HLO holds it. So the
reference's trip-count machinery (``while`` bodies x ``_trip_count``)
has no counterpart here.

``result()`` keys, the reference's where they mean the same thing:

  flops             FLOPs of the matrix products: 2 x numel(result) x
                    prod(contracted dims) per ``mm``/``bmm``/``addmm``/
                    ``baddbmm``/convolution, the ``FlopCounterMode``
                    registry's formulas (which are ``_dot_flops``')
  all_flops         every op: the registry's formula where it has one,
                    else one per element of the op's largest tensor
  hbm_bytes         operand + result bytes of each op that is not a view
                    or a bare allocation. Against a fused kernel this
                    overcounts: each intermediate of an elementwise chain
                    that a kernel keeps in registers is written and read
                    here
  collective_bytes  operand bytes of the ``c10d`` collectives dispatched
  collectives       those bytes by kind
  top_dots          (flops, site) of the heaviest product sites, the
                    counterpart of ``dot_sites()``: the innermost frame of
                    the port's model code that issued the op, prefixed by
                    the autograd node when the op runs in a backward
                    (``bwd[MmBackward0]``), or by ``recompute`` in a remat
                    recompute
  peak_live_bytes   the largest sum of live storages during the run:
                    storages are tracked from their first appearance until
                    Python frees them, the arguments ``watch``ed before
                    the run included
  saved_bytes       bytes of the tensors autograd saved for backward
                    through ``saved_tensors_hooks``, each storage once,
                    ``watch``ed ones left out
  largest_op_bytes  the largest single op output
  ops               the ops counted
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# bare allocations, and a view whose schema does not say it is one
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "_unsafe_view"}
_COLLECTIVE_NS = {"c10d", "_c10d_functional", "c10d_functional"}
_HERE = __file__
_PKG = __file__.rsplit("/launch/", 1)[0] + "/"


def _tensors(tree, out=None) -> list[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """An op whose result aliases an input without writing it."""
    for r in func._schema.returns:
        a = r.alias_info
        if a is not None and not a.is_write:
            return True
    return False


def _site() -> tuple[str, bool]:
    """The innermost frame of the port's model code (``models/``,
    ``kernels/``, ``data/``, ``core/``) on the Python stack, as
    ``path:function``, and whether a checkpoint's recompute runs it."""
    f = sys._getframe(2)
    site = ""
    while f is not None:
        fn = f.f_code.co_filename
        if not site and fn.startswith(_PKG) and fn != _HERE \
                and "/launch/" not in fn and "/train/" not in fn:
            site = f"{fn[len(_PKG):]}:{f.f_code.co_name}"
        elif fn.endswith("torch/utils/checkpoint.py"):
            return site, True
        f = f.f_back
    return site, False


class OpCost(TorchDispatchMode):
    """Counts the ops dispatched under it, the live storages and the
    tensors saved for backward (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.all_flops = 0
        self.hbm_bytes = 0
        self.collective_bytes = 0
        self.collectives: dict = defaultdict(float)
        self.dot_sites: dict = defaultdict(float)
        self.largest_op_bytes = 0
        self.n_ops = 0
        self.live = 0
        self.peak_live = 0
        self.saved_bytes = 0
        self._live: dict = {}
        self._watched: set = set()
        self._saved: set = set()

    # ---- memory ------------------------------------------------------

    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        weakref.finalize(st, self._free, key, n)

    def watch(self, tree) -> int:
        """Track the storages of tensors made before the run (the
        arguments); returns their bytes, each storage once."""
        before = self.live
        for t in _tensors(tree):
            self._track(t)
            self._watched.add(id(t.untyped_storage()))
        self.peak_live = max(self.peak_live, self.live)
        return self.live - before

    def _pack(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = id(st)
        if key not in self._watched and key not in self._saved:
            self._saved.add(key)
            self.saved_bytes += st.nbytes()
            weakref.finalize(st, self._saved.discard, key)
        return t

    def __enter__(self):
        self._hooks = torch.autograd.graph.saved_tensors_hooks(
            self._pack, lambda t: t)
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._hooks.__exit__(*exc)
        return out

    # ---- counting ----------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        self.n_ops += 1
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        self.peak_live = max(self.peak_live, self.live)
        out_bytes = sum(_nbytes(t) for t in outs)
        self.largest_op_bytes = max(self.largest_op_bytes, out_bytes)
        ns = func.namespace
        if ns in _COLLECTIVE_NS:
            b = sum(_nbytes(t) for t in ins) or out_bytes
            kind = packet.__name__
            self.collective_bytes += b
            self.collectives[kind] += b
            self.hbm_bytes += b
            return
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.all_flops += f
            site, recompute = _site()
            site = site or packet.__name__
            node = torch._C._current_autograd_node()
            if recompute:
                site = f"recompute {site}"
            elif node is not None:
                site = f"bwd[{node.name()}] {site}"
            self.dot_sites[site] += f
            self.hbm_bytes += out_bytes + sum(_nbytes(t) for t in ins)
            return
        if packet.__name__ in _ALLOC or _is_view(func) or not outs:
            return
        self.all_flops += max([t.numel() for t in ins + outs], default=0)
        self.hbm_bytes += out_bytes + sum(_nbytes(t) for t in ins)

    def result(self) -> dict:
        dots = sorted(((v, k) for k, v in self.dot_sites.items()),
                      reverse=True)
        return dict(
            flops=float(self.flops),
            all_flops=float(self.all_flops),
            hbm_bytes=float(self.hbm_bytes),
            collective_bytes=float(self.collective_bytes),
            collectives={k: v for k, v in sorted(self.collectives.items())},
            top_dots=dots[:12],
            peak_live_bytes=int(self.peak_live),
            saved_bytes=int(self.saved_bytes),
            largest_op_bytes=int(self.largest_op_bytes),
            ops=self.n_ops,
        )


def analyze(fn: Callable, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` under an ``OpCost``, its tensor arguments
    watched; its ``result()`` (the reference's ``analyze`` takes HLO
    text, this takes the program)."""
    with OpCost() as oc:
        oc.watch((args, kwargs))
        fn(*args, **kwargs)
    return oc.result()


__all__ = ["OpCost", "analyze"]

"""Purity inference — reading a task's "type signature" from its trace.

Port of ``repro/core/purity.py``.  In the paper, ``f :: A -> B`` is pure and
``f :: IO B`` is effectful, and the auto-parallelizer decides *from the
signature alone* whether a call can float.  An explicit declaration
(``@task``, ``@io_task``, :func:`declare`) is that signature and always wins.

Without one, the reference asks JAX's effect system
(``jax.make_jaxpr(fn).effects``).  PyTorch has no effect system, so the port
traces ``fn`` with FakeTensors through ``torch.func.functionalize`` and reads
the graph: functionalization turns every in-place update of an input into an
explicit ``aten.copy_`` back into that input, so a pure function's graph has
none.  Two differences from the reference follow:

* PyTorch has no counterpart of ``jax.debug.print``'s ordered effect.
  Python-level side effects (``print``, file or socket I/O, mutating a
  global) run once while tracing and leave no node, so they are invisible
  here.  Declare such functions with ``@io_task``.
* Only the tensor arguments are checked for mutation; a function that
  writes a tensor it closes over is likewise invisible.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional
import weakref

import torch

# Explicit declarations take precedence (the "type signature" the user wrote).
# Weak-keyed: an ``id()``-keyed dict would let a dead function's entry leak
# onto whatever new function the allocator places at the same address.
_DECLARED: "weakref.WeakKeyDictionary[Callable, bool]" = \
    weakref.WeakKeyDictionary()


def declare(fn: Callable, pure: bool) -> None:
    try:
        _DECLARED[fn] = pure
        return
    except TypeError:   # non-weakref-able callable: annotate directly
        pass
    try:
        fn.__declared_pure__ = pure
    except (AttributeError, TypeError):
        # neither weakref-able nor attribute-assignable (numpy ufuncs, C
        # builtins): leave undeclared — infer_purity falls back to graph
        # inspection, and the @task wrapper passes purity explicitly anyway
        pass


def declared_purity(fn: Callable) -> Optional[bool]:
    try:
        d = _DECLARED.get(fn)
    except TypeError:
        d = None
    if d is None:
        d = getattr(fn, "__declared_pure__", None)
    return d


def infer_purity(fn: Callable, *example_args: Any, **example_kwargs: Any) -> bool:
    """Return True iff ``fn`` is pure.

    Order of evidence (mirrors "check the type signature"):
      1. an explicit ``declare``/``@io_task``/``@task`` annotation;
      2. trace ``make_fx(functionalize(fn), tracing_mode="fake")`` on the
         example arguments and look for an ``aten.copy_`` whose target is
         one of the traced inputs — a write into an argument;
      3. if tracing itself raises (data-dependent Python, unsupported
         ops...), conservatively report impure.
    """
    d = declared_purity(fn)
    if d is not None:
        return d
    from torch.fx.experimental.proxy_tensor import make_fx
    body = functools.partial(fn, **example_kwargs) if example_kwargs else fn
    try:
        gm = make_fx(torch.func.functionalize(body),
                     tracing_mode="fake")(*example_args)
    except Exception:
        return False
    inputs = {n for n in gm.graph.nodes if n.op == "placeholder"}
    return not any(n.op == "call_function"
                   and n.target is torch.ops.aten.copy_.default
                   and n.args[0] in inputs
                   for n in gm.graph.nodes)

"""Hand-written Hopper kernels of the port, with their plain PyTorch versions.

Port of ``repro/kernels/``: ``ops.py`` holds the entry points, ``ref.py`` the
plain versions, ``csrc/`` the CUDA sources, and ``_build.py`` builds them on
first use.  Nothing here imports a compiler or touches the card at import.
"""

import sys
from typing import Dict

#: the kernel wrappers: (module, function name)
KERNELS = (("matmul", "matmul"), ("ssm_scan", "ssm_scan"),
           ("ssm_scan", "ssm_scan_backward"),
           ("flash_attention", "flash_attention"),
           ("flash_attention", "flash_attention_backward"))


def needs_grad(*tensors) -> bool:
    """Whether autograd would track an op on ``tensors`` (``None``s
    skipped): grad mode is on and one of them requires grad."""
    import torch
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors, remedy: str) -> None:
    """Raise if a gradient is asked of kernel ``name``'s wrapper: its
    output is written by the kernel behind autograd's back, so it would
    carry no ``grad_fn`` and the gradient would silently stop there."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel's wrapper "
            f"gives no gradient; {remedy}")


def operator_route(*tensors):
    """``torch.ops.repro_torch`` (``kernels/operators.py``: the kernels as
    operators, which a count sees) when a count is running or one of
    ``tensors`` is a fake tensor, else ``None``: the caller then calls the
    wrapper directly.  Loads nothing in a process that counts nothing and
    has no fake tensor (``torch`` itself imports the fake tensor class)."""
    import torch
    ops = sys.modules.get(f"{__name__}.operators")
    if ops is None or not ops.counting:
        fake = torch._subclasses.fake_tensor.FakeTensor
        if not any(isinstance(t, fake) for t in tensors):
            return None
        from . import operators  # noqa: F401
    return torch.ops.repro_torch


def launch_counts() -> Dict[str, int]:
    """This process's kernel launches so far: ``name`` for each wrapper that
    has been imported (``ssm_scan_backward`` and
    ``flash_attention_backward`` for the backward kernels), and
    ``name/route`` (``matmul/simt``, ``flash_attention/wgmma``, ...) and
    ``name/variant`` (``matmul/vector``) for its counts by route and load
    variant.  Imports nothing: a process that never loaded a
    wrapper launched none of its kernel."""
    counts: Dict[str, int] = {}
    for module, name in KERNELS:
        mod = sys.modules.get(f"{__name__}.{module}")
        if mod is None:
            continue
        fn = getattr(mod, name)
        counts[name] = fn.launches
        for by in ("route_launches", "variant_launches"):
            for key, n in getattr(fn, by, {}).items():
                counts[f"{name}/{key}"] = n
    return counts

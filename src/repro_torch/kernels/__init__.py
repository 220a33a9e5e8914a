"""Hand-written Hopper kernels of the port, with their plain PyTorch versions.

Port of ``repro/kernels/``: ``ops.py`` holds the entry points, ``ref.py`` the
plain versions, ``csrc/`` the CUDA sources, and ``_build.py`` builds them on
first use.  Nothing here imports a compiler or touches the card at import.
"""

import sys
from typing import Dict

#: the kernel wrappers, by module and function name
KERNELS = ("matmul", "ssm_scan", "flash_attention")


def launch_counts() -> Dict[str, int]:
    """This process's kernel launches so far: ``name`` for each wrapper that
    has been imported, and ``name/route`` (``matmul/simt``,
    ``flash_attention/wgmma``, ...) and ``name/variant`` (``matmul/vector``)
    for its counts by route and load variant.  Imports nothing: a process
    that never loaded a wrapper launched none of its kernel."""
    counts: Dict[str, int] = {}
    for name in KERNELS:
        mod = sys.modules.get(f"{__name__}.{name}")
        if mod is None:
            continue
        fn = getattr(mod, name)
        counts[name] = fn.launches
        for by in ("route_launches", "variant_launches"):
            for key, n in getattr(fn, by, {}).items():
                counts[f"{name}/{key}"] = n
    return counts

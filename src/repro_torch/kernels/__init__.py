"""Hand-written Hopper kernels of the port, with their plain PyTorch versions.

Port of ``repro/kernels/``: ``ops.py`` holds the entry points, ``ref.py`` the
plain versions, ``csrc/`` the CUDA sources, and ``_build.py`` builds them on
first use.  Nothing here imports a compiler or touches the card at import.
"""

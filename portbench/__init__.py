"""The benchmark of the PyTorch port (``src/repro_torch``) on the H100.

``run.py`` runs one cell of ``BENCHMARK.json``; everything a cell uses is
found by name: ``configs/<config>.json``, ``traffic/<mix>.json`` (driven by
``traffic/<kind>.py``), ``metrics/<metric>.py``, ``limits/<cell>.json``.
``counts/`` holds the frozen operation and byte counts and the card's
peaks, ``reference/`` the plain reference, ``compare.py`` the comparison
that decides ``correct``.  Nothing here imports JAX or the JAX package.
"""

"""The port's launchers (``repro/launch/`` in the reference).

Ported so far: ``train.py`` and ``steps.py`` (training on one device),
``serve.py`` (continuous-batching serving of the Mamba1 and
dense transformer families), ``backend.py`` (the thread and process
backends of ``--show-graph``), ``remote.py`` (``repro-worker``: workers that
dial a driver), ``driver.py`` (``repro-driver``: a checkpointed driver
that can be resumed), ``gateway.py`` (a resident multi-tenant pool that
clients submit graphs to) and ``mesh.py`` (the mesh builders and the
world helpers).
"""

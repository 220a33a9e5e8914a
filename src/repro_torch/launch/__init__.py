"""The port's launchers (``repro/launch/`` in the reference).

Ported so far: ``train.py`` and ``steps.py`` (training on one device, or
with ``--tp`` on a (data, model) mesh of a ``torch.distributed`` world),
``serve.py`` (continuous-batching serving, on one device or with
``--tp``), ``backend.py`` (the thread and process
backends of ``--show-graph``), ``remote.py`` (``repro-worker``: workers that
dial a driver), ``driver.py`` (``repro-driver``: a checkpointed driver
that can be resumed), ``gateway.py`` (a resident multi-tenant pool that
clients submit graphs to) and ``mesh.py`` (the mesh builders and the
world helpers).
"""

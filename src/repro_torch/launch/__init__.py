"""The port's launchers (``repro/launch/`` in the reference).

Ported so far: ``serve.py`` (continuous-batching serving of the Mamba1
family) and the thread backend of ``backend.py``.
"""

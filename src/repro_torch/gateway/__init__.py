"""Multi-tenant job gateway: the cluster runtime as a resident service.

Port of ``repro/gateway/``: ``errors.py`` unchanged, ``service.py`` and
``client.py`` with tensors pickled by the port's reducer (see their
docstrings).

The rest of ``repro_torch.cluster`` is a *library*: one driver process owns a
worker pool for the duration of one ``run()``.  This package is the
*service* shape of the same engine — a long-lived
:class:`GatewayService` owns one resident pool and any number of
tenants submit task graphs to it concurrently over TCP via
:func:`repro_torch.connect` (or ``run_graph(..., connect="host:port")``),
with per-tenant admission quotas, fair-share dispatch, failure
isolation, and SLO accounting.  Results remain bit-identical to
``execute_sequential`` — same deterministic trace/lower/fuse passes,
shared pool or not.
"""
from .client import Client, connect
from .errors import GatewayError, QuotaExceeded, SessionClosed
from .service import GatewayService, TenantQuota

__all__ = ["Client", "connect", "GatewayError", "QuotaExceeded",
           "SessionClosed", "GatewayService", "TenantQuota"]

"""Typed errors for the multi-tenant gateway.

Port of ``repro/gateway/errors.py``, unchanged.

These cross the wire: the service pickles the exception instance into the
``failed`` frame and the client re-raises it from ``future.result()``, so
a quota rejection is caught as ``except repro_torch.QuotaExceeded`` — not
string-matched out of a generic ``RuntimeError``.  Every class here must
therefore survive a pickle round-trip with its attributes intact
(``__reduce__`` pins the constructor args).
"""
from __future__ import annotations

__all__ = ["GatewayError", "QuotaExceeded", "SessionClosed"]


class GatewayError(RuntimeError):
    """Base class for gateway-side failures: protocol violations,
    rejected submissions, a service that is shutting down."""


class QuotaExceeded(GatewayError):
    """A submission was rejected by per-tenant admission control before
    any of its tasks ran.

    Attributes name the failed check so callers can back off sensibly:
    ``resource`` is ``"inflight_clusters"`` or ``"store_bytes"``,
    ``limit`` the tenant's configured ceiling, ``requested`` what
    admitting the job would have brought the total to.
    """

    def __init__(self, message: str, tenant: str = "",
                 resource: str = "", limit: int = 0,
                 requested: int = 0) -> None:
        super().__init__(message)
        self.tenant = tenant
        self.resource = resource
        self.limit = limit
        self.requested = requested

    def __reduce__(self):
        return (QuotaExceeded, (self.args[0], self.tenant, self.resource,
                                self.limit, self.requested))


class SessionClosed(GatewayError):
    """The client session ended (``close()``, gateway shutdown, or a
    dropped connection) while futures were still pending; those futures
    fail with this error rather than hanging forever."""

"""``model.torch_ops_ms``: device milliseconds a traced step of every
operation that is not one of the port's own kernels: the GEMMs, the
float32 unembedding, casts, norms, copies and AdamW."""
from portbench.counts.kernels import is_port_kernel


def read(rec):
    us = sum(e - s for name, s, e in rec.device if not is_port_kernel(name))
    return us / 1e3 / rec.steps

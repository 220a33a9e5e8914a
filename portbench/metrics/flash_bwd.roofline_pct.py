"""``flash_bwd.roofline_pct``: the flash backward's launches in the traced
steps, each at its least time (``counts.kernels.flash_bwd``: 10 · D FLOPs
a visible pair a head, or q, k, v, out, dout, lse read and dq, dk, dv
written once), over the device time of every kernel a launch runs, the
Δ pre-pass included."""
from portbench import trace
from portbench.counts import kernels


def read(rec):
    n, seconds = trace.device_seconds(rec, "flash_bwd")
    if n == 0:
        return None
    c, t = rec.config, rec.traffic
    bound = kernels.flash_bwd(t["batch"], c["n_heads"], c["n_kv_heads"],
                              t["seq"], c["head_dim"])["bound_s"]
    return 100.0 * n * bound / seconds

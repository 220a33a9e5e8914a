"""``scan_bwd.roofline_pct``: the scan's backward launches in the traced
steps, each at its least time (``counts.kernels.scan_bwd``: the forward's
inputs and dy read, their gradients written, float32), over the device
time of both kernels a launch runs, the sum of the partials included."""
from portbench import trace
from portbench.counts import kernels


def read(rec):
    n, seconds = trace.device_seconds(rec, "scan_bwd")
    if n == 0:
        return None
    c, t = rec.config, rec.traffic
    bound = kernels.scan_bwd(t["batch"], t["seq"],
                             c["ssm_expand"] * c["d_model"],
                             c["ssm_state"])["bound_s"]
    return 100.0 * n * bound / seconds

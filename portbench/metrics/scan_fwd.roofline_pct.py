"""``scan_fwd.roofline_pct``: the selective scan's forward launches in the
traced steps, each at its least time (``counts.kernels.scan_fwd``: float32
x, dt, B, C, A read and y and the final state written once; the states it
keeps for the backward not counted), over their device time.  Every launch
of a cell scans (batch, seq, ssm_expand · d_model) with ssm_state
states."""
from portbench import trace
from portbench.counts import kernels


def read(rec):
    n, seconds = trace.device_seconds(rec, "scan_fwd")
    if n == 0:
        return None
    c, t = rec.config, rec.traffic
    bound = kernels.scan_fwd(t["batch"], t["seq"],
                             c["ssm_expand"] * c["d_model"],
                             c["ssm_state"])["bound_s"]
    return 100.0 * n * bound / seconds

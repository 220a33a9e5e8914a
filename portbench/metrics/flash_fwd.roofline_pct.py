"""``flash_fwd.roofline_pct``: the flash forward's launches in the traced
steps, each at its least time on the card (``counts.kernels.flash_fwd``:
4 · D FLOPs a visible pair a head, or q, k, v, out and lse moved once),
over their summed device time.  Every launch of a cell has the cell's
shape: q (batch, n_heads, seq, head_dim) over n_kv_heads, causal, bf16."""
from portbench import trace
from portbench.counts import kernels


def read(rec):
    n, seconds = trace.device_seconds(rec, "flash_fwd")
    if n == 0:
        return None
    c, t = rec.config, rec.traffic
    bound = kernels.flash_fwd(t["batch"], c["n_heads"], c["n_kv_heads"],
                              t["seq"], c["head_dim"])["bound_s"]
    return 100.0 * n * bound / seconds

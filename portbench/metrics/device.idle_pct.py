"""``device.idle_pct``: the share of the traced window in which no
operation ran on the card: 1 − (union of the device's operations / the
window)."""


def read(rec):
    return 100.0 * (1.0 - rec.busy_us / rec.window_us)

"""``step.host_ms``: the benchmark's host clock from the step call to its
return, before the loss is read, mean over the untraced window's steps:
the host's time to enqueue a step, which the device waits for where it
exceeds the device's work."""


def read(rec):
    return rec.window["host_ms"]

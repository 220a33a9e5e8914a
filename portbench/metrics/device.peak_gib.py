"""``device.peak_gib``: ``torch.cuda.max_memory_allocated()`` over the
window, after a reset at its start, in GiB."""


def read(rec):
    return rec.peak_bytes / 2 ** 30

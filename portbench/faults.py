"""Faults planted underneath a training cell's timed path, to show that the
comparison refuses them (``test_portbench_correct.py`` on the CPU,
``readings.py`` on the card).  Each is a context manager that patches the
program for its duration; build the train step inside it."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def state_unchanged():
    """Each step returns the parameters and the optimizer's state as it
    got them: AdamW's update does nothing."""
    from repro_torch.optim import optimizers
    inner = optimizers.AdamW.update
    optimizers.AdamW.update = lambda self, grads, state, params: state
    try:
        yield
    finally:
        optimizers.AdamW.update = inner


@contextlib.contextmanager
def half_batch():
    """The loss leaves out half of the batch's rows (the positions of all
    its sequences, flattened) and takes the mean over the rest."""
    from repro_torch.models import transformer
    inner = transformer.softmax_xent

    def half(logits, labels):
        rows = labels.numel() // 2
        return inner(logits.reshape(1, -1, logits.shape[-1])[:, :rows],
                     labels.reshape(1, -1)[:, :rows])

    transformer.softmax_xent = half
    try:
        yield
    finally:
        transformer.softmax_xent = inner


@contextlib.contextmanager
def kernel_grad_doubled():
    """A kernel's backward returns one input's gradient twice over: the
    scan's dA (as a sum kernel that adds a chunk's part twice would), the
    flash attention's dK.  Only the leaves behind that input move wrong."""
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.kernels.ssm_scan import SSMScan
    patched = [(SSMScan, 4), (FlashAttention, 1)]
    inner = [fn.backward for fn, _ in patched]

    def doubled(backward, i):
        def wrong(ctx, *grads):
            out = list(backward(ctx, *grads))
            out[i] = out[i] * 2
            return tuple(out)
        return staticmethod(wrong)

    for (fn, i), backward in zip(patched, inner):
        fn.backward = doubled(backward, i)
    try:
        yield
    finally:
        for (fn, _), backward in zip(patched, inner):
            fn.backward = staticmethod(backward)


@contextlib.contextmanager
def token_altered():
    """The step gets its batch with one token, in the middle of the first
    row, altered where the step takes it in."""
    from repro_torch.launch import steps
    inner = steps.make_train_step

    def make(cfg, opt, ctx=None, **kw):
        step = inner(cfg, opt, ctx, **kw)

        def altered(params, state, batch):
            t = batch["tokens"].clone()
            mid = t.shape[1] // 2
            t[0, mid] = t[0, mid] % (cfg.vocab_size - 2) + 1
            return step(params, state, {**batch, "tokens": t, "labels": t})
        return altered

    steps.make_train_step = make
    try:
        yield
    finally:
        steps.make_train_step = inner


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "kernel_grad_doubled": kernel_grad_doubled,
          "token_altered": token_altered}

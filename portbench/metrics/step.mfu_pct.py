"""``step.mfu_pct``: the whole training step's share of the card's bf16
peak, over the untraced window: the step's model FLOPs
(``counts.flops.step_flops``: 6 · N · D without the input embedding, plus
attention's products) times the window's steps, over the window's seconds
and 989 TFLOP/s."""
from portbench.counts import flops, peaks


def read(rec):
    w = rec.window
    per_step = flops.step_flops(rec.config, rec.traffic["batch"],
                                rec.traffic["seq"])
    return 100.0 * per_step * w["steps"] / w["seconds"] / peaks.BF16_FLOPS

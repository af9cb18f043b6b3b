"""The train step's model FLOPs (``roofline/counts.py`` ``model_flops``)
over its mean time in the traced window (rollout plus update, between
CUDA events), as a share of the card's dense bf16 peak, in %.  The
hidden layers run in bf16 and the heads, about 2% of the FLOPs, in
float32; the share is stated against the bf16 peak."""

from benchmark.roofline.peaks import BF16_DENSE_FLOPS


def read(run):
    r, u = run.counts.get("rollout_ms"), run.counts.get("update_ms")
    if not r:
        return None
    step_s = (sum(r) + sum(u)) / len(r) / 1e3
    return 100.0 * run.counts["model_flops"] / step_s / BF16_DENSE_FLOPS

"""The training step's share (%) of the card's bf16 peak: model FLOPs a
token (``counts.model``) times the window's tokens a second, over 989
TFLOP/s (host clock over the whole window)."""

from port_bench.counts import peaks


def read(m):
    if m.kind != "train" or not m.window.get("steps"):
        return None
    return 100.0 * m.window["tokens_per_s"] * m.window["flops_per_token"] / peaks.BF16_FLOPS

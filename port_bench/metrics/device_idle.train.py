"""The card's idle share (%) over the traced training steps: the time no
operation ran on it, from the trace, over the traced region's length."""


def read(m):
    if m.kind != "train" or m.trace is None or m.trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s() / m.trace.window_s())

"""The flash forward kernel's share (%) of its roofline over the traced
training steps: the launches' least times (``counts.flash``) over their
device time by name in the trace."""

from port_bench import trace


def read(m):
    return trace.roofline(m, ["flash_fwd"]) if m.kind == "train" else None

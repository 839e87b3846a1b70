"""The flash backward kernels' share (%) of their roofline over the traced
training steps: dK/dV's and dQ's least times summed, over their summed
device time by name in the trace."""

from port_bench import trace


def read(m):
    return trace.roofline(m, ["flash_bwd_dkdv", "flash_bwd_dq"]) if m.kind == "train" else None

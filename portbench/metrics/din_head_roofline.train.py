"""din_head_roofline.train: the least time of the DIN head's work in the
profiled units (forward and backward, ``costs/din.py``) over the summed device
time of the ``din_*`` kernels there, in percent."""

from portbench import readers


def read(rec):
    return readers.roofline(rec, "din_head", r"\bdin_\w*kernel")

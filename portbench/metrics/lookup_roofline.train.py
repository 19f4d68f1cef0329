"""lookup_roofline.train: the least time of the lookups' work in the profiled
units (every ``gather_rows`` and ``onehot_grad``, ``costs/lookup.py``) over
the summed device time of ``gather_rows_kernel`` and ``onehot_grad_kernel``
there, in percent."""

from portbench import readers


def read(rec):
    return readers.roofline(rec, "lookup", r"gather_rows_kernel|onehot_grad_kernel")

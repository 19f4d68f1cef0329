"""refresh_mfu: the forward products of scoring the whole catalog (for a
history model, its real history positions only) over the median span of
``refresh()``, as a share of the 495 TFLOP/s product peak, in percent."""

from portbench import readers


def read(rec):
    return readers.span_mfu(rec, "refresh")

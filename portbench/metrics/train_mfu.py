"""train_mfu: the products of one ``Trainer.fit`` (every epoch's forward and
backward, and its evaluation forwards; counted from shapes in ``costs/``,
each product once) over the median unprofiled unit's seconds, as a share of
the 495 TFLOP/s product peak, in percent."""

from portbench import readers


def read(rec):
    return readers.unit_mfu(rec, "rows")

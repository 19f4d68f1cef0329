"""train_rows_per_s: training rows times epochs of every unit of the window,
over the time from the window's start to its last unit's end."""

from portbench import readers


def read(rec):
    return readers.rate(rec, "rows")

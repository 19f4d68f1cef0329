"""idle_share.sparse_train: the share of a row-sparse training unit in which
no device operation ran: one minus the union of the device operations'
intervals a profiled unit over the median unprofiled unit's time, in
percent."""

from portbench import readers


def read(rec):
    return readers.idle_share(rec, "sparse_train")

"""lists_per_s: top-k lists of every refresh of the window (one a user), over
the time from the window's start to its last unit's end."""

from portbench import readers


def read(rec):
    return readers.rate(rec, "lists")

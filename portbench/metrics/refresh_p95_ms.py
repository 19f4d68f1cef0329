"""refresh_p95_ms: the 95th percentile, nearest rank, of every refresh unit of
the window (refresh and top-k for every user), in milliseconds."""

from portbench import readers


def read(rec):
    p = readers.percentile(readers.unit_seconds(rec, "lists"), 95)
    return None if p is None else 1e3 * p

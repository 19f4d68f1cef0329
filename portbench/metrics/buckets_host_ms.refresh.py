"""buckets_host_ms.refresh: the host milliseconds of every ``serve.buckets``
span of a refresh (the full-history scorer building each length bucket's
padded histories and lengths and copying them to the device), summed, the
median over the refreshes recorded with the program's recorder on."""

from portbench import recorded


def read(rec):
    return recorded.unit_host_ms(rec, "serve.buckets")

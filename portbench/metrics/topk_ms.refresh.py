"""topk_ms.refresh: the median span of ``Recommender.top_k(k)`` for every user,
the lists copied to the host, in milliseconds."""

from portbench import readers


def read(rec):
    return readers.span_ms(rec, "top_k")

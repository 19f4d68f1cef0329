"""score_ms.refresh: the median span of ``Recommender.refresh()`` (the catalog
scored and the seen items masked, to a synchronise), in milliseconds."""

from portbench import readers


def read(rec):
    return readers.span_ms(rec, "refresh")

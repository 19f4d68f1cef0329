"""row_update_ms.train: the device milliseconds a step of the row-sparse
update of every table (the program's span ``train.sparse_update``: the dedup
and row-wise AdaGrad), the median over a traced run's unprofiled units,
whose recorder is on."""

from portbench import readers


def read(rec):
    return readers.span_ms(rec, "train.sparse_update")

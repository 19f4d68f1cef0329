"""cross_ms.train: the device milliseconds a step of DLRM's three low-rank
cross layers (the program's span ``dlrm.cross``, the forward), the median
over a traced run's unprofiled units, whose recorder is on."""

from portbench import readers


def read(rec):
    return readers.span_ms(rec, "dlrm.cross")

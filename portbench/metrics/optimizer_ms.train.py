"""optimizer_ms.train: the median device milliseconds of the program's span
``train.optimizer`` (the Adam step), over every epoch of the units recorded
with the program's recorder on."""

from portbench import recorded


def read(rec):
    return recorded.span_device_ms(rec, "train.optimizer")

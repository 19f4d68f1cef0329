"""bags_ms.train: the device milliseconds a step of DLRM's 26 bags: the
row-sparse step's lookup (the program's span ``train.lookup``) and the bags'
sums and concatenation (``dlrm.bags``), each unit's summed over its steps,
the median over a traced run's unprofiled units, whose recorder is on."""

from portbench import readers


def read(rec):
    units = [u["spans"] for u in rec["units"] if not u["traced"]]
    ms = [1e3 * (s["train.lookup"] + s["dlrm.bags"]) for s in units
          if "train.lookup" in s and "dlrm.bags" in s]
    return readers.median(ms)

"""rows_unique.train: the distinct table rows the row-sparse steps update
(the program's counter ``train.rows_touched``) over the ids they look up
(``train.ids``), in a traced run's unprofiled units, whose recorder is on,
in percent."""


def read(rec):
    units = [u["work"] for u in rec["units"] if "rows_touched" in u["work"]]
    ids = sum(w["ids"] for w in units)
    return 100.0 * sum(w["rows_touched"] for w in units) / ids if ids else None

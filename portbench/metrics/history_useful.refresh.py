"""history_useful.refresh: the full-history scorer's real (user, item,
position) work over what it scores with the bucket and item padding, the
program's counters ``serve.positions_real`` over ``serve.positions_scored``
in the refreshes recorded with its recorder on, in percent."""

from portbench import recorded


def read(rec):
    return recorded.counter_share(rec, "serve.positions_real", "serve.positions_scored")

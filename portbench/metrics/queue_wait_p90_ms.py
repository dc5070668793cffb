"""Scheduler: the wait of the window's due requests from their due time
to their admission (``RequestResult.t_admit``), before the profiler
started, 90th percentile, in ms."""

import math

from portbench import counts


def read(rec):
    return counts.percentile([(r.admit - r.due) * 1e3
                              for r in rec.due_in_quiet()
                              if not math.isnan(r.admit)], 90)

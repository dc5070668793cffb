"""Client: how late the generator released the window's due requests
(release minus due time), before the profiler started, 90th
percentile, in ms."""

import math

from portbench import counts


def read(rec):
    return counts.percentile([(r.release - r.due) * 1e3
                              for r in rec.due_in_quiet()
                              if not math.isnan(r.release)], 90)

"""Scheduler: the share of the pool's slots live in the window's decode
ticks before the profiler started, in %."""


def read(rec):
    ticks = [a for t, a, _ in rec.ticks if rec.in_quiet(t)]
    if not ticks:
        return None
    return 100.0 * sum(ticks) / (len(ticks) * rec.num_slots)

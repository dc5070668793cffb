"""Model step: the mean CUDA-event time of the window's decode ticks, in
ms (traced runs only, before the profiler started)."""


def read(rec):
    return sum(rec.tick_ms) / len(rec.tick_ms) if rec.tick_ms else None

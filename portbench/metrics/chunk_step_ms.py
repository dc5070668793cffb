"""Prefill: the mean CUDA-event time of the window's chunk steps, in ms
(traced runs only, before the profiler started)."""


def read(rec):
    return sum(rec.chunk_ms) / len(rec.chunk_ms) if rec.chunk_ms else None

"""Whole step: model FLOPs of the prompt tokens prefilled and the tokens
decoded in the window before the profiler started
(``counts.prefill_flops`` and ``decode_flops``, from the
configuration's shapes), over that time and the bf16 peak, in %."""

from portbench import counts


def read(rec):
    if rec.quiet_s <= 0:
        return None
    m = rec.model
    flops = sum(counts.prefill_flops(m, off, n)
                for t, _, off, n, _ in rec.chunks if rec.in_quiet(t))
    flops += sum(counts.decode_flops(m, live, resident)
                 for t, live, resident in rec.ticks if rec.in_quiet(t))
    return 100.0 * flops / rec.quiet_s / counts.PEAK_BF16_FLOPS

"""Kernels: the paged-decode attention kernel's (K1's) share of its
roofline over the profiled steps, in %: the least time its calls could
take (each live slot's resident keys and values read once, at the
memory rate; ``counts.k1_bound_s``), over the device time the profiler
gives its two kernels.  Nothing when the profiler saw no K1 kernel."""

from portbench import counts

KERNELS = ("paged_scores_kernel", "paged_pv_kernel")


def read(rec):
    p = rec.profile
    if not p:
        return None
    busy = sum(s for name, s in p["kernel_s"].items()
               if any(k in name for k in KERNELS))
    if busy <= 0:
        return None
    layers = rec.model["layers"]
    bound = sum(layers * counts.k1_bound_s(rec.model, live, resident)
                for _, live, resident in p["ticks"])
    return 100.0 * bound / busy

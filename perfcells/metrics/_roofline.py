"""Shared by the roofline readers: the bound time of a launcher's
launches in the profiled stretch (operations and bytes from each launch's
shapes) over its kernels' device time in the trace."""


def share(t, cls):
    bound, launches = t["launches"].get(cls, (0.0, 0))
    seconds, kernels = t["stretch"].get("kernels", {}).get(cls, (0.0, 0))
    if not launches or not seconds or launches != kernels:
        return None
    return 100.0 * bound / seconds

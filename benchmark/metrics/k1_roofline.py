"""K1 (csrc/solve_middle.cu, solve_middle_kernel): the least time the card
could take for the profiled stretch's calls (each call's bytes over the
HBM rate or its operations over the float32 peak, the larger; see
roofline.py) over the profiler's device time of the kernel, in percent."""

from benchmark import roofline

KERNEL = "solve_middle_kernel"


def read(record):
    p = record.get("profile")
    calls = (p or {}).get("calls", {}).get("middle")
    device_s = sum(s for name, s in (p or {}).get("kernels", {}).items() if KERNEL in name)
    if not calls or device_s <= 0:
        return None
    bound = sum(roofline.bound_seconds(roofline.k1_bytes(a), roofline.k1_ops(a))
                for a in calls)
    return 100.0 * bound / device_s

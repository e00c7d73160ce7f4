"""K2 (csrc/toi.cu, toi_kernel): the bytes the profiled stretch's calls
must move over the HBM rate (K2 is counted by bytes alone; see
roofline.py) over the profiler's device time of the kernel, in percent."""

from benchmark import roofline

KERNEL = "toi_kernel"


def read(record):
    p = record.get("profile")
    calls = (p or {}).get("calls", {}).get("toi")
    device_s = sum(s for name, s in (p or {}).get("kernels", {}).items() if KERNEL in name)
    if not calls or device_s <= 0:
        return None
    bound = sum(roofline.k2_bytes(a) / roofline.HBM_BYTES_PER_S for a in calls)
    return 100.0 * bound / device_s

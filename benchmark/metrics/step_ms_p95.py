"""The 95th percentile of the window's step times (host clock, from the
end of the last step to after this one's synchronization; a reset counts
in the step it precedes), in ms, over every step of the window."""

import statistics


def read(record):
    s = record["window"]["step_s"]
    if len(s) < 2:
        return None
    return 1e3 * statistics.quantiles(s, n=20, method="inclusive")[-1]

"""train_step_ms_p90: the 90th percentile of the window's synchronised
step times, ms (its sample count goes to standard error)."""

import statistics
import sys


def read(obs):
    steps = obs.get("step_s") if obs.get("kind") == "train" else None
    if not steps or len(steps) < 2:
        return None
    print(f"train_step_ms_p90 over {len(steps)} steps", file=sys.stderr)
    return 1e3 * statistics.quantiles(steps, n=10)[8]

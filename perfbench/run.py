"""Run one cell of the benchmark once (see perfbench/README.md):

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>
"""

import os
import sys
import time


def _started() -> float:
    """The process's start on the ``perf_counter`` clock (set-up is timed
    from it)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    STARTED = _started()
    # The checkout's root in place of this script's directory: the
    # benchmark imports as the package ``perfbench``.
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from perfbench.lib import cli

    sys.exit(cli.main(sys.argv[1:], started=STARTED))

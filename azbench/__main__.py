"""Run one cell once:

    python3 -m azbench --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>
"""

import time

T_START = time.perf_counter()  # set-up counts from here, imports included

import sys  # noqa: E402

from azbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))

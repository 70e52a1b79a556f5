"""python3 -m perfbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>: one run of one cell of BENCHMARK.json (perfbench/harness.py).
"""

import time

T0 = time.perf_counter()

if __name__ == '__main__':
    import sys

    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], T0))

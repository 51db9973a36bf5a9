"""Run one benchmark cell once and print its result as the last line:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m bench_port.run ...`` from the checkout's root).
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())

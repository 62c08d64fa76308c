"""`perfbench.readings` with the online cell's faults as well
(`perfbench/faults_online.py`): the same arguments and JSON lines.

    python3 -m perfbench.readings_online --workload online_pop.adapt_b1 \
        --seeds 1 2 3 ... --control-seeds 1 2 3 --seconds 2 [--fault <name>]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import faults, faults_online, readings  # noqa: E402


def main(argv=None) -> int:
    faults.FAULTS.update(faults_online.FAULTS)
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())

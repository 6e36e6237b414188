"""The benchmark's control: a run whose outputs are replaced, once the window
has closed, by the reference's with its permutation one partial round short
(58 of 59), and judged as the program's are. Every cell's check has to come
out not correct on it. The benchmark's own runs never run it.

    python3 hbench/control.py --workload <cell> --seed <n> --seconds <s>

prints the checks and the result's line as `hbench/run.py` does, and exits
with 0 where `correct` came out false, 1 where it came out true.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hbench import run  # noqa: E402


def main(argv=None) -> int:
    code, result = run.run(run.parse(argv), control=True)
    if result is None:
        return code or 2
    for name, c in result["checks"].items():
        print(f"hbench control check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 1 if result["correct"] else 0


if __name__ == "__main__":
    sys.exit(main())

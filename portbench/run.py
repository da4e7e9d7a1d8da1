"""Run one benchmark cell on the CUDA card of this machine:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result as JSON; the numbers the
judge compared, each with its limit, are the last lines of standard
error.  Exits 2 without enough CUDA devices, 3 when JAX or the JAX
package was loaded.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())

"""granite-moe-1b-a400m's warm training steps, timed and profiled on one
H100, with the router's backward's share: ``tools/profile_ssm_step.py
granite-moe-1b-a400m --nodes MoeRouteBackward``.

Usage, from the root of this checkout, on a machine with the card:

    python3 tools/profile_moe_step.py [--src SRC] [--steps K]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import profile_ssm_step  # noqa: E402

if __name__ == "__main__":
    sys.exit(profile_ssm_step.main(["granite-moe-1b-a400m", "--nodes",
                                    "MoeRouteBackward", *sys.argv[1:]]))

"""The benchmark's CPU tests: the checkout's root and ``src`` on the path."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# the smoke cells run on the CPU beside other test workers: one thread each
torch.set_num_threads(1)

"""A stand-in rank for the launcher test in
tests/test_torch_serve_cli_mesh.py: rank 1 fails at once with exit code
3, every other rank would wait forever, as a rank blocked on a collective
with a dead peer does."""

import os
import sys
import time

if __name__ == "__main__":
    if os.environ["RANK"] == "1":
        sys.exit(3)
    while True:
        time.sleep(1)

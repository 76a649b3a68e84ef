#!/usr/bin/env python3
"""Run a command and keep its whole standard output in a log file, each
line prefixed with the seconds since the start.

    python3 tools/timestamped_run.py LOG [COMMAND ...]

The command defaults to ``python3 chip_smoke.py``; its standard error
passes through. The log gives each phase's start time and keeps what a
caller that reads only the end of the output would lose
(``chip_smoke.py``'s kernels line alone is tens of kilobytes). Exits
with the command's exit code.
"""
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    path, cmd = Path(argv[0]), argv[1:] or [sys.executable, "chip_smoke.py"]
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
        for line in proc.stdout:
            log.write(f"{time.perf_counter() - t0:8.1f} {line}")
            log.flush()
        rc = proc.wait()
        log.write(f"{time.perf_counter() - t0:8.1f} EXIT {rc}\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())

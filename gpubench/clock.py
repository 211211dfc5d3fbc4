"""The process's age, for ``setup_s``; imports nothing heavy, so that
``__main__`` can read it before ``torch`` is imported."""

import os
import time


def process_age() -> float:
    """Seconds since this process started (the kernel's start time), so
    that ``setup_s`` counts the interpreter's start and the imports."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return 0.0

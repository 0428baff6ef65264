"""Host-RAM failsafe for long training runs: the port's own copy of
real_esrgan_tpu/utils/hostmem.py.

A process whose resident memory grows without bound ends wedged inside an
allocation (alive, silent, no progress), which no restart loop can resume
until something kills it.  A crash is recoverable: ``--resume auto`` picks
up the newest checkpoint in a fresh process.  So the trainers turn the
wedge into a crash: right after each checkpoint they call
:func:`check_host_memory`, and past the watermark the run exits
``RESTART_EXIT_CODE`` (4), with nothing lost.
"""

from __future__ import annotations

RESTART_EXIT_CODE = 4


def host_memory_fraction() -> float:
    """This process's RSS as a fraction of the machine's total RAM.

    0.0 where /proc cannot be read: the failsafe then stays off rather than
    misfiring."""
    try:
        rss_kb = total_kb = 0
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    rss_kb = int(line.split()[1])
                    break
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    total_kb = int(line.split()[1])
                    break
        return rss_kb / total_kb if total_kb else 0.0
    except OSError:
        return 0.0


def check_host_memory(watermark: float = 0.8) -> None:
    """Exit ``RESTART_EXIT_CODE`` when host RSS is at or above ``watermark``.

    Call it only where all state is durable (right after a checkpoint): the
    exit is abrupt by design."""
    frac = host_memory_fraction()
    if frac >= watermark:
        print(f"HOST-MEMORY FAILSAFE: RSS at {100 * frac:.0f}% of system RAM "
              f"(watermark {100 * watermark:.0f}%). State is checkpointed; "
              f"exiting rc={RESTART_EXIT_CODE} for a fresh-process resume "
              "before the leak wedges the machine.", flush=True)
        raise SystemExit(RESTART_EXIT_CODE)

"""Prefix each line of standard input with the seconds since this script
started, to see where a long run's time goes:

    python3 chip_smoke.py | python3 tools/timed_lines.py > smoke.log

The gap before a line is the time its phase spent before printing it.
"""
import sys
import time


def main() -> None:
    t0 = time.time()
    for line in sys.stdin:
        sys.stdout.write(f"{time.time() - t0:8.1f} {line}")
        sys.stdout.flush()


if __name__ == "__main__":
    main()

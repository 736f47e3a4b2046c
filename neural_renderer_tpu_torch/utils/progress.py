"""Text progress bar with ETA. Copy of
`neural_renderer_tpu/utils/progress.py`."""

from __future__ import annotations

import sys
import time


def format_duration(seconds: float) -> str:
    if seconds < 0:
        return "--:--"
    sec = int(seconds + 0.5)
    mins, sec = divmod(sec, 60)
    hrs, mins = divmod(mins, 60)
    if hrs > 0:
        return f"{hrs}:{mins:02d}:{sec:02d}"
    return f"{mins:02d}:{sec:02d}"


class ProgressBar:
    def __init__(self, width: int = 40):
        self.width = width
        self.label = ""
        self.total = 1
        self.start = time.monotonic()
        self.last_printed = -1

    def begin(self, label: str, total_iters: int):
        self.label = label
        self.total = max(1, total_iters)
        self.start = time.monotonic()
        self.last_printed = -1
        self.update(0)

    def update(self, current: int):
        current = min(max(current, 0), self.total)
        if current == self.last_printed:
            return
        self.last_printed = current
        progress = current / self.total
        filled = int(progress * self.width)
        elapsed = time.monotonic() - self.start
        eta = (elapsed / current) * (self.total - current) if current > 0 else -1.0
        bar = "=" * filled + " " * (self.width - filled)
        sys.stdout.write(
            f"\r{self.label} [{bar}] {current}/{self.total} "
            f"ETA {format_duration(eta)} Elapsed {format_duration(elapsed)}")
        sys.stdout.flush()
        if current == self.total:
            sys.stdout.write("\n")

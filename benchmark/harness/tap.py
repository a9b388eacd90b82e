"""The host clock at the training loop's read-back points.

The loop reads its metrics back from the card at each logged step, after
the call of steps that holds it, and then prints the record
(``step <n>  loss=...``). ``RecordTap`` stands in for ``sys.stdout``
while the loop runs and takes ``time.perf_counter()`` when each record's
line arrives: every step dispatched before it has finished on the card.
The lines are kept, not printed.
"""

from __future__ import annotations

import io
import re
import sys
import time

_RECORD = re.compile(r"^step (\d+)\s")


class RecordTap(io.TextIOBase):
    def __init__(self):
        super().__init__()
        self.records: list[tuple[float, int]] = []   # (host s, step)
        self.lines: list[str] = []
        self._buf = ""
        self._saved = None

    def write(self, text: str) -> int:
        now = time.perf_counter()
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append(line)
            m = _RECORD.match(line)
            if m:
                self.records.append((now, int(m.group(1))))
        return len(text)

    def __enter__(self):
        self._saved, sys.stdout = sys.stdout, self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._saved
        return False


def host_steal() -> tuple[int, int] | None:
    """(steal, total) jiffies of the machine's CPUs so far (``/proc/stat``):
    the time the hypervisor gave the CPUs to others. None where there is
    no such file."""
    try:
        with open("/proc/stat") as f:
            fields = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    return (fields[7] if len(fields) > 7 else 0), sum(fields)

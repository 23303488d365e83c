"""Terminal progress bar (counterpart of maskrcnn_tpu/utils/progress.py;
reference: model.py:28-53 `progress`).

Same call surface as the reference's bar; drawn with carriage returns
so long epochs stay one line (the reference emitted one line per step).
"""

from __future__ import annotations

import sys


def progress(loc: int, total: int, prefix: str = "", suffix: str = "",
             decimals: int = 1, length: int = 40, fill: str = "█",
             stream=None):
    """Render `loc`/`total` as a bar; completes with a newline."""
    stream = stream or sys.stdout
    total = max(total, 1)
    percent = ("{0:." + str(decimals) + "f}").format(
        100 * (loc / float(total)))
    filled = int(length * loc // total)
    bar = fill * filled + "-" * (length - filled)
    end = "\n" if loc >= total else "\r"
    stream.write(f"{prefix} |{bar}| {percent}% {suffix}{end}")
    stream.flush()

"""Wall-clock + device timing.

The reference self-times with `clock()` printfs (`reconstruction/main.cpp:7,18,22`,
`CStereoMatching.cpp:40,112`).  Here: a context-manager timer of named wall-clock spans, feeding the
structured per-stage stats the reference lacked (SURVEY.md section 5).
Spans around device work end in `jax.block_until_ready` (or a fetch) so
they are honest under async dispatch.
"""

from __future__ import annotations

import time
from typing import Dict


class Timer:
    """Collects named wall-clock spans; nestable."""

    def __init__(self) -> None:
        self.spans: Dict[str, float] = {}

    class _Span:
        def __init__(self, timer: "Timer", name: str):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.timer.spans[self.name] = self.timer.spans.get(self.name, 0.0) + dt
            return False

    def span(self, name: str) -> "Timer._Span":
        return Timer._Span(self, name)

    def report(self) -> str:
        total = sum(self.spans.values())
        lines = [f"{k:<32s} {v:8.3f}s" for k, v in self.spans.items()]
        lines.append(f"{'total':<32s} {total:8.3f}s")
        return "\n".join(lines)

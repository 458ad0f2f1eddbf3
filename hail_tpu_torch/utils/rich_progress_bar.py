"""Progress-bar shims with the reference `hailtop.utils.rich_progress_bar`
surface. This build is headless: the objects track totals/completed so
callers can introspect, but render nothing."""

from __future__ import annotations

from typing import Optional


class BatchProgressBarTask:
    def __init__(self, total: Optional[int] = None, cost=None):
        self.total = total
        self.completed = 0
        self.cost = cost

    def update(self, advance=None, *, total=None, completed=None, cost=None):
        if total is not None:
            self.total = total
        if completed is not None:
            self.completed = completed
        elif advance:
            self.completed += advance
        if cost is not None:
            self.cost = cost

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class BatchProgressBar:
    def __init__(self, *, disable: bool = False):
        self.disable = disable
        self._tasks = []

    def with_task(self, description: str, *, total: Optional[int] = None,
                  disable: bool = False, cost=None) -> BatchProgressBarTask:
        t = BatchProgressBarTask(total=total, cost=cost)
        self._tasks.append(t)
        return t

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class SimpleRichProgressBar(BatchProgressBar):
    pass


class SimpleCopyToolProgressBar(BatchProgressBar):
    pass

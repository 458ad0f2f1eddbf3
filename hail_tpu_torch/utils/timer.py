"""ExecutionTimer: nested timing tree (reference
`hail/hail/utils/src/is/hail/utils/ExecutionTimer.scala:12` — the timings the
driver returns in the X-Hail-Timings header)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class TimerNode:
    def __init__(self, name: str):
        self.name = name
        self.total_s = 0.0
        self.children: List['TimerNode'] = []
        self.meta: Dict = {}

    def to_dict(self) -> dict:
        out = {'name': self.name, 'total_s': round(self.total_s, 6),
               'children': [c.to_dict() for c in self.children]}
        if self.meta:
            out.update(self.meta)
        return out

    def render(self, indent: int = 0) -> str:
        extra = ''
        if self.meta:
            extra = '  [' + ', '.join(f'{k}={v}' for k, v in
                                      self.meta.items()) + ']'
        lines = [f'{"  " * indent}{self.name}: '
                 f'{self.total_s * 1000:.1f}ms{extra}']
        for c in self.children:
            lines.append(c.render(indent + 1))
        return '\n'.join(lines)


class ExecutionTimer:
    def __init__(self, root_name: str = 'execution'):
        self.root = TimerNode(root_name)
        self._stack = [self.root]

    @contextmanager
    def time(self, name: str):
        node = TimerNode(name)
        self._stack[-1].children.append(node)
        self._stack.append(node)
        t0 = time.time()
        try:
            yield node
        finally:
            node.total_s += time.time() - t0
            self._stack.pop()

    def finish(self) -> TimerNode:
        total = sum(c.total_s for c in self.root.children)
        self.root.total_s = total
        return self.root

    def render(self) -> str:
        self.finish()
        return self.root.render()


_current: Optional[ExecutionTimer] = None
_last_action: Optional[TimerNode] = None


def current_timer() -> Optional[ExecutionTimer]:
    return _current


def last_timings() -> Optional[dict]:
    """The timing tree of the most recent action's stages (the analogue of
    the reference's per-request X-Hail-Timings header,
    `utils/ExecutionTimer.scala:12` via `py4j_backend.py:309`)."""
    return _last_action.to_dict() if _last_action is not None else None


def record_stage(name: str, wall_s: float, n_partitions: int,
                 partition_s: List[float]) -> None:
    """Attach a stage's timing to the active timer (or the last-action
    buffer): wall time plus per-partition aggregate stats."""
    global _last_action
    node = TimerNode(name)
    node.total_s = wall_s
    node.meta['n_partitions'] = n_partitions
    if partition_s:
        node.meta['partition_ms'] = {
            'min': round(min(partition_s) * 1000, 3),
            'mean': round(sum(partition_s) / len(partition_s) * 1000, 3),
            'max': round(max(partition_s) * 1000, 3),
        }
    if _current is not None:
        _current._stack[-1].children.append(node)
    else:
        _last_action = node


@contextmanager
def timed(name: str = 'execution', log: bool = True):
    """Context manager: `with hl.utils.timed('query'): ...` prints the nested
    timing tree (the `hl.init(_timed)` surface of the reference)."""
    global _current
    prev = _current
    timer = ExecutionTimer(name)
    _current = timer
    try:
        yield timer
    finally:
        _current = prev
        if log:
            print(timer.render())

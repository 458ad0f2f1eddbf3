"""Wall-clock helpers (reference hailtop/utils/time.py)."""

from __future__ import annotations

import datetime
import time as _time
from typing import Optional, Union

_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
_MS = datetime.timedelta(milliseconds=1)


def time_msecs() -> int:
    return int(_time.time_ns() // 1_000_000)


def time_ns() -> int:
    return _time.monotonic_ns()


def time_msecs_str(t: Union[int, float]) -> str:
    dt = datetime.datetime.fromtimestamp(t / 1000, tz=datetime.timezone.utc)
    return dt.replace(tzinfo=None).isoformat(timespec='milliseconds') + 'Z'


def parse_timestamp_msecs(ts: Optional[str]) -> Optional[int]:
    if ts is None:
        return None
    from hailtop.timex import parse_rfc3339
    dt = parse_rfc3339(ts)
    return int((dt - _EPOCH) / _MS)


def humanize_timedelta_msecs(delta_msecs: Optional[Union[int, float]]) -> Optional[str]:
    if delta_msecs is None:
        return None
    from hailtop.humanizex import naturaldelta_msec
    return naturaldelta_msec(delta_msecs)

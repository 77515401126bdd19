"""Timestamp algebra (mirrors reference src/common/time, ~5k LoC).

Internal representation is int64 in a column-specific unit; all parsing
lands in nanoseconds and converts down.
"""

from __future__ import annotations

import datetime as dt
import re
from typing import Optional

from greptimedb_tpu_torch.datatypes.types import DataType, TimeUnit

_FORMATS = (
    "%Y-%m-%d %H:%M:%S.%f%z",
    "%Y-%m-%dT%H:%M:%S.%f%z",
    "%Y-%m-%d %H:%M:%S%z",
    "%Y-%m-%dT%H:%M:%S%z",
    "%Y-%m-%d %H:%M:%S.%f",
    "%Y-%m-%dT%H:%M:%S.%f",
    "%Y-%m-%d %H:%M:%S",
    "%Y-%m-%dT%H:%M:%S",
    "%Y-%m-%d %H:%M",
    "%Y-%m-%d",
)


def tzinfo_for(name: Optional[str]) -> dt.tzinfo:
    """Session timezone name → tzinfo: '+08:00'/'-05:30' fixed offsets,
    IANA names via zoneinfo, None/UTC → UTC (reference
    common/time timezone.rs parse precedence)."""
    if not name or name.upper() == "UTC":
        return dt.timezone.utc
    m = re.fullmatch(r"([+-])(\d{1,2}):?(\d{2})?", name.strip())
    if m:
        sign = 1 if m.group(1) == "+" else -1
        minutes = int(m.group(2)) * 60 + int(m.group(3) or 0)
        return dt.timezone(sign * dt.timedelta(minutes=minutes))
    try:
        from zoneinfo import ZoneInfo

        return ZoneInfo(name)
    except Exception as exc:  # noqa: BLE001 — bad tz name is a user error
        raise ValueError(f"unknown time zone {name!r}") from exc


def parse_timestamp_ns(text: str, tz: Optional[str] = None) -> int:
    """Parse an ISO-ish timestamp string to epoch nanoseconds. Naive
    strings are interpreted in `tz` (the session timezone), UTC when
    unset; an explicit offset in the string always wins."""
    t = text.strip().replace("Z", "+0000")
    for fmt in _FORMATS:
        try:
            d = dt.datetime.strptime(t, fmt)
            if d.tzinfo is None:
                d = d.replace(tzinfo=tzinfo_for(tz))
            epoch = d.timestamp()
            # avoid float precision loss: split seconds/micros
            whole = int(epoch // 1)
            micros = d.microsecond
            base = dt.datetime(d.year, d.month, d.day, d.hour, d.minute, d.second,
                               tzinfo=d.tzinfo)
            return int(base.timestamp()) * 10**9 + micros * 1000
        except ValueError:
            continue
    raise ValueError(f"cannot parse timestamp {text!r}")


def ns_to_unit(ns: int, unit: TimeUnit) -> int:
    return ns // unit.nanos_per_unit


def unit_to_ns(value: int, unit: TimeUnit) -> int:
    return value * unit.nanos_per_unit


def coerce_ts_literal(value, dtype: DataType,
                      tz: Optional[str] = None) -> int:
    """Coerce a SQL literal (string or int) to the storage unit of `dtype`.

    Integer literals are interpreted in the column's own unit (matching the
    reference's behavior for bare numeric timestamp comparisons); naive
    strings in the session timezone `tz`."""
    unit = dtype.time_unit
    if isinstance(value, str):
        return ns_to_unit(parse_timestamp_ns(value, tz), unit)
    if isinstance(value, dt.datetime):
        # Arrow timestamp columns round-trip as datetime objects
        tz = value if value.tzinfo else value.replace(tzinfo=dt.timezone.utc)
        delta = tz - dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)
        ns = (delta.days * 86_400 + delta.seconds) * 10**9 \
            + delta.microseconds * 1000
        return ns_to_unit(ns, unit)
    return int(value)


def format_ts(value: int, dtype: DataType) -> str:
    """Render an int timestamp for output (ISO, UTC)."""
    ns = unit_to_ns(int(value), dtype.time_unit)
    secs, rem = divmod(ns, 10**9)
    d = dt.datetime.fromtimestamp(secs, tz=dt.timezone.utc)
    if rem:
        frac = f".{rem // 10**6:03d}" if rem % 10**6 == 0 else f".{rem:09d}".rstrip("0")
        return d.strftime("%Y-%m-%dT%H:%M:%S") + frac
    return d.strftime("%Y-%m-%dT%H:%M:%S")

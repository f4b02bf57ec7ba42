# Copy of vrdone_tpu/utils/metric_logger.py, kept so that the port imports nothing of
# vrdone_tpu; tests/test_torch_copies.py pins it to the original.
"""Windowed training meters (reference mega_core/utils/metric_logger.py).

SmoothedValue tracks a metric over a sliding window and reports the
window median / average plus the global average — the reference's
detector-side observability surface (SmoothedValue :8-39, MetricLogger
:42-66), reproduced so detector training logs read the same way.
"""

from __future__ import annotations

from collections import deque


class SmoothedValue:
    """Track a series of values and provide access to smoothed values
    over a window or the global series average."""

    def __init__(self, window_size: int = 20):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        self.deque.append(float(value))
        self.count += 1
        self.total += float(value)

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        mid = n // 2
        return d[mid] if n % 2 else 0.5 * (d[mid - 1] + d[mid])

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = {}
        self.delimiter = delimiter

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.meters.setdefault(k, SmoothedValue()).update(v)

    def __getattr__(self, attr: str) -> SmoothedValue:
        meters = object.__getattribute__(self, "meters")
        if attr in meters:
            return meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())

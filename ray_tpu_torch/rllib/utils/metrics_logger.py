"""MetricsLogger: hierarchical stat aggregation (reference rllib/utils/metrics/metrics_logger.py:18).

Port of ray_tpu/rllib/utils/metrics_logger.py (numpy, copied as it is).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np


class MetricsLogger:
    def __init__(self):
        self._values: Dict[str, List[float]] = defaultdict(list)
        self._windows: Dict[str, int] = {}

    def log_value(self, key: str, value: Any, window: Optional[int] = None, reduce: str = "mean") -> None:
        if value is None:
            return
        self._values[key].append(float(value))
        if window:
            self._windows[key] = window
            self._values[key] = self._values[key][-window:]

    def log_dict(self, d: Dict[str, Any], prefix: str = "", **kw) -> None:
        for k, v in d.items():
            if isinstance(v, (int, float, np.floating, np.integer)):
                self.log_value(prefix + k, v, **kw)

    def peek(self, key: str, default=None):
        vals = self._values.get(key)
        return float(np.mean(vals)) if vals else default

    def reduce(self) -> Dict[str, float]:
        out = {}
        for k, vals in self._values.items():
            if vals:
                out[k] = float(np.mean(vals))
        # windowed stats persist across iterations; point stats reset
        for k in list(self._values):
            if k not in self._windows:
                self._values[k] = []
        return out

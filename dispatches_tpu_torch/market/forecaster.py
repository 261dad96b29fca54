"""Forecasters for the double-loop market interaction.

Parity with reference `dispatches/workflow/parametrized_bidder.py:19-70`
(`PerfectForecaster`): returns exact DA/RT LMPs and capacity factors from a
table keyed `{bus}-DALMP`, `{bus}-RTLMP`, `{gen}-DACF`, `{gen}-RTCF`, with
wraparound past the end of the data. Plus a `Backcaster`-style moving-history
forecaster (the reference uses IDAES's `Backcaster` in
`test_multiperiod_wind_battery_doubleloop.py:113`).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np


class PerfectForecaster:
    def __init__(self, data: Union[Dict[str, np.ndarray], "object"], hours_per_step: int = 1):
        """`data` maps column name -> hourly series (numpy arrays or a pandas
        DataFrame with a datetime index)."""
        try:
            import pandas as pd

            if isinstance(data, pd.DataFrame):
                self._df = data
                self._cols = {c: data[c].values for c in data.columns}
                self._start = data.index[0] if len(data.index) else None
            else:
                raise TypeError
        except (ImportError, TypeError):
            self._df = None
            self._cols = {k: np.asarray(v) for k, v in data.items()}
            self._start = None

    def __getitem__(self, col):
        return self._cols[col]

    def _abs_hour(self, date, hour: int) -> int:
        if isinstance(date, (int, np.integer)):
            return int(date) * 24 + hour
        import pandas as pd

        base = self._start if self._start is not None else pd.Timestamp(0)
        return int((pd.Timestamp(date) - base) / pd.Timedelta(hours=1)) + hour

    def get_column_from_data(self, date, hour, horizon, col):
        vals = self._cols[col]
        i0 = self._abs_hour(date, hour)
        idx = (i0 + np.arange(horizon)) % len(vals)  # wraparound (`:52-58`)
        return vals[idx]

    def forecast_day_ahead_prices(self, date, hour, bus, horizon, *_):
        return self.get_column_from_data(date, hour, horizon, f"{bus}-DALMP")

    def forecast_real_time_prices(self, date, hour, bus, horizon, *_):
        return self.get_column_from_data(date, hour, horizon, f"{bus}-RTLMP")

    def forecast_day_ahead_and_real_time_prices(self, date, hour, bus, horizon, *_):
        return (
            self.forecast_day_ahead_prices(date, hour, bus, horizon),
            self.forecast_real_time_prices(date, hour, bus, horizon),
        )

    def forecast_day_ahead_capacity_factor(self, date, hour, gen, horizon):
        return self.get_column_from_data(date, hour, horizon, f"{gen}-DACF")

    def forecast_real_time_capacity_factor(self, date, hour, gen, horizon):
        return self.get_column_from_data(date, hour, horizon, f"{gen}-RTCF")

    def fetch_hourly_stats_from_prescient(self, *_):
        pass

    def fetch_day_ahead_stats_from_prescient(self, *_):
        pass


class Backcaster:
    """Forecasts future prices as the average of the same hours over the last
    `n_historical_days` days of observed history (IDAES Backcaster semantics)."""

    def __init__(self, initial_prices: np.ndarray, n_historical_days: int = 10):
        self._hist = list(np.asarray(initial_prices, dtype=float))
        self.n_historical_days = n_historical_days

    def observe(self, prices):
        self._hist.extend(np.asarray(prices, dtype=float).tolist())

    def forecast(self, horizon: int, hour_of_day: Optional[int] = None) -> np.ndarray:
        return self.forecast_scenarios(horizon, hour_of_day).mean(axis=0)

    def forecast_scenarios(
        self, horizon: int, hour_of_day: Optional[int] = None
    ) -> np.ndarray:
        """(n_days, horizon) price scenarios: each of the last
        `n_historical_days` observed days is one equally-weighted scenario —
        the IDAES Backcaster semantics feeding the stochastic `Bidder`
        (`test_multiperiod_wind_battery_doubleloop.py:113+`).

        `hour_of_day` anchors the first forecast hour; default = the hour
        right after the observed history."""
        h = np.asarray(self._hist[-24 * self.n_historical_days :])
        days = len(h) // 24
        if days == 0:
            return np.zeros((1, horizon))
        table = h[-days * 24 :].reshape(days, 24)
        # column j of `table` holds hour-of-day (a + j) % 24 where a is the
        # hour-of-day of the table's first entry
        a = (len(self._hist) - days * 24) % 24
        h0 = a if hour_of_day is None else int(hour_of_day)
        idx = (h0 - a + np.arange(horizon)) % 24
        return table[:, idx]

"""Simulation sweep data handling for market-surrogate training (port of
`dispatches_tpu/surrogates/data.py`).

Parity with the reference's
`dispatches/workflow/train_market_surrogates/dynamic/Simulation_Data.py:22-432`
(`SimulationData`): loads Prescient sweep outputs, an hourly dispatch table
(runs x 8736 h) and a sweep-input table, and scales dispatch to capacity
factors per case family (RE/NE/FE). Everything becomes dense numpy arrays
up front; the trainers move them to a device.

The dispatch CSV is read in Python and numpy (`read_csv_matrix`, with the
header skipping and NaN rule of the JAX package's native reader); files
whose run labels are not numbers (``run_37``) are read row by row with the
`csv` module. The `.h5` inputs table needs pandas, imported only there.
"""
from __future__ import annotations

import csv
import re
from typing import Dict, Optional, Tuple, Union

import numpy as np

HOURS_PER_YEAR = 8736  # 52 weeks, the Prescient sweep convention

_NUMERIC_START = set("0123456789-+.nNiI,")
_FLOAT_PREFIX = re.compile(
    r"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|nan|inf(?:inity)?)", re.I
)


def _row_is_numeric(line: str) -> bool:
    """A row is numeric if its first non-blank character starts a number
    (digit, sign, dot, nan, inf) or an empty cell (a leading comma)."""
    s = line.lstrip(" \t")
    return bool(s) and s[0] in _NUMERIC_START


def _cell(c: str) -> float:
    """One cell as the native reader parses it: blanks skipped, the longest
    leading number (strtod's prefix), NaN for an empty or non-numeric cell."""
    c = c.lstrip(" \t")
    m = _FLOAT_PREFIX.match(c)
    return float(m.group()) if m else float("nan")


def read_csv_matrix(path: str, rows: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Numeric CSV -> float64 matrix, the semantics of the JAX package's
    native reader (`dispatches_tpu/runtime/native.py:109`): leading
    non-numeric rows are headers and skipped, later non-numeric rows are
    dropped, the column count is the first data row's, and empty or
    non-numeric cells are NaN. `rows` = (start, stop) selects data rows."""
    with open(path, newline="") as f:
        lines = f.read().split("\n")
    start = 0
    while start < len(lines) and not _row_is_numeric(lines[start]):
        start += 1
    data = [ln for ln in lines[start:] if ln and _row_is_numeric(ln)]
    if rows is not None:
        data = data[max(0, rows[0]) : rows[1]]
    if not data:
        return np.zeros((0, 0))
    ncols = data[0].count(",") + 1
    out = np.full((len(data), ncols), np.nan)
    for i, ln in enumerate(data):
        cells = ln.split(",")[:ncols]
        try:  # the common case: every cell a plain number
            out[i, : len(cells)] = np.array(cells, dtype=float)
        except ValueError:
            out[i, : len(cells)] = [_cell(c) for c in cells]
    return out


def _parse_label(r: str) -> int:
    digits = re.findall(r"\d+", r)
    if not digits:
        raise ValueError(f"unparseable run label {r!r}")
    return int(digits[0])


class SimulationData:
    def __init__(
        self,
        dispatch: Union[str, np.ndarray],
        inputs: Union[str, np.ndarray],
        num_sims: Optional[int] = None,
        case_type: str = "RE",
        rt_lmp: Optional[np.ndarray] = None,
        pmax: Optional[np.ndarray] = None,
    ):
        if case_type not in ("RE", "NE", "FE"):
            raise ValueError(f"case_type must be RE, NE or FE, got {case_type}")
        self.case_type = case_type

        if isinstance(dispatch, str):
            dispatch, index = self._read_dispatch_csv(dispatch, num_sims)
        else:
            dispatch = np.asarray(dispatch, dtype=float)
            index = np.arange(dispatch.shape[0])
        if isinstance(inputs, str):
            inputs = self._read_inputs_h5(inputs, index)
        else:
            inputs = np.asarray(inputs, dtype=float)

        if num_sims is not None:
            dispatch = dispatch[:num_sims]
            inputs = inputs[:num_sims]
            index = index[:num_sims]
        self.dispatch = dispatch  # (n_runs, T)
        self.inputs = inputs  # (n_runs, d)
        self.index = index
        self.rt_lmp = rt_lmp
        self._pmax = pmax

    # -- readers for the reference's file formats ------------------------
    @staticmethod
    def _read_dispatch_csv(path: str, num_sims: Optional[int]):
        """Run labels in the first column, one hour a column after it. A
        numeric first column takes the numeric reader; labels like
        "run_37" / "run_37.csv" (the reference's) are read with the `csv`
        module, the first line a header, as pandas reads them."""
        mat = read_csv_matrix(path, rows=(0, num_sims) if num_sims else None)
        if mat.size and not np.isnan(mat[:, 0]).any():
            return mat[:, 1:], mat[:, 0].astype(int)
        with open(path, newline="") as f:
            reader = csv.reader(f)
            next(reader, None)
            rows = []
            for row in reader:
                if num_sims is not None and len(rows) >= num_sims:
                    break
                if row:
                    rows.append(row)
        index = np.array([_parse_label(r[0]) for r in rows], dtype=int)
        values = np.array(
            [[float(c) if c.strip() else np.nan for c in r[1:]] for r in rows], dtype=float
        )
        return values, index

    @staticmethod
    def _read_inputs_h5(path: str, index: np.ndarray):
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError(
                "reading the sweep's .h5 inputs table needs pandas (with "
                "PyTables); pass the inputs as an array instead"
            ) from e

        df = pd.read_hdf(path)
        ncol = df.shape[1]
        return df.iloc[index, list(range(1, ncol))].to_numpy(dtype=float)

    # -- scaling ---------------------------------------------------------
    def pmax_per_run(self) -> np.ndarray:
        """Per-run maximum power for capacity-factor scaling.

        RE: wind pmax is a swept input (first input column, MW).
        NE: the RTS-GMLC nuclear unit is 400 MW derated by the swept
        pmin scaler (`Simulation_Data.py:_read_NE_pmin`).
        FE: pmax from the swept input (first column).
        """
        if self._pmax is not None:
            return np.asarray(self._pmax, dtype=float)
        if self.case_type == "NE":
            return np.full(self.dispatch.shape[0], 400.0)
        return self.inputs[:, 0].astype(float)

    def dispatch_capacity_factors(self) -> np.ndarray:
        """Dispatch scaled to [0, 1] capacity factors per run
        (`Simulation_Data.py:_scale_data`)."""
        pmax = self.pmax_per_run()
        return self.dispatch / np.maximum(pmax[:, None], 1e-12)

    def read_data_to_dict(self) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
        """Dict view for reference-API familiarity."""
        d = {int(i): self.dispatch[k] for k, i in enumerate(self.index)}
        x = {int(i): self.inputs[k] for k, i in enumerate(self.index)}
        return d, x

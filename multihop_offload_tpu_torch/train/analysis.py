"""Results analysis, the `results_plot-Adhoc.ipynb` equivalent as a module
(port of `multihop_offload_tpu/train/analysis.py`, without pandas).

Regenerates the paper-figure views from result CSVs (the drivers' or the
reference's shipped `out/*.csv`, one schema): mean per-task latency tau by
network size and method (Fig. 2(a)), congested-task ratio by size (Fig.
2(b)), per-instance runtime by method (Fig. 2(c)), and the live-training
monitor (rolling tau per method over file index, notebook cell 5).

A table is a dict of column name to numpy array, rows in the order pandas
gives them: `read_csv` keeps pandas' dtypes (int64 where every cell is an
integer, float64 where every cell is a number or empty, NaN for an empty
cell, else strings) and its float parser's values (`parse_float`), the
group-bys sort their keys and skip NaNs in the means, and the rolling mean
is pandas' running sum (`roll_mean`).
"""

from __future__ import annotations

import csv
import math
import os
import re

import numpy as np

# pandas' default `na_values` of `read_csv`
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_INT = re.compile(r"^\s*[+-]?\d+\s*$")
_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def _digits(t: str, i: int, number: float, count: int, limit: int) -> tuple:
    """Accumulate the ASCII digits at `t[i:]` into `number` while `count`
    stays under `limit`: (number, position, digits taken)."""
    taken = 0
    while i < len(t) and "0" <= t[i] <= "9" and count + taken < limit:
        number = number * 10.0 + (ord(t[i]) - 48)
        i += 1
        taken += 1
    return number, i, taken


def parse_float(cell: str) -> float:
    """A CSV cell as pandas' default C parser reads it (`precise_xstrtod`):
    at most 17 digits accumulated in a double (leading zeros count), then
    one multiply or divide by a power of ten.  That is not always the
    correctly rounded value Python's `float` gives, and the tables and the
    monitor's series follow pandas.  Raises ValueError on what is not a
    number."""
    t = cell.strip()
    if t.lower().lstrip("+") in ("inf", "infinity"):
        return math.inf
    if t.lower() in ("-inf", "-infinity"):
        return -math.inf
    i, negative = 0, t[:1] == "-"
    i += t[:1] in ("+", "-")
    number, i, digits = _digits(t, i, 0.0, 0, _MAX_DIGITS)
    exponent = 0
    while i < len(t) and "0" <= t[i] <= "9":  # past 17 digits: scale only
        exponent += 1
        i += 1
    if t[i:i + 1] == ".":
        number, i, decimals = _digits(t, i + 1, number, digits, _MAX_DIGITS)
        digits += decimals
        exponent -= decimals
        while i < len(t) and "0" <= t[i] <= "9":
            i += 1
    if digits == 0:
        raise ValueError(f"not a number: {cell!r}")
    number = -number if negative else number
    if t[i:i + 1] in ("e", "E"):
        j = i + 1
        eneg = t[j:j + 1] == "-"
        j += t[j:j + 1] in ("+", "-")
        e, j, taken = _digits(t, j, 0.0, 0, _MAX_DIGITS)
        if taken:
            exponent += -int(e) if eneg else int(e)
            i = j
    if i != len(t) or exponent > 308:
        raise ValueError(f"not a number: {cell!r}")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column(cells: list) -> np.ndarray:
    if cells and all(_INT.match(c) for c in cells):
        return np.asarray([int(c) for c in cells], dtype=np.int64)
    try:
        return np.asarray([math.nan if c in _NA else parse_float(c) for c in cells],
                          dtype=np.float64)
    except ValueError:
        return np.asarray([math.nan if c in _NA else c for c in cells], dtype=object)


def read_csv(path: str) -> dict:
    """The table of a CSV file with a header row, typed as pandas types it."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: _column([r[i] for r in body]) for i, name in enumerate(header)}


def _algo_col(table: dict) -> str:
    return "Algo" if "Algo" in table else "method"


def _isnan(values: np.ndarray) -> np.ndarray:
    if values.dtype == object:
        return np.asarray([isinstance(v, float) and math.isnan(v) for v in values], bool)
    if values.dtype.kind == "f":
        return np.isnan(values)
    return np.zeros(values.shape, bool)


def _groups(table: dict, keys: list) -> list:
    """(key values, row indices) of each group, keys sorted ascending, rows
    with a NaN key dropped (pandas' `groupby(sort=True, dropna=True)`)."""
    live = ~np.any([_isnan(table[k]) for k in keys], axis=0)
    groups: dict = {}
    for i in np.flatnonzero(live):
        groups.setdefault(tuple(table[k][i] for k in keys), []).append(i)
    return [(key, np.asarray(groups[key], dtype=np.int64)) for key in sorted(groups)]


def _mean(values: np.ndarray) -> float:
    """Mean of the non-NaN values, NaN when there is none."""
    live = values[~np.isnan(values)]
    return float(live.mean()) if live.size else math.nan


def _aggregate(table: dict, keys: list) -> dict:
    congest = table["congest_jobs"] / np.maximum(table["num_jobs"], 1)
    groups = _groups(table, keys)
    out = {}
    for j, k in enumerate(keys):
        col = [key[j] for key, _ in groups]
        out[k] = np.asarray(col, dtype=table[k].dtype)
    for name, values in (("tau", table["tau"]), ("congest_ratio", congest),
                         ("runtime", table["runtime"])):
        out[name] = np.asarray([_mean(values[rows]) for _, rows in groups], dtype=np.float64)
    return out, groups


def summarize_test(table: dict) -> dict:
    """Per (num_nodes, method) aggregates of tau / congestion / runtime."""
    algo = _algo_col(table)
    out, groups = _aggregate(table, ["num_nodes", algo])
    ratio = table["gnn_bl_ratio"].astype(np.float64)
    out["ratio_vs_baseline"] = np.asarray([_mean(ratio[rows]) for _, rows in groups],
                                          dtype=np.float64)
    return out


def overall_table(table: dict) -> dict:
    """Whole-set means per method: the BASELINE.md comparison table."""
    return _aggregate(table, [_algo_col(table)])[0]


def format_table(table: dict) -> str:
    """A table as aligned text, one row a line under a header."""
    names = list(table)
    cells = [[f"{v:.6g}" if isinstance(v, (float, np.floating)) else str(v)
              for v in table[name]] for name in names]
    widths = [max([len(name)] + [len(c) for c in col]) for name, col in zip(names, cells)]
    lines = ["  ".join(n.rjust(w) for n, w in zip(names, widths))]
    for row in zip(*cells):
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
    return "\n".join(lines)


def rolling_mean(values: np.ndarray, window: int, min_periods: int = 1) -> np.ndarray:
    """pandas' `Series.rolling(window, min_periods).mean()`: its running
    Kahan sum (`roll_mean`), NaNs skipped, a window of equal values exact,
    the sign of an all-positive or all-negative window kept."""
    values = np.asarray(values, dtype=np.float64)
    out = np.empty(values.size, dtype=np.float64)
    total = comp_add = comp_remove = 0.0
    nobs = neg = same = 0
    prev = values[0] if values.size else 0.0

    def add(v):
        nonlocal total, comp_add, nobs, neg, same, prev
        if v == v:
            nobs += 1
            y = v - comp_add
            t = total + y
            comp_add = t - total - y
            total = t
            neg += math.copysign(1.0, v) < 0
            same = same + 1 if v == prev else 1
            prev = v

    for i, v in enumerate(values):
        if i >= window:
            old = values[i - window]
            if old == old:
                nobs -= 1
                y = -old - comp_remove
                t = total + y
                comp_remove = t - total - y
                total = t
                neg -= math.copysign(1.0, old) < 0
        add(v)
        if nobs >= min_periods and nobs > 0:
            r = total / nobs
            if same >= nobs:
                r = prev
            elif neg == 0 and r < 0:
                r = 0.0
            elif neg == nobs and r > 0:
                r = 0.0
        else:
            r = math.nan
        out[i] = r
    return out


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_test_figures(csv_path: str, out_dir: str = "fig") -> list:
    """Fig. 2(a-c) equivalents from a test CSV."""
    plt = _pyplot()
    table = read_csv(csv_path)
    algo = _algo_col(table)
    s = summarize_test(table)
    os.makedirs(out_dir, exist_ok=True)
    tag = os.path.splitext(os.path.basename(csv_path))[0]
    written = []
    panels = [
        ("tau", "mean per-task latency tau", "fig2a"),
        ("congest_ratio", "congested-task ratio", "fig2b"),
        ("runtime", "mean per-instance runtime (s)", "fig2c"),
    ]
    for col, ylabel, name in panels:
        fig, ax = plt.subplots(figsize=(5, 3.4))
        for (method,), rows in _groups(s, [algo]):
            ax.plot(s["num_nodes"][rows], s[col][rows], marker="o", label=str(method))
        ax.set_xlabel("network size (nodes)")
        ax.set_ylabel(ylabel)
        if col == "tau":
            ax.set_yscale("log")
        ax.legend()
        fig.tight_layout()
        path = os.path.join(out_dir, f"{name}_{tag}.pdf")
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
    return written


def plot_training_monitor(csv_path: str, out_dir: str = "fig",
                          window: int = 50) -> str:
    """Rolling tau per method over training files (notebook cell 5)."""
    plt = _pyplot()
    table = read_csv(csv_path)
    algo = _algo_col(table)
    os.makedirs(out_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 3.4))
    for (method,), rows in _groups(table, [algo]):
        if "fid" in table:
            # pandas' `sort_values` sorts by numpy's default quicksort, which
            # is not stable: ties land as it leaves them
            rows = rows[np.argsort(table["fid"][rows], kind="quicksort")]
        roll = rolling_mean(table["tau"][rows], window, min_periods=1)
        ax.plot(np.arange(len(roll), dtype=np.int64), roll, label=str(method))
    ax.set_xlabel("instances seen")
    ax.set_ylabel(f"tau (rolling {window})")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    tag = os.path.splitext(os.path.basename(csv_path))[0]
    path = os.path.join(out_dir, f"training_monitor_{tag}.pdf")
    fig.savefig(path)
    plt.close(fig)
    return path

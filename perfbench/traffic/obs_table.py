"""The obs16m table of hourly station reports, made from the seed.

The fields of an ISD record's mandatory data section (NOAA's Integrated
Surface Database format document), decoded to physical units: air
temperature and dew point in degrees C and sea-level pressure in hPa at
ISD's resolution of a tenth, wind speed in m/s, and the quality codes of
temperature and pressure as ISD's one-character codes (their ASCII
bytes).  A missing element (ISD's 9999 / 99999) or one whose quality code
marks it erroneous (3, 7) is stored as NaN.  Rows are laid out as ISD's
archive is, one station-year after another in time order, every station
reporting every hour; a part holds ``stations / parts`` station-years.

The stations' climates are fixed by their index, so every seed asks the
same work of a threshold: annual means from -5 to 27 C, seasonal swings
of 2 to 16 C, daily ones of 3 to 7 C.  The seed draws the weather about
them, the missing and erroneous reports and the quality codes.
``columns`` makes the numpy arrays; ``write`` lays them out as the port's
columnar dataset (one ``part-NNNNN.npz`` per part) for the server to scan.
"""

from __future__ import annotations

import json
import os

import numpy as np

T0 = 1_672_531_200 * 10**9  # 2023-01-01T00:00Z in ns: the first report of every station-year
HOUR_NS = 3600 * 10**9
SCHEMA = (("station", "int32"), ("ts", "int64"), ("wind_speed", "float32"), ("temp", "float32"),
          ("temp_qc", "uint8"), ("dewp", "float32"), ("slp", "float32"), ("slp_qc", "uint8"))
# ISD quality codes: 1 passed all checks, 5 the same from an NCEI source, 0 / 4 gross-limits only,
# 2 / 6 suspect, 3 / 7 erroneous, 9 missing
QC_CODES = np.frombuffer(b"15042637", np.uint8)
QC_SHARES = np.array([0.700, 0.250, 0.020, 0.012, 0.006, 0.004, 0.005, 0.003])
MISSING = {"temp": 0.01, "dewp": 0.03, "slp": 0.25, "wind_speed": 0.02}  # missing shares (ISD 9999)


def part_rows(conf: dict) -> list:
    """Rows of each part: ``stations / parts`` station-years of ``hours``."""
    per = conf["stations"] // conf["parts"]
    return [per * conf["hours"]] * conf["parts"]


def climate(stations: int):
    """(annual mean, seasonal swing, daily swing) of each station, in C: fixed
    by the index, the climates interleaved so that every part holds cold and
    warm stations."""
    k = (np.arange(stations) * 733) % stations / max(stations - 1, 1)
    j = (np.arange(stations) * 379) % stations / max(stations - 1, 1)
    return -5.0 + 32.0 * k, 2.0 + 14.0 * j, 3.0 + 4.0 * (1.0 - k)


def _tenths(x: np.ndarray) -> np.ndarray:
    return (np.round(x * 10.0) / 10.0).astype(np.float32)


def columns(conf: dict, seed: int) -> list:
    """One dict of numpy columns per part of the configuration ``conf``
    (``stations``, ``hours``, ``parts``), each part from its own (seed,
    part) stream."""
    hours, parts = conf["hours"], conf["parts"]
    per = conf["stations"] // parts
    mean, season, day = climate(conf["stations"])
    h = np.arange(hours)
    cycle_y = np.cos(2 * np.pi * (h / 24.0 - 200.0) / 365.0)
    cycle_d = np.cos(2 * np.pi * (h % 24 - 15.0) / 24.0)
    out = []
    for part in range(parts):
        rng = np.random.default_rng([seed, part])
        st = np.arange(part * per, (part + 1) * per)
        n = per * hours
        base = (mean[st, None] + season[st, None] * cycle_y + day[st, None] * cycle_d).reshape(-1)
        temp = _tenths(base + rng.standard_normal(n) * 2.5)
        dewp = _tenths(temp - np.abs(rng.standard_normal(n)) * 4.0 - 1.0)
        slp = _tenths(1013.0 + rng.standard_normal(n) * 9.0)
        wind = _tenths(np.abs(rng.standard_normal(n)) * 4.0)
        temp_qc = rng.choice(QC_CODES, size=n, p=QC_SHARES)
        slp_qc = rng.choice(QC_CODES, size=n, p=QC_SHARES)
        cols = {"wind_speed": wind, "temp": temp, "dewp": dewp, "slp": slp}
        for name, share in MISSING.items():
            cols[name][rng.random(n) < share] = np.nan
        for name, qc in (("temp", temp_qc), ("slp", slp_qc)):
            qc[np.isnan(cols[name])] = ord("9")
            cols[name][(qc == ord("3")) | (qc == ord("7"))] = np.nan
        out.append({
            "station": np.repeat(st, hours).astype(np.int32),
            "ts": np.tile(T0 + h.astype(np.int64) * HOUR_NS, per),
            "wind_speed": cols["wind_speed"],
            "temp": cols["temp"],
            "temp_qc": temp_qc,
            "dewp": cols["dewp"],
            "slp": cols["slp"],
            "slp_qc": slp_qc,
        })
    return out


def write(root: str, parts: list) -> int:
    """The parts as a columnar dataset directory: ``_schema.json`` and one
    npz file a part, the layout the port's ``write_sdf_dataset`` writes,
    each file on the disk before this returns."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "_schema.json"), "w") as f:
        json.dump([{"name": n, "dtype": t, "nullable": False} for n, t in SCHEMA], f)
    rows = 0
    for i, cols in enumerate(parts):
        with open(os.path.join(root, f"part-{i:05d}.npz"), "wb") as f:
            np.savez(f, **cols)
            f.flush()
            os.fsync(f.fileno())  # written back now, in set-up, not by the kernel inside the window
        rows += len(cols["station"])
    return rows

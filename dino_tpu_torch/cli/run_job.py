#!/usr/bin/env python
"""Run the experiments of one job of a CSV schedule (one task of a
Slurm-array sweep).

    python -m dino_tpu_torch.cli.run_job -j ID -c schedule.csv -d data
        -w results [--cpu]

The port of ``dino_tpu``'s ``cli/run_job.py``, without pandas.  Rows carry
a ``job`` column; an array id past the number of jobs cycles through
seeds: seed, job = divmod(id, n_jobs), random_state = (seed + 1) * 1234.
Each row's non-empty cells are ``run_experiment``'s keyword arguments; an
experiment's exception is printed, not raised, so one bad row does not
end the array task.  Runs on the card unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import csv
import os
from typing import Any, Dict, List

from dino_tpu_torch.cli.run_experiment import run_experiment

_TRUE = ("True", "TRUE", "true")
_FALSE = ("False", "FALSE", "false")
# the cells pd.read_csv reads as missing by default
_NA = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"))


def _column_type(cells: List[str]):
    """How ``pd.read_csv`` types a column from its non-empty cells: bool
    when every cell is a true/false word, int when every cell parses as
    one, float when every cell parses as one, else str."""
    for kind in (bool, int, float):
        try:
            for c in cells:
                if kind is bool:
                    if c not in _TRUE + _FALSE:
                        raise ValueError(c)
                else:
                    kind(c)
            return kind
        except ValueError:
            continue
    return str


def _coerce(cell: str, kind, column_has_empty: bool):
    if kind is bool:
        return cell in _TRUE
    if kind is int:
        # pandas holds an int column with an empty cell as floats
        return float(cell) if column_has_empty else int(cell)
    return kind(cell)


def read_schedule(path: str) -> List[Dict[str, Any]]:
    """The schedule's rows as dicts of typed values, a missing cell left
    out (``pd.read_csv(path)`` row by row after ``dropna``).  Unlike
    pandas, an all-numeric schedule keeps its int columns ints (pandas'
    rows are then all floats)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    columns = list(rows[0]) if rows else []
    kinds, empty = {}, {}
    for col in columns:
        cells = [r[col] for r in rows if r[col] not in _NA]
        kinds[col] = _column_type(cells)
        empty[col] = len(cells) < len(rows)
    return [{col: _coerce(r[col], kinds[col], empty[col])
             for col in columns if r[col] not in _NA} for r in rows]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run experiments configured in a .csv schedule")
    parser.add_argument("--comet_tag", "-t", type=str, default=None)
    parser.add_argument("--job", "-j", type=int, default=0,
                        help="Schedule rows marked with this number run "
                             "sequentially; intended for the Slurm array id.")
    parser.add_argument("--config", "-c", type=str,
                        default=os.path.join(os.getcwd(), "exp_schedule",
                                             "main.csv"))
    parser.add_argument("--data_path", "-d", type=str,
                        default=os.path.join(os.getcwd(), "data"))
    parser.add_argument("--write_path", "-w", type=str, default=os.getcwd())
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)

    schedule = read_schedule(args.config)
    n_jobs = int(max(row["job"] for row in schedule) + 1)
    seed, job_no = divmod(args.job, n_jobs)
    rows = [row for row in schedule if row["job"] == job_no]
    if not rows:
        raise Exception(f"No job marked with the following id : {args.job}.")

    for row in rows:
        params = {k: v for k, v in row.items() if k != "job"}
        params["random_state"] = (seed + 1) * 1234
        params["data_path"] = args.data_path
        params["write_path"] = args.write_path
        params["comet_tag"] = args.comet_tag
        params["cpu"] = args.cpu

        print("Running experiment using config : ")
        print(params)
        try:
            run_experiment(**params)
        except Exception as e:
            print(e)


if __name__ == "__main__":
    main()

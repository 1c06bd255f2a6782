"""Summary of a grid's runs (counterpart of contrastyou_tpu/report.py, on the
stdlib ``csv`` module where the JAX one uses pandas): walk run directories,
take from each ``storage.csv`` the columns whose names contain one of
``--classes``, pick the best epoch by the first of them that contains
``--anchor`` (default: the first class), and write one row per run to
``<save_dir>/summary.csv``.

    python -m contrastyou_tpu_torch.report -t runs/udaiic --classes DSC_mean \\
        --save_dir runs/udaiic

As pandas does: the best epoch is the first of the highest values (or the
lowest, ``--high_better false``) among the anchor column's non-empty cells;
a run without such a column or value is left out; the summary's columns
are ``folder``, ``best_epoch`` and the selected columns in order of first
appearance over the runs, a cell a run lacks left empty; floats are
written as ``repr`` writes them.
"""
from __future__ import annotations

import argparse
import csv
import math
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["find_csvs", "read_storage", "summarize_run", "write_summary", "main"]

#: cells pandas' ``read_csv`` reads as missing
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}


def find_csvs(top_folder: Optional[str], specific_folders: Optional[List[str]],
              patterns: List[str]) -> List[Path]:
    roots = [Path(top_folder)] if top_folder else [Path(p) for p in specific_folders]
    out: List[Path] = []
    for root in roots:
        for pattern in patterns:
            out.extend(sorted(root.rglob(pattern)))
    return out


def _cell(text: str):
    if text in _NA:
        return math.nan
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def read_storage(path: Path):
    """-> (columns, {index: {column: value}}) of a CSV whose first column
    is the index, as ``pandas.read_csv(path, index_col=0)`` reads it: a
    column with a float or a missing cell holds floats."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    columns = header[1:]
    cells = {c: [_cell(r[j + 1]) if j + 1 < len(r) else math.nan for r in body]
             for j, c in enumerate(columns)}
    for c, values in cells.items():
        if any(isinstance(v, float) for v in values) and all(
                isinstance(v, (int, float)) for v in values):
            cells[c] = [float(v) for v in values]
    table = {}
    for i, r in enumerate(body):
        table[_cell(r[0])] = {c: cells[c][i] for c in columns}
    return columns, table


def _missing(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def summarize_run(csv_path: Path, classes: List[str], anchor: str,
                  high_better: bool = True) -> Optional[dict]:
    try:
        columns, table = read_storage(csv_path)
    except Exception:
        return None
    cols = [c for c in columns if any(cls in c for cls in classes)]
    anchor_cols = [c for c in cols if anchor in c]
    if not anchor_cols:
        return None
    series = [(epoch, row[anchor_cols[0]]) for epoch, row in table.items()
              if not _missing(row[anchor_cols[0]])]
    if not series:
        return None
    best_value = (max if high_better else min)(v for _, v in series)
    best_epoch = next(epoch for epoch, v in series if v == best_value)
    row = {"folder": str(csv_path.parent), "best_epoch": best_epoch}
    row.update({c: table[best_epoch][c] for c in cols})
    return row


def _format(v) -> str:
    if v is None or _missing(v):
        return ""
    return repr(v) if isinstance(v, float) else str(v)


def write_summary(rows: List[dict], path: Path) -> None:
    """``pandas.DataFrame(rows).to_csv(path, index=False)``."""
    columns: Dict[str, None] = {}
    for r in rows:
        columns.update(dict.fromkeys(r))
    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(columns))
        for r in rows:
            w.writerow([_format(r.get(c)) for c in columns])


def main(argv=None) -> List[dict]:
    parser = argparse.ArgumentParser(description="aggregate run storage.csv files")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--specific_folders", "-s", nargs="+", metavar="PATH")
    group.add_argument("--top_folder", "-t", metavar="PATH")
    parser.add_argument("--classes", nargs="+", required=True,
                        help="column substrings to collect (e.g. DSC_mean)")
    parser.add_argument("--anchor", default=None,
                        help="column substring used to pick the best epoch")
    parser.add_argument("--file", nargs="+", default=["storage.csv"])
    parser.add_argument("--high_better", type=lambda s: s.lower() != "false", default=True)
    parser.add_argument("--save_dir", required=True)
    parser.add_argument("--save_filename", default="summary.csv")
    args = parser.parse_args(argv)
    anchor = args.anchor or args.classes[0]

    csvs = find_csvs(args.top_folder, args.specific_folders, args.file)
    rows = [r for r in (summarize_run(p, args.classes, anchor, args.high_better)
                        for p in csvs) if r is not None]
    Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    out = Path(args.save_dir) / args.save_filename
    write_summary(rows, out)
    print(f"wrote {len(rows)} runs -> {out}")
    return rows


if __name__ == "__main__":
    main()

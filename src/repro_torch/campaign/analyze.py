"""Dataframe-free aggregation and table emitters for campaign records
(counterpart of ``repro.campaign.analyze``).

Records are the store's dicts (``labels`` / ``config`` / ``result`` /
``meta``).  This module gives the handful of verbs reporting needs —
select, group, pivot, format — without growing a dataframe dependency:

    from repro_torch.campaign import analyze

    recs = list(store.records())
    exp = analyze.select(recs, process="exp")
    print(analyze.markdown_table(
        ["scenario", "E[saving] kWh", "E[failures]"],
        [[analyze.label(r, "scenario"),
          f"{analyze.get(r, 'result.mean_saving_j') / 3.6e6:.2f}",
          f"{analyze.get(r, 'result.mean_failures'):.1f}"]
         for r in exp]))
"""
from __future__ import annotations

from typing import Callable, Iterable, Mapping, Optional, Sequence


def label(record: Mapping, axis_name: str, default=None):
    """The record's label on one axis (``None``/default if absent)."""
    return record.get("labels", {}).get(axis_name, default)


def get(record: Mapping, path: str, default=None):
    """Dotted-path lookup into a record: ``"result.mean_saving_j"``,
    ``"config.run.n_runs"``, ``"labels.scenario"``."""
    obj = record
    for part in path.split("."):
        if not isinstance(obj, Mapping) or part not in obj:
            return default
        obj = obj[part]
    return obj


def select(records: Iterable[Mapping], **labels_eq) -> list:
    """Records whose labels match every ``axis=label`` keyword."""
    return [r for r in records
            if all(label(r, a) == v for a, v in labels_eq.items())]


def group_by(records: Iterable[Mapping], axis_name: str) -> dict:
    """label value -> list of records, in first-seen order."""
    out: dict = {}
    for r in records:
        out.setdefault(label(r, axis_name), []).append(r)
    return out


def pivot(
    records: Iterable[Mapping],
    row_axis: str,
    col_axis: str,
    value: str,
    agg: Callable[[Sequence[float]], float] = lambda xs: sum(xs) / len(xs),
) -> tuple:
    """(row labels, col labels, cell values) over two axes.

    ``value`` is a dotted record path; cells holding several records
    aggregate with ``agg`` (mean by default); empty cells are ``None``.
    """
    rows_seen: list = []
    cols_seen: list = []
    cells: dict = {}
    for r in records:
        rl, cl = label(r, row_axis), label(r, col_axis)
        if rl not in rows_seen:
            rows_seen.append(rl)
        if cl not in cols_seen:
            cols_seen.append(cl)
        v = get(r, value)
        if v is not None:
            cells.setdefault((rl, cl), []).append(float(v))
    grid = [[agg(cells[(rl, cl)]) if (rl, cl) in cells else None
             for cl in cols_seen] for rl in rows_seen]
    return rows_seen, cols_seen, grid


# ---------------------------------------------------------------------------
# emitters
# ---------------------------------------------------------------------------

def markdown_table(headers: Sequence[str], rows: Iterable[Sequence]) -> str:
    """A GitHub-flavored markdown table (one string, no trailing newline)."""
    out = ["| " + " | ".join(str(h) for h in headers) + " |",
           "|" + "---|" * len(headers)]
    for row in rows:
        out.append("| " + " | ".join(str(c) for c in row) + " |")
    return "\n".join(out)


def text_table(headers: Sequence[str], rows: Iterable[Sequence]) -> str:
    """A column-aligned plain-text table for terminal output."""
    table = [[str(h) for h in headers]] + \
        [[str(c) for c in row] for row in rows]
    widths = [max(len(row[i]) for row in table)
              for i in range(len(headers))]
    lines = []
    for j, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip())
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def summary_table(
    records: Iterable[Mapping],
    columns: Sequence[tuple],
    fmt: str = "markdown",
) -> str:
    """Table with one row per record.  ``columns`` is a sequence of
    ``(header, spec)`` where ``spec`` is a dotted record path, a callable
    ``record -> value``, or ``(path, format_string)``."""
    def cell(r, colspec):
        if callable(colspec):
            return colspec(r)
        if isinstance(colspec, tuple):
            path, f = colspec
            v = get(r, path)
            return "" if v is None else format(v, f)
        return get(r, colspec, "")

    headers = [h for h, _ in columns]
    rows = [[cell(r, c) for _, c in columns] for r in records]
    emit = markdown_table if fmt == "markdown" else text_table
    return emit(headers, rows)

#!/usr/bin/env python3
"""Doc-drift check: every throughput number quoted in README.md and
docs/*.md must be backed by a measured number in PERF.md.

Docs whose qps numbers silently drift from the measurements after a
kernel change are a CI failure instead of a review finding.

Mechanics: extract every numeric token immediately followed by a
throughput unit ("qps", "vecs/s", "vec-iters/s") from the doc files,
normalize k-suffixes ("105.1k" -> 105100), and require each value to
match some number on a throughput line of PERF.md within RTOL.
Estimates marked "~" and tiny values are skipped. Exit 0 =
consistent, 1 = drift (prints every unbacked number with file:line).
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DOC_FILES = [ROOT / "README.md", *sorted((ROOT / "docs").glob("*.md"))]
PERF = ROOT / "PERF.md"

# "105.1k qps", "735-758k vecs/s", "1518/1073 qps", "326k vec-iters/s"
UNIT = r"(?:qps|vecs/s|vec-iters/s)"
NUM = r"~?\d[\d,.]*k?"
TOKEN = re.compile(
    rf"({NUM})(?:\s*(?:[-–/]\s*({NUM}))?)?\s*(?:{UNIT})")
PLAIN_NUM = re.compile(r"~?\d[\d,.]*k?")

RTOL = 0.05          # reverse check: docs may round ("105k" vs 105,101)
HEAD_RTOL = 0.01     # forward check: headline quotes are 3+ digits
MIN_VALUE = 50.0     # skip trivia like "2 qps" scaling estimates

# Canonical CURRENT headline metrics -> files that must quote them
# (within HEAD_RTOL): metric name -> (value, [files]). When a benchmark
# run moves a number, update it here and in PERF.md, and any doc still
# quoting the stale value fails because the new value is absent. Empty
# until the benchmark ledger holds GPU lines to quote.
HEADLINE: dict[str, tuple[float, list[str]]] = {}


def parse(tok: str) -> float | None:
    """'105.1k' -> 105100.0; '~2k' -> None (estimate); '1,518' -> 1518."""
    if tok.startswith("~"):
        return None
    mult = 1000.0 if tok.endswith("k") else 1.0
    body = tok.rstrip("k").replace(",", "")
    if not body or body.count(".") > 1:
        return None
    try:
        return float(body) * mult
    except ValueError:
        return None


def doc_numbers(path: Path):
    """(value, line_no, raw) for every unit-attached number in path."""
    out = []
    for ln, line in enumerate(path.read_text().splitlines(), 1):
        for mo in TOKEN.finditer(line):
            for tok in mo.groups():
                if tok is None:
                    continue
                # a range/pair token like "735-758k": the left side
                # inherits the right side's k-suffix
                if (not tok.endswith("k") and mo.group(2)
                        and mo.group(2).endswith("k")):
                    tok = tok + "k"
                v = parse(tok)
                if v is not None and v >= MIN_VALUE:
                    out.append((v, ln, tok))
    return out


_UNIT_RE = re.compile(UNIT)


def baseline_numbers() -> list[float]:
    """Backing = every number on a PERF.md line that mentions a
    throughput unit. Matching against every number in the whole file
    (dates, batch sizes, shapes) would make the check vacuous; a table
    row may carry the unit in another column ('queries/s')."""
    vals = []
    for line in PERF.read_text().splitlines():
        if not _UNIT_RE.search(line) and "queries/s" not in line:
            continue
        for tok in PLAIN_NUM.findall(line):
            v = parse(tok)
            if v is not None:
                vals.append(v)
        # range shorthand "735-763,000": the left side shares the
        # right side's scale, so 735 also backs 735k
        for lo, hi in re.findall(r"(\d[\d.]*)-(\d[\d,]*\d)", line):
            vlo, vhi = parse(lo), parse(hi)
            if vlo and vhi and vhi >= 1000 * vlo / 100:
                vals.append(vlo * 1000.0)
    return vals


def all_numbers(path: Path) -> list[float]:
    text = path.read_text()
    vals = []
    for tok in PLAIN_NUM.findall(text):
        v = parse(tok)
        if v is not None:
            vals.append(v)
    # range shorthand "735-758k" / "735-763,000": the left side shares
    # the right side's scale
    for lo, hi in re.findall(r"(\d[\d.]*)-(\d[\d,]*\d?k?)", text):
        vlo, vhi = parse(lo), parse(hi)
        if vlo and vhi and vhi >= 1000 * vlo / 100:
            vals.append(vlo * 1000.0)
    return vals


def main() -> int:
    failures = []
    # forward: every canonical headline value must be quoted in its
    # files AND in PERF.md
    for name, (v, files) in HEADLINE.items():
        for rel in files + ["PERF.md"]:
            path = ROOT / rel
            vals = all_numbers(path)
            if not any(abs(v - b) <= HEAD_RTOL * max(v, b)
                       for b in vals):
                failures.append(
                    f"headline {name}={v:g} not quoted in {rel}")
    # reverse: every unit-attached doc number has PERF.md backing
    base = baseline_numbers()
    for path in DOC_FILES:
        if not path.exists():
            continue
        for v, ln, raw in doc_numbers(path):
            if not any(abs(v - b) <= RTOL * max(v, b) for b in base):
                failures.append(
                    f"{path.relative_to(ROOT)}:{ln}  '{raw}' ({v:g}) "
                    "has no PERF.md backing")
    if failures:
        print(f"DOC DRIFT (rtol {RTOL:.0%}):")
        for f in failures:
            print(f"  {f}")
        return 1
    n = sum(len(doc_numbers(p)) for p in DOC_FILES if p.exists())
    print(f"doc-drift check OK: {len(HEADLINE)} headline metrics "
          f"present; {n} doc throughput numbers backed by PERF.md")
    return 0


if __name__ == "__main__":
    sys.exit(main())

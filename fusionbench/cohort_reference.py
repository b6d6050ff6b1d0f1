"""The plain reference of what ``defuse cohort`` adds to its libraries'
results: the cohort-wide tables, worked out from each library's
``results.filtered.tsv`` with the ``csv`` module and nothing of the
program.

- ``cohort_fusions.tsv``: every row of every library's filtered results,
  the libraries in the manifest's order, each row led by its library's
  name, under the first results file's header led by ``library``;
- ``cohort_recurrent.tsv``: each gene pair (the two names in sorted
  order, whichever side each is on), the number of libraries that report
  it and their names in sorted order, joined by commas; the pairs in
  descending number of libraries, then by the pair.

A library without a results file, or with an empty one, adds nothing.
Each library's own results are held to ``reference.py``.

    python3 fusionbench/cohort_reference.py <cohort output> --manifest <tsv>

compares both tables of a ``defuse cohort`` output with the reference's,
byte for byte; it prints one JSON line and exits 1 where either differs.
"""

import argparse
import collections
import csv
import io
import json
import pathlib
import sys

TABLES = ("cohort_fusions.tsv", "cohort_recurrent.tsv")


def _writer(buf):
    return csv.writer(buf, delimiter="\t", quoting=csv.QUOTE_NONE,
                      lineterminator="\n")


def tables(outdir, names) -> dict[str, str]:
    """The text of each of ``TABLES`` for the libraries ``names`` (in the
    manifest's order) under ``outdir``."""
    fusions, recurrent = io.StringIO(), io.StringIO()
    rows_out = _writer(fusions)
    seen = collections.defaultdict(set)
    header = None
    for name in names:
        path = pathlib.Path(outdir) / name / "results.filtered.tsv"
        if not path.exists():
            continue
        with open(path, newline="") as fh:
            rows = list(csv.reader(fh, delimiter="\t",
                                   quoting=csv.QUOTE_NONE))
        if not rows:
            continue
        if header is None:
            header = rows[0]
            rows_out.writerow(["library", *header])
        gene1, gene2 = rows[0].index("gene1"), rows[0].index("gene2")
        for row in rows[1:]:
            rows_out.writerow([name, *row])
            seen[tuple(sorted((row[gene1], row[gene2])))].add(name)
    pairs_out = _writer(recurrent)
    pairs_out.writerow(["gene1", "gene2", "n_libraries", "libraries"])
    for pair, libs in sorted(seen.items(),
                             key=lambda kv: (-len(kv[1]), kv[0])):
        pairs_out.writerow([*pair, len(libs), ",".join(sorted(libs))])
    return dict(zip(TABLES, (fusions.getvalue(), recurrent.getvalue())))


def manifest_names(path) -> list[str]:
    """The library names of a ``defuse cohort`` TSV manifest, in order."""
    with open(path, newline="") as fh:
        return [row[0] for row in csv.reader(fh, delimiter="\t")
                if row and row[0].strip() and not row[0].startswith("#")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("outdir", type=pathlib.Path)
    ap.add_argument("--manifest", type=pathlib.Path, required=True)
    args = ap.parse_args(argv)
    names = manifest_names(args.manifest)
    want = tables(args.outdir, names)
    same = {t: (args.outdir / t).read_bytes() == want[t].encode()
            for t in TABLES}
    print(json.dumps({"libraries": len(names), "equal": same,
                      "rows": {t: want[t].count("\n") for t in TABLES}}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

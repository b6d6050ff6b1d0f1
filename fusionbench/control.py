"""The controls of ``correct``: the plain reference put in the program's
place with one guarantee of the configuration broken, held to the same
comparison on a cell's own libraries.  Each must come out not correct,
and each fails the compared number it is named for:

* ``exact_alignment`` (``frontend_pairs_differ``): reads aligned with no
  mismatch where the configuration states up to ``align_mismatches``;
* ``breakpoint_moved`` (``fusion_disagreements``): each fusion's
  breakpoint one base past the last slide over the bases its two genes
  share, where the configuration states deFuse's exact breakpoint.

    python3 fusionbench/control.py --workload wts50.dense --seeds 1 2 3

Needs no card and runs none of the program: the libraries of a run's pool
at their full size, the reference and the comparison, on the CPU.
"""

import argparse
import dataclasses
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import compare  # noqa: E402
import generator  # noqa: E402
import observe  # noqa: E402
import reference  # noqa: E402
from prepare import ROOT, Cell, library_seeds  # noqa: E402

BROKEN_MISMATCHES = 0


def moved_breakpoints(exp: reference.Expected) -> reference.Expected:
    """The reference's answer with each breakpoint moved a base towards the
    3' gene past its last slide, so that no allowed breakpoint holds it."""
    moved = []
    for allowed in exp.breakpoints:
        pa, pb = max(allowed)
        moved.append({(pa + 1, pb + 1)})
    return dataclasses.replace(exp, breakpoints=moved)


def control_answers(lib, genes, cfg, exp) -> dict:
    """Each control's answer on one library, as the reference gives it."""
    return {
        "exact_alignment": reference.expected(lib, genes, cfg,
                                              mm=BROKEN_MISMATCHES),
        "breakpoint_moved": moved_breakpoints(exp),
    }


def control_numbers(cell: Cell, genes, seed: int) -> dict[str, list[dict]]:
    """The compared numbers of each control on the pool of ``seed``."""
    out: dict[str, list[dict]] = {}
    for s in library_seeds(seed)[:2]:
        lib = generator.make_library(cell.cfg, cell.mix, genes, s)
        exp = reference.expected(lib, genes, cell.cfg)
        for name, answer in control_answers(lib, genes, cell.cfg,
                                            exp).items():
            out.setdefault(name, []).append(compare.numbers(
                observe.from_expected(answer, genes), exp, genes))
    return out


def main(argv=None, root: pathlib.Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = Cell(args.workload, root)
    _, genes = generator.make_genome(cell.cfg)
    failed_all = True
    for seed in args.seeds:
        for name, readings in control_numbers(cell, genes, seed).items():
            ok, worst = compare.judge(readings)
            failed_all &= not ok
            print(json.dumps({"seed": seed, "control": name, "correct": ok,
                              "numbers": worst}))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())

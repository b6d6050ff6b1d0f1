"""The benchmark's own tests: the harness's data-driven parts, the
generator, the reference and a tiny run on CPU tensors.  Run from the
repository's root: ``python -m pytest fusionbench/tests -q``."""

import json
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where CUDA is absent)")


@pytest.fixture
def card():
    """Skips the test where no CUDA device is present (decided here, never
    at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


TINY_GENOME = {"chromosomes": 3, "chromosome_length": 1_500_000,
               "intergenic": [20000, 40000], "repeats": 50}


@pytest.fixture
def tiny_tree(tmp_path):
    """A tree holding a BENCHMARK.json of one new cell, ``tiny.few``, with
    its configuration and mix added as new files (what a later change
    adds), and the benchmark's own metrics found beside ``run.py``."""
    cfg = json.loads((BENCH / "configs" / "wts50.json").read_text())
    cfg["name"] = "tiny"
    cfg["library_pairs"] = 20000
    cfg["genome"].update(TINY_GENOME)
    (tmp_path / "fusionbench" / "configs").mkdir(parents=True)
    (tmp_path / "fusionbench" / "traffic").mkdir()
    (tmp_path / "fusionbench" / "configs" / "tiny.json").write_text(
        json.dumps(cfg))
    (tmp_path / "fusionbench" / "traffic" / "few.json").write_text(
        json.dumps({"name": "few", "fusions": 50, "frags_per_fusion": 150,
                    "decoy_share": 0.05}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "fusionbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny.few", "config": "tiny",
                           "traffic": "few", "chips": 1, "why": "test"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path

"""The port never imports ``jax``: importing every module of
``defuse_tpu_torch`` and running its discover on the CPU leaves ``jax``
out of ``sys.modules``.  Runs in a subprocess, because this test process
imported ``jax`` in ``conftest.py``."""

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pathlib, pkgutil, sys
sys.path[:0] = [{repo!r}, {tests!r}]
import defuse_tpu_torch
for mod in pkgutil.walk_packages(defuse_tpu_torch.__path__,
                                 "defuse_tpu_torch."):
    importlib.import_module(mod.name)
assert "jax" not in sys.modules, "importing the port imported jax"

from synthdata import make_dataset, write_dataset
from defuse_tpu_torch.pipeline.discover import discover_fusions
tmp = pathlib.Path({tmp!r})
paths = write_dataset(make_dataset(seed=31, fusion_pair=("TA", "TD"),
                                   break_a=2400, break_b=1000), tmp)
outs = discover_fusions(
    spanning=str(paths["spanning"]), improper=str(paths["improper"]),
    fastq1=str(paths["fastq1"]), fastq2=str(paths["fastq2"]),
    reference=str(paths["reference"]), exons=str(paths["exons"]),
    fragment_mean=200.0, fragment_stddev=20.0, precision=0.95,
    min_cluster_size=3, min_read_length=50, max_read_length=50,
    outdir=str(tmp / "out"), device="cpu")
assert pathlib.Path(outs["seq"]).read_text(), "no fusion called"
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_runs_without_jax(tmp_path):
    from defuse_tpu.cluster import native
    if not native.available():
        pytest.skip("native library not built")
    src = SCRIPT.format(repo=str(REPO), tests=str(REPO / "tests"),
                        tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout

"""The port never imports ``jax``: importing every module of
``defuse_tpu_torch`` and running its discover and its aligner frontend
(every candidate verified by the port's verifier) on the CPU leaves
``jax`` out of ``sys.modules``.  Runs in subprocesses, because this test
process imported ``jax`` in ``conftest.py``."""

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


FRONTEND = r"""
import os, pathlib, sys
sys.path[:0] = [{repo!r}, {tests!r}]
os.environ["DEFUSE_DEVICE_VERIFY"] = "force"
from synthdata import make_dataset, write_dataset
from torch_cases import frontend_config
from defuse_tpu_torch.align.frontend import align_reads
from defuse_tpu_torch.ops import verify_batch
calls = []
verify = verify_batch.DeviceVerifier.__call__
verify_batch.DeviceVerifier.__call__ = \
    lambda self, *a: calls.append(1) or verify(self, *a)
tmp = pathlib.Path({tmp!r})
ds = make_dataset(seed=29, n_fusion_frags=40, n_background_frags=40)
paths = write_dataset(ds, tmp)
res = align_reads(frontend_config(ds, tmp / "refs"), str(tmp / "out"),
                  str(paths["fastq1"]), str(paths["fastq2"]), device="cpu")
assert calls, "the port's verifier never ran"
assert pathlib.Path(res["improper"]).stat().st_size > 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not bad, bad
print("NO_JAX_OK")
"""


def run_without_jax(script, tmp_path):
    from defuse_tpu.cluster import native
    if not native.available():
        pytest.skip("native library not built")
    src = script.format(repo=str(REPO), tests=str(REPO / "tests"),
                        tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def test_port_runs_without_jax(tmp_path):
    run_without_jax(SCRIPT, tmp_path)


def test_port_frontend_runs_without_jax(tmp_path):
    run_without_jax(FRONTEND, tmp_path)

"""The port never imports ``jax`` nor anything of ``defuse_tpu``:
importing every module of ``defuse_tpu_torch`` and running its discover,
its aligner frontend (every candidate verified by the port's verifier)
and its command line (``create-ref``, ``run``, ``cohort``) on the CPU
leaves ``jax``, ``defuse_tpu``, ``bench`` and the
test helpers out of ``sys.modules``.  Runs in subprocesses, because this
test process imported ``jax`` in ``conftest.py``; the datasets are written
here, since ``tests/synthdata.py`` imports ``defuse_tpu``.  A static case
reads every import statement of the port and of ``chip_smoke.py``."""

import ast
import pathlib
import subprocess
import sys

import pytest

from defuse_tpu_torch.cluster import native
from synthdata import make_dataset, write_dataset
from torch_cases import frontend_config

REPO = pathlib.Path(__file__).resolve().parent.parent

PRELUDE = r"""
import os, pathlib, sys
sys.path.insert(0, {repo!r})
tmp = pathlib.Path({tmp!r})


def foreign():
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "defuse_tpu", "bench", "synthdata",
                   "torch_cases"))
"""

SCRIPT = PRELUDE + r"""
import importlib, pkgutil
import defuse_tpu_torch
for mod in pkgutil.walk_packages(defuse_tpu_torch.__path__,
                                 "defuse_tpu_torch."):
    importlib.import_module(mod.name)
assert not foreign(), ("importing the port imported", foreign())

from defuse_tpu_torch.pipeline.discover import discover_fusions
data = tmp / "data"
outs = discover_fusions(
    spanning=str(data / "spanning.compact"),
    improper=str(data / "improper.sam"),
    fastq1=str(data / "reads.1.fastq"), fastq2=str(data / "reads.2.fastq"),
    reference=str(data / "reference.fa"), exons=str(data / "cdna.regions"),
    fragment_mean=200.0, fragment_stddev=20.0, precision=0.95,
    min_cluster_size=3, min_read_length=50, max_read_length=50,
    outdir=str(tmp / "out"), device="cpu")
assert pathlib.Path(outs["seq"]).read_text(), "no fusion called"
assert not foreign(), foreign()
print("NO_JAX_OK")
"""


FRONTEND = PRELUDE + r"""
os.environ["DEFUSE_DEVICE_VERIFY"] = "force"
from defuse_tpu_torch.align.frontend import align_reads
from defuse_tpu_torch.config import Config
from defuse_tpu_torch.ops import verify_batch
calls = []
verify = verify_batch.DeviceVerifier.__call__
verify_batch.DeviceVerifier.__call__ = \
    lambda self, *a: calls.append(1) or verify(self, *a)
refs, data = tmp / "refs", tmp / "data"
config = Config.defaults(gene_models=refs / "genes.gtf",
                         genome_fasta=refs / "genome.fa",
                         cdna_fasta=refs / "cdna.fa",
                         pair_sam_checkpoint="eager")
res = align_reads(config, str(tmp / "out"), str(data / "reads.1.fastq"),
                  str(data / "reads.2.fastq"), device="cpu")
assert calls, "the port's verifier never ran"
assert pathlib.Path(res["improper"]).stat().st_size > 0
assert not foreign(), foreign()
print("NO_JAX_OK")
"""


CLI = PRELUDE + r"""
from defuse_tpu_torch.cli.main import main
data, refs = tmp / "data", tmp / "refs"
config, dataset = str(refs / "config.txt"), str(tmp / "dataset")
fastqs = ["-1", str(data / "reads.1.fastq"), "-2", str(data / "reads.2.fastq")]
assert main(["create-ref", "-c", config, "-d", dataset]) == 0
assert main(["run", "-c", config, "-d", dataset, "-o", str(tmp / "out"),
             "-n", "libA", "--device", "cpu"] + fastqs) == 0
rows = (tmp / "out" / "results.filtered.tsv").read_text().splitlines()
assert len(rows) >= 2, "no fusion called"
(tmp / "cohort.tsv").write_text("libA\t" + "\t".join(fastqs[1::2]) + "\n")
os.environ["PYTHONPATH"] = {repo!r}
assert main(["cohort", "-c", config, "-d", dataset, "-m",
             str(tmp / "cohort.tsv"), "-o", str(tmp / "cohort"),
             "--device", "cpu"]) == 0
fusions = (tmp / "cohort" / "cohort_fusions.tsv").read_text().splitlines()
assert [r.split("\t", 1)[1] for r in fusions] == rows
assert not foreign(), foreign()
print("NO_JAX_OK")
"""


def run_without_jax(script, tmp_path):
    if not native.available():
        pytest.skip("native library not built")
    src = script.format(repo=str(REPO), tmp=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_OK" in proc.stdout


def test_port_runs_without_jax(tmp_path):
    write_dataset(make_dataset(seed=31, fusion_pair=("TA", "TD"),
                               break_a=2400, break_b=1000),
                  tmp_path / "data")
    run_without_jax(SCRIPT, tmp_path)


def test_port_frontend_runs_without_jax(tmp_path):
    ds = make_dataset(seed=29, n_fusion_frags=40, n_background_frags=40)
    write_dataset(ds, tmp_path / "data")
    frontend_config(ds, tmp_path / "refs")  # writes the references
    run_without_jax(FRONTEND, tmp_path)


def test_port_cli_runs_without_jax(tmp_path):
    """``create-ref``, ``run --device cpu`` and ``cohort --device cpu``
    through ``cli.main.main``; the cohort's child is ``python -m
    defuse_tpu_torch run``."""
    from defuse_tpu_torch.utils import synth
    ds = make_dataset(seed=7, n_fusion_frags=80, n_background_frags=40)
    write_dataset(ds, tmp_path / "data")
    synth.write_run_config(ds, tmp_path / "refs")
    run_without_jax(CLI, tmp_path)


FORBIDDEN = ("defuse_tpu", "jax", "jaxlib", "bench", "synthdata", "helpers",
             "torch_cases", "conftest", "tests")
PORT_FILES = sorted((REPO / "defuse_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_the_reference(path):
    """No ``import``/``from`` statement of the port, at any depth of any
    function, names ``defuse_tpu``, ``jax``, ``bench`` or a module under
    ``tests/``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"

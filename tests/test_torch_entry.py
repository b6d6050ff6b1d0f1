"""The port's entry points (``defuse_tpu_torch/entry.py``) against
``__graft_entry__.py`` on the CPU: ``entry()``'s forward step bit for bit
against the JAX one under ``jax.jit``; ``dryrun_multichip`` with 2 and 4
ranks under gloo on CPU tensors (each rank's asserts, and the real
discover sharded over the ranks byte-identical to the one-process run, are
checked inside the ranks; a rank that fails fails the call); and the
dataset the dryrun discovers on, written by the port's ``make_dataset``,
against ``tests/synthdata.py``'s bytes."""

import filecmp
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from defuse_tpu_torch import entry as port_entry

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_entry_matches_jax_entry():
    import jax
    import __graft_entry__ as ge
    fn, args = port_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    jfn, jargs = ge.entry()
    want = jax.jit(jfn)(*jargs)
    for g, w, name in zip(got, want, ("max_score", "best_k")):
        w = np.asarray(w)
        assert g.dtype == torch.int32 and w.dtype == np.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[0].shape == (64,)
    assert 0 < int((got[0] > 0).sum()) <= 64
    for a, ja in zip(args, jargs):  # the same operands, bit for bit
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


def test_entry_needs_cuda_when_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="is_available"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="is_available"):
        port_entry.dryrun_multichip(2)


def test_entry_runs_as_a_program():
    proc = subprocess.run(
        [sys.executable, "-m", "defuse_tpu_torch.entry", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "entry OK: [(64,), (64,)]" in proc.stdout


@pytest.mark.parametrize("n,shape", [(2, [1, 2]), (4, [2, 2])])
def test_dryrun_multichip(monkeypatch, capsys, n, shape):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # n ranks share the cores
    monkeypatch.delenv("DEFUSE_NO_NATIVE", raising=False)
    out = port_entry.dryrun_multichip(n, device="cpu", timeout=400)
    printed = capsys.readouterr().out
    assert "dryrun_multichip OK" in printed
    assert "dryrun real-discover OK" in printed
    assert "DEFUSE_NO_NATIVE" not in os.environ  # set in the ranks only
    ranks = out["ranks"]
    assert [r["rank"] for r in ranks] == list(range(n))
    coords = set()
    for r in ranks:
        assert r["world_size"] == n and r["backend"] == "gloo"
        assert r["device"] == "cpu" and r["mesh"]["shape"] == shape
        coords.add((r["mesh"]["data"], r["mesh"]["inst"]))
        assert r["accepted"] == r["n_true"] == 1536
        assert np.isfinite(r["ll_sum"])
        assert r["n_breaks"] > 0 and r["em_rows"] > 0
        # on CPU tensors the plain version runs: no kernel launch counted
        assert r["launches"] == {"split_dp_rowmax": 0, "split_dp_screen": 0,
                                 "split_dp_tie_columns": 0,
                                 "em_rows_kernel": 0}
    assert coords == {(d, i) for d in range(shape[0])
                      for i in range(shape[1])}
    # each data slice is replicated over inst, each EM slice over data: the
    # sums reduced over either axis are the same on every rank
    assert len({r["ll_sum"] for r in ranks}) == 1


def test_make_dataset_writes_the_test_helpers_bytes(tmp_path):
    import synthdata
    from defuse_tpu_torch.utils import synth
    a = synthdata.write_dataset(synthdata.make_dataset(seed=5),
                                tmp_path / "tests")
    b = synth.write_dataset(synth.make_dataset(seed=5), tmp_path / "port")
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].name == b[key].name, key
        assert filecmp.cmp(a[key], b[key], shallow=False), key

"""The port's examples (examples_torch/) stay runnable on the CPU, scaled
down by CG_EXAMPLE_SCALE, with the checks tests/test_examples.py makes of
the JAX package's examples; multichip_export runs as a gloo world of four
processes under torchrun."""

import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples_torch")


def _run(example, cwd, ranks=None):
    env = dict(os.environ, CG_EXAMPLE_SCALE="500", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    script = [os.path.join(EXAMPLES, example), "--device", "cpu"]
    if ranks:
        script = ["-m", "torch.distributed.run", "--standalone",
                  "--nproc-per-node", str(ranks)] + script
    res = subprocess.run([sys.executable] + script, cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


@pytest.fixture(scope="module")
def single_cluster(tmp_path_factory):
    """single_cluster.py once: its output and the directory of its files
    (binary_merger.py reads the model file)."""
    cwd = tmp_path_factory.mktemp("single_cluster")
    return _run("single_cluster.py", cwd), cwd


def test_single_cluster_example(single_cluster):
    res, cwd = single_cluster
    assert (cwd / "single_cluster_ic.h5").exists()
    assert (cwd / "single_cluster.h5").exists()
    hse = float(re.search(r"HSE residual: (\S+)", res.stdout).group(1))
    vir = float(re.search(r"virial residual: (\S+)", res.stdout).group(1))
    assert hse < 1e-4 and vir < 1e-4, res.stdout


def test_binary_merger_example(single_cluster, tmp_path):
    shutil.copy(single_cluster[1] / "single_cluster.h5", tmp_path)
    res = _run("binary_merger.py", tmp_path)
    assert (tmp_path / "merger_ic.h5").exists()
    assert (tmp_path / "merger_B.h5").exists()
    assert "merger IC written" in res.stdout


def test_ensemble_example(tmp_path):
    res = _run("ensemble.py", tmp_path)
    assert "built" in res.stdout and "clusters" in res.stdout
    assert "every f(E) >= 0: True" in res.stdout
    assert "violations: 0" in res.stdout


def test_train_on_catalog_example(tmp_path):
    """The datagen-consumption loop: catalog -> shuffled prefetched
    batches -> Adam steps; the loss must improve."""
    res = _run("train_on_catalog.py", tmp_path)
    assert "improved" in res.stdout and "NOT improved" not in res.stdout


def test_multichip_export_example(tmp_path):
    res = _run("multichip_export.py", tmp_path, ranks=4)
    assert "wrote 4 Gadget shard files" in res.stdout
    for k in range(4):
        assert (tmp_path / f"merger_ic.{k}.h5").exists()
    assert not (tmp_path / "merger_ic.4.h5").exists()
    assert "reassembled" in res.stdout

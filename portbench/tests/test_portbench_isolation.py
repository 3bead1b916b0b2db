"""A run loads no module whose whole top-level name is ``jax``, ``jaxlib``,
``flax`` or ``cluster_generator_tpu``; the reference loads nothing of the
port; ``run.py`` without a card exits 2 and prints no result."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RUN = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from portbench import harness
from portbench.tests._small import small_cell_of
harness.cell_of = small_cell_of
result, _ = harness.run_cell({root!r}, {name!r}, 5, 0.2, {trace}, "cpu")
print(json.dumps({{"correct": result["correct"],
                  "forbidden": harness.forbidden_modules(),
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _python(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name,trace", [("merger2h-1e5", False),
                                        ("datagen-cfg5c-b256", True)])
def test_a_run_loads_neither_jax_nor_the_jax_package(name, trace):
    got = _python(RUN.format(root=ROOT, name=name, trace=trace))
    assert got["correct"]
    assert got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "cluster_generator_tpu"} & set(
        got["tops"])
    # the port itself is loaded: its name begins with the JAX package's
    assert "cluster_generator_tpu_torch" in got["tops"]


def test_the_reference_loads_nothing_of_the_port():
    got = _python(
        "import json, sys\n"
        "import portbench.reference.paths, portbench.reference.compare\n"
        "import portbench.traffic_gen.merger_halos\n"
        "import portbench.traffic_gen.ensemble_params\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not {"cluster_generator_tpu_torch", "cluster_generator_tpu",
                "jax"} & set(got)


def test_run_without_a_card_exits_2_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "merger2h-1e7",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr

"""The port's multi-device dry run on the CPU.

``dryrun_multichip(4)`` starts its own four gloo processes (a (2, 2) mesh)
and runs the six steps of ``__graft_entry__.dryrun_multichip``: the
ens-sharded build with DFs, the sharded merger draw, a cross-mesh
reduction, the sharded Gadget export (files, read back), the cfg5c and cfg6
batches over ``ens``, and the sharded field with its rms and divergence
checks.  It exits cleanly.  In a world of one, without a directory for the
files, the step builds and checks the Gadget blocks instead (the path of a
machine without ``h5py``).
"""

import os
import subprocess
import sys

from tests.test_torch_parallel_fft import ROOT, finish_world, start_world

_STEP = """
from cluster_generator_tpu_torch.parallel.dryrun import dryrun_step
from cluster_generator_tpu_torch.parallel.mesh import make_mesh
seconds = dryrun_step(make_mesh(device_type="cpu"), None)
RESULT["steps"] = np.asarray(list(seconds))
"""


def test_dryrun_multichip_four_cpu_ranks(tmp_path):
    handle = start_world(tmp_path / "w1", 1, _STEP)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", "from cluster_generator_tpu_torch.parallel."
         "dryrun import dryrun_multichip; dryrun_multichip(4)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (one,) = finish_world(handle)
    assert list(one["steps"]) == ["ensemble", "merger_draw", "reduction",
                                  "export", "datagen", "grf"]

"""bench_torch.py, the port's headline benchmark, on the CPU: it stays
runnable, prints exactly one JSON line with its keys, and never falls back
to the CPU when the card is asked for and absent."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "bench_torch.py")
KEYS = {"metric", "value", "unit", "vs_baseline", "aot", "first_run_s",
        "backend", "device", "program", "peak_mem_gib", "k1_launches"}


def _bench(tmp_path, *args, **env):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", **env)
    return subprocess.run([sys.executable, SCRIPT, *args], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_bench_smoke_on_the_cpu(tmp_path):
    res = _bench(tmp_path, "--device", "cpu", BENCH_SMOKE="1")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, res.stdout
    rec = json.loads(lines[0])
    assert set(rec) == KEYS
    assert rec["metric"] == "binary_merger_ic_1e7_particles_wall_time"
    assert rec["unit"] == "s" and rec["value"] > 0
    assert rec["vs_baseline"] == 5.0 / rec["value"]
    assert rec["aot"] is False and rec["first_run_s"] > 0
    assert rec["backend"] == "cpu" and rec["device"] == "cpu"
    assert rec["program"] == "eager"
    assert rec["peak_mem_gib"] is None
    # the CPU runs the kernel's plain version: no launch
    assert rec["k1_launches"] == 0
    assert "warm trial 2" in res.stderr


def test_bench_without_a_card_raises(tmp_path):
    res = _bench(tmp_path, CUDA_VISIBLE_DEVICES="", BENCH_SMOKE="1")
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
    assert res.stdout == ""

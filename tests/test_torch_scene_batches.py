"""The merger-scene batches (``parallel.mergers.merger_scene_batches`` and
its program ``_SceneBatch``) as the cell ``scenes-cfg6-b64`` drives them,
on the CPU at a small size.

* ``_SceneBatch.run`` marks its stages as the merger's body does: models,
  dfs, models, dfs, models, end; tables, end; draws, end.
* ``merger_scene_batches`` names each batch's slice and generator
  ``cg.host.inputs``, as ``datagen_batches`` does.
* The reference's uniforms, each site drawn whole at ``(B, n)``, are
  ``pipeline.merger_uniforms``' numbers.
* Each scene's gas mixes over its own halos only: changing another
  scene's halos leaves it as it was, bit for bit.
* The cell at a small size, run by the benchmark's harness against
  ``portbench/reference/scenes.py``.
"""

import copy

import torch
from torch.profiler import ProfilerActivity, profile

from cluster_generator_tpu_torch import pipeline as P
from cluster_generator_tpu_torch.core import profiling
from cluster_generator_tpu_torch.parallel import mergers as MG
from portbench.reference import scenes as R
from tests.test_torch_tracing import ORDER, _spans

torch.set_num_threads(2)

COUNTS = {"gas": (200, 150), "dm": (250, 200), "star": (50, 40)}
SCENES = dict(M200=[[1.2e15, 6e14], [8e14, 4e14], [1.5e15, 1.4e15]],
              conc=[[4.2, 5.0], [4.6, 5.4], [4.0, 4.1]],
              centers=[[[-1200.0, -200.0, 0], [1200.0, 200.0, 0]],
                       [[-1500.0, 0, 0], [1500.0, 0, 0]],
                       [[-1000.0, 300.0, 0], [1000.0, -300.0, 0]]],
              velocities=[[[0.3, 0, 0], [-0.6, 0, 0]],
                          [[0.4, 0, 0], [-0.8, 0, 0]],
                          [[0.5, 0, 0], [-0.5, 0, 0]]])


def _batch():
    return MG._SceneBatch(128, COUNTS["gas"], COUNTS["dm"], COUNTS["star"],
                          device="cpu")


def _run(scenes, uniforms):
    t = {k: torch.tensor(v, dtype=torch.float64) for k, v in scenes.items()}
    return _batch().run(t["M200"], t["conc"], t["centers"], t["velocities"],
                        torch.tensor([5000.0, 5000.0], dtype=torch.float64),
                        uniforms=uniforms)


def test_a_scene_batch_marks_its_stages_as_the_merger_does(monkeypatch):
    got = []
    monkeypatch.setattr(profiling, "_mark",
                        lambda name, device: got.append(name))
    _run(SCENES, None)
    assert got == ORDER
    assert profiling._open_stages() == []


def test_each_batch_names_its_inputs():
    params = {k: torch.tensor(v, dtype=torch.float64)
              for k, v in SCENES.items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [b0 for b0, _ in MG.merger_scene_batches(
            params, COUNTS, batch_size=2, num_points=64, seed=3,
            device="cpu")]
    assert got == [0, 2]
    names = [s[0] for s in _spans(prof)]
    assert names.count("cg.host.inputs") == 2


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_the_references_uniforms_are_the_programs():
    B = 3
    want = P.merger_uniforms(torch.Generator().manual_seed(5), (B,),
                             COUNTS["gas"], COUNTS["dm"], COUNTS["star"],
                             device="cpu")
    got = R.uniforms(torch.Generator().manual_seed(5), B, COUNTS)
    assert list(got) == list(want)
    for (kind, halo), u in want.items():
        a, b = _leaves(u), _leaves(got[kind, halo])
        assert len(a) == len(b) == (3 if kind == "gas" else 7)
        for x, y in zip(a, b):
            assert x.shape == (B, COUNTS[kind][halo])
            assert torch.equal(x, y), (kind, halo)


def test_each_scene_mixes_its_gas_over_its_own_halos_only():
    uni = P.merger_uniforms(torch.Generator().manual_seed(9), (3,),
                            COUNTS["gas"], COUNTS["dm"], COUNTS["star"],
                            device="cpu")
    before = _run(SCENES, uni)
    other = copy.deepcopy(SCENES)
    other["M200"][1] = [1.1e15, 2e14]
    other["conc"][1] = [4.4, 6.0]
    other["centers"][1] = [[-2500.0, 400.0, 0], [2500.0, -400.0, 0]]
    other["velocities"][1] = [[0.2, 0, 0], [-1.1, 0, 0]]
    after = _run(other, uni)
    gas = [k for k in before if k.startswith("gas_")]
    assert gas == ["gas_position", "gas_velocity", "gas_thermal_energy",
                   "gas_density"]
    for k in gas:
        for b in (0, 2):
            assert torch.equal(before[k][b], after[k][b]), (k, b)
        assert not torch.equal(before[k][1], after[k][1]), k


def test_the_cell_at_a_small_size_is_correct_against_the_reference(
        monkeypatch):
    from portbench.tests._small_scenes import run_small_scenes

    result, lines = run_small_scenes(monkeypatch, trace=True)
    assert result["correct"], lines
    assert result["attempted"] == 3 and result["failed"] == 0
    # the host's own work of a call, its slice and generator among it
    assert result["metrics"]["host_ms_per_call.scenes"]["value"] > 0.0

"""What a card keeps between program calls (``core/compiled.py``): the
release policy as plain functions, with programs and workspaces standing
in for captured ones and an injected memory probe (programs do not capture
on the CPU).

* :func:`compiled.make_room` releases the least recently used programs and
  workspaces first, across memos and workspaces, never the caller's own,
  and only those of the card that needs the room;
* the factory caches of the batch programs keep no released program alive;
* an out-of-memory error is retried once, after everything else of the
  card is released, and then raised, with nothing run in between: a
  warm-up from the generator's state of its first attempt, a capture
  alone (a warm-up that ran through never runs twice);
* a program captured again makes room for its warm-up first;
* :data:`compiled.MAX_PROGRAMS` still bounds each memo;
* the package's eager steps (the inventory in PERF.md) make room for the
  bytes they reckon before they allocate (:func:`compiled.room_for`),
  least recently used first; one that fits makes no sync and releases
  nothing; ``_combine`` moves the particles once however its steps make
  room; a release changes no result.

On the card: tests/test_torch_cuda.py (two programs, and a workspace
before an eager join, under a memory fraction) and ``chip_smoke.py``
phase 25.
"""

import math
import types
import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cluster_generator_tpu_torch import codes as TC
from cluster_generator_tpu_torch import particles as TP
from cluster_generator_tpu_torch import pipeline as TPL
from cluster_generator_tpu_torch.core import compiled as C
from cluster_generator_tpu_torch.fields import grf as TG
from cluster_generator_tpu_torch.parallel import ensemble as TE
from cluster_generator_tpu_torch.parallel import export as TX
from cluster_generator_tpu_torch.parallel import mergers as TM

torch.set_num_threads(1)

CARD0, CARD1 = torch.device("cuda", 0), torch.device("cuda", 1)
MIB = 2 ** 20


@pytest.fixture(autouse=True)
def _fresh_memo():
    C.clear()
    yield
    C.clear()


def _program(name, device, nbytes):
    """A memoized program standing in for one captured on ``device``: its
    static buffers and pool ``nbytes`` in all; used now."""
    p = C.program((name, nbytes), lambda *a: a[0], (torch.zeros(1),))
    p.device, p.static_bytes, p.pool_bytes = device, nbytes // 4, \
        nbytes - nbytes // 4
    return p


def _workspace(name, device, nbytes):
    """A workspace standing in for one on ``device``, with one program."""
    ws = C.workspace(name, 0, "cpu", lambda: torch.zeros(1))
    ws.device = device
    p = C.Program(("in", name), None, 1, ws)
    p.device, p.static_bytes, p.pool_bytes = device, 0, nbytes - 4
    ws.programs[p.key] = p
    return ws


def _probe(device, free):
    """What ``device`` can allocate: ``free`` plus the bytes released
    since (a program's pool goes back to the card with it)."""
    start = sum(h.nbytes for h in C.held(device))
    return lambda: free + start - sum(h.nbytes for h in C.held(device))


def test_releases_least_recent_first_across_memos_and_workspaces():
    a = _program("a", CARD0, 100 * MIB)
    ws = _workspace("w", CARD0, 300 * MIB)
    b = _program("b", CARD0, 200 * MIB)
    a2 = _program("a", CARD0, 50 * MIB)
    assert [h.what for h in C.held(CARD0)] == [a, ws, b, a2]
    assert C.held(CARD0)[1].nbytes == 300 * MIB   # buffers and programs
    # a is used again: ws is now the least recent
    assert C.program(("a", 100 * MIB), None, (torch.zeros(1),)) is a
    before = C.releases
    gone = [weakref.ref(ws), weakref.ref(b), weakref.ref(
        next(iter(ws.programs.values())))]
    del ws, b
    n = C.make_room(450 * MIB, CARD0, free=_probe(CARD0, 0))
    assert n == 2 and C.releases == before + 2   # ws (300), then b (200)
    assert [h.what for h in C.held(CARD0)] == [a2, a]
    assert C.workspaces() == []
    # freed at once, the workspace with its program (no reference cycle)
    assert [r() for r in gone] == [None] * 3
    # room enough: nothing goes
    assert C.make_room(10 * MIB, CARD0, free=_probe(CARD0, 20 * MIB)) == 0
    assert len(C.held(CARD0)) == 2


def test_never_releases_the_caller_or_its_workspace():
    _workspace("w", CARD0, 300 * MIB)
    p = _program("p", CARD0, 100 * MIB)
    _program("q", CARD0, 100 * MIB)
    assert C.make_room(math.inf, CARD0, keep=(p,),
                       free=_probe(CARD0, 0)) == 2
    assert [h.what for h in C.held(CARD0)] == [p]
    ws = _workspace("w", CARD0, 300 * MIB)
    own = next(iter(ws.programs.values()))
    _program("q", CARD0, 100 * MIB)
    assert C.make_room(math.inf, CARD0, keep=(own, ws),
                       free=_probe(CARD0, 0)) == 2   # p and q
    assert [h.what for h in C.held(CARD0)] == [ws]


def test_leaves_another_card_alone():
    other = [_program("x", CARD1, 500 * MIB), _workspace("w", CARD1, MIB)]
    mine = _program("x", CARD0, 100 * MIB)
    assert C.make_room(math.inf, CARD0, free=_probe(CARD0, 0)) == 1
    assert C.held(CARD0) == []
    assert [h.what for h in C.held(CARD1)] == other
    assert [h.what for h in C.held()] == other and mine.device == CARD0


def _batches():
    """The three factories' batch objects, each called once on the CPU (a
    memoized program each)."""
    M, c = TE.sample_ensemble_params(torch.Generator().manual_seed(5), 2,
                                     device="cpu")
    full = TE._datagen_full_batch_fn(64, 60, 40, 20)
    full(M, c, torch.Generator().manual_seed(0))
    dm = TE._datagen_batch_fn(64, 60)
    dm(M, c, torch.Generator().manual_seed(0))
    p = TM.sample_merger_scene_params(torch.Generator().manual_seed(6), 2,
                                      device="cpu")
    scenes = TM._merger_batch_fn(64, (40, 40), (50, 50), (10, 10),
                                 device="cpu")
    scenes(*TM._scene_inputs(p, torch.device("cpu")), [5000.0] * 2,
           torch.Generator().manual_seed(0))
    return full, dm, scenes


def test_factory_caches_keep_no_released_program():
    batches = _batches()
    progs = C.programs()
    assert sorted(p.key[0][0] for p in progs) == [
        "datagen", "datagen", "scene_batch"]
    for p in progs:
        p.device = CARD0
    refs = [weakref.ref(p) for p in progs]
    del progs, p
    assert C.make_room(math.inf, CARD0, free=lambda: 0) == 3
    # released while the factories' caches still hold the batch objects
    assert TE._datagen_full_batch_fn(64, 60, 40, 20) is batches[0]
    assert TE._datagen_batch_fn(64, 60) is batches[1]
    assert TM._merger_batch_fn(64, (40, 40), (50, 50), (10, 10),
                               device="cpu") is batches[2]
    assert [r() for r in refs] == [None] * 3


def _out_of_memory():
    return torch.cuda.OutOfMemoryError("CUDA out of memory (a stand-in)")


def test_out_of_memory_is_retried_once_then_raised(monkeypatch):
    monkeypatch.setattr(C, "free_bytes", lambda device, empty=True: 0)
    calls = []

    def once(n):
        def fn():
            calls.append(len(C.held(CARD0)))
            if len(calls) <= n:
                raise _out_of_memory()
            return "done"
        return fn

    keep = _program("keep", CARD0, MIB)
    _program("other", CARD0, MIB)
    _workspace("w", CARD1, MIB)
    retries = C.retries
    assert C.retrying(once(1), CARD0, (keep,)) == "done"
    # the second attempt ran with all but the caller released; the other
    # card untouched
    assert calls == [2, 1] and C.retries == retries + 1
    assert [h.what for h in C.held(CARD0)] == [keep]
    assert len(C.held(CARD1)) == 1
    calls.clear()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        C.retrying(once(2), CARD0, (keep,))
    assert calls == [1, 1]
    # only that error is caught
    calls.clear()

    def other():
        calls.append(0)
        raise RuntimeError("not memory")

    with pytest.raises(RuntimeError, match="not memory"):
        C.retrying(other, CARD0)
    assert calls == [0]


def _first_call(monkeypatch, prog, warm_up, capture):
    """``prog``'s first call with stand-ins for its warm-up and capture
    (``warm_up(inputs, draw) -> outputs``, ``capture()``), no room to
    spare on the card, and no eager body to run."""
    monkeypatch.setattr(C, "free_bytes", lambda device, empty=True: 0)

    def warm(side, cur, inputs, draw):
        out = warm_up(inputs, draw)
        prog.inputs, prog.uniforms = tuple(inputs), None
        return out, 0

    def capt(side):
        capture()
        prog.static_bytes, prog.pool_bytes = 0, 2 * MIB

    monkeypatch.setattr(prog, "_warm_up", warm)
    monkeypatch.setattr(prog, "_capture", capt)
    return lambda inputs, draw: prog._first(None, None, inputs, draw)


def test_a_first_call_runs_again_from_its_generator_state(monkeypatch):
    """A warm-up's retry draws the same uniforms again, and nothing (no
    eager body, no CPU route) runs between the two attempts."""
    prog = _program("first", CARD0, MIB)
    _program("other", CARD0, MIB)
    gen = torch.Generator().manual_seed(3)
    draw = C.drawer(None, gen, "cpu", lambda g, out: torch.rand(
        4, generator=g))
    drawn, eager = [], C.eager_calls

    def warm_up(inputs, draw):
        drawn.append(draw(None))
        if len(drawn) == 1:
            raise _out_of_memory()
        return warmed

    warmed = torch.ones(2)
    prog.body = None   # any eager run would fail
    first = _first_call(monkeypatch, prog, warm_up, lambda: None)
    assert first((torch.zeros(1),), draw) is warmed
    assert len(drawn) == 2 and torch.equal(drawn[0], drawn[1])
    assert C.eager_calls == eager
    assert [h.what for h in C.held(CARD0)] == [prog]
    drawn.clear()

    def failing(inputs, draw):
        drawn.append(1)
        raise _out_of_memory()

    first = _first_call(monkeypatch, prog, failing, lambda: None)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        first((torch.zeros(1),), draw)
    assert drawn == [1, 1]


def test_a_capture_runs_again_without_its_warm_up(monkeypatch):
    """A capture that runs out of memory runs once more alone: a warm-up
    that wrote a buffer shared in place ran once; a second failure
    raises."""
    prog = _program("inplace", CARD0, MIB)
    prog.inplace = 1
    _program("other", CARD0, MIB)
    buf, captures = torch.zeros(4), []

    def warm_up(inputs, draw):
        inputs[0].add_(1.0)   # the body's write in place
        return inputs[0]

    def capture(fail):
        captures.append(len(C.held(CARD0)))
        if len(captures) <= fail:
            raise _out_of_memory()

    first = _first_call(monkeypatch, prog, warm_up, lambda: capture(1))
    assert first((buf,), C.drawer(None, None, "cpu", None)) is buf
    assert torch.equal(buf, torch.ones(4))   # the body ran once
    # the second capture with the other program released
    assert captures == [2, 1]
    captures.clear()
    first = _first_call(monkeypatch, prog, warm_up, lambda: capture(2))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        first((buf,), C.drawer(None, None, "cpu", None))
    assert torch.equal(buf, torch.full((4,), 2.0)) and captures == [1, 1]


def test_a_program_captured_again_makes_room_for_its_warm_up(monkeypatch):
    """After a release, a program's next first call makes room for what
    its last capture held before its warm-up runs."""
    prog = _program("again", CARD0, MIB)
    other = _program("other", CARD0, 4 * MIB)
    seen = []
    first = _first_call(monkeypatch, prog, lambda inputs, draw: seen.append(
        [h.what for h in C.held(CARD0)]), lambda: None)
    first((torch.zeros(1),), C.drawer(None, None, "cpu", None))
    assert seen == [[prog, other]]   # no need known yet: nothing released
    monkeypatch.setattr(C, "free_bytes", lambda device, empty=True: (
        MIB if other in [h.what for h in C.held(CARD0)] else 2 * MIB))
    seen.clear()
    first((torch.zeros(1),), C.drawer(None, None, "cpu", None))
    assert seen == [[prog]]          # its 2 MiB: other went first


def test_free_bytes_is_within_the_memory_fraction(monkeypatch):
    synced = []
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: synced.append(1))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (60 * MIB, 100 * MIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 30 * MIB)
    monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction",
                        lambda d: 1.0)
    assert C.free_bytes(CARD0) == 60 * MIB   # the card's free memory
    assert len(synced) == 2
    monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction",
                        lambda d: 0.5)
    assert C.free_bytes(CARD0) == 20 * MIB   # 50 allowed, 30 reserved
    # a need that fits beside the cache: no synchronisation, no release
    synced.clear()
    _program("p", CARD0, MIB)
    assert C.make_room(20 * MIB, CARD0) == 0 and synced == []
    assert C.make_room(21 * MIB, CARD0) == 1 and len(synced) == 4


def test_each_memo_stays_bounded():
    progs = [_program("m", CARD0, (i + 1) * MIB)
             for i in range(C.MAX_PROGRAMS + 3)]
    names = [h.what.key[0][0] for h in C.held(CARD0)]
    assert names == ["m"] * C.MAX_PROGRAMS
    assert [h.what for h in C.held(CARD0)] == progs[3:]
    assert C.make_room(0, CARD0, free=lambda: 0) == 0   # nothing needed


# ------------------------------------------------ the package's eager steps
F64 = torch.float64
N = 64   # particles per type of the stand-in containers


def _container(seed, ptypes=("gas", "dm"), n=N):
    """Particles on the CPU standing in for a card's: positions in a box
    of 100 kpc, and the gas's density and thermal energy."""
    g = torch.Generator().manual_seed(seed)
    fields = {}
    for pt in ptypes:
        fields[pt, "particle_position"] = torch.rand(
            n, 3, generator=g, dtype=F64) * 100.0
        fields[pt, "particle_velocity"] = torch.randn(n, 3, generator=g,
                                                      dtype=F64)
        fields[pt, "particle_mass"] = torch.rand(n, generator=g, dtype=F64)
        if pt == "gas":
            for name in ("density", "thermal_energy"):
                fields[pt, name] = torch.rand(n, generator=g, dtype=F64)
    return TP.ClusterParticles(list(ptypes), fields)


def _bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class _Allocations(TorchDispatchMode):
    """Logs ``("alloc", op)`` for each op whose output is a new tensor (no
    input's storage) of at least ``numel`` elements."""

    def __init__(self, log, numel):
        super().__init__()
        self.log, self.numel = log, numel

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {t.untyped_storage().data_ptr()
               for t in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.numel() >= self.numel
                    and t.untyped_storage().data_ptr() not in ins):
                self.log.append(("alloc", str(func)))
        return out


def _on_card(monkeypatch, free, log=None):
    """The CPU tensors stand in for CARD0's: ``room_for`` makes room there,
    ``free`` bytes free plus what each release gives back (the injected
    probe); ``log`` gets ``("room", need)`` for each ``make_room``."""
    monkeypatch.setattr(C, "card", lambda device: CARD0)
    probe = _probe(CARD0, free)
    monkeypatch.setattr(C, "free_bytes", lambda device, empty=True: probe())
    if log is not None:
        real = C.make_room

        def make_room(need, device, keep=(), free=None):
            log.append(("room", need))
            return real(need, device, keep, free)

        monkeypatch.setattr(C, "make_room", make_room)


def _gadget_need(p, dtype=torch.float32):
    """What ``gadget_blocks`` reckons per type, every particle in the box:
    masks, index, the blocks, the two float64 temporaries of the largest,
    the IDs (int64, int32)."""
    out = []
    for pt in p.particle_types:
        n = p.num_particles[pt]
        blocks = [p[pt, f] for f in ("particle_position",
                                     "particle_velocity", "particle_mass",
                                     "thermal_energy", "density")
                  if (pt, f) in p.fields]
        largest = max(t.numel() for t in blocks)
        out.append(10 * n + 8 * n + 8 * n + 4 * n
                   + sum(t.numel() for t in blocks) * dtype.itemsize
                   + 2 * 8 * largest)
    return out


def _site_add():
    a, b = _container(1), _container(2, ("dm", "star"))
    need = [2 * _bytes(*(a["dm", f] for f in ("particle_position",
                                              "particle_velocity",
                                              "particle_mass")))]
    return lambda: a + b, need


def _site_add_offsets():
    p = _container(3)
    need = [_bytes(*(p[pt, f] for pt in ("gas", "dm")
                     for f in ("particle_position", "particle_velocity")))]
    return lambda: p.add_offsets([10.0, 0, 0], [1.0, 0, 0]), need


def _site_radial_cut():
    p = _container(4)
    need = [2 * _bytes(p[pt, "particle_position"]) + N
            + _bytes(*(p[pt, f] for f in p.field_names[pt]))
            for pt in ("gas", "dm")]
    return lambda: p.make_radial_cut(80.0, center=[50.0] * 3), need


def _site_gadget_blocks():
    p = _container(5)
    return lambda: p.gadget_blocks(100.0), _gadget_need(p)


def _site_conversions():
    g = torch.Generator().manual_seed(6)
    fields = {("dm", "particle_position"): torch.rand(N, 3, generator=g),
              ("dm", "particle_mass"): torch.rand(N, generator=g),
              ("dm", "particle_index"): torch.arange(N).to(torch.uint32)}
    # float32 to float64, the unsigned IDs widened to int64
    need = [N * 3 * 8, N * 8, N * 8]
    return lambda: TP.ClusterParticles(["dm"], fields), need


def _site_set_field_units():
    p = _container(7)
    value = torch.rand(N, dtype=F64)
    return (lambda: p.set_field("dm", "metallicity", value, units="Msun"),
            [N * 8])


def _site_arepo_background():
    p = _container(8, ("gas",))
    nx = 8
    need = [nx ** 3 * (4 * 24 + 3 * 8 + 1)]
    return (lambda: TC._arepo_background([[50.0] * 3], [30.0], 100.0, nx,
                                         p), need)


def _site_amr_fortran(tmp_path):
    p = _container(9, ("dm", "star"))
    cols = [_bytes(p["dm", f], p["star", f]) for f in TC._AMR_FIELDS]
    need = [2 * c for c in cols] + [sum(cols)]
    return (lambda: TC.write_amr_particles(
        p, tmp_path / "p.dat", ["dm", "star"], {"dm": 1, "star": 2},
        in_cgs=True, format="fortran"), need)


def _stand_in_field(dtype):
    g = torch.Generator().manual_seed(10)
    x = torch.linspace(0.0, 100.0, 8, dtype=dtype)
    comps = [torch.randn(8, 8, 8, generator=g, dtype=dtype)
             for _ in range(3)]
    return types.SimpleNamespace(x=x, y=x, z=x, gx=comps[0], gy=comps[1],
                                 gz=comps[2], _name="magnetic_field")


def _site_attach_field():
    parts = {("gas", "particle_position"): torch.rand(
        N, 3, generator=torch.Generator().manual_seed(11), dtype=F64) * 100}
    field = _stand_in_field(torch.float32)
    # the stack in float32, its cast to float64
    need = [3 * 512 * 4 + 3 * 512 * 8]
    return lambda: TPL.attach_field_to_particles(parts, field), need


def _site_map_field():
    p = _container(12)
    field = TG.RandomMagneticField([0.0] * 3, [100.0] * 3, (8,) * 3, 20.0,
                                   80.0, 1e-6, prng=3, device="cpu")
    grid = field.gx.numel() * field.gx.element_size()
    # the stacked field; the values scaled, then converted to gauss
    need = [3 * grid, N * 3 * 8, N * 3 * 8]
    return (lambda: field.map_field_to_particles(p, units="uG"), need)


def _site_export_plan():
    parts = {}
    g = torch.Generator().manual_seed(13)
    for pt in ("gas", "dm"):
        parts[pt, "particle_position"] = torch.rand(N, 3, generator=g) * 50
        parts[pt, "particle_velocity"] = torch.randn(N, 3, generator=g)
        parts[pt, "particle_mass"] = torch.rand(N, generator=g)
    # the container's float64 copies (one room each), the moved positions,
    # then per type the float64 positions moved, and the in-box masks
    need = ([N * 3 * 8, N * 3 * 8, N * 8] * 2 + [2 * N * 3 * 8]
            + [2 * N * 3 * 8 + 10 * N] * 2)
    return (lambda: TX._export_plan(parts, 100.0, center_offset=[25.0] * 3),
            need)


SITES = {"add": _site_add, "add_offsets": _site_add_offsets,
         "make_radial_cut": _site_radial_cut,
         "gadget_blocks": _site_gadget_blocks,
         "container_conversions": _site_conversions,
         "set_field_units": _site_set_field_units,
         "arepo_background": _site_arepo_background,
         "amr_fortran": _site_amr_fortran,
         "attach_field": _site_attach_field, "map_field": _site_map_field,
         "export_plan": _site_export_plan}


@pytest.mark.parametrize("site", sorted(SITES))
def test_an_eager_site_makes_room_for_its_need_before_it_allocates(
        monkeypatch, tmp_path, site):
    """Each reckonable site of the inventory asks ``make_room`` for the
    bytes it reckons before its first allocation in proportion to the
    particles or the grid, and the least recently used program goes
    first."""
    make = SITES[site]
    fn, need = make(tmp_path) if site == "amr_fortran" else make()
    _program("old", CARD0, sum(need))
    new = _program("new", CARD0, sum(need))
    log = []
    _on_card(monkeypatch, 0, log)
    with _Allocations(log, N):
        fn()
    rooms = [n for kind, n in log if kind == "room"]
    assert rooms == need, site
    assert log[0][0] == "room", (site, log[:3])
    assert [h.what for h in C.held(CARD0)] == [new]   # "old" went first


def test_an_eager_step_that_fits_makes_no_sync_and_releases_nothing(
        monkeypatch):
    synced = []
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: synced.append(1))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (60 * MIB, 100 * MIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 30 * MIB)
    monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction",
                        lambda d: 1.0)
    monkeypatch.setattr(C, "card", lambda device: CARD0)
    a, b = _container(14), _container(15)
    _program("held", CARD0, MIB)
    before = C.releases
    joined = a + b
    joined.add_offsets([1.0] * 3, [0.0] * 3)
    joined.gadget_blocks(200.0)
    assert synced == [] and C.releases == before
    assert len(C.held(CARD0)) == 1
    # the same join where it does not fit beside the cache (read anew: the
    # last reading has expired): one sync and empty per reading, and the
    # program goes
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (1024, 100 * MIB))
    C._READINGS.clear()
    a + b
    assert synced and C.releases == before + 1


def test_a_recent_reading_spares_the_eager_steps_a_read(monkeypatch):
    """An eager step reads the card's free memory (``cudaMemGetInfo``)
    only when no reading under ``READING_SECONDS`` old covers its need,
    less what this process reserved since and within the memory fraction
    now; each reading is recorded."""
    read, reserved, now = [], [30 * MIB], [100.0]
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: read.append(1) or (60 * MIB, 100 * MIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda d: reserved[0])
    monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction",
                        lambda d: 1.0)
    monkeypatch.setattr(C.time, "monotonic", lambda: now[0])

    def step(nbytes):
        return C.room_for(CARD0, (nbytes, torch.uint8))

    assert step(10 * MIB) == 0 and read == [1]       # no reading yet
    assert step(50 * MIB) == 0 and read == [1]       # 60 MiB free, read
    reserved[0] = 45 * MIB                           # 45 left by estimate
    assert step(50 * MIB) == 0 and read == [1, 1]    # not covered: read
    assert step(10 * MIB) == 0 and len(read) == 2
    now[0] += 2 * C.READING_SECONDS                  # the reading expired
    assert step(10 * MIB) == 0 and len(read) == 3
    monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction",
                        lambda d: 0.5)               # 5 MiB under the cap
    assert step(10 * MIB) == 0 and len(read) > 3     # nothing to release


def _hses():
    """Two halos' radius, density and pressure grids."""
    rr = torch.logspace(-1, 4, 128, dtype=F64)
    return [{"radius": rr, "density": 1e7 / (1 + rr / s) ** 3,
             "pressure": 1e3 / (1 + rr / s) ** 4} for s in (200.0, 300.0)]


def test_combine_moves_the_particles_once_when_room_is_made_midway(
        monkeypatch):
    """``_combine`` makes room step by step: here its sum needs the room
    its moves did not, and a join while a program still holds the card
    runs out of memory.  Every particle moves to its halo once (a
    ``_combine`` that ran its whole body again under ``retrying`` would
    move them twice)."""
    parts = [_container(16), _container(17)]
    want = {(i, pt): p[pt, "particle_position"].clone()
            for i, p in enumerate(parts) for pt in ("gas", "dm")}
    centers = [[100.0, 0.0, 0.0], [-100.0, 0.0, 0.0]]
    velocities = [[0.5, 0.0, 0.0], [-0.5, 0.0, 0.0]]
    moves = max(_bytes(*(p[pt, f] for pt in ("gas", "dm")
                         for f in ("particle_position",
                                   "particle_velocity"))) for p in parts)
    held = _program("held", CARD0, 100 * MIB)
    _on_card(monkeypatch, moves)
    cat = torch.cat

    def join(tensors, *args, **kwargs):
        if C.held(CARD0):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (a "
                                              "stand-in)")
        return cat(tensors, *args, **kwargs)

    monkeypatch.setattr(torch, "cat", join)
    out = TP._combine(parts, _hses(), centers, velocities)
    assert held.device == CARD0 and C.held(CARD0) == []
    for pt in ("gas", "dm"):
        expect = cat([want[0, pt] + torch.tensor(centers[0], dtype=F64),
                      want[1, pt] + torch.tensor(centers[1], dtype=F64)])
        assert torch.equal(out[pt, "particle_position"], expect), pt


def _export(p, box=200.0):
    blocks, _, _ = p.gadget_blocks(box)
    return [a for arrays in blocks.values() for a in arrays.values()]


def test_a_release_changes_no_result(monkeypatch):
    """The eager steps after a release equal the same steps with room to
    spare, bit for bit."""
    def run():
        a, b = _container(18), _container(19, ("dm", "star"))
        joined = a + b
        joined.add_offsets([50.0] * 3, [0.0] * 3)
        joined.make_radial_cut(120.0, center=[100.0] * 3)
        return [t.clone() for t in joined.fields.values()], _export(joined)

    _on_card(monkeypatch, 1 << 40)
    _program("spare", CARD0, MIB)
    before = C.releases
    roomy = run()
    assert C.releases == before
    _on_card(monkeypatch, 0)
    tight = run()
    assert C.releases == before + 1
    assert all(torch.equal(x, y) for x, y in zip(roomy[0], tight[0]))
    assert all(np.array_equal(x, y) for x, y in zip(roomy[1], tight[1]))

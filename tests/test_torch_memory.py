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
* :data:`compiled.MAX_PROGRAMS` still bounds each memo.

On the card: tests/test_torch_cuda.py (two programs under a memory
fraction) and ``chip_smoke.py`` phase 25.
"""

import math
import weakref

import pytest
import torch

from cluster_generator_tpu_torch.core import compiled as C
from cluster_generator_tpu_torch.parallel import ensemble as TE
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

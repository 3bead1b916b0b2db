"""The datagen draws' wrappers (``ops.draw_particles``) on the CPU.

On the CPU each wrapper runs its plain version.  Both are held here, bit
for bit, against the draws as ``_DatagenProgram._collisionless`` and
``_gas`` read before their bodies moved into ``ops.draw_particles``, on the
program's own tables at a small size (with and without an Osipkov-Merritt
radius) and on synthetic tables with uniforms at their edges.  The CUDA
kernel itself is held against the plain version in
tests/test_torch_cuda.py, which needs a card.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from cluster_generator_tpu_torch.core.draws import (
    collisionless_uniforms,
    gas_uniforms,
    node_lerp,
    radial_draw,
    velocity_draw,
)
from cluster_generator_tpu_torch.core.interp import loguniform_lerp
from cluster_generator_tpu_torch.ops import draw_particles as D
from cluster_generator_tpu_torch.parallel import ensemble as E
from cluster_generator_tpu_torch.virial import sample_speeds_joint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the card's edge cases, built on the CPU)

torch.set_num_threads(1)
F32 = torch.float32
CPU = torch.device("cpu")


def _old_collisionless(self, t, n, gen, uniforms):
    """``_DatagenProgram._collisionless`` as it read before the kernel."""
    shape = (t["r_q"].shape[0], n)
    if uniforms is None:
        uniforms = collisionless_uniforms(gen, shape, torch.float32,
                                          t["r_q"].device)
    u_r, u_q, u_b, pos_dir, vel_dir = uniforms
    kq, wq, radius, rhat = radial_draw(t["r_q"], u_r, pos_dir)
    speed = sample_speeds_joint(t["joint"], kq, wq, uniforms=(u_q, u_b))
    v_esc = node_lerp(t["v_esc"], kq, wq)
    speed = torch.minimum(speed, v_esc.to(speed.dtype))
    vel = velocity_draw(speed, vel_dir, rhat, radius, self.r_a)
    return (radius[..., None] * rhat, vel,
            (t["mtot"] / n).to(torch.float32))


def _old_gas(self, f, t, n, gen, uniforms):
    """``_DatagenProgram._gas`` as it read before the kernel."""
    f32 = torch.float32
    shape = (t["r_q"].shape[0], n)
    if uniforms is None:
        uniforms = gas_uniforms(gen, shape, f32, t["r_q"].device)
    _, _, radius, rhat = radial_draw(t["r_q"], *uniforms)
    e_grid = (1.5 * f["pressure"] / f["density"]).to(f32)
    energy = loguniform_lerp(radius, f["radius"], e_grid)
    return radius[..., None] * rhat, energy, (t["mtot"] / n).to(f32)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(a, b))


def _with_edges(u, lo=0.0):
    """``u`` with entries at ``lo`` and one ulp below 1 in every row."""
    below_one = torch.nextafter(torch.tensor(1.0, dtype=F32),
                                torch.tensor(0.0, dtype=F32))
    u[:, 0] = lo
    u[:, 1] = below_one
    u[:, -1] = lo
    return u


def _edge_uniforms(u):
    """The program's uniforms with every array's rows at their edges
    (cos_theta at -1)."""
    out = {}
    for sp, us in u.items():
        if sp == "gas":
            u_r, (c, p) = us
            out[sp] = (_with_edges(u_r), (_with_edges(c, -1.0),
                                          _with_edges(p)))
        else:
            u_r, u_q, u_b, (pc, pp), (vc, vp) = us
            out[sp] = (_with_edges(u_r), _with_edges(u_q), _with_edges(u_b),
                       (_with_edges(pc, -1.0), _with_edges(pp)),
                       (_with_edges(vc, -1.0), _with_edges(vp)))
    return out


@pytest.fixture(scope="module", params=[None, 800.0],
                ids=["isotropic", "r_a=800"])
def batch(request):
    """A small full-species program's fields and draw tables for three
    clusters (128 points; DM 32 speed rows, 256 radius nodes; stars 16 and
    128), and its uniforms with edge entries."""
    prog = E._DatagenProgram(128, 3000, 2000, 700, n_rows=32, rq=256,
                             star_n_rows=16, star_rq=128, star_n_s=64,
                             star_n_q=64, r_a=request.param)
    M, c = E.sample_ensemble_params(torch.Generator().manual_seed(4), 3,
                                    device="cpu")
    f = prog.models(M, c)
    dtabs = prog.draw_tables(f, prog.speed_tables(f, prog.dfs(f)))
    u = _edge_uniforms(prog.uniforms(3, torch.Generator().manual_seed(5),
                                     CPU))
    return prog, f, dtabs, u


@pytest.mark.parametrize("sp", ["dm", "star", "gas"])
def test_the_program_draws_as_before_the_kernel(batch, sp):
    prog, f, dtabs, u = batch
    before = (D.draw_collisionless.launches, D.draw_gas.launches)
    n = prog.counts[sp]
    if sp == "gas":
        got = prog._gas(f, dtabs[sp], n, None, u[sp])
        want = _old_gas(prog, f, dtabs[sp], n, None, u[sp])
    else:
        got = prog._collisionless(dtabs[sp], n, None, u[sp])
        want = _old_collisionless(prog, dtabs[sp], n, None, u[sp])
    assert (D.draw_collisionless.launches, D.draw_gas.launches) == before
    assert got[0].shape == (3, n, 3) and _same(got, want)
    assert all(bool(torch.isfinite(t).all()) for t in got)


def test_the_program_draws_from_its_generator_as_before(batch):
    """No uniforms given: each species takes its draws from the generator
    in the order dm, star, gas, as before."""
    prog, f, dtabs, _ = batch
    got = prog.draws(f, dtabs, torch.Generator().manual_seed(8))
    gen = torch.Generator().manual_seed(8)
    want = {sp: _old_collisionless(prog, dtabs[sp], prog.counts[sp], gen,
                                   None) for sp in ("dm", "star")}
    want["gas"] = _old_gas(prog, f, dtabs["gas"], prog.counts["gas"], gen,
                           None)
    assert sorted(got) == ["dm", "gas", "star"]
    assert all(_same(got[sp], want[sp]) for sp in got)


def _call(case, fn):
    _, kind, args, r_a = case
    if kind == "collisionless":
        return fn["collisionless"](*args, r_a)
    return fn["gas"](*args)


WRAPPERS = {"collisionless": D.draw_collisionless, "gas": D.draw_gas}
PLAIN = {"collisionless": D.draw_collisionless_plain, "gas": D.draw_gas_plain}


def _old_chain(case):
    """A case through the old program bodies' lines."""
    _, kind, args, r_a = case
    if kind == "gas":
        u, r_q, grid_r, e_grid = args
        _, _, radius, rhat = radial_draw(r_q, *u)
        return (radius[..., None] * rhat,
                loguniform_lerp(radius, grid_r, e_grid))
    u, r_q, v_esc, joint = args
    t = {"r_q": r_q, "v_esc": v_esc, "joint": joint, "mtot": r_q[..., -1]}
    return _old_collisionless(SimpleNamespace(r_a=r_a), t, u[0].shape[-1],
                              None, u)[:2]


EDGE_CASES = chip_smoke.draw_edge_cases(CPU)


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_the_wrappers_on_the_cpu_give_the_old_chain_at_the_edges(case):
    before = WRAPPERS[case[1]].launches
    got = _call(case, WRAPPERS)
    assert WRAPPERS[case[1]].launches == before  # no kernel on the CPU
    assert _same(got, _call(case, PLAIN))
    assert _same(got, _old_chain(case))
    lead, n = case[2][0][0].shape[:-1], case[2][0][0].shape[-1]
    assert got[0].shape == lead + (n, 3)
    assert all(bool(torch.isfinite(t).all()) for t in got)


def test_a_cpu_tensor_runs_the_plain_version(monkeypatch):
    calls = []

    def spy(kind):
        real = PLAIN[kind]

        def run(*args):
            calls.append(kind)
            return real(*args)
        return run

    monkeypatch.setattr(D, "draw_collisionless_plain", spy("collisionless"))
    monkeypatch.setattr(D, "draw_gas_plain", spy("gas"))
    for case in EDGE_CASES[:3]:
        _call(case, WRAPPERS)
    assert calls == ["collisionless", "collisionless", "gas"]


def test_the_clamp_bounds_are_torchs_float32_scalars():
    """The kernel's node_index bound is the float32 that torch.clamp casts
    ``n - 1 - 1e-6`` to: a value far above it clamps to exactly that."""
    for n in (2, 40, 64, 256, 512, 2048, 4096):
        far = torch.tensor([1e9], dtype=F32)
        assert float(torch.clamp(far, 0.0, n - 1 - 1e-6)) == D._hi(n), n


@pytest.mark.parametrize("batch_,n", [(1, 1), (2, 100), (3, 1000),
                                      (256, 50_000), (64, 500_000),
                                      (256, 10_000)])
def test_a_block_takes_a_multiple_of_a_block_up_to_sixteen_a_thread(batch_,
                                                                   n):
    """The least multiple of 256 that gives the launch no more than
    about ``_TARGET_BLOCKS`` blocks' worth of particles each, within
    [256, 4096]."""
    chunk = D._chunk(batch_, n)
    assert chunk % 256 == 0 and 256 <= chunk <= 16 * 256
    total, target = batch_ * n, D._TARGET_BLOCKS
    assert chunk in (256, 16 * 256) or (
        (chunk - 256) * target < total <= chunk * target)
    assert (chunk == 16 * 256) == (total > 15 * 256 * target)


def test_the_wrappers_refuse_what_the_kernel_does_not_take():
    (_, _, (u, r_q, v_esc, joint), _), _, (_, _, g, _) = EDGE_CASES[:3]
    before = (D.draw_collisionless.launches, D.draw_gas.launches)
    with pytest.raises(TypeError, match="float32"):
        D.draw_collisionless(u, r_q.double(), v_esc, joint)
    with pytest.raises(TypeError, match="float32"):
        D.draw_gas(g[0], g[1], g[2].double(), g[3])
    with pytest.raises(ValueError, match="is on meta"):
        D.draw_collisionless(u, r_q, v_esc.to("meta"), joint)
    with pytest.raises(ValueError, match="contiguous"):
        D.draw_collisionless(u, r_q, v_esc, joint.transpose(-1, -2))
    bad_u = (u[0].t().contiguous().t(),) + u[1:]
    with pytest.raises(ValueError, match="contiguous"):
        D.draw_collisionless(bad_u, r_q, v_esc, joint)
    with pytest.raises(ValueError, match="uniform arrays"):
        D.draw_gas(u, g[1], g[2], g[3])
    with pytest.raises(ValueError, match="nodes"):
        D.draw_collisionless(u, r_q, v_esc[..., :-1].contiguous(), joint)
    with pytest.raises(ValueError, match="shaped as grid_r"):
        D.draw_gas(g[0], g[1], g[2], g[3][..., :-1].contiguous())
    with pytest.raises(ValueError, match="must be"):
        D.draw_gas(g[0], g[1][:1].contiguous(), g[2], g[3])
    assert (D.draw_collisionless.launches, D.draw_gas.launches) == before


def test_the_module_imports_and_draws_on_the_cpu_without_nvcc():
    """Nothing is compiled at import or for a CPU tensor: with the build
    made to fail, the module imports and both wrappers draw."""
    code = (
        "import torch\n"
        "from cluster_generator_tpu_torch.ops import build\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('a build was attempted')\n"
        "build.nvcc_path = build.load_library = build.build_all = boom\n"
        "from cluster_generator_tpu_torch.ops import draw_particles as D\n"
        "g = torch.Generator().manual_seed(0)\n"
        "r = lambda *s: torch.rand(s, generator=g)\n"
        "u = (r(2, 50), r(2, 50), r(2, 50), (2 * r(2, 50) - 1, r(2, 50)),\n"
        "     (2 * r(2, 50) - 1, r(2, 50)))\n"
        "r_q = torch.cumsum(r(2, 16), -1)\n"
        "pos, vel = D.draw_collisionless(u, r_q, r_q.flip(-1).contiguous(),\n"
        "                                torch.cumsum(r(2, 16, 8), -1))\n"
        "x = torch.logspace(-1, 4, 32).expand(2, 32).contiguous()\n"
        "gpos, e = D.draw_gas((u[0], u[3]), r_q, x, r(2, 32))\n"
        "assert pos.shape == vel.shape == gpos.shape == (2, 50, 3)\n"
        "assert e.shape == (2, 50) and not build._LIBS\n"
        "print('drawn')\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("drawn")

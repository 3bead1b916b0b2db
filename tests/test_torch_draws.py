"""The fused merger and the ensemble datagen draw by one rule
(``core/draws.py``), on the CPU at a small size (one halo, a 128-point
grid, 2000 particles).

Each product gets the same float32 radius-quantile nodes, joint speed
table and uniforms for one halo, with the merger's centre and bulk
velocity zero: positions are equal bit for bit, and velocities wherever
the datagen's local escape-speed cap does not bind.  What the products
keep apart (the merger's offsets and mass arrays, the datagen's cap and
per-cluster mass, their two joint-table folds) is not compared here.
"""

import pytest
import torch

from cluster_generator_tpu_torch import pipeline as P
from cluster_generator_tpu_torch.core.draws import (
    collisionless_uniforms,
    gas_uniforms,
    node_index,
    node_lerp,
)
from cluster_generator_tpu_torch.core.interp import interp_monotone
from cluster_generator_tpu_torch.parallel.ensemble import _DatagenProgram
from cluster_generator_tpu_torch.virial import sample_speeds_joint

torch.set_num_threads(1)

POINTS = 128
N = 2000
R_MAX = 5000.0
F32 = torch.float32


def _bits(t):
    return t.contiguous().view(torch.int32)


def _first(tree):
    """Row 0 of every tensor of a tuple tree of (1, n) uniforms."""
    if isinstance(tree, tuple):
        return tuple(_first(x) for x in tree)
    return tree[0]


@pytest.fixture(scope="module", params=[None, 500.0],
                ids=["isotropic", "r_a=500"])
def halo(request):
    """One halo's fields, speed table and radius nodes from the merger's
    stages, with ``r_a`` the Osipkov-Merritt radius or ``None``."""
    r_a = request.param
    fields = P.build_merger_models([1.0e15], [4.0], num_points=POINTS,
                                   r_a=r_a, device="cpu")
    tables = P.build_speed_tables(fields)
    radius = P.build_radius_tables(fields, [R_MAX])
    return r_a, fields, tables, radius


@pytest.mark.parametrize("kind", ["collisionless", "gas"])
def test_merger_and_datagen_draw_one_halo_alike(halo, kind):
    r_a, fields, tables, radius = halo
    f_h = {k: v[0] for k, v in fields.items()}
    sp = "dm" if kind == "collisionless" else "gas"
    r_q, mtot = radius[sp][0], radius[sp + "_mtot"][0]
    zero = torch.zeros(3, dtype=torch.float64)
    prog = _DatagenProgram(POINTS, N, N, 0, r_a=r_a)
    gen = torch.Generator().manual_seed(11)

    if kind == "gas":
        u = gas_uniforms(gen, (1, N), F32, "cpu")
        pos_m, _ = P._sample_gas_halo(f_h, r_q, mtot, N, zero, F32,
                                      uniforms=_first(u))
        pos_d, _, _ = prog._gas({k: v[:1] for k, v in fields.items()},
                                {"r_q": r_q[None], "mtot": mtot[None]},
                                N, None, u)
        assert torch.equal(_bits(pos_m), _bits(pos_d[0]))
        return

    s_inv = tables["dm"][0]
    u = collisionless_uniforms(gen, (1, N), F32, "cpu")
    u0 = _first(u)
    pos_m, vel_m, _ = P._sample_collisionless(
        f_h, s_inv, r_q, mtot, N, zero, zero, F32, uniforms=u0, r_a=r_a)
    # the datagen's tables: the merger's own joint table, and the escape
    # speed at the nodes for its cap
    joint = P._build_joint_speed_pairs(f_h, s_inv, r_q, F32)
    psi = -f_h["gravitational_potential"]
    v_esc = torch.sqrt(2.0 * interp_monotone(r_q.double(), f_h["radius"],
                                             psi)).to(F32)
    t = {"r_q": r_q[None], "v_esc": v_esc[None], "joint": joint[None],
         "mtot": mtot[None]}
    pos_d, vel_d, _ = prog._collisionless(t, N, None, u)
    assert torch.equal(_bits(pos_m), _bits(pos_d[0]))

    # where the cap binds: the drawn speed above the escape speed lerped
    # at the drawn radius
    u_r, u_q, u_b = u0[:3]
    kq, wq = node_index(u_r * (r_q.shape[-1] - 1), r_q.shape[-1])
    speed = sample_speeds_joint(joint, kq, wq, uniforms=(u_q, u_b))
    free = speed <= node_lerp(v_esc, kq, wq)
    assert free.float().mean() > 0.9
    assert torch.equal(_bits(vel_m[free]), _bits(vel_d[0][free]))


@pytest.mark.parametrize("n", [2, 64, 2048])
def test_a_uniform_one_ulp_below_one_stays_inside_the_table(n):
    u = torch.nextafter(torch.tensor(1.0, dtype=F32),
                        torch.tensor(0.0, dtype=F32)).reshape(1)
    assert float(u) < 1.0
    j, w = node_index(u * (n - 1), n)
    assert int(j) == n - 2
    assert 0.0 <= float(w) <= 1.0
    table = torch.linspace(0.0, 1.0, n, dtype=F32)
    assert float(node_lerp(table, j, w)) <= 1.0

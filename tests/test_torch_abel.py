"""Eddington's Abel sums (``ops.abel``) on the CPU.

On the CPU the wrapper runs the kernel's plain version.  It is held here,
bit for bit, against the Abel sum as ``virial._abel_g_exact`` read before
its body moved into ``ops.abel``, and the terms the kernel stops before
(every interval whose lower end is at or above the row's energy) are held
to be exact zeros of the plain version.  The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

import cluster_generator_tpu_torch.virial as V
from cluster_generator_tpu_torch.core.interp import cubic_spline
from cluster_generator_tpu_torch.ops import abel as A
from cluster_generator_tpu_torch.ops.abel import abel_g_rows, abel_g_rows_plain

torch.set_num_threads(1)


def _old_safe_sqrt(x):
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _old_abel_g_exact(sp, ee):
    """``virial._abel_g_exact`` as it read before the kernel."""
    x = sp.x
    zero = torch.zeros_like(x[..., :1])
    lo = torch.cat([zero, x[..., :-1]], dim=-1)[..., None, :]
    hi = torch.cat([x[..., :1], x[..., 1:]], dim=-1)[..., None, :]
    xk = torch.cat([x[..., :1], x[..., :-1]], dim=-1)[..., None, :]
    b = torch.cat([sp.b[..., :1], sp.b], dim=-1)[..., None, :]
    c = torch.cat([sp.c[..., :1], sp.c], dim=-1)[..., None, :]
    d = torch.cat([sp.d[..., :1], sp.d], dim=-1)[..., None, :]

    E = ee[..., :, None]
    u_lo = _old_safe_sqrt(E - torch.minimum(lo, E))
    u_hi = _old_safe_sqrt(E - torch.minimum(hi, E))
    A_ = E - xk
    k0 = b + 2.0 * c * A_ + 3.0 * d * A_ * A_
    k2 = -(2.0 * c + 6.0 * d * A_)
    k4 = 3.0 * d

    def G(u):
        u2 = u * u
        return 2.0 * u * (k0 + u2 * (k2 / 3.0 + u2 * (k4 / 5.0)))

    return torch.sum(G(u_lo) - G(u_hi), dim=-1)


def _spline(lead, n, seed, shared_knots=False):
    """The density spline of a smooth rho(psi) rising over geometric
    knots (``lead`` entries; the knots of entry 0 for all of them with
    ``shared_knots``)."""
    rng = np.random.RandomState(seed)
    entries = int(np.prod(lead, dtype=np.int64))
    top = rng.uniform(1.0, 10.0, size=(entries, 1))
    x = top * np.geomspace(1e-4, 1.0, n)
    rho = (x / top) ** 1.7 * (1.0 + 0.05 * np.sin(
        37.0 * x / top + rng.rand(entries, 1)))
    if shared_knots:
        x = np.broadcast_to(x[:1], x.shape).copy()
    sp = cubic_spline(torch.from_numpy(x.reshape(lead + (n,))),
                      torch.from_numpy(rho.reshape(lead + (n,))))
    return sp._replace(x=sp.x.reshape(-1, n)[0]) if shared_knots else sp


@pytest.mark.parametrize("lead,n", [((), 40), ((3,), 97), ((2, 3), 64)])
def test_the_wrapper_gives_the_old_body_bit_for_bit(lead, n):
    sp = _spline(lead, n, seed=n)
    ee = sp.x
    before = abel_g_rows.launches
    got = V._abel_g_exact(sp, ee)
    assert abel_g_rows.launches == before  # no kernel on the CPU
    assert got.shape == lead + (n,)
    assert torch.equal(got, _old_abel_g_exact(sp, ee))
    assert torch.equal(got, abel_g_rows_plain(sp.x, sp.b, sp.c, sp.d, ee))


def test_rows_off_the_knots_and_shared_knots_keep_the_old_bits():
    sp = _spline((4,), 50, seed=3, shared_knots=True)
    assert sp.x.shape == (50,) and sp.b.shape == (4, 49)
    ee = torch.cat([torch.zeros(1, dtype=torch.float64), 0.5 * sp.x[:1],
                    sp.x[::3], 2.0 * sp.x[-1:]])
    got = abel_g_rows(sp.x, sp.b, sp.c, sp.d, ee)
    assert got.shape == (4, ee.shape[0])
    assert torch.equal(got, _old_abel_g_exact(sp, ee))
    assert not bool(got[:, 0].any())  # E = 0: no interval below it


def test_the_terms_past_a_rows_energy_are_exact_zeros(monkeypatch):
    """The kernel's loop ends at the first interval whose lower end is at
    or above E_i: every such term of the plain version is exactly 0."""
    sp = _spline((3,), 80, seed=5)
    x = sp.x
    lo = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)
    ee = torch.cat([x, 0.3 * x[..., :7]], dim=-1)
    past = lo[..., None, :] >= ee[..., :, None]
    assert 0 < int(past.sum()) < past.numel()
    want = abel_g_rows_plain(x, sp.b, sp.c, sp.d, ee)
    kept, real_sum = [], torch.sum

    def keep(t, dim):
        kept.append(t)  # the (..., rows, N) terms before their sum
        return real_sum(t, dim=dim)

    monkeypatch.setattr(torch, "sum", keep)
    got = abel_g_rows_plain(x, sp.b, sp.c, sp.d, ee)
    monkeypatch.undo()
    terms, = kept
    assert terms.shape == past.shape and torch.equal(got, want)
    assert bool((terms[past] == 0.0).all())
    assert bool((terms[~past] != 0.0).any())


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    sp = _spline((2,), 30, seed=1)
    args = [sp.x, sp.b, sp.c, sp.d, sp.x]
    before = abel_g_rows.launches
    for i, value, err in ((1, sp.b.float(), TypeError),       # float32
                          (4, sp.x.float(), TypeError),
                          (2, sp.c[..., :-1], ValueError),     # width
                          (4, sp.x.to("meta"), ValueError)):   # two devices
        with pytest.raises(err):
            abel_g_rows(*args[:i], value, *args[i + 1:])
    with pytest.raises(ValueError, match="knots"):
        abel_g_rows(sp.x[..., :1], sp.b[..., :0], sp.c[..., :0],
                    sp.d[..., :0], sp.x[..., :1])
    with pytest.raises(ValueError, match="unsupported device"):
        abel_g_rows(*(t.to("meta") for t in args))
    assert abel_g_rows.launches == before


@pytest.mark.parametrize("entries,rows,log_s", [
    (256, 512, 2), (256, 704, 2), (128, 512, 3), (64, 512, 4), (2, 1000, 5),
    (2, 1192, 5), (1, 1000, 5), (1, 4288, 5), (0, 512, 5), (4096, 512, 0)])
def test_the_lanes_fill_the_launch(entries, rows, log_s):
    """Fewer lanes the more row pairs there are: the fewest of 1 to 32 a
    pair that give the launch 2^18 threads."""
    assert A.lanes_log2(entries, rows) == log_s


def test_the_autograd_function_differentiates_the_plain_version(
        monkeypatch):
    """``_AbelG``'s backward (the card's grad path) gives the plain
    version's own gradient bit for bit; its forward stands in for the
    kernel here."""
    monkeypatch.setattr(A, "_launch", lambda x, b, c, d, ee, lead:
                        abel_g_rows_plain(x, b, c, d, ee))
    sp = _spline((2,), 24, seed=7)
    w = torch.from_numpy(np.random.RandomState(0).rand(2, 24))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (sp.x, sp.b, sp.c,
                                                       sp.d)]
        ee = leaves[0].detach().clone().requires_grad_()
        (fn(*leaves, ee) * w).sum().backward()
        return [t.grad for t in leaves + [ee]]

    got = grads(lambda *a: A._AbelG.apply(*a, A._check(*a)))
    want = grads(abel_g_rows_plain)
    assert all(torch.equal(g, h) for g, h in zip(got, want))

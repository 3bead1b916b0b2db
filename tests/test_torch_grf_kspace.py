"""The constant-rms field's k-space stage (``ops.grf_kspace``).

On the CPU the field program runs the plain twin ``fields.grf._kspace``,
the slab code it ran before the kernel; the twin is held here against the
arithmetic the CUDA kernel does in its own order, f T(sigma W) with
f = g_rms N / sqrt(q) and q the Parseval power of the projected shaped
spectra, written in torch: within 1e-13 of each component's largest
|value| in float64 and 1e-5 in float32, for every pair of switches.  The
wrapper refuses CPU tensors, and spectra and wave vectors the kernel does
not take.

The tests marked ``cuda`` hold the kernel against the plain twin on the
card (the same limits, and a grid with more entries than the card's
resident threads, so that each thread walks several), two replays of a
field program to the same bits and a vector potential's call to one
launch; without a card they skip.
On a machine with one, run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_grf_kspace.py
"""

import numpy as np
import pytest
import torch

from cluster_generator_tpu_torch.core import compiled as C
from cluster_generator_tpu_torch.fields import grf as G
from cluster_generator_tpu_torch.ops import grf_kspace as K

torch.set_num_threads(1)

SHAPES = [(16, 16, 14), (24, 30, 32), (33, 17, 9)]   # odd nz: no Nyquist plane
# 455,000 half-spectrum entries, more than an H100's resident threads
# (132 SMs x 8 blocks x 256 = 270,336): each thread steps several times,
# through the carries of z into y and of y into x
WALKED = (130, 70, 98)
SWITCHES = [(True, False), (True, True), (False, False), (False, True)]
TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}
K0, K1, ALPHA, G_RMS = 2 * np.pi / 60.0, 2 * np.pi / 400.0, -11 / 3, 3.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")


def _case(shape, dtype, device="cpu", seed=3):
    """Half spectra of white noise's size and the grid's wave vector."""
    f = G.ClusterField([0.0] * 3, [1000.0] * 3, shape, padding=0.0,
                       device="cpu")
    waves = torch.from_numpy(G._wave_vector(f._compute_waves(), f.deltas))
    rng = np.random.default_rng(seed)
    half = shape[:2] + (shape[2] // 2 + 1,)
    n = float(np.sqrt(np.prod(shape)))
    W = [torch.from_numpy(n * (rng.standard_normal(half)
                               + 1j * rng.standard_normal(half))).to(
        device=device, dtype=COMPLEX[dtype]) for _ in range(3)]
    return W, waves.to(device)


def _floats(device):
    return [torch.tensor(v, dtype=torch.float64, device=device)
            for v in (K0, K1, ALPHA, G_RMS)]


def _kernel_arithmetic(W, waves, shape, div_clean, vec_pot):
    """``csrc/grf_kspace.cu``'s arithmetic in torch, in float64: the
    spectra f T(sigma W), sigma = exp(alpha/4 log1p(k^2/k1^2) -
    k^2/(2 k0^2)), P the projection on e = kd / |kd|, T the potential
    i k' x P / k^2, f = g_rms N / sqrt(q), q = sum wz |P(sigma W)|^2."""
    nx, ny, nz = shape
    k, kd, ko, wz = G._unpack_waves(waves, shape)
    kk2 = k[0] ** 2 + k[1] ** 2 + k[2] ** 2
    pos = kk2 > 0
    sigma = torch.where(pos, torch.exp(
        0.25 * ALPHA * torch.log1p(kk2 / K1 ** 2) - 0.5 * kk2 / K0 ** 2), 0.0)
    g = [w.to(torch.complex128) for w in W]
    if div_clean:
        d2 = kd[0] ** 2 + kd[1] ** 2 + kd[2] ** 2
        inv = torch.where(d2 > 0, torch.rsqrt(torch.where(d2 > 0, d2, 1.0)),
                          0.0)
        e = [c * inv for c in kd]
        b = e[0] * g[0] + e[1] * g[1] + e[2] * g[2]
        g = [gc - ec * b for gc, ec in zip(g, e)]
    q = sum((torch.view_as_real(c).square().sum(-1) * sigma ** 2 * wz).sum()
            for c in g)
    n_cells = float(nx * ny * nz)
    scale = G_RMS / torch.sqrt(q / (n_cells * n_cells)) * sigma
    if vec_pot:
        scale = scale * torch.where(pos, 1.0 / torch.where(pos, kk2, 1.0),
                                    0.0)
        g = [1j * (ko[1] * g[2] - ko[2] * g[1]),
             1j * (ko[2] * g[0] - ko[0] * g[2]),
             1j * (ko[0] * g[1] - ko[1] * g[0])]
    return [(scale * c).to(W[0].dtype) for c in g]


def _max_rel(got, want):
    """Largest |got - want| over the largest |want|, over components."""
    return max(float((a.to(torch.complex128) - b.to(torch.complex128))
                     .abs().max() / b.abs().max()) for a, b in zip(got, want))


# ------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("div_clean,vec_pot", SWITCHES)
def test_the_plain_twin_is_the_kernels_arithmetic(dtype, shape, div_clean,
                                                  vec_pot):
    W, waves = _case(shape, dtype)
    want = _kernel_arithmetic(W, waves, shape, div_clean, vec_pot)
    before = K.grf_kspace.launches
    G._kspace(W, waves, *_floats("cpu"), shape, dtype, div_clean, vec_pot)
    assert K.grf_kspace.launches == before  # no kernel on the CPU
    assert all(w.dtype == COMPLEX[dtype] for w in W)
    assert _max_rel(W, want) <= TOL[dtype]


def test_a_cpu_tensor_runs_the_plain_twin(monkeypatch):
    """The field program's k-space stage on the CPU is the plain twin,
    called once a field with the program's spectra in place, and never
    the kernel's wrapper."""
    called = []
    plain = G._kspace

    def record(W, *args):
        called.append([w.data_ptr() for w in W])
        return plain(W, *args)

    def kernel(*args):
        raise AssertionError("the kernel's wrapper ran on the CPU")

    monkeypatch.setattr(G, "_kspace", record)
    monkeypatch.setattr(G, "grf_kspace", kernel)
    f = G.RandomMagneticVectorPotential([0.0] * 3, [1000.0] * 3, (12, 10, 9),
                                        50.0, 500.0, 1e-6, padding=0.0,
                                        prng=4, device="cpu")
    assert len(called) == 1 and len(set(called[0])) == 3
    assert all(torch.isfinite(g).all() for g in (f.gx, f.gy, f.gz))


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    shape = (8, 6, 10)
    W, waves = _case(shape, torch.float64)
    args = (*_floats("cpu"), shape, torch.float64, True, False)

    def call(W=W, waves=waves, args=args):
        K.grf_kspace(W, waves, *args)

    with pytest.raises(TypeError, match="complex128"):
        call(W=[w.to(torch.complex64) for w in W])
    with pytest.raises(TypeError, match="dtype must be"):
        call(args=args[:5] + (torch.float16,) + args[6:])
    with pytest.raises(ValueError, match="shaped"):
        call(W=[w[:, :, :-1].contiguous() for w in W])
    with pytest.raises(ValueError, match="contiguous"):
        call(W=[w.transpose(0, 1).contiguous().transpose(0, 1) for w in W])
    with pytest.raises(ValueError, match="three spectra"):
        call(W=W[:2])
    with pytest.raises(ValueError, match="wave vector"):
        call(waves=waves[:-1])
    with pytest.raises(ValueError, match="wave vector"):
        call(waves=waves.to(torch.float32))
    with pytest.raises(ValueError, match="waves on meta"):
        call(waves=waves.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        call(W=[w.to("meta") for w in W], waves=waves.to("meta"))
    with pytest.raises(TypeError, match="torch.Tensor"):
        call(W=[W[0], W[1], W[2].numpy()])
    with pytest.raises(ValueError, match="unsupported device cpu"):
        call()


def test_the_kernels_floats_are_one_float64_each_on_its_device():
    cpu = torch.device("cpu")
    t = torch.tensor(0.25, dtype=torch.float64)
    assert K._scalar("k0", t, cpu) is t
    for bad in (0.25, t.to(torch.float32), torch.ones(2, dtype=torch.float64),
                t.to("meta")):
        with pytest.raises(ValueError, match="one float64"):
            K._scalar("k1", bad, cpu)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", SHAPES + [WALKED])
@pytest.mark.parametrize("div_clean,vec_pot", SWITCHES)
def test_the_kernel_matches_the_plain_twin(dtype, shape, div_clean, vec_pot):
    _card()
    W, waves = _case(shape, dtype, "cuda")
    want = [w.clone() for w in W]
    G._kspace(want, waves, *_floats("cuda"), shape, dtype, div_clean,
              vec_pot)
    before = K.grf_kspace.launches
    K.grf_kspace(W, waves, *_floats("cuda"), shape, dtype, div_clean,
                 vec_pot)
    torch.cuda.synchronize()
    assert K.grf_kspace.launches == before + 1
    assert _max_rel(W, want) <= TOL[dtype]


def _potential(seed, dims=(40, 36, 33)):
    f = G.RandomMagneticVectorPotential(
        [-1000.0] * 3, [1000.0] * 3, dims, 50.0, 500.0, 1e-6, padding=0.0,
        prng=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    return f.gx, f.gy, f.gz


@pytest.mark.cuda
def test_two_replays_of_a_program_give_the_same_bits():
    _card()
    C.clear()
    first = _potential(7)          # the warm-up, eager, then the capture
    again = [_potential(7) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(p.graph is not None for p in C.programs())
    for got in again:
        assert all(torch.equal(a, b) for a, b in zip(got, again[0]))
        assert all(torch.equal(a, b) for a, b in zip(got, first))
    C.clear()


@pytest.mark.cuda
def test_a_vector_potential_call_launches_the_kernel_once():
    _card()
    C.clear()
    for seed in range(3):          # the warm-up, then two replays
        before = K.grf_kspace.launches
        _potential(seed)
        torch.cuda.synchronize()
        assert K.grf_kspace.launches == before + 1, seed
    C.clear()

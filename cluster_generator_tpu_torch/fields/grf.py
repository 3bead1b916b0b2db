"""Divergence-free 3D Gaussian random vector fields with ``torch.fft``.

White noise is transformed to k-space, shaped by a Kolmogorov-like
spectrum, projected onto its divergence-free part with the finite-difference
wavenumbers kd = sin(k d)/d, and (optionally) replaced by its vector
potential A~ = i k x g~ / k^2.  Every transform works on half spectra
(``rfftn`` / ``irfftn``): complex64 for float32 fields, complex128 for
float64.  Every route draws its white noise as ONE ``(3, nx, ny, nz)``
standard-normal tensor in the field's dtype, or takes it pre-drawn
(``noise=``), so that a field can be compared with another generator's.

* constant rms (no halo profile): one k-space pass, 3 forward and 3
  inverse transforms; the rms normalisation and the projection's
  power-preserving rescale come from the spectra by Parseval.  The
  transforms run in place in the noise's buffer (:func:`_layout`), so that
  the route holds one field's worth of memory: the noise, then the
  spectra, then the field;
* radial (up to three halo profiles): unit-rms shaping, the real-space
  scale sqrt(sum_h g_h(r)^2), then the projection and the vector potential
  as staged transforms.

Field components are tensors on the field's device.  Each route is one
captured program on the card (``core/compiled.function``, the counterpart
of the JAX package's jitted cores): the shape, the dtype and the switches
are its key; the wavenumbers, the halo profiles and every float are
inputs, and the white noise is drawn into the program's buffer from the
caller's generator before each replay.  The trilinear sampling of a field
at particle positions is a program too.

Stage marks (:mod:`..core.profiling`): the noise draw marks ``noise``
(eagerly, before the replay), and each route's body marks its transforms
``fft`` and the arithmetic between them ``kspace`` as one sequence closed
by ``end``: noise, fft, kspace, fft, end for the constant-rms route.  The
host's set-up of a field (wavenumbers, coordinates, the wave vector's copy
to the device, the generator) is the span ``cg.host.inputs``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import compiled
from ..core.device import host_to_device, resolve_device
from ..core.interp import interp
from ..core.logging import mylog
from ..core.profiling import device_mark, device_sequence, device_stage, span
from ..core.staging import to_host
from ..ops.grf_kspace import grf_kspace
from ..sampling import parse_prng

__all__ = ["ClusterField", "GaussianRandomField", "RandomMagneticField",
           "RadialRandomMagneticField", "RandomMagneticVectorPotential",
           "RadialRandomMagneticVectorPotential", "RandomVelocityField",
           "RadialRandomVelocityField", "parse_value"]

# the transforms of the constant-rms route (and its k-space arithmetic on
# the CPU) run on slabs of at most this many half-spectrum entries, so
# that their temporaries stay small beside the three spectra
_SLAB = 1 << 24


def parse_value(value, default_units: str):
    """A number, array or tensor, or a ``(value, unit)`` tuple, in galactic
    base units of ``default_units``.  Tensors stay tensors on their device;
    anything else becomes a float64 numpy array."""
    from ..core import units

    factor = None
    if (isinstance(value, tuple) and len(value) == 2
            and isinstance(value[1], str)):
        value, factor = value
    if isinstance(value, torch.Tensor):
        value = value.to(torch.float64)
    else:
        value = np.asarray(value, dtype=np.float64)
    if factor is None:
        return value
    return value * units.unit_factor(factor) / units.unit_factor(default_units)


def _div_clean_k(gx, gy, gz, kxd, kyd, kzd):
    """Project out the compressive part: g -= khat_d (khat_d . g)."""
    kkd = torch.sqrt(kxd**2 + kyd**2 + kzd**2)
    inv = torch.where(kkd > 0.0, 1.0 / torch.where(kkd > 0.0, kkd, 1.0), 0.0)
    ex, ey, ez = kxd * inv, kyd * inv, kzd * inv
    kb = ex * gx + ey * gy + ez * gz
    return gx - ex * kb, gy - ey * kb, gz - ez * kb


def _vector_potential_k(gx, gy, gz, kx, ky, kz, k2):
    """A~ = i k x g~ / k^2 (zero at k = 0), with ``k2`` the squared
    wavenumbers and (kx, ky, kz) those of the numerator (see
    :func:`_odd_waves`)."""
    inv = torch.where(k2 > 0.0, 1.0 / torch.where(k2 > 0.0, k2, 1.0), 0.0)
    ax = 1j * (ky * gz - kz * gy) * inv
    ay = 1j * (kz * gx - kx * gz) * inv
    az = 1j * (kx * gy - ky * gx) * inv
    return ax, ay, az


def _odd_waves(k):
    """``k`` with its Nyquist entry (even length) set to 0, for the
    numerator of :func:`_vector_potential_k`.

    On the discrete grid the Nyquist wavenumber is its own mirror, so i k g~
    is not Hermitian there; the real part of a full complex inverse
    transform (the JAX package's route) keeps only the Hermitian part,
    which is i k' g~ with this k' in the numerator and k^2 unchanged.  With
    it a half-spectrum inverse gives that same real field."""
    k = np.array(k, dtype=np.float64)
    n = k.size
    if n % 2 == 0:
        k.reshape(-1)[n // 2] = 0.0
    return k


def _spectrum_sigma(kk, k0, k1, alpha, dtype):
    """The spectrum shaping of every route: a power law with an outer-scale
    cutoff; the zero mode (kk == 0, the origin only) carries no power."""
    sigma = (1.0 + (kk / k1) ** 2) ** (0.25 * alpha) * torch.exp(
        -0.5 * (kk / k0) ** 2)
    return torch.where(kk > 0.0, sigma, 0.0).to(dtype)


def _wave_vector(waves, deltas):
    """Every wavenumber vector a field program reads, as one float64 host
    array (one copy to the device): the angular wavenumbers k of the three
    axes (of z the half that ``rfftn`` keeps), their finite-difference
    forms sin(k d)/d, their numerator forms (:func:`_odd_waves`) and the
    Parseval weights of the kz planes: 2 where the dropped half holds the
    conjugate mirror, 1 for the self-conjugate kz = 0 (and kz = nz/2)."""
    kx, ky, kz = (np.asarray(k, np.float64).reshape(-1) for k in waves)
    nz = kz.size
    nzh = nz // 2 + 1
    ks = (kx, ky, kz[:nzh])
    wz = np.full(nzh, 2.0)
    wz[0] = 1.0
    if nz % 2 == 0:
        wz[-1] = 1.0
    return np.concatenate([*ks, *(np.sin(k * d) / d
                                  for k, d in zip(ks, deltas)),
                           _odd_waves(kx), _odd_waves(ky),
                           _odd_waves(kz)[:nzh], wz])


def _unpack_waves(vec, shape):
    """:func:`_wave_vector`'s array on the device as views: ``(k, kd,
    k_odd, wz)``, the first three each a triple of float64 tensors shaped
    (nx, 1, 1), (1, ny, 1), (1, 1, nzh) to broadcast over a half
    spectrum, ``wz`` (nzh,)."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    parts = torch.split(vec, (nx, ny, nzh) * 3 + (nzh,))
    axes = [p.reshape([-1 if a == i % 3 else 1 for a in range(3)])
            for i, p in enumerate(parts[:9])]
    return axes[0:3], axes[3:6], axes[6:9], parts[9]


def _noise_drawer(noise, gen, shape, dtype, device, spectra=False):
    """The white noise of a field program (its ``noise`` argument): a flat
    buffer in ``dtype`` whose head holds ``(3, nx, ny, nz)`` standard
    normals, ``noise`` as given, or drawn from ``gen`` (default: one on
    ``device`` seeded with 0) as one ``torch.randn`` call draws them (the
    head is contiguous).  With ``spectra`` the buffer has room for the
    three half spectra as well (:func:`_layout`).  Drawn into the
    program's buffer in place before each replay, or into a new one."""
    nx, ny, nz = shape
    shape = (3,) + tuple(shape)
    size = 3 * nx * ny * 2 * (nz // 2 + 1) if spectra else int(np.prod(shape))
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=dtype, device=device)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise has shape {tuple(noise.shape)}, the "
                             f"field needs {shape}")

    def draw(g, out):
        if out is None:
            out = torch.empty(size, dtype=dtype, device=device)
        head = _head(out, shape[1:])
        device_mark("noise", out)
        if noise is None:
            head.normal_(generator=g)
        else:
            head.copy_(noise)
        return out

    return compiled.drawer(None, gen, device, draw)


def _head(buf, shape):
    """The ``(3, nx, ny, nz)`` head of a field program's flat buffer: its
    noise, and the constant-rms route's field."""
    return buf[:3 * int(np.prod(shape))].view((3,) + tuple(shape))


def _layout(buf, shape):
    """The constant-rms route's views of its buffer: the head
    (:func:`_head`) and the three (nx, ny, nz // 2 + 1) complex half
    spectra, spectrum c from entry c M, M = nx ny (nz + 2).  Spectrum c
    starts at or after noise c (c M >= c N, N = nx ny nz) and each of its
    x rows at or after the same row of the noise (ny (nz + 2) >= ny nz
    entries per row), which is what lets :func:`_rfftn_in_place` and
    :func:`_irfftn_in_place` overwrite the noise and the spectra."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    m = nx * ny * 2 * nzh
    return _head(buf, shape), [torch.view_as_complex(
        buf[c * m:(c + 1) * m].view(nx, ny, nzh, 2)) for c in range(3)]


def _chunks(n, per):
    """Slices of ``range(n)`` of at most ``_SLAB // per`` (at least 1)."""
    step = max(1, _SLAB // per)
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _rfftn_in_place(buf, shape):
    """The three noise components' half spectra, in place in ``buf``
    (:func:`_layout`): per x slab the 2D transform over (y, z), then per y
    chunk the transform over x.  The components from the last to the
    first, each one's x slabs from the last to the first: a slab's
    spectrum then overwrites only noise already transformed."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    noise, spec = _layout(buf, shape)
    for c in (2, 1, 0):
        for s in reversed(_chunks(nx, ny * nzh)):
            spec[c][s].copy_(torch.fft.rfftn(noise[c][s], dim=(1, 2)))
        for s in _chunks(ny, nx * nzh):
            spec[c][:, s].copy_(torch.fft.fft(spec[c][:, s], dim=0))
    return spec


def _irfftn_in_place(buf, shape):
    """The inverse of :func:`_rfftn_in_place`: per y chunk the inverse
    transform over x, then per x slab the inverse over (y, z) into the
    head.  The components from the first to the last, each one's x slabs
    from the first to the last: a slab's field overwrites only spectra
    already transformed.  Returns the head's three components."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    field, spec = _layout(buf, shape)
    for c in range(3):
        for s in _chunks(ny, nx * nzh):
            spec[c][:, s].copy_(torch.fft.ifft(spec[c][:, s], dim=0))
        for s in _chunks(nx, ny * nzh):
            field[c][s].copy_(torch.fft.irfftn(spec[c][s], s=(ny, nz),
                                               dim=(1, 2)))
    return tuple(field.unbind(0))


def _plane_power(w):
    """sum |w|^2 over the first two axes, per kz plane, in float64."""
    return torch.view_as_real(w).square().sum(dim=(0, 1, 3),
                                              dtype=torch.float64)


@compiled.function(static=("shape", "dtype", "div_clean", "vec_pot"),
                   random="noise")
def _constant_rms_field(waves, k0, k1, alpha, g_rms, shape, dtype,
                        div_clean, vec_pot, noise):
    """The constant-rms field on half spectra: shaping, rms normalisation,
    divergence projection with its power-preserving rescale and the vector
    potential in one k-space stage between 3 forward and 3 inverse
    transforms (on the card one call of the hand-written kernel
    :func:`..ops.grf_kspace.grf_kspace`, on the CPU :func:`_kspace` slab
    by slab along x).  ``noise``: the flat buffer of :func:`_noise_drawer`
    with room for the spectra; the transforms run in place in it, and the
    field is its head.

    One program (JAX ``_grf_core_fused`` and its staged rfft route) keyed
    by the shape, the dtype and the two switches; ``waves``
    (:func:`_wave_vector`), ``k0``, ``k1``, ``alpha`` and ``g_rms`` are
    inputs, so an ``l_min`` or ``g_rms`` sweep replays it.  Marks: fft,
    kspace, fft, end."""
    with device_sequence(noise.device):
        with device_stage("fft", noise):
            W = _rfftn_in_place(noise, shape)
        with device_stage("kspace", noise):
            stage = grf_kspace if noise.is_cuda else _kspace
            stage(W, waves, k0, k1, alpha, g_rms, shape, dtype, div_clean,
                  vec_pot)
        with device_stage("fft", noise):
            field = _irfftn_in_place(noise, shape)
    return field


def _kspace(W, waves, k0, k1, alpha, g_rms, shape, dtype, div_clean,
            vec_pot):
    """The k-space pass of :func:`_constant_rms_field` on the half spectra
    ``W``, in place, slab by slab along x: the CPU's route, and the plain
    twin the card's kernel is held against."""
    nx, ny, nz = shape
    n_cells = nx * ny * nz
    # the shaping in float64, the rest at the field's real dtype: a float64
    # operand would promote complex64 spectra
    k64, kd, k_odd, wz = _unpack_waves(waves, shape)
    kd = [k.to(dtype) for k in kd]
    k_odd = [k.to(dtype) for k in k_odd]
    k_sq = [k.to(dtype) ** 2 for k in k64]
    slabs = _chunks(nx, ny * (nz // 2 + 1))

    def power(ws):
        return sum((_plane_power(w) * wz).sum() for w in ws)

    def store(ws, new):
        for w, a in zip(ws, new):
            w.copy_(a)

    p = 0.0
    for s in slabs:
        kk = torch.sqrt(k64[0][s] ** 2 + k64[1] ** 2 + k64[2] ** 2)
        sigma = _spectrum_sigma(kk, k0, k1, alpha, dtype)
        for w in W:
            w[s].mul_(sigma)
        p = p + power([w[s] for w in W])
    # mean_x(sum_c g_c^2) = sum_{c,k} |W_c|^2 / N^2
    scale = (g_rms / torch.sqrt(p / (n_cells * float(n_cells)))).to(dtype)

    def potential(s):
        ws = [w[s] for w in W]
        k2 = k_sq[0][s] + k_sq[1] + k_sq[2]
        store(ws, _vector_potential_k(*ws, k_odd[0][s], k_odd[1], k_odd[2],
                                      k2))

    p0 = p2 = 0.0
    for s in slabs:
        ws = [w[s] for w in W]
        for w in ws:
            w.mul_(scale)
        if div_clean:
            p0 = p0 + power(ws)
            store(ws, _div_clean_k(*ws, kd[0][s], kd[1], kd[2]))
            p2 = p2 + power(ws)
        elif vec_pot:
            potential(s)
    if div_clean:
        rescale = torch.sqrt(p0 / p2).to(dtype)
        for s in slabs:
            for w in W:
                w[s].mul_(rescale)
            if vec_pot:
                potential(s)


def _unit_rms_field(noise, shape, k, k0, k1, alpha):
    """White noise -> spectrum-shaped unit-rms Gaussian random field
    (``k``: the float64 wavenumbers of :func:`_unpack_waves`)."""
    kx, ky, kz = k
    sigma = _spectrum_sigma(torch.sqrt(kx**2 + ky**2 + kz**2), k0, k1, alpha,
                            noise.dtype)
    g = [_fft(torch.fft.irfftn, _fft(torch.fft.rfftn, noise[c]) * sigma,
              s=shape) for c in range(3)]
    g_avg = torch.sqrt(torch.mean(g[0]**2 + g[1]**2 + g[2]**2))
    return tuple(x / g_avg for x in g)


def _fft(transform, x, **kw):
    """``transform(x, **kw)`` as stage ``fft``, handing back to the stage
    around it (the radial route's ``kspace``)."""
    with device_stage("fft", x):
        return transform(x, **kw)


def _transform(g, shape, mul):
    """The inverse transforms of ``mul`` applied to the half spectra of
    the components ``g``."""
    W = [_fft(torch.fft.rfftn, c) for c in g]
    return [_fft(torch.fft.irfftn, w, s=shape) for w in mul(*W)]


@compiled.function(static=("shape", "dtype", "div_clean", "vec_pot"),
                   random="noise")
def _radial_field(waves, x, y, z, halos, r_max, k0, k1, alpha, shape, dtype,
                  div_clean, vec_pot, noise):
    """The radial route: unit-rms shaping (JAX ``_grf_core``), the
    real-space scale sqrt(sum_h g_h(r)^2), the finite-difference projection
    with its power-preserving rescale (JAX ``_div_clean_k``) and the vector
    potential (JAX ``_vector_potential_k``), as staged transforms in one
    program.

    ``x``/``y``/``z``: the cell centres; ``halos``: per halo ``(center,
    r, g)``, the centre three floats and the profile's radii and values;
    ``r_max`` clamps the radii (``None``: no clamp).  The key holds the
    number of halos, each profile's length and whether ``r_max`` is None;
    the centres, profiles and ``r_max`` are inputs.

    Marks: the arithmetic as ``kspace``, each transform as ``fft`` inside
    it, the sequence closed by ``end``."""
    with device_sequence(x.device), device_stage("kspace", x):
        k64, kd, k_odd, _ = _unpack_waves(waves, shape)
        g = _unit_rms_field(_head(noise, shape), shape, k64, k0, k1, alpha)
        X, Y, Z = x[:, None, None], y[None, :, None], z[None, None, :]
        g2sum = torch.zeros(shape, dtype=dtype, device=x.device)
        for ctr, rprof, gprof in halos:
            rr = torch.sqrt((X - ctr[0]) ** 2 + (Y - ctr[1]) ** 2
                            + (Z - ctr[2]) ** 2)
            if r_max is not None:
                rr = torch.clamp_max(rr, r_max)
            g2sum = g2sum + interp(rr, rprof, gprof).to(dtype) ** 2
        scale = torch.sqrt(g2sum)
        g = [c * scale for c in g]
        if div_clean:
            # keep <g^2> through the projection; the wavenumbers at the
            # field's real dtype (a float64 operand would promote complex64
            # spectra to complex128)
            power = sum(torch.sum(c**2) for c in g)
            kd = [k.to(dtype) for k in kd]
            g = _transform(g, shape, lambda *W: _div_clean_k(*W, *kd))
            rescale = torch.sqrt(power / sum(torch.sum(c**2) for c in g))
            g = [c * rescale for c in g]
        if vec_pot:
            k_odd = [k.to(dtype) for k in k_odd]
            k2 = sum(k.to(dtype) ** 2 for k in k64)
            g = _transform(g, shape, lambda *W: _vector_potential_k(*W, *k_odd,
                                                                    k2))
    return tuple(g)


def _on_device(a, device):
    """A radial profile (a tensor or an array) as a float64 tensor on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float64)
    return host_to_device(np.asarray(a, np.float64), device)


class ClusterField:
    """A 3D vector field on a padded uniform grid, on one device."""

    _units = "dimensionless"
    _name = "vector"

    def __init__(self, left_edge, right_edge, ddims, padding=0.1,
                 vector_potential=False, divergence_clean=False,
                 dtype=torch.float64, device="cuda"):
        ddims = np.array(ddims).astype(int)
        left_edge = parse_value(left_edge, "kpc")
        right_edge = parse_value(right_edge, "kpc")
        width = right_edge - left_edge
        self.deltas = width / ddims
        pad_dims = (2 * np.ceil(0.5 * padding * ddims)).astype(int)
        self.left_edge = left_edge - 0.5 * pad_dims * self.deltas
        self.right_edge = right_edge + 0.5 * pad_dims * self.deltas
        self.ddims = ddims + pad_dims
        self.vector_potential = vector_potential
        self.divergence_clean = divergence_clean
        self.comps = [f"{self._name}_{ax}" for ax in "xyz"]
        self.dx, self.dy, self.dz = self.deltas
        self.dtype = dtype
        self.device = resolve_device(device)

    # --------------------------------------------------------- grid helpers
    def _compute_coords(self):
        """Cell-centre coordinates, three float64 tensors on the device."""
        le = self.left_edge + self.deltas * 0.5
        re = self.right_edge - self.deltas * 0.5
        return [host_to_device(np.linspace(le[i], re[i], self.ddims[i]),
                               self.device) for i in range(3)]

    def _compute_waves(self):
        """FFT angular wavenumbers, float64 numpy arrays shaped to
        broadcast over the grid."""
        nx, ny, nz = self.ddims
        kx = np.fft.fftfreq(nx, d=self.dx / (2.0 * np.pi))
        ky = np.fft.fftfreq(ny, d=self.dy / (2.0 * np.pi))
        kz = np.fft.fftfreq(nz, d=self.dz / (2.0 * np.pi))
        return (kx[:, None, None].astype(np.float64),
                ky[None, :, None].astype(np.float64),
                kz[None, None, :].astype(np.float64))

    # ------------------------------------------------------------- mapping
    def __getitem__(self, item):
        if item in ("x", "y", "z"):
            return getattr(self, item)
        if item in self.comps:
            return getattr(self, f"g{item[-1]}")
        raise KeyError(item)

    @property
    def units(self):
        if self.vector_potential:
            return f"{self._units}*kpc"
        return self._units

    def _output_value(self, field, length_unit, field_unit):
        """A component or coordinate in the requested output units (stored:
        kpc coordinates and ``self._units`` values; a vector potential
        carries an extra length factor)."""
        from ..core import units as U

        v = self[field]
        lfac = U.unit_factor(length_unit)  # kpc per length_unit
        if field in "xyz":
            return v / lfac, length_unit
        if field_unit is None:
            return v, self.units
        ffac = U.unit_factor(field_unit) / U.unit_factor(self._units)
        if self.vector_potential:
            return v / (ffac * lfac), f"{length_unit}*{field_unit}"
        return v / ffac, field_unit

    def write_file(self, filename, overwrite=False, length_unit=None,
                   field_unit=None, format="hdf5"):
        """Write the field and its coordinates, optionally unit-converted,
        as HDF5 datasets or Fortran records (float64)."""
        if length_unit is None:
            length_unit = "kpc"
        if os.path.exists(filename) and not overwrite:
            raise IOError(f"Cannot create {filename}. "
                          "It exists and overwrite=False.")
        all_comps = ["x", "y", "z"] + self.comps

        # every array to the host in one pinned copy (views on the CPU)
        values = [self._output_value(field, length_unit, field_unit)
                  for field in all_comps]
        arrays = to_host([fd for fd, _ in values])

        if format == "hdf5":
            import h5py

            with h5py.File(filename, "w") as f:
                for field, fd, (_, unit) in zip(all_comps, arrays, values):
                    d = f.create_dataset(field, data=fd)
                    d.attrs["units"] = unit
                f.attrs["name"] = self._name
                f.attrs["units"] = self.units
                f.attrs["vector_potential"] = int(self.vector_potential)
                f.attrs["divergence_clean"] = int(self.divergence_clean)
        elif format == "fortran":
            from scipy.io import FortranFile

            with FortranFile(filename, "w") as f:
                f.write_record(int(self.x.numel()))
                for fd in arrays:
                    f.write_record(np.asarray(fd, dtype=np.float64))
        else:
            raise ValueError(f"Unknown format {format}")

    def map_field_to_particles(self, cluster_particles, ptype="gas",
                               units=None):
        """Trilinear interpolation of the field onto the particle positions
        of ``ptype``, stored as the particle field ``self._name``.

        ``units``: the unit of the values handed to ``set_field``; they are
        converted from ``self.units`` first (a unit of another dimension
        raises), so the stored value is the same either way."""
        from ..core import units as U

        pos = cluster_particles[ptype, "particle_position"]
        if pos.device.type != self.device.type:
            raise ValueError(f"the particles live on {pos.device}, the field "
                             f"on {self.device}")
        comps = (self.gx, self.gy, self.gz)
        compiled.room_for(pos.device, *comps)   # the stacked field
        vals = _trilinear(self.x, self.y, self.z, torch.stack(comps), pos)
        out = vals.T
        if units is None:
            cluster_particles.set_field(ptype, self._name, out)
        else:
            factor = U.conversion_factor(self.units, units)
            compiled.room_for(pos.device, vals)
            cluster_particles.set_field(ptype, self._name, out * factor,
                                        units=units)


@compiled.function()
def _trilinear(x, y, z, g, pos):
    """Trilinear sample of a (3, nx, ny, nz) field at (N, 3) points;
    returns (3, N).  One program (JAX ``_trilinear``) keyed by the grid's
    and the particles' counts and the dtypes.

    Points outside ``[coords[0], coords[-1]]`` (the outermost cell centres)
    get 0.  The coordinates are uniform, so each cell index is computed,
    not searched; the three components sit on the trailing axis so that
    each of the 8 corner fetches gathers rows of 3.  Positions are located
    in the promoted dtype of the coordinates and the positions."""
    dt = torch.promote_types(x.dtype, pos.dtype)
    pos = pos.to(dt)

    def axis_locate(coords, p):
        coords = coords.to(dt)
        n = coords.shape[0]
        d = (coords[-1] - coords[0]) / (n - 1)
        t = torch.clamp((p - coords[0]) / d, 0.0, n - 1 - 1e-9)
        # in float32 the 1e-9 margin rounds away at n - 1: the integer
        # clamp is what keeps i + 1 on the grid
        i = torch.clamp_max(t.to(torch.int64), n - 2)
        w = torch.clamp(t - i.to(dt), 0.0, 1.0)
        inside = (p >= coords[0]) & (p <= coords[-1])
        return i, w, inside

    ix, wx, inx = axis_locate(x, pos[:, 0])
    iy, wy, iny = axis_locate(y, pos[:, 1])
    iz, wz, inz = axis_locate(z, pos[:, 2])
    inside = (inx & iny & inz).to(g.dtype)

    ny, nz = g.shape[2], g.shape[3]
    gf = torch.movedim(g, 0, -1).reshape(-1, g.shape[0])  # (nx*ny*nz, 3)
    base = (ix * ny + iy) * nz + iz

    out = 0.0
    for dx_, wx_ in ((0, 1.0 - wx), (1, wx)):
        for dy_, wy_ in ((0, 1.0 - wy), (1, wy)):
            for dz_, wz_ in ((0, 1.0 - wz), (1, wz)):
                flat = base + (dx_ * ny + dy_) * nz + dz_
                out = out + (wx_ * wy_ * wz_)[:, None] * gf[flat]
    return (out * inside[:, None]).T


class GaussianRandomField(ClusterField):
    """Kolmogorov-spectrum Gaussian random vector field.

    ``noise`` (optional): the ``(3, nx, ny, nz)`` standard normals of the
    padded grid, in place of a draw from ``prng`` (an int, a
    ``torch.Generator`` on ``device``, or None).  ``use_rfft`` is accepted
    for the JAX package's signature; there is one route, on half
    spectra."""

    def __init__(self, left_edge, right_edge, ddims, l_min, l_max,
                 padding=0.1, alpha=-11.0 / 3.0, g_rms=1.0, ctr1=None,
                 ctr2=None, ctr3=None, r1=None, r2=None, r3=None, g1=None,
                 g2=None, g3=None, vector_potential=False,
                 divergence_clean=False, prng=None, r_max=None,
                 dtype=torch.float64, use_rfft=None, noise=None,
                 device="cuda"):
        del use_rfft
        super().__init__(left_edge, right_edge, ddims, padding=padding,
                         vector_potential=vector_potential,
                         divergence_clean=divergence_clean, dtype=dtype,
                         device=device)
        shape = tuple(int(n) for n in self.ddims)
        # halo slots bind by POSITION: each slot is validated whole, so a
        # partly given slot raises instead of dropping a halo
        ctrs, rs, gs = [], [], []
        for ctr, r, g, tag in ((ctr1, r1, g1, "1"), (ctr2, r2, g2, "2"),
                               (ctr3, r3, g3, "3")):
            if ctr is None and r is None and g is None:
                continue
            if r is None or g is None:
                raise ValueError(
                    f"halo {tag} is partially specified (r{tag}="
                    f"{'set' if r is not None else None}, g{tag}="
                    f"{'set' if g is not None else None}): each halo "
                    f"needs both r{tag} and g{tag}")
            if ctr is None:
                if tag != "1":
                    raise RuntimeError(
                        f"Need to specify 'ctr{tag}' for halo {tag}!")
                ctr = 0.5 * (self.left_edge + self.right_edge)
            ctrs.append(np.asarray(parse_value(ctr, "kpc")))
            rs.append(parse_value(r, "kpc"))
            gs.append(parse_value(g, self._units))

        k0 = 2.0 * np.pi / float(parse_value(l_min, "kpc"))
        k1 = 2.0 * np.pi / float(parse_value(l_max, "kpc"))

        mylog.info("Setting up the Gaussian random fields.")
        with span("cg.host.inputs"):
            gen = None if noise is not None else parse_prng(prng,
                                                            self.device)
            kx, ky, kz = self._compute_waves()
            self.x, self.y, self.z = self._compute_coords()
            waves = host_to_device(_wave_vector((kx, ky, kz), self.deltas),
                                   self.device)
            noise = _noise_drawer(noise, gen, shape, self.dtype, self.device,
                                  spectra=not ctrs)
            halos = [(tuple(float(c) for c in ctr),
                      _on_device(r, self.device), _on_device(g, self.device))
                     for ctr, r, g in zip(ctrs, rs, gs)]
        statics = dict(shape=shape, dtype=self.dtype,
                       div_clean=bool(self.divergence_clean),
                       vec_pot=bool(self.vector_potential), noise=noise)
        if not ctrs:
            g_rms = float(parse_value(g_rms, self._units))
            mylog.info("Scaling the fields by the constant value %s.", g_rms)
            self.gx, self.gy, self.gz = _constant_rms_field(
                waves, k0, k1, float(alpha), g_rms, **statics)
            mylog.info("Field generation complete.")
            return

        mylog.info("Scaling the fields by %d cluster profile(s).", len(ctrs))
        if self.divergence_clean:
            mylog.info("Perform divergence cleaning.")
        if self.vector_potential:
            mylog.info("Compute vector potential.")
        if r_max is not None:
            r_max = float(parse_value(r_max, "kpc"))
        self.gx, self.gy, self.gz = _radial_field(
            waves, self.x, self.y, self.z, halos, r_max, k0, k1, float(alpha),
            **statics)
        mylog.info("Field generation complete.")


def _load_radial_profile(profile, field_name):
    """(r, g) from a ClusterModel, an HDF5 model file or an (r, g) tuple."""
    from ..model import ClusterModel

    if isinstance(profile, ClusterModel):
        return profile["radius"], profile[field_name]
    if isinstance(profile, (str, os.PathLike)):
        import h5py

        with h5py.File(profile, "r") as f:
            r = np.asarray(f["fields"]["radius"][()])
            g = np.asarray(f["fields"][field_name][()])
        return r, g
    r, g = profile
    return r, g


class RandomMagneticField(GaussianRandomField):
    """Constant-rms magnetic field, in gauss, divergence-cleaned."""

    _units = "gauss"
    _name = "magnetic_field"
    _vector_potential = False

    def __init__(self, left_edge, right_edge, ddims, l_min, l_max, B_rms,
                 padding=0.1, alpha=-11.0 / 3.0, prng=None,
                 dtype=torch.float64, use_rfft=None, noise=None,
                 device="cuda"):
        super().__init__(left_edge, right_edge, ddims, l_min, l_max,
                         padding=padding, alpha=alpha, divergence_clean=True,
                         g_rms=B_rms, vector_potential=self._vector_potential,
                         prng=prng, dtype=dtype, use_rfft=use_rfft,
                         noise=noise, device=device)


class RadialRandomMagneticField(GaussianRandomField):
    """Magnetic field scaled by up to three radial B(r) profiles."""

    _units = "gauss"
    _name = "magnetic_field"
    _vector_potential = False
    _profile_field = "magnetic_field_strength"

    def __init__(self, left_edge, right_edge, ddims, l_min, l_max, ctr1,
                 profile1, padding=0.1, ctr2=None, profile2=None, ctr3=None,
                 profile3=None, alpha=-11.0 / 3.0, r_max=None, prng=None,
                 divergence_clean=True, dtype=torch.float64, noise=None,
                 device="cuda"):
        r1, g1 = _load_radial_profile(profile1, self._profile_field)
        r2 = g2 = r3 = g3 = None
        if profile2 is not None:
            r2, g2 = _load_radial_profile(profile2, self._profile_field)
        if profile3 is not None:
            r3, g3 = _load_radial_profile(profile3, self._profile_field)
        super().__init__(left_edge, right_edge, ddims, l_min, l_max,
                         padding=padding, alpha=alpha, ctr1=ctr1, ctr2=ctr2,
                         ctr3=ctr3, r1=r1, r2=r2, r3=r3, g1=g1, g2=g2, g3=g3,
                         divergence_clean=divergence_clean, r_max=r_max,
                         vector_potential=self._vector_potential, prng=prng,
                         dtype=dtype, noise=noise, device=device)


class RandomMagneticVectorPotential(RandomMagneticField):
    """The vector potential of a constant-rms magnetic field."""

    _name = "magnetic_vector_potential"
    _vector_potential = True


class RadialRandomMagneticVectorPotential(RadialRandomMagneticField):
    """The vector potential of a radially scaled magnetic field."""

    _name = "magnetic_vector_potential"
    _vector_potential = True


class RandomVelocityField(GaussianRandomField):
    """Constant-rms turbulent velocity field, in kpc/Myr."""

    _units = "kpc/Myr"
    _name = "velocity"

    def __init__(self, left_edge, right_edge, ddims, l_min, l_max, V_rms,
                 padding=0.1, alpha=-11.0 / 3.0, divergence_clean=False,
                 prng=None, dtype=torch.float64, noise=None, device="cuda"):
        super().__init__(left_edge, right_edge, ddims, l_min, l_max,
                         padding=padding, g_rms=V_rms, alpha=alpha, prng=prng,
                         divergence_clean=divergence_clean, dtype=dtype,
                         noise=noise, device=device)


class RadialRandomVelocityField(RadialRandomMagneticField):
    """Velocity field scaled by sigma_v(r) profiles."""

    _units = "kpc/Myr"
    _name = "velocity"
    _vector_potential = False
    _profile_field = "velocity_dispersion"

    def __init__(self, left_edge, right_edge, ddims, l_min, l_max, ctr1,
                 profile1, padding=0.1, ctr2=None, profile2=None, ctr3=None,
                 profile3=None, alpha=-11.0 / 3.0, r_max=None,
                 divergence_clean=False, prng=None, dtype=torch.float64,
                 noise=None, device="cuda"):
        super().__init__(left_edge, right_edge, ddims, l_min, l_max, ctr1,
                         profile1, padding=padding, ctr2=ctr2,
                         profile2=profile2, ctr3=ctr3, profile3=profile3,
                         alpha=alpha, r_max=r_max, prng=prng,
                         divergence_clean=divergence_clean, dtype=dtype,
                         noise=noise, device=device)

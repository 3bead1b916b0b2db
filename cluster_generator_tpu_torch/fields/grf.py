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
  power-preserving rescale come from the spectra by Parseval;
* radial (up to three halo profiles): unit-rms shaping, the real-space
  scale sqrt(sum_h g_h(r)^2), then the projection and the vector potential
  as staged transforms.

Field components are tensors on the field's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.interp import interp
from ..core.logging import mylog
from ..sampling import parse_prng

__all__ = ["ClusterField", "GaussianRandomField", "RandomMagneticField",
           "RadialRandomMagneticField", "RandomMagneticVectorPotential",
           "RadialRandomMagneticVectorPotential", "RandomVelocityField",
           "RadialRandomVelocityField", "parse_value"]

# k-space arithmetic of the constant-rms route runs on slabs of at most this
# many half-spectrum entries, so that its temporaries stay small beside the
# three spectra
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


def _half(kz):
    """The non-negative half of the z wavenumbers that ``rfftn`` keeps."""
    return kz[..., :kz.shape[-1] // 2 + 1]


def _draw_noise(noise, gen, shape, dtype, device):
    """``(3, nx, ny, nz)`` standard normals in ``dtype``: ``noise`` as
    given, or one draw from ``gen``."""
    if noise is None:
        return torch.randn((3,) + tuple(shape), generator=gen, dtype=dtype,
                           device=device)
    noise = torch.as_tensor(noise, dtype=dtype, device=device)
    if tuple(noise.shape) != (3,) + tuple(shape):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, the field "
                         f"needs {(3,) + tuple(shape)}")
    return noise


def _plane_power(w):
    """sum |w|^2 over the first two axes, per kz plane, in float64."""
    return torch.view_as_real(w).square().sum(dim=(0, 1, 3),
                                              dtype=torch.float64)


def _constant_rms_route(noise, gen, shape, waves, k0, k1, alpha, g_rms,
                        deltas, div_clean, vec_pot, dtype, device):
    """The constant-rms field on half spectra: shaping, rms normalisation,
    divergence projection with its power-preserving rescale and the vector
    potential in one k-space pass between 3 forward and 3 inverse
    transforms.  The k-space arithmetic runs slab by slab along x."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    n_cells = nx * ny * nz
    kx, ky, kz = waves

    def dev(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    # every wavenumber array (nx, 1, 1), (1, ny, 1), (1, 1, nzh); sliced
    # along x per slab.  The shaping in float64, the rest at the field's
    # real dtype: a float64 operand would promote complex64 spectra
    k64 = [dev(kx, torch.float64), dev(ky, torch.float64),
           dev(_half(kz), torch.float64)]
    kd = [dev(np.sin(k * d) / d) for k, d in
          zip((kx, ky, _half(kz)), deltas)]
    k_odd = [dev(_odd_waves(kx)), dev(_odd_waves(ky)),
             dev(_half(_odd_waves(kz)))]
    k_sq = [dev(kx) ** 2, dev(ky) ** 2, dev(_half(kz)) ** 2]
    # Parseval weights of the kz planes: 2 where the dropped half holds the
    # conjugate mirror, 1 for the self-conjugate kz = 0 (and kz = nz/2)
    wz = torch.full((nzh,), 2.0, dtype=torch.float64, device=device)
    wz[0] = 1.0
    if nz % 2 == 0:
        wz[-1] = 1.0
    step = max(1, _SLAB // (ny * nzh))
    slabs = [slice(i, min(i + step, nx)) for i in range(0, nx, step)]

    noise = _draw_noise(noise, gen, shape, dtype, device)
    W = [torch.fft.rfftn(noise[c]) for c in range(3)]
    del noise

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
    out = []
    while W:
        out.append(torch.fft.irfftn(W.pop(0), s=shape))
    return tuple(out)


def _unit_rms_field(noise, shape, waves, k0, k1, alpha):
    """White noise -> spectrum-shaped unit-rms Gaussian random field."""
    kx, ky, kz = (torch.as_tensor(k, device=noise.device)
                  for k in (waves[0], waves[1], _half(waves[2])))
    sigma = _spectrum_sigma(torch.sqrt(kx**2 + ky**2 + kz**2), k0, k1, alpha,
                            noise.dtype)
    g = [torch.fft.irfftn(torch.fft.rfftn(noise[c]) * sigma, s=shape)
         for c in range(3)]
    g_avg = torch.sqrt(torch.mean(g[0]**2 + g[1]**2 + g[2]**2))
    return tuple(x / g_avg for x in g)


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
        return [torch.as_tensor(np.linspace(le[i], re[i], self.ddims[i]),
                                device=self.device) for i in range(3)]

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

    def _transform(self, mul):
        """Replace (gx, gy, gz) by the inverse transform of ``mul`` applied
        to their half spectra."""
        shape = tuple(int(n) for n in self.ddims)
        W = [torch.fft.rfftn(g) for g in (self.gx, self.gy, self.gz)]
        self.gx, self.gy, self.gz = (torch.fft.irfftn(w, s=shape)
                                     for w in mul(*W))

    def _divergence_clean(self, kx, ky, kz):
        """Transform -> finite-difference projection -> inverse."""
        mylog.info("Perform divergence cleaning.")
        # the wavenumbers at the field's real dtype: a float64 operand would
        # promote complex64 spectra to complex128
        kd = [torch.as_tensor(np.sin(k * d) / d, dtype=self.dtype,
                              device=self.device)
              for k, d in zip((kx, ky, _half(kz)), self.deltas)]
        self._transform(lambda *W: _div_clean_k(*W, *kd))

    def _compute_vector_potential(self, kx, ky, kz):
        """Replace g by A with curl A = g."""
        mylog.info("Compute vector potential.")

        def dev(k):
            return torch.as_tensor(k, dtype=self.dtype, device=self.device)

        k_odd = [dev(_odd_waves(kx)), dev(_odd_waves(ky)),
                 dev(_half(_odd_waves(kz)))]
        k2 = dev(kx) ** 2 + dev(ky) ** 2 + dev(_half(kz)) ** 2
        self._transform(lambda *W: _vector_potential_k(*W, *k_odd, k2))

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

        def host(field):
            fd, unit = self._output_value(field, length_unit, field_unit)
            return fd.cpu().numpy(), unit

        if format == "hdf5":
            import h5py

            with h5py.File(filename, "w") as f:
                for field in all_comps:
                    fd, unit = host(field)
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
                for field in all_comps:
                    f.write_record(np.asarray(host(field)[0],
                                              dtype=np.float64))
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
        vals = _trilinear(self.x, self.y, self.z,
                          torch.stack([self.gx, self.gy, self.gz]), pos)
        out = vals.T
        if units is None:
            cluster_particles.set_field(ptype, self._name, out)
        else:
            factor = U.conversion_factor(self.units, units)
            cluster_particles.set_field(ptype, self._name, out * factor,
                                        units=units)


def _trilinear(x, y, z, g, pos):
    """Trilinear sample of a (3, nx, ny, nz) field at (N, 3) points;
    returns (3, N).

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
        gen = None if noise is not None else parse_prng(prng, self.device)

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
        kx, ky, kz = self._compute_waves()
        self.x, self.y, self.z = self._compute_coords()

        if not ctrs:
            g_rms = float(parse_value(g_rms, self._units))
            mylog.info("Scaling the fields by the constant value %s.", g_rms)
            self.gx, self.gy, self.gz = _constant_rms_route(
                noise, gen, shape, (kx, ky, kz), k0, k1, alpha, g_rms,
                self.deltas, self.divergence_clean, self.vector_potential,
                self.dtype, self.device)
            mylog.info("Field generation complete.")
            return

        noise = _draw_noise(noise, gen, shape, self.dtype, self.device)
        self.gx, self.gy, self.gz = _unit_rms_field(noise, shape,
                                                    (kx, ky, kz), k0, k1,
                                                    alpha)
        del noise

        X = self.x[:, None, None]
        Y = self.y[None, :, None]
        Z = self.z[None, None, :]
        g2sum = torch.zeros(shape, dtype=self.dtype, device=self.device)
        for ctr, rprof, gprof in zip(ctrs, rs, gs):
            mylog.info("Scaling the fields by a cluster profile.")
            rr = torch.sqrt((X - float(ctr[0])) ** 2 + (Y - float(ctr[1])) ** 2
                            + (Z - float(ctr[2])) ** 2)
            if r_max is not None:
                rr = torch.clamp_max(rr, float(parse_value(r_max, "kpc")))
            gval = interp(rr, torch.as_tensor(rprof, device=self.device),
                          torch.as_tensor(gprof, device=self.device))
            g2sum = g2sum + gval.to(self.dtype) ** 2
        scale = torch.sqrt(g2sum)
        self.gx = self.gx * scale
        self.gy = self.gy * scale
        self.gz = self.gz * scale

        if self.divergence_clean:
            # keep <g^2> through the projection
            power = (torch.sum(self.gx**2) + torch.sum(self.gy**2)
                     + torch.sum(self.gz**2))
            self._divergence_clean(kx, ky, kz)
            power2 = (torch.sum(self.gx**2) + torch.sum(self.gy**2)
                      + torch.sum(self.gz**2))
            rescale = torch.sqrt(power / power2)
            self.gx = self.gx * rescale
            self.gy = self.gy * rescale
            self.gz = self.gz * rescale

        if self.vector_potential:
            self._compute_vector_potential(kx, ky, kz)

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

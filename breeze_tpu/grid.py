"""Rectilinear staggered (Arakawa C) grids for atmospheric simulation.

Design notes
------------
Arrays are laid out ``(z, y, x)``: x is the contiguous (fastest-varying)
axis, then y, and z is the outer, sequential axis (columns are never sharded,
matching the reference's assumption that the vertical is the implicit axis).

Index conventions (C-grid, mirrors the reference's Oceananigans substrate,
see reference ``src/Breeze.jl:202`` import surface):

- Cell centers: ``i = 0..N-1`` at positions ``x_c[i]``.
- Faces: face ``i`` is the *lower* edge of cell ``i`` (``x_f[i] <= x_c[i]``).
- ``u[i]`` lives on face ``i`` (between cells ``i-1`` and ``i``).
- Along a Bounded axis, a face-located field stores faces ``0..N-1``; the
  topmost face ``N`` is a wall where the normal velocity vanishes.

All fields therefore share the shape ``(nz, ny, nx)``; staggering is encoded
by *location* metadata, not shape — critical for XLA, which wants uniform
static shapes.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


class Topology(enum.Enum):
    """Topology of one grid direction.

    Mirrors the reference's ``Periodic``/``Bounded``/``Flat`` topologies.
    """

    PERIODIC = "periodic"
    BOUNDED = "bounded"
    FLAT = "flat"


PERIODIC = Topology.PERIODIC
BOUNDED = Topology.BOUNDED
FLAT = Topology.FLAT


def _uniform_spacing(extent: float, n: int) -> float:
    return extent / n


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["z_c", "z_f", "dz_c", "dz_f",
                 "coslat_c", "coslat_f", "tanlat_c", "tanlat_f"],
    meta_fields=[
        "nx", "ny", "nz",
        "x_topology", "y_topology", "z_topology",
        "x0", "y0", "z0", "Lx", "Ly", "Lz",
        "dx", "dy", "halo", "dtype_name", "uniform_z", "dz_min",
        "z_c_meta", "radius",
    ],
)
@dataclasses.dataclass(frozen=True)
class Grid:
    """A rectilinear, possibly vertically-stretched, staggered grid.

    Analogue of the reference's ``RectilinearGrid``: horizontal
    spacings are uniform scalars (x, y are the FFT/shard axes); the vertical
    may be stretched, carried as 1-D arrays:

    - ``z_c[k]``  : height of cell center ``k``      (shape ``(nz,)``)
    - ``z_f[k]``  : height of face ``k``             (shape ``(nz+1,)``)
    - ``dz_c[k]`` : ``z_f[k+1] - z_f[k]``            (shape ``(nz,)``, center spacing)
    - ``dz_f[k]`` : ``z_c[k] - z_c[k-1]`` padded     (shape ``(nz+1,)``, face spacing)
    """

    nx: int
    ny: int
    nz: int
    x_topology: Topology
    y_topology: Topology
    z_topology: Topology
    x0: float
    y0: float
    z0: float
    Lx: float
    Ly: float
    Lz: float
    dx: float
    dy: float
    halo: int
    dtype_name: str
    uniform_z: bool
    dz_min: float          # static min(dz_c): usable under jit traces
    z_c: jax.Array
    z_f: jax.Array
    dz_c: jax.Array
    dz_f: jax.Array
    # Lat-lon metric (None on Cartesian grids).  On a LatitudeLongitudeGrid
    # (reference re-export, src/Breeze.jl:202): x = longitude λ [rad spacing
    # dx/radius], y = latitude φ; the cos/tan factors carry the spherical
    # metric (shallow-atmosphere approximation, metric frozen at radius).
    #: static copy of the cell-center heights (Python floats) — usable for
    #: compile-time interpolation weights under jit, where ``z_c`` is a tracer.
    z_c_meta: tuple = ()
    radius: float | None = None
    coslat_c: jax.Array | None = None   # (ny,) at y-centers
    coslat_f: jax.Array | None = None   # (ny+1,) at y-faces
    tanlat_c: jax.Array | None = None   # (ny,)
    tanlat_f: jax.Array | None = None   # (ny+1,)

    # ------------------------------------------------------------------
    @property
    def is_latlon(self) -> bool:
        return self.radius is not None

    @property
    def dtype(self):
        return jnp.dtype(self.dtype_name)

    @property
    def shape(self) -> tuple[int, int, int]:
        """Field shape ``(nz, ny, nx)``."""
        return (self.nz, self.ny, self.nx)

    @property
    def dz_c_col(self) -> jax.Array:
        """``dz_c`` broadcastable against ``(nz, ny, nx)`` fields."""
        return self.dz_c[:, None, None]

    @property
    def dz_f_col(self) -> jax.Array:
        """``dz_f[0:nz]`` (the stored w faces) broadcastable to fields."""
        return self.dz_f[: self.nz, None, None]

    @property
    def z_c_col(self) -> jax.Array:
        return self.z_c[:, None, None]

    @property
    def z_f_col(self) -> jax.Array:
        return self.z_f[: self.nz, None, None]

    def x_c(self) -> np.ndarray:
        return self.x0 + (np.arange(self.nx) + 0.5) * self.dx

    def x_f(self) -> np.ndarray:
        return self.x0 + np.arange(self.nx) * self.dx

    def y_c(self) -> np.ndarray:
        return self.y0 + (np.arange(self.ny) + 0.5) * self.dy

    def y_f(self) -> np.ndarray:
        return self.y0 + np.arange(self.ny) * self.dy

    # Meshes broadcastable to (nz, ny, nx), useful for initial conditions.
    # On lat-lon grids the horizontal coordinates are (longitude, latitude)
    # in RADIANS; on Cartesian grids they are meters.
    def xyz_c(self):
        x = jnp.asarray(self.x_c(), self.dtype)[None, None, :]
        y = jnp.asarray(self.y_c(), self.dtype)[None, :, None]
        if self.is_latlon:
            x = x / self.radius
            y = y / self.radius
        z = self.z_c[:, None, None]
        return x, y, z

    def topologies(self) -> tuple[Topology, Topology, Topology]:
        """Topologies in array-axis order (z, y, x)."""
        return (self.z_topology, self.y_topology, self.x_topology)


def make_grid(
    size: tuple[int, int, int],
    extent: tuple[float, float, float] | None = None,
    x: tuple[float, float] | None = None,
    y: tuple[float, float] | None = None,
    z: tuple[float, float] | Callable[[int], float] | np.ndarray | None = None,
    topology: tuple[Topology, Topology, Topology] = (PERIODIC, PERIODIC, BOUNDED),
    halo: int = 3,
    dtype=jnp.float32,
) -> Grid:
    """Build a :class:`Grid`.

    Args:
      size: ``(nx, ny, nz)``.
      extent: ``(Lx, Ly, Lz)`` with origin 0 (exclusive with x/y/z).
      x, y: ``(min, max)`` intervals.
      z: ``(min, max)`` interval for uniform spacing, an array of ``nz+1``
        face heights for a stretched grid, or a callable ``k -> z_f(k)``
        over ``k = 0..nz`` (mirrors the reference's function-valued ``z``).
      topology: per-direction topology ``(x, y, z)``.
      halo: halo width (3 suffices for WENO5; use 5 for WENO9).
      dtype: field floating dtype.
    """
    nx, ny, nz = size
    if extent is not None:
        x = (0.0, float(extent[0]))
        y = (0.0, float(extent[1]))
        if z is None:
            z = (0.0, float(extent[2]))
    assert x is not None and y is not None and z is not None

    tx, ty, tz = topology
    x0, x1 = float(x[0]), float(x[1])
    y0, y1 = float(y[0]), float(y[1])

    if callable(z):
        z_f = np.asarray([float(z(k)) for k in range(nz + 1)], dtype=np.float64)
    elif isinstance(z, (tuple, list)) and len(z) == 2 and np.isscalar(z[0]):
        z_f = np.linspace(float(z[0]), float(z[1]), nz + 1, dtype=np.float64)
    else:
        z_f = np.asarray(z, dtype=np.float64)
        assert z_f.shape == (nz + 1,), "stretched z must provide nz+1 face heights"

    z_c = 0.5 * (z_f[1:] + z_f[:-1])
    dz_c = np.diff(z_f)  # (nz,)
    # Face spacings: dz_f[k] = z_c[k] - z_c[k-1]; ends use half-cell closure.
    dz_f = np.empty(nz + 1, dtype=np.float64)
    dz_f[1:nz] = z_c[1:] - z_c[:-1]
    dz_f[0] = dz_c[0]
    dz_f[nz] = dz_c[-1]

    uniform_z = bool(np.allclose(dz_c, dz_c[0]))

    fdtype = jnp.dtype(dtype)
    return Grid(
        nx=nx, ny=ny, nz=nz,
        x_topology=tx, y_topology=ty, z_topology=tz,
        x0=x0, y0=y0, z0=float(z_f[0]),
        Lx=x1 - x0, Ly=y1 - y0, Lz=float(z_f[-1] - z_f[0]),
        dx=_uniform_spacing(x1 - x0, nx),
        dy=_uniform_spacing(y1 - y0, ny),
        halo=int(halo),
        dtype_name=str(fdtype),
        uniform_z=uniform_z,
        dz_min=float(dz_c.min()),
        z_c_meta=tuple(float(v) for v in z_c),
        z_c=jnp.asarray(z_c, fdtype),
        z_f=jnp.asarray(z_f, fdtype),
        dz_c=jnp.asarray(dz_c, fdtype),
        dz_f=jnp.asarray(dz_f, fdtype),
    )


def make_latlon_grid(
    size: tuple[int, int, int],
    longitude: tuple[float, float] = (0.0, 360.0),
    latitude: tuple[float, float] = (-80.0, 80.0),
    z: tuple[float, float] | np.ndarray = (0.0, 10_000.0),
    radius: float = 6.371e6,
    halo: int = 3,
    dtype=jnp.float32,
) -> Grid:
    """Latitude-longitude grid on a sphere of ``radius`` (shallow atmosphere).

    Analogue of the reference's ``LatitudeLongitudeGrid``
    (re-export ``src/Breeze.jl:202``; used by the baroclinic-wave and
    DCMIP configs): x is longitude (periodic when spanning 360°), y is
    latitude (bounded), z is height.  ``dx``/``dy`` store the *equatorial*
    arc spacings R·Δλ and R·Δφ; the stored cos/tan latitude factors carry
    the metric so that operators compute

        ∂x = δx / (R cosφ Δλ),   div_y-term = δy(cosφ_f F) / (R cosφ_c Δφ).
    """
    nx, ny, nz = size
    lon0, lon1 = np.deg2rad(longitude[0]), np.deg2rad(longitude[1])
    lat0, lat1 = np.deg2rad(latitude[0]), np.deg2rad(latitude[1])
    x_periodic = abs((longitude[1] - longitude[0]) - 360.0) < 1e-10

    dlam = (lon1 - lon0) / nx
    dphi = (lat1 - lat0) / ny
    lat_c = lat0 + (np.arange(ny) + 0.5) * dphi
    lat_f = lat0 + np.arange(ny + 1) * dphi

    base = make_grid((nx, ny, nz),
                     x=(radius * lon0, radius * lon1),
                     y=(radius * lat0, radius * lat1),
                     z=z,
                     topology=(PERIODIC if x_periodic else BOUNDED,
                               BOUNDED, BOUNDED),
                     halo=halo, dtype=dtype)
    fdtype = jnp.dtype(dtype)
    return dataclasses.replace(
        base,
        radius=float(radius),
        coslat_c=jnp.asarray(np.cos(lat_c), fdtype),
        coslat_f=jnp.asarray(np.cos(lat_f), fdtype),
        tanlat_c=jnp.asarray(np.tan(lat_c), fdtype),
        tanlat_f=jnp.asarray(np.tan(lat_f), fdtype),
    )


def piecewise_stretched_z(
    nz: int,
    surface_layer_height: float,
    surface_layer_spacing: float,
    top: float,
    stretching: float = 1.02,
) -> np.ndarray:
    """Face heights for a surface-resolving stretched vertical grid.

    Equivalent of the reference's
    ``PiecewiseStretchedDiscretization`` (``src/VerticalGrids.jl:47-82``):
    uniform ``surface_layer_spacing`` up to ``surface_layer_height``, then
    geometric stretching by ``stretching`` per level, rescaled so the last
    face lands exactly on ``top``.
    """
    faces = [0.0]
    while faces[-1] + surface_layer_spacing <= surface_layer_height + 1e-9:
        faces.append(faces[-1] + surface_layer_spacing)
    dz = surface_layer_spacing
    while len(faces) < nz + 1:
        dz *= stretching
        faces.append(faces[-1] + dz)
    faces = np.asarray(faces[: nz + 1], dtype=np.float64)
    # Rescale the stretched section so faces[-1] == top exactly.
    n_uniform = int(np.searchsorted(faces, surface_layer_height + 1e-9))
    if faces[-1] != top and len(faces) - 1 > n_uniform:
        z_pivot = faces[n_uniform]
        scale = (top - z_pivot) / (faces[-1] - z_pivot)
        faces[n_uniform:] = z_pivot + (faces[n_uniform:] - z_pivot) * scale
    return faces

"""
Minimal labeled N-d arrays with netCDF round-trip (a copy of
``amof_tpu/labeled.py``: numpy and scipy only; BadByCn's result).

The reference returns xarray objects for BAD-by-CN (amof/bad.py:294-300),
ring statistics (amof/ring/core.py:142-149) and elastic constants
(amof/elastic/core.py:150-157), serialized as netCDF. xarray and netCDF4
are not dependencies of this rebuild; this module provides the small
subset actually used — named dims, 1-d coordinates, exact-label selection,
fillna, and netCDF-3 (classic) file round-trip via scipy.io.netcdf_file.
netCDF-4 (HDF5-based) files — what the reference writes when the
netcdf4 package is installed — are additionally readable through h5py.

String coordinates are stored as netCDF-3 char matrices with a
``string<N>`` auxiliary dimension (the same convention xarray uses), so
files written here remain readable by xarray and vice versa.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.io import netcdf_file


class DataArray:
    """N-d array with named dims and optional per-dim coordinate labels."""

    def __init__(self, values, coords=None, dims=None, name=None):
        self.values = np.asarray(values)
        if dims is None and coords is not None and not isinstance(coords, dict):
            # xarray-style list of (dim, coord_values) pairs
            dims = tuple(c[0] for c in coords)
            coords = {c[0]: np.asarray(c[1]) for c in coords}
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(self.values.ndim))
        self.dims: Tuple[str, ...] = tuple(dims)
        if len(self.dims) != self.values.ndim:
            raise ValueError("dims / values rank mismatch")
        self.coords: Dict[str, np.ndarray] = {}
        if coords:
            for k, v in coords.items():
                self.coords[k] = np.asarray(v)
        for d, size in zip(self.dims, self.values.shape):
            if d in self.coords and len(self.coords[d]) != size:
                raise ValueError(f"coord {d} length mismatch")
        self.name = name

    # -- basic API ----------------------------------------------------------
    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.ndim

    def __array__(self, dtype=None):
        return np.asarray(self.values, dtype=dtype)

    def _axis(self, dim: str) -> int:
        return self.dims.index(dim)

    def get_coord(self, dim: str) -> np.ndarray:
        if dim in self.coords:
            return self.coords[dim]
        return np.arange(self.values.shape[self._axis(dim)])

    def isel(self, **indexers) -> "DataArray":
        """Select by integer position along named dims."""
        out = self
        for dim, idx in indexers.items():
            ax = out._axis(dim)
            values = np.take(out.values, idx, axis=ax)
            coords = dict(out.coords)
            drop = np.isscalar(idx)
            if dim in coords:
                coords[dim] = np.take(coords[dim], idx)
                if drop:
                    coords.pop(dim)
            dims = tuple(d for i, d in enumerate(out.dims) if not (drop and i == ax))
            out = DataArray(values, coords=coords, dims=dims, name=out.name)
        return out

    def sel(self, **indexers) -> "DataArray":
        """Select by coordinate label (exact match)."""
        pos = {}
        for dim, label in indexers.items():
            coord = self.get_coord(dim)
            if np.isscalar(label) or isinstance(label, str):
                matches = np.nonzero(coord == label)[0]
                if len(matches) == 0:
                    raise KeyError(f"{label!r} not in coord {dim!r}")
                pos[dim] = int(matches[0])
            else:
                pos[dim] = [int(np.nonzero(coord == l)[0][0]) for l in label]
        return self.isel(**pos)

    def fillna(self, value) -> "DataArray":
        values = np.where(np.isnan(self.values.astype(np.float64)), value, self.values)
        return DataArray(values, coords=self.coords, dims=self.dims, name=self.name)

    def rename(self, name) -> "DataArray":
        return DataArray(self.values, coords=self.coords, dims=self.dims, name=name)

    def allclose(self, other, **kw) -> bool:
        return (
            self.dims == other.dims
            and self.shape == other.shape
            and np.allclose(self.values, other.values, **kw)
        )

    def __repr__(self):
        return (
            f"DataArray{self.dims} shape={self.shape} name={self.name!r}\n"
            f"coords: {list(self.coords)}"
        )

    # -- IO -----------------------------------------------------------------
    def to_netcdf(self, path):
        Dataset({self.name or "data": self}).to_netcdf(path)

    def to_dataset(self, name=None) -> "Dataset":
        return Dataset({name or self.name or "data": self})


def concat(arrays: Sequence[DataArray], dim: str, labels=None, fill=np.nan) -> DataArray:
    """Stack DataArrays along a new leading dim, aligning coords by label
    (outer join, missing entries filled) — covers the xr.Dataset ->
    to_array('Step') + fillna(0) idiom of amof/ring/core.py:142-149."""
    # union of coords per existing dim, preserving first-seen order
    base_dims = arrays[0].dims
    unions: List[np.ndarray] = []
    for d in base_dims:
        seen: List = []
        for a in arrays:
            for v in a.get_coord(d).tolist():
                if v not in seen:
                    seen.append(v)
        unions.append(np.asarray(seen))
    shape = (len(arrays),) + tuple(len(u) for u in unions)
    out = np.full(shape, fill, dtype=np.result_type(*(a.values.dtype for a in arrays), type(fill)))
    for k, a in enumerate(arrays):
        # index of each of a's labels in the union (int64 even when empty)
        idx = [
            np.array(
                [int(np.nonzero(u == v)[0][0]) for v in a.get_coord(d)],
                dtype=np.int64,
            )
            for d, u in zip(base_dims, unions)
        ]
        out[(k,) + np.ix_(*idx)] = a.values
    coords = {d: u for d, u in zip(base_dims, unions)}
    if labels is not None:
        coords[dim] = np.asarray(labels)
    return DataArray(out, coords=coords, dims=(dim,) + base_dims,
                     name=arrays[0].name)


def _nc3_dtype(dtype) -> np.dtype:
    """Narrow a dtype to one NetCDF-3 classic supports (no 64-bit ints)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "i" and dtype.itemsize > 4:
        return np.dtype(np.int32)
    if dtype.kind == "u":
        return np.dtype(np.int32)
    if dtype.kind == "f" and dtype.itemsize < 4:
        return np.dtype(np.float32)
    if dtype.kind == "b":
        return np.dtype(np.int8)
    if dtype.kind not in "if":
        raise ValueError(f"unsupported dtype {dtype} for NetCDF-3")
    return dtype


class Dataset:
    """Named collection of DataArrays (shared-coord semantics not
    enforced — files store each variable with its own dims)."""

    def __init__(self, data_vars: Optional[Dict[str, DataArray]] = None):
        self.data_vars: Dict[str, DataArray] = dict(data_vars or {})

    def __getitem__(self, key) -> DataArray:
        return self.data_vars[key]

    def __setitem__(self, key, value: DataArray):
        self.data_vars[key] = value.rename(key)

    def __contains__(self, key):
        return key in self.data_vars

    def keys(self):
        return self.data_vars.keys()

    def to_netcdf(self, path):
        with netcdf_file(str(path), "w", version=2) as f:
            created_dims: Dict[str, int] = {}
            str_dims: Dict[int, str] = {}

            def ensure_dim(name, size):
                if name in created_dims:
                    if created_dims[name] != size:
                        raise ValueError(f"conflicting sizes for dim {name}")
                    return
                f.createDimension(name, size)
                created_dims[name] = size

            def ensure_string_dim(maxlen):
                if maxlen not in str_dims:
                    name = f"string{maxlen}"
                    ensure_dim(name, maxlen)
                    str_dims[maxlen] = name
                return str_dims[maxlen]

            written_coords = set()
            for var_name, da in self.data_vars.items():
                for d, size in zip(da.dims, da.shape):
                    ensure_dim(d, size)
                for d in da.dims:
                    if d in da.coords and d not in written_coords:
                        cv = da.coords[d]
                        if cv.dtype.kind in ("U", "S", "O"):
                            strs = [str(s) for s in cv]
                            maxlen = max(1, max(len(s) for s in strs))
                            sdim = ensure_string_dim(maxlen)
                            v = f.createVariable(d, "S1", (d, sdim))
                            arr = np.zeros((len(strs), maxlen), dtype="S1")
                            for i, s in enumerate(strs):
                                enc = s.encode()
                                arr[i, : len(enc)] = np.frombuffer(enc, dtype="S1")
                            v[:] = arr
                        else:
                            dt = _nc3_dtype(cv.dtype)
                            v = f.createVariable(d, dt, (d,))
                            v[:] = cv.astype(dt)
                        written_coords.add(d)
                dt = _nc3_dtype(da.values.dtype)
                v = f.createVariable(var_name, dt, da.dims)
                v[:] = da.values.astype(dt)

    @classmethod
    def from_netcdf(cls, path) -> "Dataset":
        """Read a netCDF file: classic netCDF-3 via scipy, or netCDF-4
        (HDF5-based, what the reference's xarray writes when netcdf4 is
        installed) via h5py (ADVICE r1: reference-produced outputs must
        be readable)."""
        with open(path, "rb") as fh:
            magic = fh.read(8)
        if magic.startswith(b"\x89HDF"):
            return cls._from_netcdf4_h5(path)
        return cls._from_netcdf3(path)

    @classmethod
    def _from_netcdf4_h5(cls, path) -> "Dataset":
        import h5py

        coords: Dict[str, np.ndarray] = {}
        data: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {}

        def decode(ds):
            values = ds[()]
            if h5py.check_string_dtype(ds.dtype) is not None:
                flat = [
                    x.decode() if isinstance(x, bytes) else str(x)
                    for x in np.ravel(values)
                ]
                values = np.array(flat).reshape(np.shape(values))
            return np.asarray(values)

        with h5py.File(str(path), "r") as f:
            for name, ds in f.items():
                if not isinstance(ds, h5py.Dataset):
                    continue
                # netCDF-4 phony dimensions carry a marker NAME and no data
                nc_name = ds.attrs.get("NAME", b"")
                if isinstance(nc_name, bytes) and nc_name.startswith(
                    b"This is a netCDF dimension but not a netCDF variable"
                ):
                    continue
                vdims = []
                for i, dim in enumerate(ds.dims):
                    if len(dim) > 0:
                        vdims.append(dim[0].name.split("/")[-1])
                    else:
                        vdims.append(name if ds.ndim == 1 else f"dim_{i}")
                vdims = tuple(vdims)
                values = decode(ds)
                is_scale = ds.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"
                if is_scale and vdims == (name,):
                    coords[name] = values
                else:
                    data[name] = (vdims, values)
        ds_out = cls()
        for name, (vdims, values) in data.items():
            c = {d: coords[d] for d in vdims if d in coords}
            ds_out.data_vars[name] = DataArray(
                values, coords=c, dims=vdims, name=name
            )
        return ds_out

    @classmethod
    def _from_netcdf3(cls, path) -> "Dataset":
        with netcdf_file(str(path), "r", mmap=False) as f:
            dims = dict(f.dimensions)
            coords: Dict[str, np.ndarray] = {}
            data: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {}
            for name, var in f.variables.items():
                vdims = tuple(var.dimensions)
                values = np.array(var[:])
                is_char = values.dtype.kind == "S" and len(vdims) >= 1 and str(
                    vdims[-1]
                ).startswith("string")
                if is_char:
                    values = np.array(
                        [b"".join(row).decode().rstrip("\x00") for row in values]
                    )
                    vdims = vdims[:-1]
                if len(vdims) == 1 and vdims[0] == name:
                    coords[name] = values
                else:
                    data[name] = (vdims, values)
            ds = cls()
            for name, (vdims, values) in data.items():
                c = {d: coords[d] for d in vdims if d in coords}
                ds.data_vars[name] = DataArray(values, coords=c, dims=vdims, name=name)
            return ds


def open_dataset(path) -> Dataset:
    """xarray.open_dataset stand-in."""
    return Dataset.from_netcdf(path)

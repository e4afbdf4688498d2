"""The port's HDF5 reader and writer (``native/hdf5.py``) against h5py.

Fixtures are written by h5py: its default layout (superblock 0,
symbol-table groups, contiguous data), chunked with gzip, with shuffle +
gzip, chunks that do not divide the shape (padded edge chunks), compact
data, big-endian types, nested groups, never-written data (the fill
value), and files of ``libver="latest"`` (superblock 3, object header v2,
link messages, data layout 4): the reader returns, bit for bit, what h5py
reads, or raises a ``NotImplementedError`` that names what it lacks.
The writer's files are read back by h5py bit for bit. Exact throughout.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from diffusiondepth_tpu_torch.native.hdf5 import read_datasets, write_datasets  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _arrays(seed=0):
    r = np.random.RandomState(seed)
    return {
        "rgb": (r.rand(3, 24, 32) * 256).astype(np.uint8),
        "depth": (r.rand(24, 32) * 10).astype(np.float32),
        "u2": (r.rand(7, 9) * 65536).astype(np.uint16),
        "i2": (r.randn(5, 6) * 1000).astype(np.int16),
        "i4": (r.randn(30) * 1e6).astype(np.int32),
        "f8": r.randn(4, 5, 6),
    }


def _h5py_read(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset)
                     else None)
    return out


def _same(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].dtype == r.dtype.newbyteorder("="), (k, got[k].dtype, r.dtype)
        assert got[k].shape == r.shape and np.array_equal(got[k], r), k
        assert got[k].tobytes() == r.astype(r.dtype.newbyteorder("=")).tobytes(), k


LAYOUTS = {
    "default": {},
    "chunked_gzip": dict(chunks=True, compression="gzip"),
    "shuffle_gzip": dict(chunks=True, compression="gzip", shuffle=True),
    "edge_chunks": dict(chunks=(5, 7), compression="gzip", compression_opts=9, shuffle=True),
    "chunked_raw": dict(chunks=(3, 4)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_reader_matches_h5py(tmp_path, layout):
    """Every dtype under each storage layout of h5py's default file."""
    path = tmp_path / "f.h5"
    arrays = _arrays()
    kw = LAYOUTS[layout]
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            opts = dict(kw)
            if isinstance(opts.get("chunks"), tuple):  # on the last axes, 1 on the rest
                tail = opts["chunks"][-v.ndim:]
                opts["chunks"] = (1,) * (v.ndim - len(tail)) + tuple(
                    min(c, d) for c, d in zip(tail, v.shape[-len(tail):]))
            f.create_dataset(k, data=v, **opts)
    _same(read_datasets(str(path), list(arrays)), _h5py_read(path))


def test_compact_big_endian_and_nested_groups(tmp_path):
    path = tmp_path / "f.h5"
    r = np.random.RandomState(1)
    with h5py.File(path, "w") as f:
        space = h5py.h5s.create_simple((12,))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        dset = h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I32LE, space, dcpl=dcpl)
        dset.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(12, dtype=np.int32) * 7 - 30)
        f.create_dataset("be_f4", data=r.randn(6, 5).astype(">f4"))
        f.create_dataset("be_i4", data=(r.randn(11) * 1e5).astype(">i4"))
        f.create_dataset("be_u2", data=(r.rand(3, 3) * 6e4).astype(">u2"))
        f.create_dataset("be_f8_gzip", data=r.randn(9, 9).astype(">f8"), chunks=(4, 4),
                         compression="gzip", shuffle=True)
        g = f.create_group("a/b")
        g.create_dataset("c", data=r.rand(4, 4).astype(np.float32))
        f["a"].create_dataset("d", data=np.arange(5, dtype=np.uint8))
        f.create_dataset("scalar", data=np.float64(2.5))
        f.create_dataset("unwritten", shape=(3, 4), dtype="f4", fillvalue=1.25)
        f.create_dataset("unwritten_chunked", shape=(5, 5), dtype="i2", chunks=(2, 2),
                         fillvalue=-3)
        f.create_dataset("partly", shape=(6, 6), dtype="f4", chunks=(3, 3), fillvalue=9.0)
        f["partly"][:3, :3] = r.rand(3, 3)
    ref = _h5py_read(path)
    assert set(ref) >= {"a/b/c", "a/d", "compact"}
    with h5py.File(path, "r") as f:
        assert f["compact"].id.get_create_plist().get_layout() == h5py.h5d.COMPACT
    _same(read_datasets(str(path), list(ref)), ref)


def test_libver_latest(tmp_path):
    """A file of libver='latest' (superblock 3, object header v2, link
    messages, layout 4): contiguous and compact data read as h5py reads
    them; the v4 chunk indexes and dense link storage raise by name."""
    path = tmp_path / "latest.h5"
    arrays = _arrays(2)
    with h5py.File(path, "w", libver="latest") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
        f.create_dataset("grp/x", data=np.arange(6, dtype=">i2"))
        f.create_dataset("grp/chunked", data=np.ones((8, 8), np.float32), chunks=(4, 4))
        for i in range(20):  # more links than compact storage holds (8)
            f.create_dataset(f"many/d{i:02d}", data=np.full(2, i, np.int32))
    with open(path, "rb") as fh:
        assert fh.read(9)[8] == 3  # superblock version 3
    ref = _h5py_read(path)
    names = list(arrays) + ["grp/x"]
    _same(read_datasets(str(path), names), {k: ref[k] for k in names})
    with pytest.raises(NotImplementedError, match="layout version 4"):
        read_datasets(str(path), ["grp/chunked"])
    with pytest.raises(NotImplementedError, match="dense link storage"):
        read_datasets(str(path), ["many/d03"])


@pytest.mark.parametrize("kind", ["fletcher32", "lzf", "string", "vlen_string", "compound",
                                  "soft_link"])
def test_unsupported_features_raise_by_name(tmp_path, kind):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        if kind == "fletcher32":
            f.create_dataset("x", data=np.arange(10.0), chunks=(5,), fletcher32=True)
        elif kind == "lzf":
            f.create_dataset("x", data=np.arange(10.0), chunks=(5,), compression="lzf")
        elif kind == "string":
            f.create_dataset("x", data=np.array([b"abc", b"de"]))
        elif kind == "vlen_string":
            f.create_dataset("x", data=["abc", "de"], dtype=h5py.string_dtype())
        elif kind == "compound":
            f.create_dataset("x", data=np.zeros(3, [("a", "f4"), ("b", "i2")]))
        else:
            f.create_dataset("y", data=np.arange(3))
            f["x"] = h5py.SoftLink("/y")
    match = {"fletcher32": "fletcher32", "lzf": "filter 32000", "string": "string",
             "vlen_string": "variable-length", "compound": "compound",
             "soft_link": "only hard links"}[kind]
    with pytest.raises(NotImplementedError, match=match):
        read_datasets(str(path), ["x"])


def test_missing_dataset_and_not_hdf5(tmp_path):
    path = tmp_path / "f.h5"
    write_datasets(str(path), {"a": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="'b'"):
        read_datasets(str(path), ["b"])
    (tmp_path / "g.h5").write_bytes(b"not an hdf5 file" * 40)
    with pytest.raises(ValueError, match="superblock"):
        read_datasets(str(tmp_path / "g.h5"), ["a"])


def test_writer_read_by_h5py(tmp_path):
    """write_datasets in h5py's default shape: h5py reads every array back
    bit for bit, with its dtype, and sees superblock 0 and contiguous,
    unfiltered data; the port's reader reads it too."""
    arrays = dict(_arrays(3), be=np.arange(7, dtype=">f4"),
                  nyu_rgb=np.random.RandomState(4).randint(0, 256, (3, 480, 640), np.uint8))
    path = tmp_path / "w.h5"
    write_datasets(str(path), arrays)
    ref = _h5py_read(path)
    assert ref.keys() == arrays.keys()
    for k, v in arrays.items():
        assert ref[k].dtype == v.dtype and np.array_equal(ref[k], v), k
    with h5py.File(path, "r") as f:
        assert f.id.get_create_plist().get_version()[0] == 0
        for k in arrays:
            plist = f[k].id.get_create_plist()
            assert plist.get_layout() == h5py.h5d.CONTIGUOUS and plist.get_nfilters() == 0
    _same(read_datasets(str(path), list(arrays)), ref)
    half = {"h": np.arange(4, dtype=np.float16), "u8": np.arange(3, dtype=np.uint64),
            "scalar": np.asarray(-7, np.int8)}
    write_datasets(str(tmp_path / "h.h5"), half)
    _same(read_datasets(str(tmp_path / "h.h5"), list(half)), _h5py_read(tmp_path / "h.h5"))
    with pytest.raises(ValueError):
        write_datasets(str(tmp_path / "x.h5"), {"a/b": np.zeros(2)})
    with pytest.raises(ValueError):
        write_datasets(str(tmp_path / "x.h5"), {f"d{i}": np.zeros(2) for i in range(9)})
    with pytest.raises(ValueError):
        write_datasets(str(tmp_path / "x.h5"), {"s": np.array(["x"])})


def test_reader_does_not_load_h5py(tmp_path):
    """Reading and writing through the port load no h5py module."""
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(20.0).reshape(4, 5), chunks=(2, 2),
                         compression="gzip", shuffle=True)
    code = ("import sys\n"
            "from diffusiondepth_tpu_torch.native.hdf5 import read_datasets, write_datasets\n"
            f"x = read_datasets({str(path)!r}, ['x'])['x']\n"
            f"write_datasets({str(tmp_path / 'w.h5')!r}, {{'x': x}})\n"
            "assert float(x.sum()) == 190.0\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'h5py'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"

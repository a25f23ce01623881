"""IO loader round-trips for every supported format."""

import numpy as np
import pytest

from lidar_crowd.utils import io as pio


@pytest.fixture
def pts():
    rng = np.random.RandomState(0)
    return rng.uniform(-10, 10, (500, 3))


@pytest.mark.parametrize("fmt", ["npy", "xyz", "txt", "csv", "pcd", "ply",
                                 "las"])
def test_roundtrip(tmp_path, pts, fmt):
    p = str(tmp_path / f"cloud.{fmt}")
    pio.save_points(p, pts)
    out = pio.load_points(p)
    assert out.shape == (500, 3)
    atol = 1e-5 if fmt in ("las",) else 1e-6
    np.testing.assert_allclose(out, pts, atol=atol)


def test_csv_with_named_columns(tmp_path, pts):
    import pandas as pd
    p = str(tmp_path / "named.csv")
    pd.DataFrame({"intensity": np.ones(len(pts)), "X": pts[:, 0],
                  "Y": pts[:, 1], "Z": pts[:, 2]}).to_csv(p, index=False)
    out = pio.load_points(p)
    np.testing.assert_allclose(out, pts, atol=1e-8)


def test_text_skips_garbage_lines(tmp_path):
    p = str(tmp_path / "messy.xyz")
    with open(p, "w") as f:
        f.write("# comment\n1.0 2.0 3.0\nnot a line\n4,5,6\n7;8;9\n")
    out = pio.load_points(p)
    np.testing.assert_allclose(out, [[1, 2, 3], [4, 5, 6], [7, 8, 9]])


def test_bytes_source_requires_fmt(pts):
    raw = pts.astype("<f8").tobytes()
    with pytest.raises(pio.LoaderError):
        pio.load_points(raw)


def test_empty_cloud_raises(tmp_path):
    p = str(tmp_path / "empty.xyz")
    with open(p, "w") as f:
        f.write("# nothing\n")
    with pytest.raises(pio.LoaderError):
        pio.load_points(p)


def test_laz_rejected(tmp_path):
    p = str(tmp_path / "f.laz")
    with open(p, "wb") as f:
        f.write(b"LASF0000")
    with pytest.raises(pio.LoaderError, match="LAZ"):
        pio.load_points(p)


def test_unsupported_format(tmp_path):
    p = str(tmp_path / "f.glb")
    with open(p, "wb") as f:
        f.write(b"x")
    with pytest.raises(pio.LoaderError, match="Unsupported"):
        pio.load_points(p)


def test_ply_binary_little_endian(tmp_path, pts):
    p = str(tmp_path / "bin.ply")
    with open(p, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n"
                + f"element vertex {len(pts)}\n".encode()
                + b"property float x\nproperty float y\nproperty float z\n"
                b"end_header\n")
        f.write(pts.astype("<f4").tobytes())
    out = pio.load_points(p)
    np.testing.assert_allclose(out, pts, atol=1e-4)


def _pcd_header(n, mode):
    return (b"# .PCD v0.7\nVERSION 0.7\n"
            b"FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            + f"WIDTH {n}\nHEIGHT 1\nPOINTS {n}\n".encode()
            + f"DATA {mode}\n".encode())


def test_pcd_binary(tmp_path, pts):
    p = str(tmp_path / "bin.pcd")
    with open(p, "wb") as f:
        f.write(_pcd_header(len(pts), "binary"))
        f.write(pts.astype("<f4").tobytes())
    out = pio.load_points(p)
    np.testing.assert_allclose(out, pts, atol=1e-4)


def test_pcd_binary_compressed_lzf(tmp_path, pts):
    # literal-only runs (ctrl byte = len-1 < 32) are valid LZF, so the
    # fixture needs no compressor; body layout is SoA per the PCD spec
    soa = pts.astype("<f4").T.copy().tobytes()
    comp = b"".join(bytes([len(chunk) - 1]) + chunk
                    for chunk in (soa[i:i + 32]
                                  for i in range(0, len(soa), 32)))
    p = str(tmp_path / "comp.pcd")
    with open(p, "wb") as f:
        f.write(_pcd_header(len(pts), "binary_compressed"))
        f.write(np.asarray([len(comp), len(soa)], "<u4").tobytes())
        f.write(comp)
    out = pio.load_points(p)
    np.testing.assert_allclose(out, pts, atol=1e-4)


def test_pcd_binary_compressed_python_fallback(tmp_path, pts, monkeypatch):
    from lidar_crowd.utils import native
    monkeypatch.setattr(native, "get_lib", lambda: None)
    test_pcd_binary_compressed_lzf(tmp_path, pts)

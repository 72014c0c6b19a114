"""Native PLY codec (C++/ctypes) vs numpy equivalence."""

import numpy as np
import pytest

from splatapult_jax.io import native
from splatapult_jax.io.ply import read_ply


def test_native_library_builds_and_loads():
    # io/native.py builds the library from native/splatply.cpp at first use
    # (native/build.sh does the same by hand) on any box with g++
    assert native.available(), "run native/build.sh to build libsplatply.so"


def test_decode_matches_numpy(test_ply_path):
    ply = read_ply(test_ply_path)
    names = ["x", "y", "z", "opacity", "f_dc_0", "f_rest_44", "rot_3"]
    got = native.decode_columns(ply.vertices, names)
    want = np.stack([ply.vertices[n].astype(np.float32) for n in names], axis=-1)
    np.testing.assert_array_equal(got, want)


def test_decode_mixed_dtypes(rng):
    n = 1000
    dt = np.dtype([("a", "<f4"), ("b", "<f8"), ("c", "u1"), ("d", "<i4")])
    v = np.empty(n, dt)
    v["a"] = rng.standard_normal(n).astype(np.float32)
    v["b"] = rng.standard_normal(n)
    v["c"] = rng.integers(0, 255, n)
    v["d"] = rng.integers(-1000, 1000, n)
    got = native.decode_columns(v, ["a", "b", "c", "d"])
    want = np.stack([v[nm].astype(np.float32) for nm in "abcd"], axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_encode_roundtrip(rng):
    if not native.available():
        pytest.skip("native lib not built")
    n = 500
    dt = np.dtype([("x", "<f4"), ("pad", "u1"), ("y", "<f4")])
    v = np.zeros(n, dt)
    vals = rng.standard_normal((n, 2)).astype(np.float32)
    native.encode_columns(vals, v, ["x", "y"])
    np.testing.assert_array_equal(v["x"], vals[:, 0])
    np.testing.assert_array_equal(v["y"], vals[:, 1])
    assert (v["pad"] == 0).all()  # untouched bytes stay zero
    back = native.decode_columns(v, ["x", "y"])
    np.testing.assert_array_equal(back, vals)


def test_large_roundtrip_multithreaded(rng):
    if not native.available():
        pytest.skip("native lib not built")
    # > 1<<16 records engages the threaded path
    n = 200_000
    dt = np.dtype([(f"f{i}", "<f4") for i in range(8)])
    v = np.zeros(n, dt)
    vals = rng.standard_normal((n, 8)).astype(np.float32)
    names = [f"f{i}" for i in range(8)]
    native.encode_columns(vals, v, names)
    np.testing.assert_array_equal(native.decode_columns(v, names), vals)

"""The port's host annotation library (neuralsim_tpu_torch/native: its own
copy of annotate.cc, built with g++, and the numpy twin) against the JAX
package's (neuralsim_tpu.native) on the cases of
tests/test_native_annotate.py. Stats and RLE must be equal."""

import subprocess

import numpy as np
import pytest

import neuralsim_tpu.native as jnat
import neuralsim_tpu_torch.native as tnat
from neuralsim_tpu_torch.native import build


def two_blobs():
    m = np.zeros((20, 30), np.uint8)
    m[2:8, 3:10] = 1       # blob A: x3 y2 w7 h6 area42
    m[12:18, 20:28] = 1    # blob B: x20 y12 w8 h6 area48
    return m


def diagonal():
    m = np.zeros((4, 4), np.uint8)
    m[0, 0] = m[1, 1] = m[2, 2] = 1
    return m


def u_shape():
    # a U forces label merging in the second pass
    m = np.zeros((5, 5), np.uint8)
    m[0:4, 0] = 1
    m[0:4, 4] = 1
    m[3, 0:5] = 1
    return m


def random_masks():
    rng = np.random.RandomState(0)
    return [(rng.rand(37, 23) > 0.6).astype(np.uint8) for _ in range(5)] + [
        (rng.rand(13, 17) > 0.5).astype(np.uint8)]


CASES = {"two_blobs": [two_blobs()], "diagonal": [diagonal()], "u_shape": [u_shape()],
         "empty": [np.zeros((8, 8), np.uint8)], "ones": [np.ones((3, 3), np.uint8)],
         "random": random_masks()}


def test_port_library_builds_in_the_checkout():
    assert tnat._load_lib() is not None, "g++ build of the port's annotation library failed"
    lib = build.library_path()
    assert lib.exists() and lib.parent == build.BUILD_DIR
    assert build.SOURCE.read_text().split("#include", 1)[1] == \
        open(jnat.__file__.replace("__init__.py", "annotate.cc")).read().split("#include", 1)[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats_and_rle_equal_jax(case):
    for m in CASES[case]:
        want = jnat.connected_components(m)
        assert tnat.connected_components(m) == want
        assert sorted(tnat._connected_components_np(m)) == sorted(want)
        rle = tnat.rle_encode(m)
        assert rle == jnat.rle_encode(m)
        if m.reshape(-1, order="F")[0]:
            assert rle["counts"][0] == 0      # COCO: the first run counts zeros
        assert sum(rle["counts"]) == m.size
        np.testing.assert_array_equal(tnat.rle_decode(rle), m)
        np.testing.assert_array_equal(tnat.rle_decode(rle), jnat.rle_decode(rle))


def test_numpy_twins_equal_library():
    """The numpy twins give the library's runs and components, in its
    order."""
    masks = [m for ms in CASES.values() for m in ms]
    assert [tnat._rle_encode_np(m) for m in masks] == [tnat.rle_encode(m) for m in masks]
    assert [tnat._connected_components_np(m) for m in masks] == [
        tnat.connected_components(m) for m in masks]


def test_known_answers():
    assert sorted(tnat.connected_components(two_blobs())) == sorted(
        [(3, 2, 7, 6, 42), (20, 12, 8, 6, 48)])
    assert tnat.connected_components(diagonal()) == [(0, 0, 3, 3, 3)]
    (x, y, w, h, area), = tnat.connected_components(u_shape())
    assert (x, y, w, h, area) == (0, 0, 5, 4, int(u_shape().sum()))
    assert tnat.connected_components(np.zeros((8, 8), np.uint8)) == []
    assert tnat.rle_encode(np.ones((3, 3), np.uint8))["counts"][0] == 0


def many_components():
    m = np.zeros((41, 40), np.uint8)
    m[::2, ::2] = 1                      # 21 x 20 isolated pixels: the most a mask holds
    m[20, 10:30] = 1                     # a bar joins 11 of them (columns 10-30)
    return m


@pytest.mark.parametrize("max_components", [256, 1])
def test_more_components_than_the_buffer_equal_jax(max_components):
    """Past max_components the library labels again with room for every
    component an h x w mask can hold: the stats, in order, equal the JAX
    package's (its numpy fallback there) and the twin's."""
    m = many_components()
    got = tnat.connected_components(m, max_components=max_components)
    assert len(got) == 21 * 20 - 11 + 1
    assert got == jnat.connected_components(m, max_components=max_components)
    assert got == tnat._connected_components_np(m)


def test_failed_build_raises(monkeypatch):
    """No silent fallback: where g++ fails, annotation raises."""
    def fail():
        raise subprocess.CalledProcessError(1, ["g++"])

    monkeypatch.setattr(tnat, "_LIB", None)
    monkeypatch.setattr(build, "build", fail)
    with pytest.raises(subprocess.CalledProcessError):
        tnat.connected_components(two_blobs())
    with pytest.raises(subprocess.CalledProcessError):
        tnat.rle_encode(two_blobs())

"""Native C++ prefetching loader tests (built on demand with g++)."""
import os

import numpy as np
import pytest

from localregneuralde_tpu.native import native_available

pytestmark = pytest.mark.skipif(
    not native_available(), reason="no native toolchain"
)


def _data(n=200, f=8):
    x = np.arange(n * f, dtype=np.float32).reshape(n, f)
    y = np.arange(n, dtype=np.int64)
    return x, y


def test_rows_stay_aligned_across_arrays():
    from localregneuralde_tpu.native import NativeDataloader

    x, y = _data()
    dl = NativeDataloader((x, y), 32, shuffle=True, seed=7)
    batches = list(dl)
    assert len(batches) == 200 // 32
    for xb, yb in batches:
        np.testing.assert_array_equal(xb[:, 0], yb.astype(np.float32) * 8)


def test_epoch_covers_rows_without_duplicates():
    from localregneuralde_tpu.native import NativeDataloader

    x, y = _data()
    dl = NativeDataloader((x, y), 32, shuffle=True, seed=7)
    seen = np.concatenate([b[1] for b in dl])
    assert len(set(seen.tolist())) == len(seen)


def test_cycle_mode_streams_forever():
    from localregneuralde_tpu.native import NativeDataloader

    x, y = _data()
    dl = NativeDataloader((x, y), 32, shuffle=True, cycle=True, seed=7)
    it = iter(dl)
    for _ in range(20):  # > 3 epochs
        xb, yb = next(it)
        assert xb.shape == (32, 8)
    dl.close()


def test_make_dataloader_prefers_native():
    from localregneuralde_tpu.harness import make_dataloader
    from localregneuralde_tpu.native import NativeDataloader

    x, y = _data()
    dl = make_dataloader((x, y), 32)
    assert isinstance(dl, NativeDataloader)


def test_library_path_is_keyed_on_the_source(tmp_path):
    """The build directory is named after the source's hash: the same
    source maps to one library, an edited source to another."""
    from localregneuralde_tpu.native.loader import library_path

    a = tmp_path / "a.cpp"
    b = tmp_path / "b.cpp"
    c = tmp_path / "c.cpp"
    a.write_text("int f() { return 1; }\n")
    b.write_text("int f() { return 1; }\n")
    c.write_text("int f() { return 2; }\n")
    assert library_path(str(a)) == library_path(str(b))
    assert library_path(str(a)) != library_path(str(c))
    assert os.path.basename(library_path(str(a))) == "libnativeloader.so"


def test_loaded_library_was_built_from_this_source():
    from localregneuralde_tpu.native import loader

    assert loader._build() == loader.library_path()
    assert os.path.exists(loader.library_path())

"""The port's input pipeline against the JAX package's, byte for byte.

The same seeds, ranks and steps go through ``tf_operator_tpu.train.data``
and ``tf_operator_tpu_torch.train.data``: synthetic epochs, the token
memmap's train and holdout splits and elastic windows, idx files written
by one package and read by the other (``.gz`` too), the idx dataset, the
crop and flip augmentation on the native and the numpy path and across
epochs, the image preparation, and the elastic re-carve primitives over
the cases of ``tests/test_data_recarve.py``. Then the port's DeviceLoader
contract on the CPU (prefetch, skip, error re-raise, close while blocked,
``local_loader``'s batches against JAX's) and its native library loader.
"""

import threading
import time
import warnings
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tf_operator_tpu.train import data as jd  # noqa: E402
from tf_operator_tpu_torch.train import data as td  # noqa: E402
from tf_operator_tpu_torch.train import native_dataops  # noqa: E402

torch.set_num_threads(1)


def _equal_batches(a, b):
    """Two batches (dicts of arrays) hold the same bytes."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _take(it, n):
    return [next(it) for _ in range(n)]


# ---- synthetic datasets -----------------------------------------------------


@pytest.mark.parametrize("kind,kw", [
    ("SyntheticTokens", {"n": 24, "seq_len": 16, "vocab": 300}),
    ("SyntheticImages", {"n": 20, "image_size": 6, "num_classes": 7}),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_epochs_match_jax(kind, kw, seed):
    j = getattr(jd, kind)(4, seed=seed, **kw)
    p = getattr(td, kind)(4, seed=seed, **kw)
    assert len(j) == len(p)
    # three epochs through __iter__: the per-epoch reshuffle and the ragged tail
    for a, b in zip(_take(iter(j), 3 * len(j)), _take(iter(p), 3 * len(p))):
        _equal_batches(a, b)


def test_array_dataset_nested_tree_and_validation():
    x = np.arange(20, dtype=np.float32)
    ds = td.ArrayDataset({"xy": (x, x.astype(np.int32)), "z": [x * 2]}, batch_size=8)
    assert len(ds) == 2
    for b in ds.epoch(1):
        np.testing.assert_array_equal(b["xy"][0], b["xy"][1])
        np.testing.assert_array_equal(b["z"][0], 2 * b["xy"][0])
    with pytest.raises(ValueError, match="leading dim"):
        td.ArrayDataset({"x": np.zeros(4), "y": np.zeros(5)}, batch_size=2)
    with pytest.raises(ValueError, match="batch_size"):
        td.ArrayDataset({"x": np.zeros(4)}, batch_size=8)


# ---- the token memmap -------------------------------------------------------


@pytest.fixture
def corpus(tmp_path):
    path = str(tmp_path / "corpus.bin")
    jd.write_token_corpus(path, np.random.default_rng(4).integers(0, 60000, 16 * 53))
    return path


def test_write_token_corpus_matches_jax(tmp_path):
    tokens = np.random.default_rng(1).integers(0, 60000, 1000)
    for mod, name in ((jd, "j.bin"), (td, "p.bin")):
        mod.write_token_corpus(str(tmp_path / name), tokens)
    for suffix in ("", ".meta"):
        assert (tmp_path / f"j.bin{suffix}").read_bytes() == \
            (tmp_path / f"p.bin{suffix}").read_bytes()


@pytest.mark.parametrize("holdout,split", [(0, "train"), (7, "train"), (7, "holdout")])
def test_token_memmap_splits_and_epochs_match_jax(corpus, holdout, split):
    kw = dict(holdout=holdout, split=split, seed=5)
    j = jd.TokenMemmapDataset(corpus, 3, 16, **kw)
    p = td.TokenMemmapDataset(corpus, 3, 16, **kw)
    np.testing.assert_array_equal(j._windows, p._windows)
    for a, b in zip(_take(iter(j), 3 * len(j)), _take(iter(p), 3 * len(p))):
        _equal_batches(a, b)
    # the ranks' strides come from the arguments; the holdout is carved first
    ranks = [td.TokenMemmapDataset(corpus, 1, 16, rank=r, world_size=3, **kw)._windows
             for r in range(3)]
    for r in range(3):
        np.testing.assert_array_equal(ranks[r], j._windows[r::3])
    assert sorted(np.concatenate(ranks).tolist()) == j._windows.tolist()


def test_token_memmap_refusals_match_jax(corpus):
    for kw in ({"split": "holdout"}, {"holdout": 53}, {"split": "test", "holdout": 2}):
        for mod in (jd, td):
            with pytest.raises(ValueError):
                mod.TokenMemmapDataset(corpus, 1, 16, **kw)


def test_token_memmap_rank_from_torch_distributed(corpus, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    got = td.TokenMemmapDataset(corpus, 1, 16, holdout=3)._windows
    np.testing.assert_array_equal(got, np.arange(50)[1::2])
    assert td.process_rank(0, 4) == (0, 4)


@pytest.mark.parametrize("holdout", [0, 6])
def test_elastic_windows_and_batches_match_jax(corpus, holdout):
    j = jd.TokenMemmapDataset(corpus, 2, 16, seed=9, holdout=holdout, process_shard=False)
    p = td.TokenMemmapDataset(corpus, 2, 16, seed=9, holdout=holdout, process_shard=False)
    for start, end, n in ((0, 12, 3), (12, 40, 2), (40, 53 - holdout, 4)):
        for r in range(n):
            np.testing.assert_array_equal(j.elastic_windows(start, end, r, n),
                                          p.elastic_windows(start, end, r, n))
            for a, b in zip(j.elastic_batches(start, end, r, n),
                            p.elastic_batches(start, end, r, n)):
                _equal_batches(a, b)


# ---- idx files --------------------------------------------------------------


@pytest.mark.parametrize("suffix", ["", ".gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_idx_across_packages(tmp_path, suffix, dtype):
    arr = (np.random.default_rng(2).random((5, 7, 3)) * 100).astype(dtype)
    jp, pp = str(tmp_path / f"j{suffix}"), str(tmp_path / f"p{suffix}")
    jd.write_idx(jp, arr)
    td.write_idx(pp, arr)
    if not suffix:  # gzip headers carry a timestamp; the raw files are equal
        assert open(jp, "rb").read() == open(pp, "rb").read()
    for src in (jp, pp):
        a, b = jd.read_idx(src), td.read_idx(src)
        assert a.dtype == b.dtype == dtype and a.tobytes() == b.tobytes() == arr.tobytes()


def test_idx_refusals(tmp_path):
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x01\x00\x08\x01" + b"\x00" * 8)
    with pytest.raises(ValueError, match="not an idx"):
        td.read_idx(str(bad))
    short = tmp_path / "short"
    short.write_bytes(b"\x00\x00\x08\x01\x00\x00\x00\x05ab")
    with pytest.raises(ValueError, match="expected 5"):
        td.read_idx(str(short))
    with pytest.raises(ValueError, match="unsupported"):
        td.write_idx(str(tmp_path / "x"), np.zeros(3, np.int64))


def _mnist_fixture(d, n_train=40, n_test=12, size=8, gz=False):
    rng = np.random.default_rng(11)
    sfx = ".gz" if gz else ""
    d.mkdir(exist_ok=True)
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        jd.write_idx(str(d / f"{prefix}-images-idx3-ubyte{sfx}"),
                     rng.integers(0, 256, (n, size, size), dtype=np.uint8))
        jd.write_idx(str(d / f"{prefix}-labels-idx1-ubyte{sfx}"),
                     rng.integers(0, 10, n, dtype=np.uint8))
    return d


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_dataset_matches_jax(tmp_path, gz):
    d = _mnist_fixture(tmp_path / "mnist", gz=gz)
    for split in ("train", "test"):
        j = jd.MnistIdxDataset(str(d), 4, split=split, seed=2)
        p = td.MnistIdxDataset(str(d), 4, split=split, seed=2)
        assert j.global_n == p.global_n
        for a, b in zip(_take(iter(j), 2 * len(j)), _take(iter(p), 2 * len(p))):
            _equal_batches(a, b)
    # global_n is taken before the rank's stride
    shard = td.MnistIdxDataset(str(d), 4, rank=1, world_size=3)
    assert shard.global_n == 40 and shard.n == 13
    whole = jd.MnistIdxDataset(str(d), 4).arrays["label"]
    np.testing.assert_array_equal(shard.arrays["label"], whole[1::3])


# ---- augmentation -----------------------------------------------------------


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shape,dtype", [((16, 12, 12, 3), np.uint8),
                                         ((9, 10, 10), np.float32),
                                         ((3, 8, 8, 1), np.int16)])
def test_augment_images_matches_jax(native, shape, dtype):
    imgs = (np.random.default_rng(0).random(shape) * 255).astype(dtype)
    for kw in ({}, {"pad": 0}, {"flip": False}, {"pad": 3, "flip": True}):
        before = td.native_augment_batches
        got = td.augment_images(imgs, np.random.default_rng(7), native=native, **kw)
        assert td.native_augment_batches - before == (1 if native else 0)
        want = jd.augment_images(imgs, np.random.default_rng(7), native=False, **kw)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert td.augment_images(imgs, np.random.default_rng(7), pad=0, flip=False) is imgs


def test_augmented_images_epochs_match_jax(tmp_path):
    d = _mnist_fixture(tmp_path / "mnist")
    j = jd.AugmentedImages(jd.MnistIdxDataset(str(d), 8, seed=1), pad=2, flip=True, seed=3)
    p = td.AugmentedImages(td.MnistIdxDataset(str(d), 8, seed=1), pad=2, flip=True, seed=3)
    # 3 epochs of 5 batches: one generator for the object's lifetime
    for a, b in zip(_take(iter(j), 15), _take(iter(p), 15)):
        _equal_batches(a, b)


def test_augment_native_noncontiguous_falls_back():
    imgs = np.asfortranarray(
        (np.random.default_rng(1).random((8, 10, 10, 3)) * 255).astype(np.uint8))
    before = td.native_augment_batches
    got = td.augment_images(imgs, np.random.default_rng(3))
    assert td.native_augment_batches == before
    want = jd.augment_images(np.ascontiguousarray(imgs), np.random.default_rng(3),
                             native=False)
    assert got.tobytes() == np.ascontiguousarray(want).tobytes()


def test_augment_native_load_failure_warns_once():
    imgs = (np.random.default_rng(5).random((8, 10, 10, 3)) * 255).astype(np.uint8)
    want = td.augment_images(imgs, np.random.default_rng(9), native=False)
    with mock.patch.object(td, "_dataops_warned", False), \
            mock.patch.object(native_dataops, "load_dataops",
                              side_effect=RuntimeError("no toolchain")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = td.augment_images(imgs, np.random.default_rng(9))
            again = td.augment_images(imgs, np.random.default_rng(9))
        with pytest.raises(RuntimeError, match="unavailable"):
            td.augment_images(imgs, np.random.default_rng(9), native=True)
    assert got.tobytes() == want.tobytes() == again.tobytes()
    msgs = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "native dataops unavailable" in msgs[0]


def test_native_library_builds_once_under_a_lock():
    path = native_dataops.ensure_built()
    assert path.parent == native_dataops.BUILD_DIR and path.name.startswith("dataops-")
    mtime = path.stat().st_mtime_ns
    # concurrent callers find the library built and leave it alone
    threads = [threading.Thread(target=native_dataops.ensure_built) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert path.stat().st_mtime_ns == mtime
    assert native_dataops.load_dataops() is native_dataops.load_dataops()


@pytest.mark.parametrize("size", [None, 8, 24])
def test_prepare_classification_images_matches_jax(size):
    gray = np.random.default_rng(0).random((3, 8, 8)).astype(np.float32)
    a, b = jd.prepare_classification_images(gray, size), td.prepare_classification_images(gray, size)
    assert a.shape == b.shape and a.tobytes() == b.tobytes()
    for mod in (jd, td):
        with pytest.raises(ValueError, match="integer multiple"):
            mod.prepare_classification_images(gray, 20)


# ---- elastic re-carve primitives (the cases of tests/test_data_recarve.py) ----


@pytest.mark.parametrize("total,worlds", [(120, [4, 3, 4, 2]), (97, [4, 3, 4]),
                                          (53, [3, 1, 3])])
def test_elastic_primitives_match_jax(total, worlds):
    bounds = [0]
    for i in range(1, len(worlds)):
        bounds.append(bounds[-1] + total // len(worlds) + (i % 2))
    bounds.append(total)
    segments = [(bounds[i], bounds[i + 1], worlds[i]) for i in range(len(worlds))]
    assert td.elastic_coverage(segments) == jd.elastic_coverage(segments)
    assert [p for p, _ in td.elastic_coverage(segments)] == list(range(total))
    for start, end, n in segments:
        for r in range(n):
            assert td.elastic_rank_positions(start, end, r, n) == \
                jd.elastic_rank_positions(start, end, r, n)
    for seed, shuffle in ((0, True), (5, True), (5, False)):
        np.testing.assert_array_equal(td.elastic_global_order(total, seed, shuffle),
                                      jd.elastic_global_order(total, seed, shuffle))
    for bad in ((0, 10, 0, 0), (0, 10, 3, 3)):
        with pytest.raises(ValueError):
            td.elastic_rank_positions(*bad)


# ---- the DeviceLoader on the CPU --------------------------------------------


def test_local_loader_matches_jax():
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    kw = dict(seq_len=16, vocab=300, skip=2)
    j = jd.local_loader(jd.SyntheticTokens, 4, sharding, **kw)
    p = td.local_loader(td.SyntheticTokens, 4, "cpu", **kw)
    try:
        for a, b in zip(_take(j, 20), _take(p, 20)):
            assert isinstance(b["tokens"], torch.Tensor)
            assert np.asarray(a["tokens"]).tobytes() == b["tokens"].numpy().tobytes()
    finally:
        j.close()
        p.close()
    with pytest.raises(ValueError, match="not divisible"):
        td.local_loader(td.SyntheticTokens, 5, "cpu", rank=0, world_size=2)


def test_loader_prefetches_ahead_and_skips():
    pulled = []

    def source():
        for i in range(8):
            pulled.append(i)
            yield {"x": np.full((4,), i, dtype=np.float32)}

    loader = td.DeviceLoader(source(), "cpu", prefetch=2, skip=3)
    first = next(loader)
    assert float(first["x"][0]) == 3.0  # three batches dropped on the host
    deadline = time.time() + 5
    while len(pulled) < 6 and time.time() < deadline:
        time.sleep(0.01)
    assert len(pulled) >= 6, pulled  # the first and two more staged ahead
    assert [float(b["x"][0]) for b in loader] == [4.0, 5.0, 6.0, 7.0]
    stats = loader.stats()
    assert stats["staged"] == stats["delivered"] == 5 and stats["copy_stream"] is None
    with td.DeviceLoader(iter([{"x": np.zeros(2)}]), "cpu", skip=5) as empty:
        assert list(empty) == []
    for bad in ({"prefetch": 0}, {"skip": -1}):
        with pytest.raises(ValueError):
            td.DeviceLoader(iter([]), "cpu", **bad)


def test_loader_reraises_source_errors():
    def bad_source():
        yield {"x": np.zeros(4, np.float32)}
        raise RuntimeError("disk on fire")

    loader = td.DeviceLoader(bad_source(), "cpu")
    next(loader)
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(loader)


def test_loader_close_unblocks_stager():
    def endless():
        while True:
            yield {"x": np.zeros(8, np.float32)}

    loader = td.DeviceLoader(endless(), "cpu", prefetch=1)
    next(loader)
    time.sleep(0.3)  # the stager is now blocked on a full queue
    loader.close()
    assert not loader._thread.is_alive()
    with td.DeviceLoader(endless(), "cpu") as loader2:
        next(loader2)
    assert not loader2._thread.is_alive()

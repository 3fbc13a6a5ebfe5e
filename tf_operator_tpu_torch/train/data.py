"""Input pipeline: host-side datasets and the loader that stages batches on the card.

Port of ``tf_operator_tpu/train/data.py``. The datasets are numpy and
yield the JAX package's batches byte for byte for the same seed, rank and
step: the same draws (``SyntheticImages``, ``SyntheticTokens``), the same
per-epoch shuffle (``default_rng(seed + epoch)``, ragged tail dropped),
the idx wire format (``read_idx``, ``write_idx``, ``.gz`` included), the
tokenized-corpus memmap with its holdout carved out before sharding
(``TokenMemmapDataset``), the elastic re-carve primitives, and the crop
and flip augmentation, whose randomness is drawn in one order whether the
native gather (``native/dataops.cc``, loaded by ``native_dataops``) or
the numpy loop serves it.

``DeviceLoader`` stages batches on a ``torch.device`` from a background
thread, ``prefetch`` ahead of the consumer. On a CUDA device the stager
binds the device, copies each numpy leaf into a pinned host buffer (a ring
of ``prefetch + 1`` buffer sets, a set reused only after its last copy's
event has completed), issues the host-to-device copy with
``non_blocking=True`` on a copy stream of its own and records an event;
the consumer's ``__next__`` makes its current stream wait on that event
and marks each tensor with ``record_stream``, so the caching allocator
does not hand the block out again before the step that reads it is done.
On the CPU a batch is ``torch.from_numpy(leaf).to(device)``.

Declared differences from the JAX package:

- ``process_shard`` (``MnistIdxDataset``, ``TokenMemmapDataset``) and
  ``local_loader`` take the process rank and world size from the keyword
  arguments ``rank`` and ``world_size``; each defaults to
  ``torch.distributed``'s when a process group is initialised, else to 0
  and 1. JAX reads ``jax.process_index()`` and ``process_count()``.
- ``DeviceLoader`` takes a device, not a sharding (a process drives one
  device; the workloads pass the data rank and the data-rank count, so tp
  peers read the same rows, where JAX seeds by process: ROADMAP F3), and
  no ``put``: the device alone chooses the staging.
- ``native_augment_batches`` counts the batches the native gather served.
"""

from __future__ import annotations

import gzip
import os
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.compat import tree_map

__all__ = [
    "SyntheticImages",
    "SyntheticTokens",
    "ArrayDataset",
    "DeviceLoader",
    "local_loader",
    "read_idx",
    "write_idx",
    "MnistIdxDataset",
    "TokenMemmapDataset",
    "write_token_corpus",
    "augment_images",
    "AugmentedImages",
    "prepare_classification_images",
    "elastic_global_order",
    "elastic_rank_positions",
    "elastic_coverage",
]

# batches whose augmentation the native gather served (module counter)
native_augment_batches = 0


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts, lists and tuples, in ``tree_map``'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def process_rank(rank: Optional[int] = None, world_size: Optional[int] = None) -> tuple:
    """(rank, world_size): the arguments where given, else
    ``torch.distributed``'s when a process group is initialised, else 0
    and 1."""
    if rank is None or world_size is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            r, n = dist.get_rank(), dist.get_world_size()
        else:
            r, n = 0, 1
        rank = r if rank is None else rank
        world_size = n if world_size is None else world_size
    return int(rank), int(world_size)


class ArrayDataset:
    """Finite in-memory dataset: yields batches sliced from arrays.

    arrays: nested dicts, lists or tuples of ndarrays with a common leading
    (example) dim. Deterministic order per epoch (reshuffled by ``seed +
    epoch``), dropping the ragged tail batch."""

    def __init__(self, arrays: Any, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0) -> None:
        leaves = tree_leaves(arrays)
        if not leaves:
            raise ValueError("ArrayDataset needs at least one array")
        n = leaves[0].shape[0]
        for leaf in leaves:
            if leaf.shape[0] != n:
                raise ValueError("all arrays must share the leading dim")
        if batch_size > n:
            raise ValueError(f"batch_size {batch_size} > dataset size {n}")
        self.arrays = arrays
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed

    def __len__(self) -> int:
        return self.n // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[Any]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        for i in range(len(self)):
            idx = order[i * self.batch_size : (i + 1) * self.batch_size]
            yield tree_map(lambda a: a[idx], self.arrays)

    def __iter__(self) -> Iterator[Any]:
        epoch = 0
        while True:  # repeat forever; the consumer bounds steps
            yield from self.epoch(epoch)
            epoch += 1


class SyntheticImages(ArrayDataset):
    """Deterministic fake image-classification data (ImageNet-shaped by default)."""

    def __init__(self, batch_size: int, *, n: int = 1024, image_size: int = 224,
                 channels: int = 3, num_classes: int = 1000, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        super().__init__(
            {
                "image": rng.standard_normal(
                    (n, image_size, image_size, channels), dtype=np.float32
                ),
                "label": rng.integers(0, num_classes, (n,), dtype=np.int32),
            },
            batch_size,
            seed=seed,
        )


class SyntheticTokens(ArrayDataset):
    """Deterministic fake LM token data."""

    def __init__(self, batch_size: int, *, n: int = 2048, seq_len: int = 512,
                 vocab: int = 32000, seed: int = 0) -> None:
        rng = np.random.default_rng(seed)
        super().__init__(
            {"tokens": rng.integers(0, vocab, (n, seq_len), dtype=np.int32)},
            batch_size,
            seed=seed,
        )


# ---------------------------------------------------------------------------
# Disk-backed readers: MNIST idx-ubyte + tokenized-corpus memmap
# ---------------------------------------------------------------------------

# once-only latch for the native-dataops-unavailable warning in
# _augment_native
_dataops_warned = False

_IDX_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
    0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
}
_IDX_CODES = {np.dtype(v): k for k, v in _IDX_DTYPES.items()}


def read_idx(path: str) -> np.ndarray:
    """Read an idx-ubyte file (the MNIST wire format): 2 zero bytes, dtype
    code, ndim, big-endian uint32 dims, raw big-endian data. ``.gz`` paths
    decompress transparently."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        header = f.read(4)
        if len(header) != 4 or header[0] != 0 or header[1] != 0:
            raise ValueError(f"{path}: not an idx file (bad magic {header!r})")
        code, ndim = header[2], header[3]
        if code not in _IDX_DTYPES:
            raise ValueError(f"{path}: unknown idx dtype code 0x{code:02x}")
        dims = np.frombuffer(f.read(4 * ndim), dtype=">u4")
        if dims.size != ndim:
            raise ValueError(f"{path}: truncated idx header")
        data = np.frombuffer(f.read(), dtype=np.dtype(_IDX_DTYPES[code]).newbyteorder(">"))
        n = int(np.prod(dims)) if ndim else 0
        if data.size != n:
            raise ValueError(f"{path}: expected {n} elements, got {data.size}")
        return data.reshape(tuple(int(d) for d in dims)).astype(_IDX_DTYPES[code])


def write_idx(path: str, array: np.ndarray) -> None:
    """Write an idx file (gzip when path ends .gz), so fixtures carry the
    real wire format."""
    arr = np.ascontiguousarray(array)
    code = _IDX_CODES.get(arr.dtype)
    if code is None:
        raise ValueError(f"unsupported idx dtype {arr.dtype}")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes([0, 0, code, arr.ndim]))
        f.write(np.asarray(arr.shape, dtype=">u4").tobytes())
        f.write(arr.astype(arr.dtype.newbyteorder(">")).tobytes())


def _find_idx(data_dir: str, names) -> str:
    for name in names:
        for suffix in ("", ".gz"):
            p = os.path.join(data_dir, name + suffix)
            if os.path.exists(p):
                return p
    raise FileNotFoundError(
        f"none of {list(names)} (or .gz) under {data_dir}"
    )


class MnistIdxDataset(ArrayDataset):
    """Disk-backed image classification from standard idx files.

    Reads the canonical MNIST names (train-images-idx3-ubyte /
    train-labels-idx1-ubyte, t10k-* for split="test", optionally .gz).
    Images normalize to [0, 1] f32 by a scale taken from the dtype (255
    for integers), not from the split's max, so train and test scale
    alike. ``global_n`` is the example count before sharding: every
    process derives the same steps per epoch from it.

    ``process_shard``: in a multi-process gang each process takes a
    disjoint stride of the examples (rank::world_size)."""

    def __init__(self, data_dir: str, batch_size: int, *, split: str = "train",
                 shuffle: bool = True, seed: int = 0,
                 process_shard: bool = True, rank: Optional[int] = None,
                 world_size: Optional[int] = None) -> None:
        prefix = {"train": "train", "test": "t10k"}[split]
        images = read_idx(
            _find_idx(data_dir, (f"{prefix}-images-idx3-ubyte", f"{prefix}-images.idx3-ubyte"))
        )
        labels = read_idx(
            _find_idx(data_dir, (f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels.idx1-ubyte"))
        )
        if images.shape[0] != labels.shape[0]:
            raise ValueError(
                f"{data_dir}: {images.shape[0]} images vs {labels.shape[0]} labels"
            )
        scale = 255.0 if np.issubdtype(images.dtype, np.integer) else 1.0
        x = images.astype(np.float32) / scale
        y = labels.astype(np.int32)
        self.global_n = x.shape[0]
        if process_shard:
            r, n = process_rank(rank, world_size)
            if n > 1:
                x, y = x[r::n], y[r::n]
        super().__init__({"image": x, "label": y}, batch_size,
                         shuffle=shuffle, seed=seed)


# ---------------------------------------------------------------------------
# Host-side image augmentation: random crop + horizontal flip
# ---------------------------------------------------------------------------


def augment_images(images: np.ndarray, rng: np.random.Generator, *,
                   pad: int = 4, flip: bool = True,
                   native: Optional[bool] = None) -> np.ndarray:
    """Random-crop + horizontal-flip augmentation, on the host.

    Zero-pads ``pad`` pixels on each spatial edge, crops back to h x w at a
    per-image random offset, then mirrors each image left-right with
    probability 1/2 (``flip=False`` for orientation-sensitive classes).
    images: [b, h, w] or [b, h, w, c]; same shape out.

    The randomness is always drawn here, in one order (crop rows, crop
    columns, flips), so every path gives the same bytes for one seed. The
    gather runs through the native library when ``native`` is None or
    True, and falls back to the numpy loop when the library is unavailable
    or the array is not C-contiguous (``native=False`` forces the
    fallback; True raises if the native path cannot serve)."""
    b, h, w = images.shape[:3]
    if not pad and not flip:
        return images  # no-op config: input returned as-is on every path
    dy = dx = do = None
    if pad:
        dy = rng.integers(0, 2 * pad + 1, b)
        dx = rng.integers(0, 2 * pad + 1, b)
    if flip:
        do = rng.random(b) < 0.5
    if native is not False and b > 0:
        out = _augment_native(images, pad, dy, dx, do)
        if out is not None:
            return out
        if native:
            raise RuntimeError("native augmentation unavailable for this input")
    out = images
    if pad:
        widths = [(0, 0), (pad, pad), (pad, pad)] + [(0, 0)] * (images.ndim - 3)
        padded = np.pad(images, widths)
        out = np.empty_like(images)
        for i in range(b):
            out[i] = padded[i, dy[i]:dy[i] + h, dx[i]:dx[i] + w]
    if flip:
        out = np.where(
            do.reshape((b,) + (1,) * (images.ndim - 1)), out[:, :, ::-1], out
        )
    return out


def _augment_native(images: np.ndarray, pad: int, dy, dx, do) -> Optional[np.ndarray]:
    """The crop and flip gather through native/dataops.cc. None when the
    native path cannot serve this input (library missing or broken, array
    not C-contiguous), so the caller falls back to the same bytes."""
    import ctypes

    global _dataops_warned, native_augment_batches
    # a failed load warned once: do not retry the build on every batch
    if _dataops_warned:
        return None
    try:
        from tf_operator_tpu_torch.train.native_dataops import load_dataops

        lib = load_dataops()
    except Exception as exc:
        _dataops_warned = True
        import warnings

        warnings.warn(
            f"native dataops unavailable ({exc!r}); augmentation falls "
            "back to the slower numpy path", RuntimeWarning)
        return None
    if not images.flags["C_CONTIGUOUS"]:
        return None
    arr = images
    b, h, w = arr.shape[:3]
    # trailing dims and element size fold into bytes a pixel (pure byte movement)
    pixel = arr.itemsize
    for dim in arr.shape[3:]:
        pixel *= dim
    out = np.empty_like(arr)
    # the staging arrays stay referenced across the call (ctypes keeps none)
    dy_a = np.ascontiguousarray(dy, dtype=np.int32) if dy is not None else None
    dx_a = np.ascontiguousarray(dx, dtype=np.int32) if dx is not None else None
    do_a = np.ascontiguousarray(do, dtype=np.uint8) if do is not None else None
    rc = lib.tpuj_augment(
        arr.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        b, h, w, pixel, pad,
        dy_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) if dy_a is not None else None,
        dx_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) if dx_a is not None else None,
        do_a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if do_a is not None else None,
        0,
    )
    if rc != 0:
        return None
    native_augment_batches += 1
    return out


class AugmentedImages:
    """Wraps a dict-batch image iterable with augment_images on the
    ``key`` leaf (fresh randomness per batch, deterministic per seed):

        DeviceLoader(AugmentedImages(MnistIdxDataset(...)), device)

    One generator for the object's lifetime, so epochs get new crops."""

    def __init__(self, source: Iterable[Any], *, pad: int = 4,
                 flip: bool = True, seed: int = 0, key: str = "image") -> None:
        self.source = source
        self.pad = pad
        self.flip = flip
        self.key = key
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Any]:
        for batch in self.source:
            batch = dict(batch)
            batch[self.key] = augment_images(
                batch[self.key], self._rng, pad=self.pad, flip=self.flip
            )
            yield batch


def prepare_classification_images(images: np.ndarray,
                                  image_size: Optional[int] = None) -> np.ndarray:
    """Adapt reader output to a convnet's [b, h, w, 3]: grayscale [b, h, w]
    gets a broadcast channel dim, and ``image_size`` (an integer multiple
    of the native size) upsamples nearest-neighbour."""
    if images.ndim == 3:
        images = np.repeat(images[..., None], 3, axis=-1)
    if image_size and image_size != images.shape[1]:
        factor, rem = divmod(image_size, images.shape[1])
        if rem or factor < 1:
            raise ValueError(
                f"image_size {image_size} is not an integer multiple of the "
                f"native size {images.shape[1]}"
            )
        images = np.repeat(np.repeat(images, factor, axis=1), factor, axis=2)
    return images


# ---------------------------------------------------------------------------
# Elastic re-carve primitives: one canonical, world-size-independent global
# window order G, and a pure function from (consumed offset, rank, world
# size) to the positions of G a rank owns. Offsets count positions of G.
# ---------------------------------------------------------------------------


def elastic_global_order(n_windows: int, seed: int = 0,
                         shuffle: bool = True) -> np.ndarray:
    """The canonical global window order G: a permutation of
    ``arange(n_windows)`` seeded by ``seed`` alone."""
    order = np.arange(int(n_windows))
    if shuffle:
        np.random.default_rng(int(seed)).shuffle(order)
    return order


def elastic_rank_positions(start: int, end: int, rank: int,
                           world_size: int) -> range:
    """Positions of G that ``rank`` (of ``world_size``) owns within the
    half-open offset interval [start, end): the ``rank::n`` stride anchored
    at the global consumed offset."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world of {world_size}")
    return range(int(start) + int(rank), int(end), int(world_size))


def elastic_coverage(segments) -> list:
    """Every (position, rank) assignment of a resize history, in position
    order. ``segments``: iterable of ``(start, end, world_size)``, offsets
    half-open and contiguous."""
    out = []
    for start, end, n in segments:
        for r in range(int(n)):
            for p in elastic_rank_positions(start, end, r, n):
                out.append((p, r))
    out.sort(key=lambda pr: pr[0])
    return out


def write_token_corpus(path: str, tokens: np.ndarray, dtype=np.uint16) -> None:
    """Persist a 1-D token stream as a raw little-endian memmap file plus a
    sidecar ``path + '.meta'`` (dtype and count)."""
    arr = np.ascontiguousarray(tokens, dtype=dtype)
    arr.tofile(path)
    with open(path + ".meta", "w") as f:
        f.write(f"{np.dtype(dtype).name} {arr.size}\n")


class TokenMemmapDataset:
    """Tokenized-corpus reader: a flat memmapped token stream cut into
    non-overlapping [seq_len] windows, batched. Yields {"tokens": [batch,
    seq_len] int32} forever, reshuffling the window order per epoch.

    ``holdout=N`` reserves the last N windows as a held-out split, carved
    out before process sharding, so it is disjoint from every trainer
    rank's stride: split="train" reads the windows before it,
    split="holdout" exactly the reserved ones (the evaluator's view).
    ``process_shard``: each process reads the stride rank::world_size of
    the (post-holdout) windows."""

    def __init__(self, path: str, batch_size: int, seq_len: int, *,
                 dtype=None, shuffle: bool = True, seed: int = 0,
                 process_shard: bool = True, holdout: int = 0,
                 split: str = "train", rank: Optional[int] = None,
                 world_size: Optional[int] = None) -> None:
        if dtype is None:
            meta = path + ".meta"
            if os.path.exists(meta):
                with open(meta) as f:
                    dtype = np.dtype(f.read().split()[0])
            else:
                dtype = np.uint16
        self._mm = np.memmap(path, dtype=dtype, mode="r")
        n_windows = self._mm.size // seq_len
        if n_windows < 1:
            raise ValueError(
                f"{path}: {self._mm.size} tokens < one window of {seq_len}"
            )
        if split not in ("train", "holdout"):
            raise ValueError(f'unknown split {split!r}; use "train"|"holdout"')
        if split == "holdout" and not holdout:
            raise ValueError('split="holdout" requires holdout > 0')
        if holdout and holdout >= n_windows:
            raise ValueError(
                f"holdout {holdout} >= {n_windows} corpus windows — nothing "
                "left to train on"
            )
        self._windows = np.arange(n_windows)
        if holdout:
            self._windows = (
                self._windows[-holdout:] if split == "holdout"
                else self._windows[:-holdout]
            )
        # the domain of the elastic canonical order: taken before the
        # world-size-dependent carve below
        self._global_windows = self._windows
        if process_shard:
            r, n = process_rank(rank, world_size)
            if n > 1:
                self._windows = self._windows[r::n]
        if batch_size > self._windows.size:
            raise ValueError(
                f"batch_size {batch_size} > {self._windows.size} local windows"
            )
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.shuffle = shuffle
        self.seed = seed

    def __len__(self) -> int:
        return self._windows.size // self.batch_size

    def _gather(self, idx) -> dict:
        batch = np.stack(
            [self._mm[w * self.seq_len : (w + 1) * self.seq_len] for w in idx]
        )
        return {"tokens": batch.astype(np.int32)}

    def epoch(self, epoch: int = 0) -> Iterator[Any]:
        order = self._windows.copy()
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        for i in range(len(self)):
            yield self._gather(order[i * self.batch_size : (i + 1) * self.batch_size])

    def __iter__(self) -> Iterator[Any]:
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1

    def elastic_windows(self, start: int, end: int, rank: int,
                        world_size: int) -> np.ndarray:
        """This rank's window ids for offset interval [start, end) of the
        canonical global order."""
        order = elastic_global_order(
            self._global_windows.size, seed=self.seed, shuffle=self.shuffle
        )
        positions = np.fromiter(
            elastic_rank_positions(start, end, rank, world_size), dtype=np.int64
        )
        return self._global_windows[order[positions]] if positions.size else positions

    def elastic_batches(self, start: int, end: int, rank: int,
                        world_size: int) -> Iterator[Any]:
        """Batched view of :meth:`elastic_windows` (ragged tail dropped)."""
        wins = self.elastic_windows(start, end, rank, world_size)
        for i in range(wins.size // self.batch_size):
            yield self._gather(wins[i * self.batch_size : (i + 1) * self.batch_size])


def local_loader(
    dataset_cls: Callable[..., ArrayDataset],
    global_batch: int,
    device: Any,
    *,
    min_examples: int = 32,
    prefetch: int = 2,
    skip: int = 0,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    **dataset_kw: Any,
) -> "DeviceLoader":
    """Split ``global_batch`` across processes (must divide), seed the
    synthetic dataset by rank so shards carry distinct data, and wrap it
    in a prefetching DeviceLoader. ``skip`` fast-forwards past batches a
    previous incarnation already trained on."""
    r, n_proc = process_rank(rank, world_size)
    if global_batch % n_proc:
        raise ValueError(
            f"batch_size {global_batch} not divisible by {n_proc} processes"
        )
    local = global_batch // n_proc
    ds = dataset_cls(local, n=max(2 * local, min_examples), seed=r, **dataset_kw)
    return DeviceLoader(ds, device, prefetch=prefetch, skip=skip)


class DeviceLoader:
    """Wraps a host batch iterable; yields batches as tensors on ``device``.

    A daemon thread pulls host batches, stages them on the device and
    keeps up to ``prefetch`` ahead of the consumer, so the copy for step
    N+1 overlaps step N (see the module docstring for the CUDA path).
    ``skip`` drops that many source batches on the host first (a resumed
    job continues the stream where the last incarnation left off).
    Iteration ends when the source does; ``close()`` (or ``with``) stops
    the stager; errors in the source re-raise at the consumer's next pull.

    ``stats()`` summarises the staging: batches staged and delivered, the
    host ms a batch spent in the source (gather, augment) and in the
    pinned copy, the device ms of its host-to-device copy, and the copy
    and consumer streams."""

    _END = object()
    _TIMED = 1024  # batches whose timings are kept

    def __init__(
        self,
        source: Iterable[Any],
        device: Any,
        *,
        prefetch: int = 2,
        skip: int = 0,
    ) -> None:
        if prefetch < 1:
            raise ValueError("prefetch must be >= 1")
        if skip < 0:
            raise ValueError("skip must be >= 0")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._skip = skip
        self._cuda = self.device.type == "cuda"
        self._put = self._put_cuda if self._cuda else self._put_host
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self.copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self.consumer_stream = None
        # pinned buffer sets, each (leaves, event of its last copy)
        self._slots: List[list] = [[None, None] for _ in range(prefetch + 1)]
        self._slot = 0
        self._log: List[dict] = []
        self.staged = self.delivered = 0
        self._thread = threading.Thread(
            target=self._stage, args=(iter(source),), name="device-loader", daemon=True
        )
        self._thread.start()

    # ---- staging ----------------------------------------------------------

    def _put_host(self, batch: Any, device: torch.device) -> Any:
        return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device), batch)

    def _put_cuda(self, batch: Any, device: torch.device) -> Any:
        """Pinned copy, then an async copy on the copy stream; returns
        (device batch, the copy's event)."""
        leaves = [np.ascontiguousarray(a) for a in tree_leaves(batch)]
        slot = self._slots[self._slot]
        self._slot = (self._slot + 1) % len(self._slots)
        t0 = time.perf_counter()
        if slot[1] is not None:
            slot[1].synchronize()  # the buffer's last copy has landed
        want = [(torch.Size(a.shape), _torch_dtype(a.dtype)) for a in leaves]
        pinned = slot[0]
        if pinned is None or [(p.shape, p.dtype) for p in pinned] != want:
            pinned = [torch.empty(shape, dtype=dtype, pin_memory=True) for shape, dtype in want]
            slot[0] = pinned
        for p, a in zip(pinned, leaves):
            p.copy_(torch.from_numpy(a))
        t1 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            start.record(self.copy_stream)
            out = [torch.empty(p.shape, dtype=p.dtype, device=device) for p in pinned]
            for o, p in zip(out, pinned):
                o.copy_(p, non_blocking=True)
            done.record(self.copy_stream)
        slot[1] = done
        if len(self._log) < self._TIMED:
            self._log[-1].update(pin_ms=(t1 - t0) * 1e3, copy_events=(start, done),
                                 bytes=sum(a.nbytes for a in leaves))
        it = iter(out)
        return tree_map(lambda _: next(it), batch), done

    def _stage(self, it: Iterator[Any]) -> None:
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            try:
                for _ in range(self._skip):
                    next(it)
            except StopIteration:
                self._enqueue_end()
                return
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                if len(self._log) < self._TIMED:
                    self._log.append({"source_ms": (time.perf_counter() - t0) * 1e3})
                staged = self._put(batch, self.device)
                self.staged += 1
                while not self._stop.is_set():
                    try:
                        self._q.put(staged, timeout=0.2)
                        break
                    except queue.Full:
                        continue
            if not self._stop.is_set():
                self._enqueue_end()
        except BaseException as exc:  # surfaced to the consumer
            self._err = exc
            self._enqueue_end()

    def _enqueue_end(self) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(self._END, timeout=0.2)
                return
            except queue.Full:
                continue

    # ---- consuming --------------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        while True:
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    item = self._END
                    break
        if item is self._END:
            self._stop.set()
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        if self._cuda:
            item, done = item
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in tree_leaves(item):
                t.record_stream(stream)
            self.consumer_stream = stream
        self.delivered += 1
        return item

    def close(self) -> None:
        self._stop.set()
        # drain so a blocked stager can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if self._cuda:
            self.copy_stream.synchronize()  # no copy in flight past close

    def __enter__(self) -> "DeviceLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        """Medians over the timed batches (see the class docstring)."""
        def median(key):
            vals = [r[key] for r in self._log if key in r]
            return float(np.median(vals)) if vals else None

        copy_ms = []
        for r in self._log:
            ev = r.get("copy_events")
            if ev is not None and ev[1].query():
                copy_ms.append(ev[0].elapsed_time(ev[1]))
        return {
            "device": str(self.device), "staged": self.staged, "delivered": self.delivered,
            "source_ms": median("source_ms"), "pin_ms": median("pin_ms"),
            "copy_device_ms": float(np.median(copy_ms)) if copy_ms else None,
            "batch_bytes": int(median("bytes")) if median("bytes") is not None else None,
            "copy_stream": None if self.copy_stream is None else self.copy_stream.stream_id,
            "consumer_stream": (None if self.consumer_stream is None
                                else self.consumer_stream.stream_id),
        }

"""Host data pipeline: dataset loading + threaded prefetching batcher.

Reference: ``experiments/src/utils.jl:155-166`` (BatchView + FLoops threaded
``eachobsparallel`` with a buffered channel) and the MLDatasets loaders used
by the entry scripts.

This environment has zero network egress, so loaders resolve in order:
1. real data found under ``data_root`` (NPZ or raw IDX / CIFAR binary files),
2. a deterministic, *learnable* synthetic stand-in with identical shapes and
   dtypes (fixed seed; class-prototype images + noise, or a latent
   oscillator for the PhysioNet-like irregular series). The synthetic
   fallback keeps every experiment end-to-end runnable and NFE-measurable;
   swapping in the real artifacts requires only dropping files into
   ``data_root``.
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# MNIST / CIFAR loading


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)


def _find(data_root: str, names: Sequence[str]) -> Optional[str]:
    for name in names:
        for suffix in ("", ".gz"):
            p = os.path.join(data_root, name + suffix)
            if os.path.exists(p):
                return p
    return None


def load_mnist(data_root: str = ""):
    """(x_train, y_train, x_test, y_test); x: (N,28,28,1) float32 ∈ [0,1],
    y: int labels. Returns None if no real data is present."""
    if not data_root:
        return None
    npz = _find(data_root, ["mnist.npz"])
    if npz:
        d = np.load(npz)
        return (
            d["x_train"].reshape(-1, 28, 28, 1).astype(np.float32) / 255.0,
            d["y_train"].astype(np.int32),
            d["x_test"].reshape(-1, 28, 28, 1).astype(np.float32) / 255.0,
            d["y_test"].astype(np.int32),
        )
    xtr = _find(data_root, ["train-images-idx3-ubyte", "train-images.idx3-ubyte"])
    ytr = _find(data_root, ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"])
    xte = _find(data_root, ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"])
    yte = _find(data_root, ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"])
    if xtr and ytr and xte and yte:
        return (
            _read_idx(xtr)[..., None].astype(np.float32) / 255.0,
            _read_idx(ytr).astype(np.int32),
            _read_idx(xte)[..., None].astype(np.float32) / 255.0,
            _read_idx(yte).astype(np.int32),
        )
    return None


def load_cifar10(data_root: str = ""):
    """(x_train, y_train, x_test, y_test); x: (N,32,32,3) float32 ∈ [0,1]."""
    if not data_root:
        return None
    npz = _find(data_root, ["cifar10.npz"])
    if npz:
        d = np.load(npz)
        return (
            d["x_train"].astype(np.float32) / 255.0,
            d["y_train"].astype(np.int32),
            d["x_test"].astype(np.float32) / 255.0,
            d["y_test"].astype(np.int32),
        )
    batches = [
        os.path.join(data_root, "cifar-10-batches-bin", f"data_batch_{i}.bin")
        for i in range(1, 6)
    ]
    test = os.path.join(data_root, "cifar-10-batches-bin", "test_batch.bin")
    if all(os.path.exists(b) for b in batches) and os.path.exists(test):
        def read_bin(path):
            raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
            y = raw[:, 0].astype(np.int32)
            x = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return x.astype(np.float32) / 255.0, y

        xs, ys = zip(*[read_bin(b) for b in batches])
        xte, yte = read_bin(test)
        return np.concatenate(xs), np.concatenate(ys), xte, yte
    return None


# ---------------------------------------------------------------------------
# deterministic synthetic fallbacks


def synthetic_classification(
    image_size=(28, 28), channels=1, num_classes=10,
    n_train=8192, n_test=2048, seed=0, difficulty="easy",
):
    """Class-prototype images + Gaussian noise: learnable, fixed seed.

    ``difficulty='easy'`` (default): well-separated prototypes — models
    saturate at 100% within ~50 steps (fine for smoke/perf runs, vacuous
    for matched-accuracy science). ``'hard'``: prototypes are mixed toward
    a shared mean (overlap), pixel noise is higher, and 8% of labels are
    resampled uniformly in BOTH splits — eval accuracy provably plateaus
    below ~93%, so matched-accuracy comparisons discriminate."""
    rng = np.random.RandomState(seed)
    h, w = image_size
    # smooth prototypes: low-frequency random fields per class
    freq = rng.randn(num_classes, 4, 4, channels)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    protos = np.zeros((num_classes, h, w, channels), np.float32)
    for c in range(num_classes):
        for i in range(4):
            for j in range(4):
                basis = np.sin(
                    (i + 1) * np.pi * yy / h
                ) * np.sin((j + 1) * np.pi * xx / w)
                protos[c] += freq[c, i, j] * basis[..., None]
    protos = (protos - protos.min()) / (np.ptp(protos) + 1e-8)

    hard = difficulty == "hard"
    if hard:
        # pull every prototype halfway to the class mean: pairwise
        # separations shrink 2x while staying learnable
        protos = 0.5 * protos + 0.5 * protos.mean(axis=0, keepdims=True)
    noise = 0.4 if hard else 0.25
    label_noise = 0.08 if hard else 0.0

    def make(n, seed_):
        r = np.random.RandomState(seed_)
        y = r.randint(0, num_classes, size=n).astype(np.int32)
        x = protos[y] + noise * r.randn(n, h, w, channels).astype(np.float32)
        if label_noise > 0:
            flip = r.rand(n) < label_noise
            y = np.where(
                flip, r.randint(0, num_classes, size=n).astype(np.int32), y
            )
        return np.clip(x, 0, 1).astype(np.float32), y

    x_train, y_train = make(n_train, seed + 1)
    x_test, y_test = make(n_test, seed + 2)
    return x_train, y_train, x_test, y_test


def synthetic_physionet(
    n=1024, t_steps=49, features=37, seed=0, observe_prob=0.5,
    difficulty="easy",
):
    """Irregularly-observed multivariate series from a latent oscillator,
    shaped like the PhysioNet tuples the reference builds
    (``experiments/physionet/main.jl:15-30``): returns
    (data (N,T,F), mask (N,T,F), tgrid (T,)) in batch-major layout.

    ``difficulty='easy'`` (default): a smooth 2-D oscillator — at the
    shipped tol 1.4e-8 the trained dynamics sit near the adaptive-solver
    floor (NFE ≈ 5k), so NFE comparisons are vacuous ("nothing to cut";
    round-4 ladder finding). ``'hard'``: a 4-D multi-scale latent — the
    slow pair plus a faster low-amplitude pair (4–8× the slow frequency,
    amplitude comparable to the observation-noise floor) and 5× higher
    observation noise. Fitting the fast pair forces high-frequency
    learned dynamics (NFE well off the floor) while buying little masked
    MSE over the noise floor — so a regularized arm can trade it away at
    matched MSE and the comparison discriminates (the latent-family
    analog of the classification stand-in's 'hard' mode)."""
    rng = np.random.RandomState(seed)
    tgrid = np.sort(rng.rand(t_steps).astype(np.float32))
    tgrid[0] = 0.0
    hard = difficulty == "hard"
    d_latent = 4 if hard else 2
    decoder = rng.randn(d_latent, features).astype(np.float32) * 0.5
    phase = rng.rand(n, 1).astype(np.float32) * 2 * np.pi
    freqs = 1.0 + rng.rand(n, 1).astype(np.float32)
    z1 = np.sin(2 * np.pi * freqs * tgrid[None, :] + phase)
    z2 = np.cos(2 * np.pi * freqs * tgrid[None, :] + phase)
    comps = [z1, z2]
    if hard:
        phase_f = rng.rand(n, 1).astype(np.float32) * 2 * np.pi
        freqs_f = 4.0 + 4.0 * rng.rand(n, 1).astype(np.float32)
        amp = 0.4
        comps.append(amp * np.sin(2 * np.pi * freqs_f * tgrid[None, :] + phase_f))
        comps.append(amp * np.cos(2 * np.pi * freqs_f * tgrid[None, :] + phase_f))
    latent = np.stack(comps, axis=-1)  # (N, T, d_latent)
    data = latent @ decoder  # (N, T, F)
    noise = 0.25 if hard else 0.05
    data += noise * rng.randn(*data.shape).astype(np.float32)
    mask = (rng.rand(n, t_steps, features) < observe_prob).astype(np.float32)
    return data.astype(np.float32), mask, tgrid


def get_classification_data(cfg):
    """Resolve (x_train, y_train, x_test, y_test) for a config; real data if
    present under ``cfg.dataset.data_root``, synthetic otherwise."""
    size = tuple(cfg.model.image_size)
    if size == (28, 28) and cfg.model.in_channels == 1:
        real = load_mnist(cfg.dataset.data_root)
    else:
        real = load_cifar10(cfg.dataset.data_root)
    if real is not None:
        return real + (True,)
    return synthetic_classification(
        size, cfg.model.in_channels, cfg.model.num_classes, seed=cfg.seed,
        difficulty=getattr(cfg.dataset, "difficulty", "easy"),
    ) + (False,)


def one_hot(y: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((y.shape[0], num_classes), np.float32)
    out[np.arange(y.shape[0]), y] = 1.0
    return out


# ---------------------------------------------------------------------------
# batching + threaded prefetch


def prefetch_to_device(iterator, place, size: int = 2):
    """Device-resident input prefetch: keep ``size`` batches placed on
    device ahead of consumption so the (asynchronously dispatched) H2D
    transfer of batch k+1 overlaps the device compute of batch k.

    ``place`` is the runner's batch-placement function (plain
    ``jnp.asarray`` single-device, mesh-sharded under data-parallel, or a
    global-array build under multi-process) — every placement JAX offers
    is an async dispatch, so enqueueing ahead is what buys the overlap.
    ``size<=1`` degrades to place-on-demand (the pre-round-5 behavior).
    Reference intent: the buffered-channel data pipeline of
    ``experiments/src/utils.jl:155-166`` (which only overlaps HOST batch
    assembly; this extends the overlap across the host→device
    transfer)."""
    import collections
    import itertools

    if size <= 1:
        for item in iterator:
            yield place(item)
        return
    q: "collections.deque" = collections.deque()

    def enqueue(n):
        for item in itertools.islice(iterator, n):
            q.append(place(item))

    enqueue(size)
    while q:
        yield q.popleft()
        enqueue(1)


def make_dataloader(arrays, batch_size, *, backend: str = "auto", **kwargs):
    """Build a batch loader: the native C++ prefetcher
    (``native/dataloader.cpp``) when available, else the Python threaded
    one. Both expose the same iterator contract."""
    if backend in ("auto", "native"):
        try:
            from ..native import NativeDataloader, native_available

            if native_available():
                return NativeDataloader(arrays, batch_size, **kwargs)
            if backend == "native":
                raise RuntimeError("native loader requested but unavailable")
        except ImportError:
            if backend == "native":
                raise
    return Dataloader(arrays, batch_size, **kwargs)


class Dataloader:
    """Shuffling batcher with background-thread prefetch into a bounded
    queue (the ``eachobsparallel`` buffered-channel analog,
    reference ``utils.jl:155-166``). ``cycle=True`` repeats forever."""

    def __init__(
        self,
        arrays: Tuple[np.ndarray, ...],
        batch_size: int,
        *,
        shuffle: bool = False,
        cycle: bool = False,
        seed: int = 0,
        prefetch: int = 4,
        drop_last: bool = True,
        skip_batches: int = 0,
    ):
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.cycle = cycle
        self.seed = seed
        self.prefetch = prefetch
        # index-only fast-forward for exact checkpoint resume: the stream
        # replays the SAME per-epoch permutations (seed + epoch) starting
        # mid-epoch, so a resumed run sees the identical batch sequence an
        # uninterrupted run would have seen from that step
        self.skip_batches = max(0, int(skip_batches))
        n = arrays[0].shape[0]
        if drop_last:
            self.n_batches = n // batch_size
        else:
            self.n_batches = -(-n // batch_size)
        self.n = n

    def __len__(self):
        return self.n_batches

    def _indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def _produce(self, q: "queue.Queue"):
        nb = self.n_batches
        epoch, b0 = (
            divmod(self.skip_batches, nb) if nb > 0 else (0, 0)
        )
        while True:
            idx = self._indices(epoch)
            for b in range(b0, nb):
                sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
                q.put(tuple(a[sel] for a in self.arrays))
            if not self.cycle:
                q.put(None)
                return
            epoch += 1
            b0 = 0

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        thread = threading.Thread(
            target=self._produce, args=(q,), daemon=True
        )
        thread.start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item

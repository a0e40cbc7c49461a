#!/usr/bin/env python
"""One-command real-dataset ingestion.

Zero-egress environments can't download MNIST / CIFAR-10 / PhysioNet, but
the loaders (`harness/data.py`, `harness/latent_runner.py`) accept the
standard artifact formats the moment the files exist under
``dataset.data_root``. This script is the documented ingest path: point it
at user-supplied files (in any of the recognized formats) and it
validates, normalizes, and installs them into the data root, then reports
which shipped experiment YAMLs become real-data runs.

Usage:
    python scripts/ingest_data.py SRC [SRC ...] [--data-root data]

Recognized sources (file or directory):
  MNIST     mnist.npz (x_train/y_train/x_test/y_test), or the four IDX
            files train-images-idx3-ubyte(.gz) etc., or a directory
            containing them
  CIFAR-10  cifar10.npz, cifar-10-binary.tar.gz, or a
            cifar-10-batches-bin/ directory (data_batch_{1..5}.bin +
            test_batch.bin)
  PhysioNet physionet.npz (train_data/train_mask/test_data/test_mask +
            a time grid under tgrid/observed_tp/tp_to_predict)

After ingesting:
    python experiments/mnist_ode/main.py experiments/mnist_ode/mlp.yaml \
        --dataset.data_root=data
runs the shipped config on real MNIST unchanged (`real_data: True` in the
summary), and `python scripts/real_parity.py --data-root data` reports
accuracy against the BASELINE.md parity targets.

Reference data paths: `experiments/mnist_ode/main.jl:23-27` (MLDatasets),
`experiments/Artifacts.toml:1-8` + `physionet/main.jl:11-30` (artifact
tarball).
"""
import argparse
import os
import shutil
import sys
import tarfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

MNIST_IDX = [
    "train-images-idx3-ubyte", "train-labels-idx1-ubyte",
    "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte",
]


def _install(src: Path, dest: Path):
    dest.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy2(src, dest)
    print(f"  installed {src} -> {dest}")


def _ingest_mnist_npz(src: Path, root: Path) -> bool:
    d = np.load(src)
    keys = set(d.keys())
    if not {"x_train", "y_train", "x_test", "y_test"} <= keys:
        return False
    n = d["x_train"].shape[0]
    assert d["x_train"].shape[1:] in ((28, 28), (28, 28, 1)), \
        f"unexpected MNIST image shape {d['x_train'].shape}"
    assert d["y_train"].shape[0] == n, "x/y train length mismatch"
    _install(src, root / "mnist.npz")
    print(f"  MNIST npz: {n} train / {d['x_test'].shape[0]} test images")
    return True


def _ingest_cifar_npz(src: Path, root: Path) -> bool:
    d = np.load(src)
    if not {"x_train", "y_train", "x_test", "y_test"} <= set(d.keys()):
        return False
    assert d["x_train"].shape[1:] == (32, 32, 3), \
        f"unexpected CIFAR image shape {d['x_train'].shape}"
    _install(src, root / "cifar10.npz")
    print(f"  CIFAR-10 npz: {d['x_train'].shape[0]} train / "
          f"{d['x_test'].shape[0]} test images")
    return True


def _ingest_physionet_npz(src: Path, root: Path) -> bool:
    # the artifact layout build_physionet_arrays consumes
    # (latent_runner.py:32-49): feature-major (F, T, N) tensors + (T, N)
    # time grids, reference physionet/main.jl:15-30 naming
    d = np.load(src)
    keys = set(d.keys())
    if not {"observed_data", "observed_mask", "observed_tp"} <= keys:
        return False
    assert d["observed_data"].shape == d["observed_mask"].shape, \
        "observed_data/observed_mask shape mismatch"
    assert d["observed_tp"].shape[0] == d["observed_data"].shape[1], \
        "observed_tp time axis does not match observed_data"
    _install(src, root / "physionet.npz")
    f, t, n = d["observed_data"].shape
    print(f"  PhysioNet npz: {n} series x {t} timepoints x {f} features")
    return True


def _ingest_npz(src: Path, root: Path) -> bool:
    name = src.name.lower()
    order = [
        _ingest_physionet_npz, _ingest_cifar_npz, _ingest_mnist_npz,
    ]
    if "mnist" in name:
        order = [_ingest_mnist_npz, _ingest_physionet_npz, _ingest_cifar_npz]
    elif "cifar" in name:
        order = [_ingest_cifar_npz, _ingest_mnist_npz, _ingest_physionet_npz]
    return any(fn(src, root) for fn in order)


def _ingest_idx(src: Path, root: Path) -> bool:
    base = src.name[:-3] if src.name.endswith(".gz") else src.name
    base = base.replace(".idx3-ubyte", "-idx3-ubyte").replace(
        ".idx1-ubyte", "-idx1-ubyte")
    if base not in MNIST_IDX:
        return False
    from localregneuralde_tpu.harness.data import _read_idx

    arr = _read_idx(str(src))  # validates magic + dims
    suffix = ".gz" if src.name.endswith(".gz") else ""
    _install(src, root / (base + suffix))
    print(f"  MNIST IDX {base}: shape {arr.shape}")
    return True


def _ingest_cifar_tar(src: Path, root: Path) -> bool:
    with tarfile.open(src) as tf:
        names = tf.getnames()
        bins = [n for n in names if n.endswith(".bin")]
        if not any("data_batch_1.bin" in n for n in bins):
            return False
        out = root / "cifar-10-batches-bin"
        out.mkdir(parents=True, exist_ok=True)
        for n in bins:
            member = tf.getmember(n)
            member.name = os.path.basename(n)  # flatten
            tf.extract(member, out)
            print(f"  extracted {n} -> {out / member.name}")
    return True


def _ingest_cifar_bin_dir(src: Path, root: Path) -> bool:
    batches = [src / f"data_batch_{i}.bin" for i in range(1, 6)]
    test = src / "test_batch.bin"
    if not (all(b.exists() for b in batches) and test.exists()):
        return False
    for b in batches + [test]:
        raw = np.fromfile(b, dtype=np.uint8)
        assert raw.size % 3073 == 0, f"{b}: not CIFAR binary rows"
        _install(b, root / "cifar-10-batches-bin" / b.name)
    return True


def ingest_one(src: Path, root: Path) -> bool:
    if src.is_dir():
        ok = _ingest_cifar_bin_dir(src, root)
        sub = src / "cifar-10-batches-bin"
        if sub.is_dir():
            ok = _ingest_cifar_bin_dir(sub, root) or ok
        for pattern in ("*.npz", "*ubyte", "*ubyte.gz", "*.tar.gz"):
            for f in sorted(src.glob(pattern)):
                ok = ingest_one(f, root) or ok
        return ok
    if src.suffix == ".npz":
        return _ingest_npz(src, root)
    if "ubyte" in src.name:
        return _ingest_idx(src, root)
    if src.name.endswith((".tar.gz", ".tgz", ".tar")):
        return _ingest_cifar_tar(src, root)
    return False


def report(root: Path):
    from localregneuralde_tpu.harness.data import load_cifar10, load_mnist

    print(f"\ndata root: {root}")
    rows = [
        ("MNIST", load_mnist(str(root)) is not None,
         "experiments/mnist_ode/mlp.yaml, mlp_stiff.yaml, "
         "experiments/mnist_sde/mlp.yaml"),
        ("CIFAR-10", load_cifar10(str(root)) is not None,
         "experiments/cifar10/cnn.yaml"),
        ("PhysioNet", (root / "physionet.npz").exists(),
         "experiments/physionet/physionet.yaml"),
    ]
    for name, present, configs in rows:
        mark = "REAL" if present else "synthetic fallback"
        print(f"  {name:10s} [{mark}]  -> {configs}")
    print(
        "\nrun any config with --dataset.data_root="
        f"{root} (summaries report real_data: True)"
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--data-root", type=Path, default=REPO / "data")
    args = ap.parse_args()
    for src in args.sources:
        if not src.exists():
            sys.exit(f"source {src} does not exist")
        print(f"ingesting {src}:")
        if not ingest_one(src, args.data_root):
            sys.exit(
                f"{src}: unrecognized dataset format (see --help for the "
                "accepted MNIST/CIFAR/PhysioNet artifact layouts)"
            )
    report(args.data_root)


if __name__ == "__main__":
    main()

"""Example datasets (port of ``numpyro_tpu/examples/datasets.py``): the
``dset`` descriptors (``BASEBALL``, ``COVTYPE``, ``MNIST``, ...), ``_load``,
``iter_dataset`` and ``load_dataset``, which return numpy arrays.

The port downloads nothing.  Each loader parses the raw files already in
``DATA_DIR`` (``$DATA_DIR``, else ``~/.data``), as the JAX package does.
Where a file is missing:

- ``BASEBALL`` and ``MNIST`` serve the JAX package's surrogates, drawn from
  ``np.random.RandomState(0)`` by the same code, so both packages give the
  same arrays bit for bit;
- ``COVTYPE`` and ``HIGGS`` serve a deterministic surrogate at the real
  shape with a warning.  The JAX package draws it with ``jax.random``, which
  the port cannot reproduce; the port draws it from ``np.random.default_rng``
  with the same shapes, the same intercept column (covtype) and the same
  generating law (standard normal features, coefficients ``N(0, 0.5^2)``,
  or ``N(0, 0.3^2)`` for HIGGS, Bernoulli labels of the logistic of ``X
  w``), so the numbers differ;
- every other dataset raises ``FileNotFoundError`` naming the path to place
  the file at.

The JAX module makes ``DATA_DIR`` when it is imported; this one makes
nothing (it only reads).  ``load_dataset``'s ``get_batch`` clamps a batch
that would run past the end to the last full batch, as the JAX package's
``lax.dynamic_slice_in_dim`` does; shuffling uses numpy's global generator,
as there.
"""

from __future__ import annotations

import csv
import gzip
import io
import os
import pickle
import struct
import warnings
import zipfile
from collections import namedtuple

import numpy as np

DATA_DIR = os.environ.get("DATA_DIR", os.path.join(os.path.expanduser("~"), ".data"))

dset = namedtuple("dset", ["name", "urls"])

BASEBALL = dset("baseball", ["https://d2hg8soec8ck9v.cloudfront.net/datasets/EfronMorrisBB.txt"])
BOSTON_HOUSING = dset(
    "boston_housing",
    ["https://archive.ics.uci.edu/ml/machine-learning-databases/housing/housing.data"],
)
COVTYPE = dset("covtype", ["https://d2hg8soec8ck9v.cloudfront.net/datasets/covtype.zip"])
DIPPER_VOLE = dset("dipper_vole",
                   ["https://d2hg8soec8ck9v.cloudfront.net/datasets/dipper_vole.zip"])
MNIST = dset(
    "mnist",
    [
        "https://d2hg8soec8ck9v.cloudfront.net/datasets/mnist/train-images-idx3-ubyte.gz",
        "https://d2hg8soec8ck9v.cloudfront.net/datasets/mnist/train-labels-idx1-ubyte.gz",
        "https://d2hg8soec8ck9v.cloudfront.net/datasets/mnist/t10k-images-idx3-ubyte.gz",
        "https://d2hg8soec8ck9v.cloudfront.net/datasets/mnist/t10k-labels-idx1-ubyte.gz",
    ],
)
SP500 = dset("SP500", ["https://d2hg8soec8ck9v.cloudfront.net/datasets/SP500.csv"])
UCBADMIT = dset("ucbadmit", ["https://d2hg8soec8ck9v.cloudfront.net/datasets/UCBadmit.csv"])
LYNXHARE = dset("lynxhare", ["https://d2hg8soec8ck9v.cloudfront.net/datasets/LynxHare.txt"])
JSB_CHORALES = dset(
    "jsb_chorales",
    ["https://d2hg8soec8ck9v.cloudfront.net/datasets/polyphonic/jsb_chorales.pickle"],
)
HIGGS = dset(
    "higgs",
    ["https://archive.ics.uci.edu/ml/machine-learning-databases/00280/HIGGS.csv.gz"],
)


def _local_path(url):
    return os.path.join(DATA_DIR, os.path.basename(url))


def _cached(dset_):
    """Whether every file of ``dset_`` is in ``DATA_DIR``."""
    return all(os.path.exists(_local_path(url)) for url in dset_.urls)


def _require(dset_):
    """Raise naming the first file of ``dset_`` that is not in ``DATA_DIR``:
    the port downloads nothing."""
    for url in dset_.urls:
        local = _local_path(url)
        if not os.path.exists(local):
            raise FileNotFoundError(
                f"{dset_.name}: {local} is missing and the port downloads nothing; place the "
                f"file from {url} there"
            )


def _surrogate_streams(seed):
    """Three independent numpy generators for the features, the
    coefficients and the labels, as the JAX package splits its key in three
    (so the coefficients do not depend on the number of rows)."""
    return [np.random.default_rng(s) for s in np.random.SeedSequence(seed).spawn(3)]


def _surrogate_coefficients(name):
    """The generating coefficients of the ``covtype`` or ``higgs``
    surrogate."""
    dim, scale, seed = {"covtype": (55, 0.5, 20260816), "higgs": (28, 0.3, 20260817)}[name]
    return (_surrogate_streams(seed)[1].standard_normal(dim) * scale).astype(np.float32)


def _synthetic_covtype(num_datapoints=-1):
    """Deterministic covtype-shaped binary classification surrogate: 54
    standard normal features and an intercept column."""
    n = 581_012 if num_datapoints < 0 else num_datapoints
    rx, _, ry = _surrogate_streams(20260816)
    X = rx.standard_normal((n, 54), dtype=np.float32)
    X = np.concatenate([X, np.ones((n, 1), np.float32)], axis=1)
    w = _surrogate_coefficients("covtype")
    y = (ry.random(n, dtype=np.float32) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    return {"train": (X, y)}


def _synthetic_higgs(num_datapoints=-1):
    n = 11_000_000 if num_datapoints < 0 else num_datapoints
    n = min(n, 1_000_000)
    rx, _, ry = _surrogate_streams(20260817)
    X = rx.standard_normal((n, 28), dtype=np.float32)
    w = _surrogate_coefficients("higgs")
    y = (ry.random(n, dtype=np.float32) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    cut = n - n // 20
    return {"train": (X[:cut], y[:cut]), "test": (X[cut:], y[cut:])}


def _load_baseball():
    if not _cached(BASEBALL):
        # the JAX package's surrogate: an Efron-Morris-shaped table (18
        # players, 45 first at-bats, season follow-up) from a fixed
        # beta-binomial
        rng = np.random.RandomState(0)
        phi = rng.beta(60, 160, size=18)
        first_ab = np.full(18, 45)
        first_hits = rng.binomial(first_ab, phi)
        season_ab = rng.randint(200, 600, size=18)
        season_hits = rng.binomial(season_ab, phi)
        train = np.stack([first_ab, first_hits], axis=1)
        test = np.stack([season_ab, season_hits], axis=1)
        names = np.array([f"Player {i}" for i in range(18)])
        return {"train": (train, names), "test": (test, names)}

    train, test, player_names = [], [], []
    with open(_local_path(BASEBALL.urls[0]), "r") as f:
        reader = csv.reader(f, delimiter="\t")
        next(reader)
        for row in reader:
            player_names.append(row[0] + " " + row[1])
            train.append([int(row[2]), int(row[8])])
            test.append([int(row[5]), int(row[9])])
    names = np.array(player_names)
    return {"train": (np.stack(train), names), "test": (np.stack(test), names)}


def _load_covtype(num_datapoints=-1):
    local = _local_path(COVTYPE.urls[0])
    if not os.path.exists(local):
        warnings.warn(
            "covtype raw file not cached; serving the deterministic "
            "synthetic surrogate at the covtype shape.",
            stacklevel=2,
        )
        return _synthetic_covtype(num_datapoints)
    with zipfile.ZipFile(local) as z:
        with z.open(z.namelist()[0]) as f:
            data = np.load(io.BytesIO(f.read()), allow_pickle=True).item()
    features, labels = data["data"], data["target"]
    labels = (labels == 2).astype(np.float32)  # binary: class 2 against the rest
    if num_datapoints > 0:
        features, labels = features[:num_datapoints], labels[:num_datapoints]
    return {"train": (features, labels)}


def _load_sp500():
    _require(SP500)
    dates, values = [], []
    with open(_local_path(SP500.urls[0]), "r") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            dates.append(row[0])
            values.append(float(row[1]))
    return {"train": (np.array(dates), np.array(values))}


def _load_mnist():
    if not _cached(MNIST):
        # the JAX package's surrogate: blurred class-template digits at the
        # MNIST shape (28 x 28, labels 0-9)
        rng = np.random.RandomState(0)
        templates = rng.rand(10, 28, 28) > 0.8
        out = {}
        for split, n in (("train", 2000), ("test", 400)):
            labels = rng.randint(0, 10, size=n)
            imgs = templates[labels].astype(np.float32)
            imgs = imgs * (0.7 + 0.3 * rng.rand(n, 28, 28))
            imgs += 0.1 * rng.rand(n, 28, 28)
            out[split] = (
                np.clip(imgs, 0, 1).reshape(n, 784).astype(np.float32),
                labels.astype(np.uint8),
            )
        return out

    def read_label(path):
        with gzip.open(path, "rb") as f:
            f.read(8)
            return np.frombuffer(f.read(), dtype=np.uint8)

    def read_img(path):
        with gzip.open(path, "rb") as f:
            _, _, nrows, ncols = struct.unpack(">IIII", f.read(16))
            return (np.frombuffer(f.read(), dtype=np.uint8).reshape(-1, nrows * ncols)
                    / np.float32(255.0))

    files = [_local_path(u) for u in MNIST.urls]
    return {
        "train": (read_img(files[0]), read_label(files[1])),
        "test": (read_img(files[2]), read_label(files[3])),
    }


def _load_ucbadmit():
    _require(UCBADMIT)
    dept, male, applications, admit = [], [], [], []
    with open(_local_path(UCBADMIT.urls[0])) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            dept.append(ord(row[1][1]) - ord("A"))
            male.append(row[2] == '"Male"' or row[2] == "Male")
            applications.append(int(row[4]))
            admit.append(int(row[3]))
    return {"train": (np.stack([dept, male, applications]).T, np.array(admit))}


def _load_lynxhare():
    _require(LYNXHARE)
    with open(_local_path(LYNXHARE.urls[0])) as f:
        rows = [r.split() for r in f.readlines() if r.strip()]
    data = np.array(rows, dtype=float)
    return {"train": (data[:, 0].astype(int), data[:, 1:])}


def _pad_sequence(sequences):
    max_length = max(len(s) for s in sequences)
    out = np.zeros((len(sequences), max_length, 88))
    lengths = np.zeros(len(sequences), dtype=int)
    for i, seq in enumerate(sequences):
        lengths[i] = len(seq)
        for t, chord in enumerate(seq):
            for note in chord:
                out[i, t, note - 21] = 1
    return out, lengths


def _load_jsb_chorales():
    _require(JSB_CHORALES)
    with open(_local_path(JSB_CHORALES.urls[0]), "rb") as f:
        data = pickle.load(f)
    out = {}
    for split, sequences in data.items():
        padded, lengths = _pad_sequence(sequences)
        out[split] = (lengths, padded)
    return out


def _load_higgs(num_datapoints=-1):
    local = _local_path(HIGGS.urls[0])
    if not os.path.exists(local):
        warnings.warn(
            "HIGGS raw file not cached; serving the deterministic synthetic surrogate.",
            stacklevel=2,
        )
        return _synthetic_higgs(num_datapoints)
    # the JAX package reads with pandas' default header row, which drops the
    # first row of the headerless file; numpy skips it the same way
    with gzip.open(local, "rt") as f:
        df = np.loadtxt(f, delimiter=",", skiprows=1,
                        max_rows=num_datapoints if num_datapoints > 0 else None, ndmin=2)
    obs, feats = df[:, 0], df[:, 1:]
    n = len(obs)
    return {
        "train": (feats[: n - n // 20], obs[: n - n // 20]),
        "test": (feats[n - n // 20:], obs[n - n // 20:]),
    }


def _load(dset_, num_datapoints=-1):
    if dset_ == BASEBALL:
        return _load_baseball()
    if dset_ == COVTYPE:
        return _load_covtype(num_datapoints)
    if dset_ == SP500:
        return _load_sp500()
    if dset_ == MNIST:
        return _load_mnist()
    if dset_ == UCBADMIT:
        return _load_ucbadmit()
    if dset_ == LYNXHARE:
        return _load_lynxhare()
    if dset_ == JSB_CHORALES:
        return _load_jsb_chorales()
    if dset_ == HIGGS:
        return _load_higgs(num_datapoints)
    raise ValueError(f"Dataset {dset_.name} not supported.")


def iter_dataset(dset_, batch_size=None, split="train", shuffle=True):
    """Yield the whole batches of ``split`` in order (shuffled by numpy's
    global generator with ``shuffle``)."""
    arrays = _load(dset_)[split]
    num_records = len(arrays[0])
    idxs = np.arange(num_records)
    if not batch_size:
        batch_size = num_records
    if shuffle:
        idxs = np.random.permutation(idxs)
    for i in range(num_records // batch_size):
        start_idx = i * batch_size
        end_idx = min((i + 1) * batch_size, num_records)
        yield tuple(a[idxs[start_idx:end_idx]] for a in arrays)


def load_dataset(dset_, batch_size=None, split="train", shuffle=True, num_datapoints=-1):
    """Return ``(init, get_batch)`` over ``split``: ``init()`` gives the
    number of whole batches and an order of the records (a permutation from
    numpy's global generator with ``shuffle``), ``get_batch(i, idxs)`` the
    ``i``-th batch in that order as numpy arrays.  A batch that would run
    past the end is the last full one, as under the JAX package's
    ``lax.dynamic_slice_in_dim``."""
    arrays = _load(dset_, num_datapoints)[split]
    num_records = len(arrays[0])
    idxs = np.arange(num_records)
    if not batch_size:
        batch_size = num_records

    def init():
        return num_records // batch_size, (np.random.permutation(idxs) if shuffle else idxs)

    def get_batch(i=0, idxs=idxs):
        start = min(max(i * batch_size, 0), max(len(idxs) - batch_size, 0))
        ret_idx = np.asarray(idxs)[start:start + batch_size]
        return tuple(np.take(np.asarray(a), ret_idx, axis=0) for a in arrays)

    return init, get_batch

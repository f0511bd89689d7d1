"""``numpyro_tpu_torch.examples.datasets`` against the JAX package's
``numpyro_tpu.examples.datasets`` on the same files.

Small files are written to a temporary ``DATA_DIR``, set as each module's
attribute: a baseball TSV, the UCBadmit and SP500 CSVs, LynxHare, gzipped
MNIST idx files, a JSB pickle and a covtype zip of an ``.npy``.  Both
packages' loaders give equal arrays, and so do the baseball and MNIST
surrogates (the same ``RandomState(0)`` code) and ``load_dataset``'s
batches, with a batch index past the end (clamped by JAX's
``lax.dynamic_slice_in_dim``) and after ``set_rng_seed`` when shuffled.

The COVTYPE and HIGGS surrogates are a departure: the JAX package draws
them with ``jax.random``, the port with numpy.  Both are held to the same
law: shapes and dtypes, the intercept column, standard normal features and
labels whose rate lies within 4 Monte-Carlo errors of the expected rate
under each package's own coefficients (the coefficients are a draw of the
law, so the two rates differ by more than the Monte-Carlo error: 0.500
against 0.455 at 200,000 rows).

The JAX module's ``_download`` is replaced by one that raises for a missing
file, so that no test tries the network.
"""

import csv
import gzip
import io
import os
import pickle
import struct
import zipfile

import numpy as np
import pytest

import jax
from jax import random

import numpyro_tpu.examples.datasets as jds
import numpyro_tpu.util as jutil
import numpyro_tpu_torch.examples.datasets as tds
from numpyro_tpu_torch.util import set_rng_seed


def _no_network(dset):
    for url in dset.urls:
        local = jds._local_path(url)
        if not os.path.exists(local):
            raise RuntimeError(f"no network: {local} is missing")


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(jds, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(tds, "DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jds, "_download", _no_network)
    return tmp_path


def _write_files(d):
    rng = np.random.default_rng(0)
    with open(d / "EfronMorrisBB.txt", "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["FirstName", "LastName", "At-Bats", "Hits", "BattingAverage",
                    "RemainingAt-Bats", "RemainingAverage", "SeasonAt-Bats", "SeasonHits",
                    "SeasonAverage"])
        for i in range(6):
            w.writerow([f"First{i}", f"Last{i}", 45, 0, 0.0, int(rng.integers(200, 600)), 0.0,
                        0, int(rng.integers(5, 45)), int(rng.integers(50, 200))])
    with open(d / "UCBadmit.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["row", "dept", "applicant.gender", "admit", "applications"])
        for i, dept in enumerate("ABCDEF"):
            for gender in ("Male", "Female"):
                apps = int(rng.integers(20, 900))
                w.writerow([i, f"[{dept}]", gender, int(rng.integers(0, apps)), apps])
    with open(d / "SP500.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Date", "Close"])
        for day in range(12):
            w.writerow([f"2020-01-{day + 1:02d}", f"{3000 + rng.normal(0, 20):.4f}"])
    with open(d / "LynxHare.txt", "w") as f:
        for year in range(1900, 1912):
            f.write(f"{year} {rng.integers(1, 90)} {rng.integers(1, 90)}\n\n")
    for name, n, images in (("train-images-idx3-ubyte.gz", 7, True),
                            ("train-labels-idx1-ubyte.gz", 7, False),
                            ("t10k-images-idx3-ubyte.gz", 3, True),
                            ("t10k-labels-idx1-ubyte.gz", 3, False)):
        with gzip.open(d / name, "wb") as f:
            if images:
                f.write(struct.pack(">IIII", 2051, n, 28, 28))
                f.write(rng.integers(0, 256, (n, 28, 28), dtype=np.uint8).tobytes())
            else:
                f.write(struct.pack(">II", 2049, n))
                f.write(rng.integers(0, 10, n, dtype=np.uint8).tobytes())
    chorales = {split: [[sorted(set(rng.integers(21, 109, 3).tolist())) for _ in range(t)]
                        for t in lengths]
                for split, lengths in (("train", (4, 7, 2)), ("valid", (3,)), ("test", (5, 1)))}
    with open(d / "jsb_chorales.pickle", "wb") as f:
        pickle.dump(chorales, f)
    buf = io.BytesIO()
    np.save(buf, {"data": rng.normal(size=(40, 54)), "target": rng.integers(1, 8, 40)},
            allow_pickle=True)
    with zipfile.ZipFile(d / "covtype.zip", "w") as z:
        z.writestr("covtype.npy", buf.getvalue())


def _assert_equal_splits(got, want):
    assert set(got) == set(want)
    for split in want:
        assert len(got[split]) == len(want[split])
        for a, b in zip(got[split], want[split]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


DATASETS = ["BASEBALL", "UCBADMIT", "SP500", "LYNXHARE", "MNIST", "JSB_CHORALES", "COVTYPE"]


@pytest.mark.parametrize("name", DATASETS)
def test_parsers_give_jax_s_arrays(data_dir, name):
    _write_files(data_dir)
    _assert_equal_splits(tds._load(getattr(tds, name)), jds._load(getattr(jds, name)))


def test_covtype_file_keeps_num_datapoints(data_dir):
    _write_files(data_dir)
    _assert_equal_splits(tds._load(tds.COVTYPE, 25), jds._load(jds.COVTYPE, 25))
    assert tds._load(tds.COVTYPE, 25)["train"][0].shape == (25, 54)


@pytest.mark.parametrize("name", ["BASEBALL", "MNIST"])
def test_surrogates_equal_jax_s(data_dir, name):
    _assert_equal_splits(tds._load(getattr(tds, name)), jds._load(getattr(jds, name)))


@pytest.mark.parametrize("name", ["SP500", "UCBADMIT", "LYNXHARE", "JSB_CHORALES"])
def test_a_missing_file_raises_and_names_its_path(data_dir, name):
    dset = getattr(tds, name)
    with pytest.raises(FileNotFoundError, match=os.path.basename(dset.urls[0])) as info:
        tds._load(dset)
    assert str(data_dir) in str(info.value)
    assert not list(data_dir.iterdir())


def test_the_port_makes_no_data_dir(tmp_path, monkeypatch):
    missing = tmp_path / "nowhere"
    monkeypatch.setattr(tds, "DATA_DIR", str(missing))
    tds._load(tds.BASEBALL)
    assert not missing.exists()


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


@pytest.fixture(scope="module")
def jax_coefficients():
    """The JAX package's surrogate coefficients, drawn as its module draws
    them (the second of three keys split from its seed)."""
    out = {}
    for name, seed, dim, scale in (("covtype", 20260816, 55, 0.5), ("higgs", 20260817, 28, 0.3)):
        kw = random.split(random.PRNGKey(seed), 3)[1]
        out[name] = np.asarray(random.normal(kw, (dim,))) * scale
    return out


@pytest.mark.parametrize("name, n", [("covtype", 30_000), ("higgs", 30_000)])
def test_covtype_and_higgs_surrogates_follow_jax_s_law(data_dir, jax_coefficients, name, n):
    loader = "_load_covtype" if name == "covtype" else "_load_higgs"
    with pytest.warns(UserWarning, match="surrogate"):
        got = getattr(tds, loader)(n)
    with pytest.warns(UserWarning, match="surrogate"):
        want = getattr(jds, loader)(n)
    assert set(got) == set(want)
    for split in want:
        for a, b in zip(got[split], want[split]):
            assert a.shape == np.shape(b) and a.dtype == np.asarray(b).dtype == np.float32
    for pkg, splits, w in (("port", got, tds._surrogate_coefficients(name)),
                           ("jax", want, jax_coefficients[name])):
        X = np.concatenate([np.asarray(s[0]) for s in splits.values()])
        y = np.concatenate([np.asarray(s[1]) for s in splits.values()])
        features = X[:, :-1] if name == "covtype" else X
        if name == "covtype":
            assert (X[:, -1] == 1.0).all(), pkg
        assert abs(features.mean()) < 4 / np.sqrt(features.size), pkg
        assert abs(features.std() - 1.0) < 4 / np.sqrt(2 * features.size), pkg
        assert set(np.unique(y)) <= {0.0, 1.0}
        p = _sigmoid(X.astype(np.float64) @ w.astype(np.float64))
        mc_error = np.sqrt((p * (1 - p)).sum()) / len(y)
        assert abs(y.mean() - p.mean()) < 4 * mc_error, (pkg, y.mean(), p.mean())


@pytest.mark.parametrize("shuffle", [False, True])
def test_load_dataset_batches_equal_jax_s(data_dir, shuffle):
    jinit, jget = jds.load_dataset(jds.MNIST, batch_size=300, split="test", shuffle=shuffle)
    tinit, tget = tds.load_dataset(tds.MNIST, batch_size=300, split="test", shuffle=shuffle)
    jutil.set_rng_seed(4)
    jn, jidx = jinit()
    set_rng_seed(4)
    tn, tidx = tinit()
    assert tn == jn == 1
    np.testing.assert_array_equal(tidx, np.asarray(jidx))
    # 400 records in batches of 300: batch 1 (and 5) run past the end and
    # are clamped to the last full batch
    for i in (0, 1, 5):
        for a, b in zip(tget(i, tidx), jget(i, jidx)):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tget(1, tidx)[1], tget(0, tidx[100:])[1])


def test_iter_dataset_equals_jax_s(data_dir):
    _write_files(data_dir)
    jutil.set_rng_seed(2)
    want = list(jds.iter_dataset(jds.UCBADMIT, batch_size=5))
    set_rng_seed(2)
    got = list(tds.iter_dataset(tds.UCBADMIT, batch_size=5))
    assert len(got) == len(want) == 2
    for gb, wb in zip(got, want):
        for a, b in zip(gb, wb):
            np.testing.assert_array_equal(a, b)


def test_jax_is_not_asked_for_the_network(data_dir):
    """The patched ``_download`` raises for a missing file instead of
    fetching it, so the JAX package serves its surrogate."""
    with pytest.raises(RuntimeError, match="no network"):
        jds._download(jds.SP500)
    assert jax.devices()[0].platform == "cpu"

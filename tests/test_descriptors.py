"""Binary descriptors + image database tests."""

import numpy as np
import pytest
from scipy import ndimage

import jax.numpy as jnp

from beam_slam_tpu.vision import descriptors as dsc
from beam_slam_tpu.vision import detector as det
from beam_slam_tpu.vision.image_database import ImageDatabase


def _textured(rng, H=200, W=260, n=120, seed_shift=0):
    img = np.zeros((H, W), np.float32)
    ys = rng.uniform(16, H - 16, n)
    xs = rng.uniform(16, W - 16, n)
    amps = rng.uniform(80, 220, n)
    yy, xx = np.mgrid[0:H, 0:W]
    for y, x, a in zip(ys, xs, amps):
        img += a * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * 2.2 ** 2))
    return np.clip(img, 0, 255).astype(np.float32)


def test_descriptor_matching_under_shift(rng):
    img1 = _textured(rng)
    img2 = ndimage.shift(img1, (4.0, -6.0), order=1, mode="nearest")
    xy1, s1, v1 = det.detect(jnp.asarray(img1), det.FastConfig(threshold=10,
                                                               cell_size=24))
    xy2 = xy1 + jnp.asarray([-6.0, 4.0])  # features move by (-dx? ) shift
    d1, ok1 = dsc.compute(jnp.asarray(img1), xy1, v1)
    d2, ok2 = dsc.compute(jnp.asarray(img2), xy2, v1)
    idx, good = dsc.match(d1, ok1, d2, ok2)
    good = np.asarray(good)
    assert good.sum() >= 10
    # matches must be the identity correspondence
    assert (np.asarray(idx)[good] == np.nonzero(good)[0]).mean() > 0.9


def test_descriptor_distance_separates_random(rng):
    img = _textured(rng)
    xy, s, v = det.detect(jnp.asarray(img), det.FastConfig(threshold=10,
                                                           cell_size=24))
    d, ok = dsc.compute(jnp.asarray(img), xy, v)
    sel = np.nonzero(np.asarray(ok))[0][:20]
    D = np.asarray(dsc.hamming_matrix(d[sel], d[sel]))
    assert np.all(np.diag(D) == 0)
    off = D[~np.eye(len(sel), dtype=bool)]
    # distinct smooth-blob patches still differ in a solid fraction of bits
    assert np.median(off) > 30, np.median(off)


def test_image_database_recognizes_revisit(rng):
    db = ImageDatabase(n_words=128)
    imgs = [_textured(np.random.default_rng(s)) for s in (1, 2, 3)]
    descs = []
    for i, img in enumerate(imgs):
        xy, s, v = det.detect(jnp.asarray(img),
                              det.FastConfig(threshold=10, cell_size=24))
        d, ok = dsc.compute(jnp.asarray(img), xy, v)
        descs.append((d, ok))
        db.add_frame(float(i), d, ok)
    # query with a slightly shifted re-observation of scene 0
    img_q = ndimage.shift(imgs[0], (2.0, 1.0), order=1, mode="nearest")
    xy, s, v = det.detect(jnp.asarray(img_q),
                          det.FastConfig(threshold=10, cell_size=24))
    dq, okq = dsc.compute(jnp.asarray(img_q), xy, v)
    res = db.query(dq, okq, top_k=1, exclude_recent=0)
    assert res and res[0][0] == 0.0, res


def test_image_database_discriminates_revisits():
    """Retrieval quality on nontrivial data: 20 distinct
    'places', each revisited with descriptor noise (5% bit flips + 20%
    outlier replacement). The database must rank the true place first for
    every noisy revisit — random-hyperplane BoW or not, it has to actually
    discriminate."""
    from beam_slam_tpu.vision.image_database import ImageDatabase

    rng = np.random.default_rng(4)
    n_places, n_desc = 20, 120
    db = ImageDatabase(n_words=256)
    places = []
    for pi in range(n_places):
        d = rng.integers(0, 2**32, (n_desc, 8), dtype=np.uint64) \
            .astype(np.uint32)
        places.append(d)
        db.add_frame(float(pi), jnp.asarray(d), jnp.ones(n_desc, bool))

    hits = 0
    for pi in range(n_places):
        noisy = places[pi].copy()
        # 5% bit flips
        flips = (rng.random(noisy.shape) < 0.05 * 32 / 32)
        masks = rng.integers(0, 2**32, noisy.shape, dtype=np.uint64) \
            .astype(np.uint32)
        bitsel = (rng.random((n_desc, 8, 32)) < 0.05)
        flip_mask = np.zeros_like(noisy)
        for b in range(32):
            flip_mask |= (bitsel[:, :, b].astype(np.uint32) << b)
        noisy ^= flip_mask
        # 20% outliers
        out = rng.random(n_desc) < 0.2
        noisy[out] = rng.integers(0, 2**32, (int(out.sum()), 8),
                                  dtype=np.uint64).astype(np.uint32)
        res = db.query(jnp.asarray(noisy), jnp.ones(n_desc, bool),
                       top_k=1, exclude_recent=0)
        if res and int(res[0][0]) == pi:
            hits += 1
    assert hits >= 18, hits  # >= 90% top-1 on noisy revisits


def test_trained_vocabulary_beats_random_quantization():
    """Binary k-means vocabulary (DBoW-style descriptor clustering): on a
    corpus drawn from latent prototypes, the trained vocab's quantization
    error must be far below the random-hyperplane vocab's, and noisy
    revisit retrieval must stay perfect."""
    from beam_slam_tpu.vision.image_database import (ImageDatabase,
                                                     train_vocabulary)

    rng = np.random.default_rng(7)
    n_proto, per_proto = 32, 60
    protos = rng.integers(0, 2**32, (n_proto, 8), dtype=np.uint64) \
        .astype(np.uint32)
    corpus = np.repeat(protos, per_proto, axis=0)
    # 3% bit noise around each prototype
    bitsel = rng.random((corpus.shape[0], 8, 32)) < 0.03
    flip = np.zeros_like(corpus)
    for b in range(32):
        flip |= (bitsel[:, :, b].astype(np.uint32) << b)
    corpus ^= flip
    valid = np.ones(corpus.shape[0], bool)

    vocab = train_vocabulary(corpus, valid, n_words=n_proto, n_iters=15,
                             seed=3)

    def mean_quant_err(voc):
        D = np.asarray(dsc.hamming_matrix(jnp.asarray(corpus),
                                          jnp.asarray(voc)))
        return D.min(axis=1).mean()

    rand_db = ImageDatabase(n_words=n_proto)
    err_trained = mean_quant_err(vocab)
    err_random = mean_quant_err(rand_db.vocab)
    # trained centroids sit on the prototypes (~3% noise floor ≈ 7.7 bits);
    # random words are ~128 bits away
    assert err_trained < 15, err_trained
    assert err_trained < 0.25 * err_random, (err_trained, err_random)

    # retrieval: places built from disjoint prototype subsets
    db = ImageDatabase(vocab=vocab)
    n_places = 8
    place_descs = []
    for pi in range(n_places):
        sel = rng.choice(n_proto, 4, replace=False)
        d = corpus[np.concatenate([np.arange(s * per_proto,
                                             s * per_proto + 30)
                                   for s in sel])]
        place_descs.append(d)
        db.add_frame(float(pi), jnp.asarray(d), np.ones(len(d), bool))
    hits = 0
    for pi in range(n_places):
        noisy = place_descs[pi].copy()
        bitsel = rng.random((noisy.shape[0], 8, 32)) < 0.05
        flip = np.zeros_like(noisy)
        for b in range(32):
            flip |= (bitsel[:, :, b].astype(np.uint32) << b)
        noisy ^= flip
        res = db.query(jnp.asarray(noisy), np.ones(len(noisy), bool),
                       top_k=1, exclude_recent=0)
        if res and int(res[0][0]) == pi:
            hits += 1
    assert hits == n_places, hits


def test_vocabulary_round_trip(tmp_path):
    from beam_slam_tpu.vision.image_database import ImageDatabase

    rng = np.random.default_rng(2)
    descs = rng.integers(0, 2**32, (200, 8), dtype=np.uint64) \
        .astype(np.uint32)
    db = ImageDatabase.trained(jnp.asarray(descs), np.ones(200, bool),
                               n_words=16, n_iters=4)
    path = str(tmp_path / "vocab.npz")
    db.save_vocabulary(path)
    db2 = ImageDatabase.from_vocabulary_file(path)
    assert np.array_equal(np.asarray(db.vocab), np.asarray(db2.vocab))
    w1 = db.words_for(jnp.asarray(descs[:10]), np.ones(10, bool))
    w2 = db2.words_for(jnp.asarray(descs[:10]), np.ones(10, bool))
    assert np.array_equal(w1, w2)

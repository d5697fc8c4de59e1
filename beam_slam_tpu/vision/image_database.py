"""Bag-of-binary-words image database.

Replaces the reference's beam_cv ``ImageDatabase`` (DBoW-backed; used by
VisualOdometry's local-map word search and by reloc requests): binary
descriptors are quantized against a vocabulary by Hamming distance (one
batched popcount matmul-like op), frames are tf-idf weighted word
histograms, and queries are cosine similarities over the whole database in
one einsum.

Vocabulary tiers:

* random hyperplanes (default, zero training) — adequate for revisit
  detection on distinctive scenes;
* **trained** (:func:`train_vocabulary`): binary k-means over corpus
  descriptors — Hamming assignment via one ±1 matmul, centroid update
  by per-bit majority vote — a flat counterpart of DBoW2's
  hierarchical-k-means descriptor clustering (a tree buys O(log) lookup on
  a CPU; on an accelerator one [N,words] matmul + argmin is a single
  kernel, so the hierarchy would only add latency).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from beam_slam_tpu.vision import descriptors as desc_mod

N_BITS = desc_mod.N_WORDS * 32


def _unpack_bits(descs: jnp.ndarray) -> jnp.ndarray:
    """[N, W] uint32 → [N, W·32] float32 in {0, 1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (descs[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(descs.shape[0], -1).astype(jnp.float32)


def _pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """[M, W·32] bool → [M, W] uint32."""
    M = bits.shape[0]
    b = bits.reshape(M, -1, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnames=("n_words", "n_iters"))
def _kmeans_binary(bits: jnp.ndarray, valid: jnp.ndarray, key,
                   n_words: int, n_iters: int) -> jnp.ndarray:
    """Binary k-means. bits [N, B] float {0,1}; returns centroids [K, B]
    bool. Hamming distance through one matmul: with s = 2·bits−1 ∈ {±1},
    d(x, c) = (B − s_x·s_c)/2 — so argmin Hamming = argmax s_x @ s_cᵀ."""
    N, B = bits.shape
    vf = valid.astype(jnp.float32)
    s_x = (2.0 * bits - 1.0) * vf[:, None]  # invalid rows → 0 (inert)

    # init: farthest-point (maximin) sampling — one center per descriptor
    # mode, immune to the merged-prototype local optima of random init
    first = jax.random.choice(key, N, p=vf / jnp.maximum(vf.sum(), 1.0))
    neg = -jnp.inf

    def fps_step(k, carry):
        centers, dmin = carry
        s_c = 2.0 * centers[k - 1] - 1.0
        d = 0.5 * (B - s_x @ s_c)               # Hamming to newest center
        dmin = jnp.minimum(dmin, jnp.where(valid, d, neg))
        nxt = jnp.argmax(dmin)
        centers = centers.at[k].set(bits[nxt])
        return centers, dmin

    centers0 = jnp.zeros((n_words, B), jnp.float32).at[0].set(bits[first])
    dmin0 = jnp.where(valid, jnp.full((N,), jnp.inf), neg)
    centers, _ = jax.lax.fori_loop(1, n_words, fps_step, (centers0, dmin0))

    def step(centers, _):
        s_c = 2.0 * centers - 1.0
        sim = s_x @ s_c.T                       # [N, K]
        assign = jnp.argmax(sim, axis=1)
        oh = jax.nn.one_hot(assign, n_words, dtype=jnp.float32) * vf[:, None]
        counts = oh.sum(axis=0)                  # [K]
        sums = oh.T @ bits                       # [K, B]
        mean = sums / jnp.maximum(counts, 1.0)[:, None]
        new = jnp.where(counts[:, None] > 0, mean > 0.5, centers > 0.5)
        return new.astype(jnp.float32), None

    centers, _ = jax.lax.scan(step, centers, None, length=n_iters)
    return centers > 0.5


def train_vocabulary(descs, valid, n_words: int = 256, n_iters: int = 12,
                     seed: int = 0) -> jnp.ndarray:
    """Train a binary-BoW vocabulary from a corpus of descriptors.

    descs [N, W] uint32, valid [N] bool. Returns vocab [n_words, W] uint32
    — drop-in for ``ImageDatabase(vocab=...)``."""
    bits = _unpack_bits(jnp.asarray(descs))
    centers = _kmeans_binary(bits, jnp.asarray(valid),
                             jax.random.PRNGKey(seed), n_words, n_iters)
    return _pack_bits(centers)


class ImageDatabase:
    def __init__(self, n_words: int = 256, seed: int = 11,
                 vocab: Optional[jnp.ndarray] = None):
        if vocab is not None:
            self.vocab = jnp.asarray(vocab, jnp.uint32)
            n_words = int(self.vocab.shape[0])
        else:
            key = jax.random.PRNGKey(seed)
            self.vocab = jax.random.bits(key, (n_words, desc_mod.N_WORDS),
                                         jnp.uint32)
        self.n_words = n_words
        self.frames: List[float] = []
        self._hists: List[np.ndarray] = []
        self.word_of: Dict[float, np.ndarray] = {}

    @classmethod
    def trained(cls, descs, valid, n_words: int = 256, n_iters: int = 12,
                seed: int = 0) -> "ImageDatabase":
        """Build a database with a vocabulary trained on a corpus (the
        offline DBoW-vocabulary-creation step of the reference stack)."""
        return cls(vocab=train_vocabulary(descs, valid, n_words, n_iters,
                                          seed))

    def save_vocabulary(self, path: str):
        np.savez(path, vocab=np.asarray(self.vocab))

    @classmethod
    def from_vocabulary_file(cls, path: str) -> "ImageDatabase":
        return cls(vocab=np.load(path)["vocab"])

    def words_for(self, descs: jnp.ndarray, valid: jnp.ndarray) -> np.ndarray:
        d = desc_mod.hamming_matrix(descs, self.vocab)
        w = np.asarray(jnp.argmin(d, axis=1))
        return np.where(np.asarray(valid), w, -1)

    def _hist(self, words: np.ndarray) -> np.ndarray:
        h = np.bincount(words[words >= 0], minlength=self.n_words) \
            .astype(np.float64)
        n = np.linalg.norm(h)
        return h / n if n > 0 else h

    def add_frame(self, stamp: float, descs, valid):
        words = self.words_for(jnp.asarray(descs), jnp.asarray(valid))
        self.word_of[stamp] = words
        self.frames.append(stamp)
        self._hists.append(self._hist(words))

    def query(self, descs, valid, top_k: int = 3,
              exclude_recent: int = 1) -> List[Tuple[float, float]]:
        """Most similar database frames: [(stamp, cosine score)]."""
        if len(self.frames) <= exclude_recent:
            return []
        words = self.words_for(jnp.asarray(descs), jnp.asarray(valid))
        h = self._hist(words)
        H = np.stack(self._hists[: len(self._hists) - exclude_recent])
        scores = H @ h
        order = np.argsort(scores)[::-1][:top_k]
        return [(self.frames[i], float(scores[i])) for i in order]

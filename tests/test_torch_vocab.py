"""The vocabulary and the keyframe database of the port
(``extractorb_tpu_torch/place/``) against the JAX package's.

The same seeded descriptors train both packages' trees (same nodes and idf
weights), descend them to the same words (random and rendered descriptors,
and a tree read from the DBoW2 text format the JAX package writes), give
the same sparse BoW, and the two keyframe databases return the same
candidates with scores within 1e-6.  On a card, kernel K11 gives the plain
version's words on an ORBvoc-shaped tree and on a trained one.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import port_fixtures as pf
from extractorb_tpu.place import vocab as jvocab
from extractorb_tpu.place.database import KeyFrameDatabase as JDatabase
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.config import ORBConfig
from extractorb_tpu_torch.frontend.extractor import ORBExtractor
from extractorb_tpu_torch.place import vocab as tvocab
from extractorb_tpu_torch.place.database import KeyFrameDatabase
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)


def corpus(seed=0, n_centres=40, n=1500):
    """Descriptors in clusters (a few bits flipped around random centres),
    as real ORB descriptors cluster."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 256, (n_centres, 32), dtype=np.uint8)
    d = centres[rng.integers(0, n_centres, n)]
    flips = (rng.random((n, 256)) < 0.06).astype(np.uint8)
    return d ^ np.packbits(flips, axis=1)


@pytest.fixture(scope="module")
def vocabs():
    d = corpus()
    return d, jvocab.Vocabulary.train(d, k=8, L=3, seed=0), tvocab.Vocabulary.train(d, k=8, L=3,
                                                                                      seed=0)


def rendered_descriptors():
    img, _ = pf.render_two_plane(pf.procedural_texture(), pf.true_pose(0), 320, 240)
    f = ORBExtractor(ORBConfig(n_features=500), (240, 320), torch.device("cpu"))(
        torch.from_numpy(img))
    return f.desc.numpy()[f.valid.numpy()]


def assert_same_tree(a, b):
    assert (a.k, a.L) == (b.k, b.L)
    for l in range(a.L):
        np.testing.assert_array_equal(np.asarray(a.children_desc[l]), b.children_desc[l])
        np.testing.assert_array_equal(np.asarray(a.children_id[l]), b.children_id[l])
    np.testing.assert_allclose(np.asarray(a.weights), b.weights, rtol=0, atol=1e-12)


def test_train_same_tree_and_weights(vocabs):
    _, jv, tv = vocabs
    assert_same_tree(jv, tv)
    assert tv.n_words == jv.n_words > 100


@pytest.mark.parametrize("source", ["random", "corpus", "rendered"])
def test_transform_words_equal(vocabs, source):
    _, jv, tv = vocabs
    d = {"random": lambda: np.random.default_rng(3).integers(0, 256, (700, 32), dtype=np.uint8),
         "corpus": lambda: corpus(seed=4, n=700),
         "rendered": rendered_descriptors}[source]()
    np.testing.assert_array_equal(tv.transform_words(d), np.asarray(jv.transform_words(d)))


def test_bow_equal(vocabs):
    _, jv, tv = vocabs
    d = corpus(seed=5, n=600)
    valid = np.random.default_rng(5).random(600) < 0.9
    ji, jw = jv.bow_sparse(d, valid)
    ti, tw = tv.bow_sparse(d, valid)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tv.bow_vector(d, valid), jv.bow_vector(d, valid))


def test_orbvoc_text_and_npz_files(vocabs, tmp_path):
    """A tree written by the JAX package's save_orbvoc_text reads in the
    port as in JAX; the npz format and the interop copy round-trip."""
    _, jv, tv = vocabs
    txt = str(tmp_path / "voc.txt")
    jvocab.save_orbvoc_text(jv, txt)
    assert_same_tree(jvocab.load_orbvoc_text(txt), tvocab.load_orbvoc_text(txt))
    tvocab.save_orbvoc_text(tv, str(tmp_path / "voc2.txt"))
    assert open(txt).read() == open(tmp_path / "voc2.txt").read()
    npz = str(tmp_path / "voc.npz")
    jv.save(npz)
    assert_same_tree(jv, tvocab.Vocabulary.load(npz))
    assert_same_tree(jv, interop.vocab_from_numpy(interop.vocab_to_numpy(jv)))


def groups(n_kf, rng):
    """Keyframe descriptors of n_kf keyframes in 4 places (each place's
    keyframes share most of their descriptors) and a covisibility function
    of the places."""
    places = [corpus(seed=10 + p, n=400) for p in range(4)]
    kfs = []
    for i in range(n_kf):
        d = places[i % 4].copy()
        d[rng.random(400) < 0.3] = rng.integers(0, 256, 32, dtype=np.uint8)
        kfs.append(d)
    covis = lambda key: [k for k in range(n_kf) if k % 4 == key % 4 and k != key][:10]
    return kfs, covis


@pytest.mark.parametrize("mode", ["plain", "covis", "reloc", "min-score"])
def test_database_queries_equal(vocabs, mode):
    corpus_d, jv, tv = vocabs
    rng = np.random.default_rng(7)
    kfs, covis = groups(16, rng)
    jdb, tdb = JDatabase(jv), KeyFrameDatabase(tv)
    for i, d in enumerate(kfs):
        valid = rng.random(400) < 0.95
        jdb.add(i, d, valid)
        tdb.add(i, d, valid)
    jdb.erase(5)
    tdb.erase(5)
    jdb.rekey(6, 60)
    tdb.rekey(6, 60)
    q = kfs[2].copy()
    q[rng.random(400) < 0.2] = rng.integers(0, 256, 32, dtype=np.uint8)
    kw = {"plain": dict(exclude={2}, n_best=5),
          "covis": dict(exclude={2, 3}, n_best=3, covis_fn=covis),
          "reloc": dict(n_best=5, covis_fn=covis, rel_score_ratio=0.75),
          "min-score": dict(exclude={2}, covis_fn=covis,
                            min_score=jdb.min_score_against([10, 14, 99], q))}[mode]
    jr, tr = jdb.query(q, **kw), tdb.query(q, **kw)
    assert [k for k, _ in tr] == [k for k, _ in jr] and jr
    np.testing.assert_allclose([s for _, s in tr], [s for _, s in jr], rtol=0, atol=1e-6)
    assert tdb.min_score_against([10, 14, 99], q) == pytest.approx(
        jdb.min_score_against([10, 14, 99], q), abs=1e-6)
    with pytest.raises(NotImplementedError, match="B.26"):
        tdb.enable_device_backend(None)


# ------------------------------------------------------------ card (K11)


@pytest.mark.gpu
def test_vocab_words_kernel_matches_plain(cuda_device, vocabs):
    """K11 against the plain descent: an ORBvoc-shaped tree (k=10, L=6)
    and the trained one, 1128 descriptors; words equal."""
    _, _, tv = vocabs
    d = torch.from_numpy(corpus(seed=9, n=1128)).to(cuda_device)
    for v in (chip_smoke.random_vocab(), tv):
        assert torch.equal(v.transform_words_device(d).long(), v.transform_words_plain(d).long())

"""Keyframe database: BoW place-recognition queries (port of
``extractorb_tpu/place/database.py``, host numpy).

Replaces KeyFrameDatabase (reference src/KeyFrameDatabase.cc:39 add, :47
erase, :612 DetectNBestCandidates, :783 DetectRelocalizationCandidates).
Keyframe BoW vectors are stored sparse (sorted word ids + tf-idf weights)
in one CSR arena; a query densifies once into an (n_words,) vector and
scores every stored keyframe with one gather and segment sum: for
L1-normalised vectors

    score = 1 - 0.5 |v - q|_1 = 0.5 sum_{shared words} (v_i + q_i - |v_i - q_i|).

The words of a query come from ``Vocabulary.bow_sparse`` on the
database's ``device`` (kernel K11 on the card); a caller that already has
a keyframe's BoW passes it as ``bow``.

``enable_device_backend(mesh)`` scores places on the device mesh instead,
as the JAX module does: dense per-keyframe histograms, one block of
keyframes per shard (``dist/kf_blocks``, kernel K29 on a card), rebuilt
when the entries change.  Dense rows are W floats each, so the backend is
taken only for vocabularies of at most ``max_dense_words`` words; the host
CSR pass stays the default at ORBvoc scale (~1M words).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import kernels
from ..dist import kf_blocks as kfb


class KeyFrameDatabase:
    def __init__(self, vocab, device=None):
        self.vocab = vocab
        self.device = kernels.resolve_device(device, "the keyframe database")
        # kf_id -> (word_ids int32, weights float32)
        self.entries: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._dirty = True
        self._cat_words: Optional[np.ndarray] = None
        self._cat_weights: Optional[np.ndarray] = None
        self._cat_row: Optional[np.ndarray] = None
        self._row_ids: Optional[np.ndarray] = None
        self._mesh = None
        self._max_dense_words = 1 << 16
        self._rev = 0            # bumped on every mutation
        self._dev_rev = -1       # the revision the device arena holds
        self._dev_arena = None   # KF-sharded (hists, has_word, valid)

    def enable_device_backend(self, mesh, max_dense_words: int = 1 << 16):
        """Score places on ``mesh`` (the host pass's scores within float32
        rounding; None turns the backend off)."""
        self._mesh = mesh
        self._max_dense_words = max_dense_words
        self._dirty = True
        self._dev_arena = None

    def _device_arena(self):
        """The dense histograms, shared-word masks and row validity of the
        entries, padded to the mesh and KF-sharded; rebuilt after a change."""
        if self._dev_arena is None or self._dev_rev != self._rev:
            self._dev_rev = self._rev
            cw, cwt, crow, row_ids = self._arena()
            K, n = len(row_ids), self._mesh.size
            hists = np.zeros((K, self.vocab.n_words), np.float32)
            hists[crow, cw] = cwt
            blocks = [kfb.pad_to_mesh(a, n) for a in (hists, hists > 0, np.ones(K, bool))]
            self._dev_arena = tuple(kfb.shard_kf_axis(self._mesh, a) for a in blocks)
        return self._dev_arena

    def __len__(self) -> int:
        return len(self.entries)

    def _bow(self, descs, valid, bow):
        return bow if bow is not None else self.vocab.bow_sparse(descs, valid, self.device)

    def add(self, kf_id: int, descs: np.ndarray, valid=None, bow=None):
        self.entries[kf_id] = self._bow(descs, valid, bow)
        self._dirty = True
        self._rev += 1

    def rekey(self, old_id: int, new_id: int):
        """Rename an entry (welded keyframes get new ids after a merge)."""
        e = self.entries.pop(old_id, None)
        if e is not None:
            self.entries[new_id] = e
            self._dirty = True
        self._rev += 1

    def erase(self, kf_id: int):
        """Drop a culled keyframe's entry (KeyFrameDatabase::erase)."""
        if self.entries.pop(kf_id, None) is not None:
            self._dirty = True
        self._rev += 1

    def _arena(self):
        if self._dirty:
            if self.entries:
                kf_ids = list(self.entries.keys())
                words = [self.entries[k][0] for k in kf_ids]
                lens = np.asarray([len(w) for w in words], np.int64)
                self._cat_words = np.concatenate(words)
                self._cat_weights = np.concatenate([self.entries[k][1] for k in kf_ids])
                self._cat_row = np.repeat(np.arange(len(kf_ids), dtype=np.int32), lens)
                self._row_ids = np.asarray(kf_ids, np.int64)
            else:
                self._cat_words = np.zeros(0, np.int32)
                self._cat_weights = np.zeros(0, np.float32)
                self._cat_row = np.zeros(0, np.int32)
                self._row_ids = np.zeros(0, np.int64)
            self._dirty = False
        return self._cat_words, self._cat_weights, self._cat_row, self._row_ids

    def min_score_against(self, keys, descs, valid=None, bow=None):
        """Minimum L1 BoW score of the query against the given stored
        entries (DetectLoopCandidates' minScore over the query's
        covisibles, KeyFrameDatabase.cc:100); None when no key is stored."""
        q_ids, q_w = self._bow(descs, valid, bow)
        if len(q_ids) == 0:
            return None
        qv = np.zeros(self.vocab.n_words, np.float32)
        qv[q_ids] = q_w
        best = None
        for k in keys:
            e = self.entries.get(k)
            if e is None:
                continue
            ids, w = e
            qg = qv[ids]
            s = float(0.5 * np.sum(w + qg - np.abs(w - qg)))
            best = s if best is None else min(best, s)
        return best

    def query(self, descs: np.ndarray, valid=None, exclude: Optional[set] = None,
              n_best: int = 3, min_common_ratio: float = 0.8, covis_fn=None,
              rel_score_ratio: Optional[float] = None, min_score: Optional[float] = None,
              bow=None) -> List[Tuple[int, float]]:
        """DetectNBestCandidates / DetectRelocalizationCandidates
        (KeyFrameDatabase.cc:612-897): the shared-word gate at
        min_common_ratio x the most shared words, then with ``covis_fn``
        (key -> covisible keys) the scores accumulated over each
        candidate's covisibility group, its best member representing it.
        ``rel_score_ratio`` returns every group within that ratio of the
        best; ``min_score`` is the score floor.  [(kf_id, score)] best
        first."""
        if not self.entries:
            return []
        cw, cwt, crow, row_ids = self._arena()
        K = len(row_ids)
        q_ids, q_w = self._bow(descs, valid, bow)
        if len(q_ids) == 0:
            return []
        qv = np.zeros(self.vocab.n_words, np.float32)
        qv[q_ids] = q_w
        if self._mesh is not None and self.vocab.n_words <= self._max_dense_words:
            sc, cm = kfb.sharded_place_scores(self._mesh, *self._device_arena(), qv)
            scores = kfb.gather_host(sc)[:K].astype(np.float64)
            common = kfb.gather_host(cm)[:K].astype(np.int64)
        else:
            qg = qv[cw]
            shared = qg > 0
            common = np.zeros(K, np.int64)
            np.add.at(common, crow[shared], 1)
            contrib = 0.5 * (cwt + qg - np.abs(cwt - qg))
            scores = np.zeros(K, np.float64)
            np.add.at(scores, crow, contrib)

        live = np.ones(K, bool)
        if exclude:
            live &= ~np.isin(row_ids, np.fromiter(exclude, np.int64, len(exclude)))
        if not live.any():
            return []
        max_common = common[live].max()
        gate = live & (common >= min_common_ratio * max_common) & (common > 0)
        if min_score is not None:
            gate &= scores >= min_score
        if not gate.any():
            return []
        if covis_fn is None:
            idx = np.where(gate)[0]
            order = idx[np.argsort(-scores[idx])][:n_best]
            return [(int(row_ids[i]), float(scores[i])) for i in order]

        sharing = live & (common > 0)
        score_of = {int(row_ids[r]): float(scores[r]) for r in np.where(sharing)[0]}
        groups: List[Tuple[float, int]] = []
        for r in np.where(gate)[0]:
            seed = int(row_ids[r])
            acc = score_of.get(seed, 0.0)
            best_kf, best_s = seed, acc
            for member in list(covis_fn(seed))[:10]:
                s = score_of.get(int(member))
                if s is None:
                    continue
                acc += s
                if s > best_s:
                    best_kf, best_s = int(member), s
            groups.append((acc, best_kf))
        if not groups:
            return []
        groups.sort(key=lambda g: -g[0])
        out: List[Tuple[int, float]] = []
        seen: set = set()
        if rel_score_ratio is not None:
            min_acc = rel_score_ratio * groups[0][0]
            for acc, kf in groups:
                if acc < min_acc:
                    break
                if kf not in seen:
                    seen.add(kf)
                    out.append((kf, acc))
        else:
            for acc, kf in groups:
                if kf not in seen:
                    seen.add(kf)
                    out.append((kf, acc))
                if len(out) >= n_best:
                    break
        return out

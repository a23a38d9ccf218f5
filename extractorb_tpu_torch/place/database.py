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
a keyframe's BoW passes it as ``bow``.  The JAX module's optional
mesh-sharded scoring (``dist/kf_blocks``) is ROADMAP B.26 / A.14.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class KeyFrameDatabase:
    def __init__(self, vocab, device="cpu"):
        self.vocab = vocab
        self.device = device
        # kf_id -> (word_ids int32, weights float32)
        self.entries: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._dirty = True
        self._cat_words: Optional[np.ndarray] = None
        self._cat_weights: Optional[np.ndarray] = None
        self._cat_row: Optional[np.ndarray] = None
        self._row_ids: Optional[np.ndarray] = None

    def enable_device_backend(self, mesh, max_dense_words: int = 1 << 16):
        raise NotImplementedError("KeyFrameDatabase: the mesh-sharded dense scoring "
                                  "(dist/kf_blocks) is not ported (ROADMAP B.26, A.14)")

    def __len__(self) -> int:
        return len(self.entries)

    def _bow(self, descs, valid, bow):
        return bow if bow is not None else self.vocab.bow_sparse(descs, valid, self.device)

    def add(self, kf_id: int, descs: np.ndarray, valid=None, bow=None):
        self.entries[kf_id] = self._bow(descs, valid, bow)
        self._dirty = True

    def rekey(self, old_id: int, new_id: int):
        """Rename an entry (welded keyframes get new ids after a merge)."""
        e = self.entries.pop(old_id, None)
        if e is not None:
            self.entries[new_id] = e
            self._dirty = True

    def erase(self, kf_id: int):
        """Drop a culled keyframe's entry (KeyFrameDatabase::erase)."""
        if self.entries.pop(kf_id, None) is not None:
            self._dirty = True

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

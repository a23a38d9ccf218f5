"""Vocabulary tree for place recognition (port of
``extractorb_tpu/place/vocab.py``).

The tree is stored level by level as dense tables: at level l every node
row holds k child descriptors (``children_desc[l]``, (n_l, k, 32) u8) and
their ids (``children_id[l]``, (n_l, k), the row at level l+1 or, at the
last level, the word id; -1 for a missing child).  Unused child slots
repeat child 0, so a tie resolves to the real child.  ``transform_words``
descends the tree: at each level the child with the smallest Hamming
distance, the lowest index on a tie (``jnp.argmin``'s rule).  A -1 id met
on the way down indexes the level's last row, as the JAX gather does.

``transform_words_device`` launches kernel K11 (``csrc/vocab_words.cu``)
on CUDA tensors and runs ``transform_words_plain`` on the CPU.  ``train``
is the JAX package's numpy k-means (bitwise-majority centres), draw for
draw: the same seed gives the same tree and idf weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels


def _hamming_np(a, b):
    """(N,32) x (M,32) uint8 -> (N,M) popcount distances."""
    abits = np.unpackbits(a, axis=1)
    bbits = np.unpackbits(b, axis=1)
    return (abits[:, None, :] != bbits[None, :, :]).sum(-1)


def _majority(descs: np.ndarray) -> np.ndarray:
    """Bitwise-majority centre of (N,32) uint8 descriptors."""
    bits = np.unpackbits(descs, axis=1)
    return np.packbits((bits.mean(0) >= 0.5).astype(np.uint8))


def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Bit count of each byte of a uint8 tensor, summed over the last dim."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    return ((x[..., None] >> shifts) & 1).sum((-1, -2), dtype=torch.int32)


@dataclasses.dataclass
class Vocabulary:
    """Level-wise dense vocabulary tree (see the module docstring)."""

    k: int
    L: int
    children_desc: list
    children_id: list
    weights: np.ndarray

    def __post_init__(self):
        self._dev = {}

    @property
    def n_words(self) -> int:
        return len(self.weights)

    # ------------------------------------------------------------- train

    @staticmethod
    def train(descs: np.ndarray, k: int = 10, L: int = 4, seed: int = 0,
              iters: int = 8) -> "Vocabulary":
        """Hierarchical binary k-means over (N,32) uint8 descriptors and
        idf weights log(N / (count + 1)) clamped at 0."""
        rng = np.random.default_rng(seed)

        def kmeans(data):
            if len(data) <= k:
                return data.copy(), np.arange(len(data)) % max(len(data), 1)
            centers = data[rng.choice(len(data), k, replace=False)]
            assign = None
            for _ in range(iters):
                assign = _hamming_np(data, centers).argmin(1)
                new = []
                for c in range(k):
                    m = assign == c
                    new.append(_majority(data[m]) if m.any() else data[rng.integers(len(data))])
                centers = np.stack(new)
            return centers, assign

        levels_desc, levels_id = [], []
        current = [descs]
        word_count = 0
        for lvl in range(L):
            nd = np.zeros((len(current), k, 32), np.uint8)
            nid = np.full((len(current), k), -1, np.int64)
            next_clusters = []
            for i, data in enumerate(current):
                if len(data) == 0:
                    continue
                centers, assign = kmeans(data)
                for c in range(len(centers)):
                    nd[i, c] = centers[c]
                    if lvl == L - 1:
                        nid[i, c] = word_count
                        word_count += 1
                    else:
                        nid[i, c] = len(next_clusters)
                        next_clusters.append(data[assign == c])
                for c in range(len(centers), k):
                    nd[i, c] = centers[0]
                    nid[i, c] = nid[i, 0]
            levels_desc.append(nd)
            levels_id.append(nid)
            current = next_clusters

        voc = Vocabulary(k, L, levels_desc, levels_id, np.ones(word_count))
        words = voc.transform_words(descs)
        counts = np.bincount(words, minlength=word_count) + 1
        voc.weights = np.maximum(np.log(len(descs) / counts), 0.0)
        return voc

    # --------------------------------------------------------- transform

    def device_tables(self, device):
        """The tree on ``device``: all levels' child descriptors (R, k, 32)
        u8 and ids (R, k) int32 stacked, and per level its first row and
        row count (2L,) int32.  Built once per device."""
        device = torch.device(device)
        tabs = self._dev.get(str(device))
        if tabs is None:
            rows = [len(d) for d in self.children_desc]
            first = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int32)
            desc = np.concatenate([np.asarray(d, np.uint8) for d in self.children_desc], 0)
            ids = np.concatenate([np.asarray(i, np.int64) for i in self.children_id], 0)
            meta = np.concatenate([first, np.asarray(rows, np.int32)]).astype(np.int32)
            to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            tabs = (to(desc), to(ids.astype(np.int32)), to(meta))
            self._dev[str(device)] = tabs
        return tabs

    def transform_words(self, descs, device=None) -> np.ndarray:
        """(N,32) uint8 -> (N,) int64 word ids, on ``device`` (default:
        the CPU plain path); host in, host out."""
        d = torch.from_numpy(np.ascontiguousarray(descs, np.uint8))
        dev = torch.device(device) if device is not None else torch.device("cpu")
        return self.transform_words_device(d.to(dev)).cpu().numpy().astype(np.int64)

    def transform_words_plain(self, descs: torch.Tensor) -> torch.Tensor:
        """Plain version of ``transform_words_device``."""
        desc_t, id_t, meta = self.device_tables(descs.device)
        node = torch.zeros(descs.shape[0], dtype=torch.int64, device=descs.device)
        for lvl in range(self.L):
            first, rows = int(meta[lvl]), int(meta[self.L + lvl])
            row = first + torch.remainder(node, rows)
            d = _popcount_u8(desc_t[row] ^ descs[:, None, :])          # (N,k)
            best = torch.argmin(d, dim=1)                               # first minimum
            node = id_t[row, best].long()
        return node.to(torch.int32)

    def transform_words_device(self, descs: torch.Tensor) -> torch.Tensor:
        """Descend the tree for (N,32) uint8 descriptors: (N,) int32 word
        ids.  Replaces ``extractorb_tpu/place/vocab.py:transform_words_device``
        (L batched bit-plane Hamming argmins).  On CUDA tensors this
        launches K11 (one warp per descriptor, lane c scores child c by XOR
        and popcount); on the CPU it runs ``transform_words_plain``."""
        if not descs.is_cuda:
            return self.transform_words_plain(descs)
        N = descs.shape[0]
        if descs.dim() != 2 or descs.shape[1] != 32 or descs.dtype != torch.uint8:
            raise ValueError(f"vocab_words: descriptors {tuple(descs.shape)} {descs.dtype}, "
                             "expected (N, 32) uint8")
        if self.k > 32:
            raise ValueError(f"vocab_words: k={self.k} > 32 children per node")
        desc_t, id_t, meta = self.device_tables(descs.device)
        q = descs.contiguous()
        if q.data_ptr() % 16:
            q = q.clone()
        out = torch.empty(N, dtype=torch.int32, device=descs.device)
        kernels.require_cuda("vocab_words", q, desc_t, id_t, meta)
        err = kernels.lib().vocab_words_launch(q.data_ptr(), N, desc_t.data_ptr(),
                                               id_t.data_ptr(), meta.data_ptr(), self.k, self.L,
                                               out.data_ptr(), kernels.stream())
        kernels.check(err, "vocab_words")
        kernels.LAUNCHES["vocab_words"] += 1
        return out

    # ------------------------------------------------------------- BoW

    def bow_of_words(self, words: np.ndarray):
        """Sparse L1-normalised tf-idf BoW of word ids: (sorted unique word
        ids int32, weights float32), zero weights dropped."""
        ids, counts = np.unique(np.asarray(words), return_counts=True)
        w = counts.astype(np.float32) * self.weights[ids].astype(np.float32)
        n = w.sum()
        if n > 0:
            w /= n
        keep = w > 0
        return ids[keep].astype(np.int32), w[keep]

    def bow_sparse(self, descs: np.ndarray, valid=None, device=None):
        """Sparse L1-normalised tf-idf BoW of the valid descriptors."""
        words = self.transform_words(descs, device)
        if valid is not None:
            words = words[np.asarray(valid)]
        return self.bow_of_words(words)

    def bow_vector(self, descs: np.ndarray, valid=None, device=None) -> np.ndarray:
        """Dense L1-normalised tf-idf histogram (n_words,) float32."""
        words = self.transform_words(descs, device)
        if valid is not None:
            words = words[np.asarray(valid)]
        hist = np.bincount(words, minlength=self.n_words).astype(np.float32)
        hist *= self.weights.astype(np.float32)
        n = hist.sum()
        return hist / n if n > 0 else hist

    # ------------------------------------------------------------ save/load

    def save(self, path: str):
        np.savez_compressed(
            path, k=self.k, L=self.L, weights=self.weights,
            **{f"desc{l}": d for l, d in enumerate(self.children_desc)},
            **{f"id{l}": i for l, i in enumerate(self.children_id)},
        )

    @staticmethod
    def load(path: str) -> "Vocabulary":
        z = np.load(path)
        k, L = int(z["k"]), int(z["L"])
        return Vocabulary(k, L, [z[f"desc{l}"] for l in range(L)],
                          [z[f"id{l}"] for l in range(L)], z["weights"])


def load_orbvoc_text(path: str) -> Vocabulary:
    """Parse the DBoW2 text format (ORBvoc.txt): a header 'k L scoring
    weighting', then one node per line in node-id order from id 1 (the
    root, id 0, is implicit): 'parent_id is_leaf d0..d31 weight'.  Words
    above the last level descend through passthrough rows whose children
    all repeat the word's descriptor."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, is_leaf, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            is_leaf.append(int(parts[1]) != 0)
            descs.append([int(v) for v in parts[2:34]])
            weights.append(float(parts[34]))
    descs = np.asarray(descs, np.uint8)
    weights_arr = np.asarray(weights)

    children = {}
    for i, p in enumerate(parents):
        children.setdefault(p, []).append(i + 1)

    def leaf(nid):
        return is_leaf[nid - 1] or not children.get(nid)

    levels_desc, levels_id = [], []
    current = [("node", 0)]
    word_count = 0
    word_of = {}
    for lvl in range(L):
        nd = np.zeros((len(current), k, 32), np.uint8)
        nid = np.full((len(current), k), -1, np.int64)
        nxt = []
        for row, entry in enumerate(current):
            if entry[0] == "word":
                _, wnid, wid = entry
                nd[row, :] = descs[wnid - 1]
                if lvl == L - 1:
                    nid[row, :] = wid
                else:
                    nid[row, :] = len(nxt)
                    nxt.append(entry)
                continue
            ch = children.get(entry[1], [])
            for c, cid in enumerate(ch[:k]):
                nd[row, c] = descs[cid - 1]
                if leaf(cid):
                    wid = word_of.get(cid)
                    if wid is None:
                        wid = word_count
                        word_of[cid] = wid
                        word_count += 1
                    if lvl == L - 1:
                        nid[row, c] = wid
                    else:
                        nid[row, c] = len(nxt)
                        nxt.append(("word", cid, wid))
                else:
                    nid[row, c] = len(nxt)
                    nxt.append(("node", cid))
            for c in range(len(ch), k):
                if ch:
                    nd[row, c] = descs[ch[0] - 1]
                    nid[row, c] = nid[row, 0]
        levels_desc.append(nd)
        levels_id.append(nid)
        current = nxt

    w = np.zeros(word_count)
    for cid, wid in word_of.items():
        w[wid] = weights_arr[cid - 1]
    return Vocabulary(k, L, levels_desc, levels_id, w)


def save_orbvoc_text(voc: Vocabulary, path: str):
    """Write a Vocabulary in the DBoW2 text format (breadth-first node ids,
    padded duplicate child slots skipped)."""
    lines = []
    next_id = 1
    queue = [(0, 0, 0)]
    while queue:
        lvl, row, parent = queue.pop(0)
        nd = voc.children_desc[lvl][row]
        nid = voc.children_id[lvl][row]
        for c in range(voc.k):
            if nid[c] < 0 or (c > 0 and nid[c] == nid[0]):
                continue
            my_id = next_id
            next_id += 1
            d = " ".join(str(int(v)) for v in nd[c])
            if lvl == voc.L - 1:
                lines.append(f"{parent} 1 {d} {float(voc.weights[int(nid[c])])!r}")
            else:
                lines.append(f"{parent} 0 {d} 0.0")
                queue.append((lvl + 1, int(nid[c]), my_id))
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.L}  0 0\n")
        f.write("\n".join(lines) + "\n")

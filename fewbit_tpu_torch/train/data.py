"""Batch sources, as ``fewbit_tpu/train/data.py``: ``synthetic_glue`` and
``synthetic_lm``; a pre-tokenized npz and epochs over it; real English text
from the image (``/usr/share/common-licenses``) as a byte-level LM corpus,
a sentence-pair task and a document-classification task; and a token
archive through the host stream codec; and a tokenized GLUE split
(``load_glue``, through HF ``datasets`` and a tokenizer, both from their
local caches).

numpy only, with the same draws in the same order, so that one seed gives
the JAX package and the port the same batches.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ("synthetic_glue", "synthetic_lm", "load_tokenized_npz",
           "batches_from_arrays", "real_text_corpus", "real_text_documents",
           "byte_lm_arrays", "byte_lm_batches", "real_pair_arrays",
           "real_doc_arrays", "save_token_archive", "load_token_archive",
           "load_glue")


def synthetic_glue(batch_size: int,
                   seq_len: int = 128,
                   vocab_size: int = 50265,
                   pad_token_id: int = 1,
                   num_labels: int = 2,
                   seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless MRPC-shaped batches with learnable labels (a parity of a few
    token buckets)."""
    rng = np.random.RandomState(seed)
    while True:
        lengths = rng.randint(seq_len // 2, seq_len + 1, size=batch_size)
        ids = rng.randint(10, vocab_size, size=(batch_size, seq_len))
        mask = np.zeros((batch_size, seq_len), np.int32)
        for i, n in enumerate(lengths):
            mask[i, :n] = 1
            ids[i, n:] = pad_token_id
        ids[:, 0] = 0  # <s>
        signal = (ids[:, 1:8].sum(axis=1) // 7) % num_labels
        yield {"input_ids": ids.astype(np.int32),
               "attention_mask": mask,
               "labels": signal.astype(np.int32)}


def synthetic_lm(batch_size: int,
                 seq_len: int = 128,
                 vocab_size: int = 50257,
                 seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless causal-LM batches with learnable structure (each token is a
    noisy function of its predecessor), labels pre-shifted for
    :func:`fewbit_tpu_torch.train.causal_lm_loss` (-100 = ignored)."""
    rng = np.random.RandomState(seed)
    while True:
        ids = np.empty((batch_size, seq_len), np.int64)
        ids[:, 0] = rng.randint(0, vocab_size, size=batch_size)
        for t in range(1, seq_len):
            follow = (ids[:, t - 1] * 31 + 7) % vocab_size
            noise = rng.randint(0, vocab_size, size=batch_size)
            take = rng.rand(batch_size) < 0.75
            ids[:, t] = np.where(take, follow, noise)
        labels = np.full_like(ids, -100)
        labels[:, :-1] = ids[:, 1:]
        yield {"input_ids": ids.astype(np.int32),
               "attention_mask": np.ones_like(ids, np.int32),
               "labels": labels.astype(np.int32)}


def load_tokenized_npz(path) -> Dict[str, Dict[str, np.ndarray]]:
    """Load a pre-tokenized classification dataset from one ``.npz`` file.

    Schema (produced by ``tools/prepare_mrpc.py`` in an environment with
    network access — this build environment has none):

    * ``{split}_input_ids``       int32 ``(n, seq)``
    * ``{split}_attention_mask``  int32 ``(n, seq)``
    * ``{split}_labels``          int32 ``(n,)``

    for ``split`` in ``train`` / ``validation``.  Returns
    ``{split: {"input_ids": ..., "attention_mask": ..., "labels": ...}}``.
    """
    archive = np.load(path)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key in archive.files:
        split, _, field = key.partition("_")
        out.setdefault(split, {})[field] = archive[key]
    for split, fields in out.items():
        missing = {"input", "attention", "labels"} - {
            f.split("_")[0] for f in fields}
        if missing:
            raise ValueError(f"split {split!r} missing fields: {missing}")
    return out


def batches_from_arrays(arrays: Dict[str, np.ndarray], batch_size: int,
                        seed: int = 0,
                        drop_remainder: bool = True
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless shuffled epochs over an in-memory dataset dict."""
    n = len(arrays["labels"])
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(n)
        stop = n - batch_size + 1 if drop_remainder else n
        for start in range(0, stop, batch_size):
            idx = order[start:start + batch_size]
            yield {k: v[idx] for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# Real-text language modelling (no-egress real data).
#
# GLUE is not in the repository, so the real-data experiments use
# byte-level language modelling over genuine English prose that ships with
# the OS image (the common-licenses corpus: GPL/LGPL/GFDL/MPL texts, ~200 KB
# of natural language).  Labels are the actual next bytes, nothing
# synthetic.
# ---------------------------------------------------------------------------

_CORPUS_DIRS = ("/usr/share/common-licenses",)


def real_text_documents(dirs=_CORPUS_DIRS, max_bytes: int = 4 << 20):
    """Per-file real English documents from the image; deterministic order."""
    import os

    docs = []
    total = 0
    for d in dirs:
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            p = os.path.join(d, name)
            if os.path.islink(p) or not os.path.isfile(p):
                continue
            with open(p, "rb") as fh:
                data = fh.read()
            docs.append(data)
            total += len(data)
            if total >= max_bytes:
                break
    if not docs:
        raise FileNotFoundError(f"no corpus text found under {dirs}")
    return docs


def real_text_corpus(dirs=_CORPUS_DIRS, max_bytes: int = 4 << 20) -> bytes:
    """Concatenated real English text from the image; deterministic order."""
    return b"\n\n".join(real_text_documents(dirs, max_bytes))[:max_bytes]


def byte_lm_arrays(text: bytes, seq_len: int = 128,
                   val_fraction: float = 0.1, seed: int = 0):
    """Chop a byte corpus into shuffled (train, val) example matrices.

    Returns ``(train_ids, val_ids)`` of shape ``(n, seq_len + 1)`` uint8 —
    position ``t+1`` is the label for position ``t``.
    """
    arr = np.frombuffer(text, dtype=np.uint8)
    n = (len(arr) - 1) // seq_len
    ids = np.stack([arr[i * seq_len:i * seq_len + seq_len + 1]
                    for i in range(n)])
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    n_val = max(int(n * val_fraction), 1)
    return ids[order[n_val:]], ids[order[:n_val]]


def byte_lm_batches(ids: np.ndarray, batch_size: int,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless shuffled LM batches from a ``byte_lm_arrays`` matrix, labels
    pre-shifted for :func:`fewbit_tpu_torch.train.causal_lm_loss`."""
    rng = np.random.RandomState(seed)
    n = len(ids)
    while True:
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            chunk = ids[order[start:start + batch_size]]
            tokens = chunk[:, :-1].astype(np.int32)
            labels = chunk[:, 1:].astype(np.int32)
            yield {"input_ids": tokens,
                   "attention_mask": np.ones_like(tokens),
                   "labels": labels}


def real_pair_arrays(documents=None, seq_len: int = 128,
                     val_fraction: float = 0.1, seed: int = 0,
                     min_segment: int = 20):
    """MRPC-shaped sentence-pair classification from REAL prose.

    MRPC asks whether two sentences are paraphrases; the no-egress stand-in
    with the same shape asks whether two real text segments come from the
    SAME document and are consecutive (label 1) or from two DIFFERENT
    documents (label 0) — a binary decision over genuine English text pairs
    that needs actual textual signal (shared topic/vocabulary/style of one
    license text vs another) to beat chance.

    Encoding is byte-level with RoBERTa special-token conventions:
    ``<s>=0 pad=1 </s>=2``, byte ``b`` -> token ``b + 3`` (vocab 259);
    layout ``<s> seg1 </s> </s> seg2 </s>`` truncated/padded to
    ``seq_len``.  Returns ``(train, val)`` dicts with ``input_ids`` /
    ``attention_mask`` / ``labels``.

    Split hygiene: the train/val split is by contiguous SEGMENT RANGE
    within each document — the tail ``val_fraction`` of every document's
    segments (and the pairs/negatives built from them) forms the val set,
    so no text segment appears on both sides (an earlier by-pair split
    leaked segments shared between neighbouring/negative pairs into val,
    overstating generalization).  Only the single range-boundary pair per
    document is dropped.
    """
    import re

    if documents is None:
        documents = real_text_documents()
    doc_parts = []
    for doc in documents:
        parts = [p.strip() for p in re.split(rb"(?<=[.!?:;])\s+|\n\n+",
                                             doc)]
        parts = [p for p in parts if len(p) >= min_segment]
        if len(parts) >= 2:
            doc_parts.append(parts)
    if len(doc_parts) < 2:
        raise ValueError("need at least two documents for the pair task")
    rng = np.random.RandomState(seed)
    half = (seq_len - 4) // 2

    def encode(s1: bytes, s2: bytes):
        toks = ([0] + [b + 3 for b in s1[:half]] + [2, 2]
                + [b + 3 for b in s2[:half]] + [2])
        toks = toks[:seq_len]
        mask = [1] * len(toks) + [0] * (seq_len - len(toks))
        toks = toks + [1] * (seq_len - len(toks))
        return toks, mask

    # Per-document boundary: segments [0, cut) are train-side, [cut, n)
    # val-side.  Documents with >= 4 segments contribute at least one val
    # PAIR (two tail segments) and at least one train pair; a 3-segment
    # document keeps its single train pair and contributes one val segment
    # (usable only as a negative partner); 2-segment documents contribute
    # one train pair.  A corpus where a whole split still ends up empty
    # (e.g. every document has < 4 segments for val) raises below.
    def _cut(n_seg: int) -> int:
        hi = n_seg - 2 if n_seg >= 4 else n_seg - 1
        return max(min(int(n_seg * (1.0 - val_fraction)), hi), 1)

    cuts = [_cut(len(p)) for p in doc_parts]

    def build(side: str):
        ids, masks, labels = [], [], []
        for d, parts in enumerate(doc_parts):
            lo, hi = (0, cuts[d]) if side == "train" else (cuts[d],
                                                           len(parts))
            for i in range(lo, hi - 1):
                ids_m, mask_m = encode(parts[i], parts[i + 1])
                ids.append(ids_m)
                masks.append(mask_m)
                labels.append(1)
                # Negative: second segment from a different document,
                # drawn from the SAME side's range so val text never
                # reaches a train negative (and vice versa).
                d2 = rng.randint(0, len(doc_parts) - 1)
                if d2 >= d:
                    d2 += 1
                # Both side ranges are non-empty for every retained
                # document (_cut clamps to 1 <= cut <= n-1 and doc_parts
                # keeps only >= 2 segments), so positives and negatives
                # stay exactly balanced.
                o_lo, o_hi = ((0, cuts[d2]) if side == "train"
                              else (cuts[d2], len(doc_parts[d2])))
                other = doc_parts[d2][rng.randint(o_lo, o_hi)]
                ids_m, mask_m = encode(parts[i], other)
                ids.append(ids_m)
                masks.append(mask_m)
                labels.append(0)
        if not labels:
            raise ValueError(
                f"the {side} split came out empty — no document has enough "
                f"segments (>= {4 if side == 'val' else 2} after the "
                "min_segment filter) to contribute a pair to it; provide "
                "longer documents or a smaller min_segment ONLY if the "
                "documents contain shorter sentences to recover")
        order = rng.permutation(len(labels))
        return {"input_ids": np.asarray(ids, np.int32)[order],
                "attention_mask": np.asarray(masks, np.int32)[order],
                "labels": np.asarray(labels, np.int32)[order]}

    return build("train"), build("val")


def real_doc_arrays(documents=None, seq_len: int = 128,
                    val_fraction: float = 0.1, seed: int = 0,
                    min_segment: int = 64):
    """Real-prose single-segment document classification.

    Each example is one genuine text segment; the label is which document
    (license text) it came from — byte-level topic/style classification
    over real English, the classification-head analog that a small
    from-scratch model demonstrably learns (unlike the relational
    :func:`real_pair_arrays` task, which needs a pretrained encoder).
    Same byte encoding as the pair task (``<s>=0 pad=1 </s>=2``,
    byte ``b`` -> ``b + 3``).  Returns ``(train, val, num_classes)``.
    """
    import re

    if documents is None:
        documents = real_text_documents()
    ids_l, labels = [], []
    for d, doc in enumerate(documents):
        parts = [p.strip() for p in re.split(rb"(?<=[.!?:;])\s+|\n\n+",
                                             doc)]
        for p in parts:
            if len(p) < min_segment:
                continue
            toks = [0] + [b + 3 for b in p[:seq_len - 2]] + [2]
            pad = seq_len - len(toks)
            ids_l.append(toks + [1] * pad)
            labels.append(d)
    ids = np.asarray(ids_l, np.int32)
    labels = np.asarray(labels, np.int32)
    if len(labels) < 16:
        raise ValueError("corpus too small for the doc-classification task")
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(labels))
    n_val = max(int(len(labels) * val_fraction), 2)
    val_idx, train_idx = order[:n_val], order[n_val:]

    def take(idx):
        sub = ids[idx]
        return {"input_ids": sub,
                "attention_mask": (sub != 1).astype(np.int32),
                "labels": labels[idx]}

    return take(train_idx), take(val_idx), int(labels.max()) + 1


def save_token_archive(path, splits: Dict[str, Dict[str, np.ndarray]]
                       ) -> None:
    """Persist a tokenized dataset with the native stream codec.

    Token ids are small non-negative ints (vocab < 2^17 for RoBERTa, < 2^9
    for the byte-level tasks), so each field is stream-packed at
    ``ceil(log2(max + 1))`` bits per element by the threaded host codec
    (:func:`fewbit_tpu_torch.native.stream_pack`) before the npz's deflate
    pass.  Layout per
    field: ``{split}.{field}.stream`` (uint8), ``.shape``, ``.width``.
    Signed fields (e.g. -100 LM label masks) are offset by their minimum,
    stored in ``.offset``.
    """
    from fewbit_tpu_torch import native

    payload = {}
    for split, fields in splits.items():
        # "." is the key separator ({split}.{field}.{suffix}) — a dotted
        # split name would silently re-group on load as a different split.
        if "." in split:
            raise ValueError(f"split name {split!r} must not contain '.'")
        for field, arr in fields.items():
            if "." in field:
                raise ValueError(
                    f"field name {field!r} (split {split!r}) must not "
                    f"contain '.'")
            arr = np.asarray(arr)
            if not np.issubdtype(arr.dtype, np.integer):
                raise TypeError(f"{split}.{field} is not integer-typed")
            offset = int(arr.min()) if arr.size else 0
            offset = min(offset, 0)
            shifted64 = arr.astype(np.int64) - offset
            # Loads come back as int32; anything past 2^31-1 after the
            # min-offset shift would wrap silently (and past 2^32 would
            # already wrap in the uint32 cast below) — refuse instead.
            span = int(shifted64.max()) if arr.size else 0
            if span >= 2 ** 31:
                raise ValueError(
                    f"{split}.{field}: value range [{offset}, "
                    f"{offset + span}] spans {span + 1} after the min "
                    f"offset shift, which does not fit the int32 the "
                    f"archive reloads as")
            shifted = shifted64.astype(np.uint32)
            width = max(int(shifted.max()).bit_length(), 1) if arr.size else 1
            key = f"{split}.{field}"
            payload[f"{key}.stream"] = native.stream_pack(
                shifted.reshape(-1), width)
            payload[f"{key}.shape"] = np.asarray(arr.shape)
            payload[f"{key}.width"] = np.asarray(width)
            payload[f"{key}.offset"] = np.asarray(offset)
    np.savez_compressed(path, **payload)


def load_token_archive(path) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of :func:`save_token_archive`; returns int32 arrays."""
    from fewbit_tpu_torch import native

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as npz:
        keys = {k.rsplit(".", 1)[0] for k in npz.files}
        for key in sorted(keys):
            split, field = key.split(".", 1)
            shape = tuple(int(x) for x in npz[f"{key}.shape"])
            n = int(np.prod(shape)) if shape else 1
            codes = native.stream_unpack(npz[f"{key}.stream"], n,
                                         int(npz[f"{key}.width"]))
            arr = (codes.astype(np.int64)
                   + int(npz[f"{key}.offset"])).astype(np.int32)
            out.setdefault(split, {})[field] = arr.reshape(shape)
    return out


def load_glue(task: str = "mrpc", split: str = "train",
              tokenizer_name: str = "roberta-base",
              max_length: int = 128,
              cache_dir: Optional[str] = None):
    """A tokenized GLUE split through HF ``datasets`` and ``transformers``,
    imported here: both need their local caches (nothing is downloaded
    where there is no network).  Sentence pairs padded to
    ``max_length``."""
    import datasets
    from transformers import AutoTokenizer

    ds = datasets.load_dataset("glue", task, split=split,
                               cache_dir=cache_dir)
    tok = AutoTokenizer.from_pretrained(tokenizer_name)
    keys = {"mrpc": ("sentence1", "sentence2")}[task]

    def encode(ex):
        return tok(ex[keys[0]], ex[keys[1]], truncation=True,
                   padding="max_length", max_length=max_length)

    return ds.map(encode, batched=True)

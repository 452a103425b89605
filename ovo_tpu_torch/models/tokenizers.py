"""Text tokenizers (the port's own copy of ``ovo_tpu/models/tokenizers.py``,
pure Python + numpy: the port imports nothing of the JAX package).

- CLIPBPETokenizer: standalone byte-pair-encoding tokenizer implementing the
  CLIP scheme (lowercase + whitespace cleanup, byte-level unicode mapping,
  merge ranks from ``bpe_simple_vocab_16e6.txt.gz``). Used when the vocab
  file ships with the checkpoints (the reference gets this via open_clip /
  PE transforms, clip_utils.py:81,110).
- SentencePieceTokenizer: standalone SentencePiece **unigram** encoder for
  the SigLIP (32k) and SigLIP2/Gemma (256k) text towers: parses the binary
  ``*.model`` ModelProto directly (minimal protobuf wire reader, no
  sentencepiece dependency in-image) and segments with Viterbi over piece
  log-probs, with byte-fallback pieces when the model defines them. The
  reference reaches these tokenizers through open_clip
  (clip_utils.py:51-86).
- HashTokenizer: deterministic vocabulary-hash fallback so every pipeline
  stage runs without downloaded assets (tests, smoke runs). NOT semantically
  meaningful -- only structural.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
import string
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np


@functools.lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.lower()


class CLIPBPETokenizer:
    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        # \p{L}/\p{N} classes need the regex module; the stdlib-compatible
        # ASCII classes below are equivalent for English class names/queries
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in re.findall(self.pat, _clean(text)):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: self.context_length - 2] \
                + [self.eot]
            out[i, :len(ids)] = ids
        return out


# ---------------------------------------------------------------------------
# SentencePiece (unigram) -- self-contained .model reader + Viterbi encoder
# ---------------------------------------------------------------------------

def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    val, shift = 0, 0
    while True:
        b = data[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.
    wire 0 -> varint int, wire 1 -> 8 raw bytes, wire 2 -> bytes,
    wire 5 -> 4 raw bytes."""
    i, n = 0, len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(data, i)
        elif wire == 1:
            val, i = data[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(data, i)
            val, i = data[i:i + ln], i + ln
        elif wire == 5:
            val, i = data[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def parse_sentencepiece_model(data: bytes):
    """SentencePiece ModelProto -> (pieces [(text, score, type)], trainer
    ids {unk,bos,eos,pad}). Piece types: 1 NORMAL, 2 UNKNOWN, 3 CONTROL,
    4 USER_DEFINED, 6 BYTE (sentencepiece_model.proto field numbers)."""
    pieces: List[Tuple[str, float, int]] = []
    ids: Dict[str, int] = {}
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:            # repeated SentencePiece
            text, score, ptype = "", 0.0, 1
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 1:
                    text = v2.decode("utf-8")
                elif f2 == 2:
                    score = float(np.frombuffer(v2, "<f4")[0])
                elif f2 == 3:
                    ptype = v2
            pieces.append((text, score, ptype))
        elif field == 2 and wire == 2:          # TrainerSpec
            def _i32(v):                         # negative ids (-1 = absent)
                return v - (1 << 64) if v >= (1 << 63) else v
            for f2, w2, v2 in _iter_fields(val):
                if f2 == 40:
                    ids["unk"] = _i32(v2)
                elif f2 == 41:
                    ids["bos"] = _i32(v2)
                elif f2 == 42:
                    ids["eos"] = _i32(v2)
                elif f2 == 43:
                    ids["pad"] = _i32(v2)
    return pieces, ids


def _canonicalize_text(text: str) -> str:
    """open_clip's canonicalize_text (SigLipTokenizer preprocessing):
    strip punctuation, lowercase, collapse whitespace."""
    text = text.replace("_", " ")
    text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


class SentencePieceTokenizer:
    """Unigram-model SentencePiece encoder.

    style="siglip": open_clip SigLipTokenizer convention -- canonicalize
      (lowercase, strip punctuation), encode, truncate to context-1, append
      eos, pad with pad_id (T5-style: pad=0, eos=1).
    style="gemma" (SigLIP2): prepend bos, keep case/punctuation (Gemma's
      tokenizer does not lowercase), truncate, append eos, pad with pad_id.
    """

    def __init__(self, model_path: str, context_length: int = 64,
                 style: str = "siglip"):
        with open(model_path, "rb") as f:
            pieces, ids = parse_sentencepiece_model(f.read())
        self.context_length = context_length
        self.style = style
        self.vocab_size = len(pieces)
        self._piece_id = {p: i for i, (p, s, t) in enumerate(pieces)}
        # only NORMAL/USER_DEFINED pieces participate in segmentation
        self._scores = {p: s for p, s, t in pieces if t in (1, 4)}
        self._max_len = max((len(p) for p in self._scores), default=1)
        self._bytes = {p: i for i, (p, s, t) in enumerate(pieces) if t == 6}
        min_score = min((s for p, s, t in pieces if t == 1), default=0.0)
        self._unk_score = min_score - 10.0       # sentencepiece convention
        self.unk_id = ids.get("unk", 0)
        self.bos_id = ids.get("bos", -1)
        self.eos_id = ids.get("eos", 1)
        self.pad_id = ids.get("pad", 0)
        # fall back to control-piece lookup when TrainerSpec is absent
        for name, attr in (("<unk>", "unk_id"), ("<s>", "bos_id"),
                           ("</s>", "eos_id"), ("<pad>", "pad_id"),
                           ("<bos>", "bos_id"), ("<eos>", "eos_id")):
            if name in self._piece_id and ids == {}:
                setattr(self, attr, self._piece_id[name])

    def encode(self, text: str) -> List[int]:
        """Viterbi segmentation maximizing the sum of piece log-probs
        (sentencepiece unigram). Normalization follows SentencePiece's
        default ``nmt_nfkc`` spec: NFKC, collapse duplicate internal
        whitespace, strip leading/trailing whitespace (the raw mapping
        would keep duplicate spaces as extra U+2581 pieces). Whitespace then
        becomes the U+2581 meta symbol with a leading boundary
        (``add_dummy_prefix``)."""
        text = unicodedata.normalize("NFKC", text)
        text = " ".join(text.split())
        s = "▁" + text.replace(" ", "▁")
        n = len(s)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, str]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self._max_len)
            for j in range(i + 1, hi + 1):
                sc = self._scores.get(s[i:j])
                if sc is not None and best[i] + sc > best[j]:
                    best[j] = best[i] + sc
                    back[j] = (i, s[i:j])
            # unknown single char (grouped later) so segmentation never dies
            if best[i] + self._unk_score > best[i + 1]:
                best[i + 1] = best[i] + self._unk_score
                back[i + 1] = (i, None)
        out_rev: List[int] = []
        j = n
        while j > 0:
            i, piece = back[j]
            if piece is None:                    # unknown character
                ch = s[i:j]
                enc = ch.encode("utf-8")
                if self._bytes:                  # byte-fallback pieces
                    for b in reversed(enc):
                        out_rev.append(self._bytes[f"<0x{b:02X}>"])
                else:
                    out_rev.append(self.unk_id)
            else:
                out_rev.append(self._piece_id[piece])
            j = i
        return out_rev[::-1]

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.context_length), self.pad_id,
                      np.int32)
        for i, t in enumerate(texts):
            if self.style == "siglip":
                ids = self.encode(_canonicalize_text(_clean(t)))
                ids = ids[: self.context_length - 1] + [self.eos_id]
            else:                                # gemma
                ids = self.encode(_clean(t))
                bos = [self.bos_id] if self.bos_id >= 0 else []
                ids = bos + ids[: self.context_length - 1 - len(bos)] \
                    + [self.eos_id]
            out[i, :len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic fallback: word -> stable hash id. Gives structurally
    valid token arrays with a distinct high EOT id (so CLIP argmax pooling
    selects it)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        import hashlib

        ids = []
        for w in _clean(text).split(" "):
            h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: self.context_length - 2] \
                + [self.eot]
            out[i, :len(ids)] = ids
        return out


# SentencePiece model filenames looked up next to the checkpoints (the
# reference receives these via open_clip's bundled/HF tokenizers,
# clip_utils.py:51-86; here they are user-provided files)
_SP_NAMES = ("sentencepiece.model", "spiece.model", "tokenizer.model")


def get_tokenizer(ckpt_dir: str | None = None, context_length: int = 77,
                  card=None):
    """Tokenizer for a model card, preferring real vocab files next to the
    checkpoints. CLIP/PE/DFN cards (49408-token BPE) take the CLIP BPE
    vocab; SigLIP (32k sentencepiece) and SigLIP2 (Gemma 256k) cards take a
    SentencePiece ``*.model``. Loud HashTokenizer fallback otherwise."""
    import sys

    siglip = bool(getattr(card, "siglip", False))
    vocab_size = getattr(getattr(card, "text", None), "vocab_size", None)
    if ckpt_dir and siglip:
        style = "gemma" if (vocab_size or 0) >= 200000 else "siglip"
        for name in _SP_NAMES:
            path = os.path.join(ckpt_dir, name)
            if not os.path.exists(path):
                continue
            tok = SentencePieceTokenizer(path, context_length, style=style)
            if vocab_size and tok.vocab_size != vocab_size:
                sys.stderr.write(
                    f"WARNING: {path} has {tok.vocab_size} pieces but the "
                    f"{getattr(card, 'name', '?')} text tower expects "
                    f"{vocab_size}; wrong tokenizer file?\n")
            return tok
    elif ckpt_dir:
        for name in ("bpe_simple_vocab_16e6.txt.gz",
                     "bpe_simple_vocab_16e6.txt"):
            path = os.path.join(ckpt_dir, name)
            if os.path.exists(path):
                return CLIPBPETokenizer(path, context_length)
    if ckpt_dir:
        # LOUD: real weights + hash tokens produce structurally plausible
        # but semantically garbage text embeddings -- silent fallback would
        # poison query results (mirrors the weight-fallback warnings)
        want = (" / ".join(_SP_NAMES) if siglip
                else "bpe_simple_vocab_16e6.txt[.gz]")
        sys.stderr.write(
            "=" * 70 + "\n"
            f"WARNING: no tokenizer vocab ({want}) in {ckpt_dir}.\n"
            "Falling back to HashTokenizer: text embeddings will be GARBAGE\n"
            "with real model weights. Place the vocab next to the\n"
            "checkpoints for meaningful text queries.\n" + "=" * 70 + "\n")
    else:
        sys.stderr.write("[tokenizer] no ckpt_dir: using HashTokenizer "
                         "(fine for random-weight runs only)\n")
    return HashTokenizer(vocab_size=vocab_size or 49408,
                         context_length=context_length)

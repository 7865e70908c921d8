"""CLIP byte-pair-encoding tokenizer (host-side; a copy of
`mudg_tpu/conditioning/tokenizer.py`, which imports no JAX).

Implements the open_clip SimpleTokenizer algorithm used by the reference
(`lvdm/modules/encoders/condition.py:210`: `open_clip.tokenize`, 77-token
context): byte-to-unicode mapping, lowercasing + whitespace cleaning, BPE
merges with the '</w>' end-of-word marker, <start>/<end> special tokens,
zero-padded fixed-length output.

The merge table (bpe_simple_vocab_16e6.txt.gz) is not vendored; pass its path
(or an HF vocab.json/merges.txt pair) to `ClipTokenizer`. For environments
without the vocab file, `HashTokenizer` provides a deterministic stand-in with
the same interface (tests; NOT checkpoint-compatible).

open_clip additionally runs ftfy before whitespace cleaning; the ftfy package
is not available here, so `_fix_mojibake` implements its core heuristic (undo
UTF-8-read-as-cp1252/latin-1, the dominant mojibake class). Plain-ASCII text
(all Waymo captions) passes through untouched either way.
"""
from __future__ import annotations

import gzip
import html
import json
import os
from functools import lru_cache

import numpy as np

try:
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover
    import re as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        _re.IGNORECASE,
    )

CONTEXT_LENGTH = 77
SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"


@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _fix_mojibake(text: str) -> str:
    """Minimal ftfy.fix_text stand-in: iteratively undo UTF-8 bytes that were
    mis-decoded as cp1252/latin-1 ('Ã©' -> 'é', 'â€™' -> '’'). Correctly
    encoded text round-trips to invalid UTF-8 and is returned unchanged;
    pure-ASCII input short-circuits.

    Known divergence from ftfy: there is no plausibility ("badness")
    heuristic, so a rare caption that GENUINELY contains sequences like
    'Ã©' (which also happen to re-encode to valid UTF-8) is rewritten where
    ftfy would leave it alone. Harmless for the ASCII Waymo captions this
    pipeline feeds; callers with adversarial non-ASCII text should pre-clean
    with real ftfy."""
    for _ in range(3):  # ftfy also bounds repeated-mojibake unwinding
        if text.isascii():
            return text
        fixed = None
        for enc in ("cp1252", "latin-1"):
            try:
                fixed = text.encode(enc).decode("utf-8")
                break
            except (UnicodeEncodeError, UnicodeDecodeError):
                continue
        if fixed is None or fixed == text:
            return text
        text = fixed
    return text


def _clean(text: str) -> str:
    text = _fix_mojibake(text)
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip().lower()


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ClipTokenizer:
    """BPE tokenizer matching open_clip.tokenize given the same merge table."""

    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        merges = self._load_merges(bpe_path)
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend([SOT_TEXT, EOT_TEXT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self.sot = self.encoder[SOT_TEXT]
        self.eot = self.encoder[EOT_TEXT]
        self.vocab_size = len(vocab)

    @staticmethod
    def _load_merges(path):
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # open_clip format: merges on lines 1..49152-256-2+1
            lines = lines[1 : 49152 - 256 - 2 + 1]
        elif path.endswith("merges.txt"):
            with open(path, encoding="utf-8") as f:
                lines = [l for l in f.read().split("\n") if l and not l.startswith("#")]
        else:
            raise ValueError(f"unrecognized BPE file {path}")
        return [tuple(l.split()) for l in lines if l]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for tok in _PAT.findall(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Tokenize to a (B, 77) int32 array, like open_clip.tokenize."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in when no BPE table is available (tests only)."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, t in enumerate(texts):
            words = _clean(t).split()
            ids = [self.sot] + [
                (hash(w) % (self.vocab_size - 3)) + 1 for w in words
            ][: context_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


def _hf_cache_merges() -> list[str]:
    """merges.txt from any locally cached HF CLIP tokenizer (the OpenCLIP
    ViT-H checkpoints ship the same 16e6 merge table)."""
    found: list[str] = []
    try:
        from huggingface_hub import snapshot_download

        for repo in (
            "laion/CLIP-ViT-H-14-laion2B-s32B-b79K",
            "openai/clip-vit-large-patch14",
            "openai/clip-vit-base-patch32",
        ):
            try:
                d = snapshot_download(repo, local_files_only=True,
                                      allow_patterns=["merges.txt"])
                p = os.path.join(d, "merges.txt")
                if os.path.exists(p):
                    found.append(p)
            except Exception:
                continue
    except Exception:
        pass
    return found


def default_tokenizer(bpe_path: str | None = None, *, require_real: bool = False):
    """ClipTokenizer if a merge table is available (arg, env var, packaged
    file, or a locally cached HF CLIP repo), else HashTokenizer.

    require_real=True refuses the hash fallback: real-checkpoint inference
    with hash token ids would silently condition on garbage text embeddings
    (the text tower indexes its learned vocab, condition.py:210). Override
    with MUDG_ALLOW_HASH_TOKENIZER=1 for smoke runs.
    """
    candidates = [
        bpe_path,
        os.environ.get("MUDG_BPE_PATH"),
        os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz"),
    ]
    candidates += _hf_cache_merges()
    for c in candidates:
        if c and os.path.exists(c):
            return ClipTokenizer(c)
    if require_real and os.environ.get("MUDG_ALLOW_HASH_TOKENIZER") != "1":
        raise FileNotFoundError(
            "No CLIP BPE merge table found. Checkpoint-compatible text "
            "conditioning needs the open_clip bpe_simple_vocab_16e6.txt.gz "
            "(or any CLIP merges.txt, e.g. from a cached HF CLIP repo). Pass "
            "--bpe/MUDG_BPE_PATH, or set MUDG_ALLOW_HASH_TOKENIZER=1 to "
            "proceed with hash tokens (NOT checkpoint-compatible)."
        )
    return HashTokenizer()

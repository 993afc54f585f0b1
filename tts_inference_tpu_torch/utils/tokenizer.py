"""Tokenizer abstraction: the checkpoint's own tokenizer when a checkpoint dir
is available, byte-level fallback when not (tests/bench run with zero
downloadable assets).

The reference always tokenizes "voice: text" with the model's HF tokenizer
(`modal_audio_stream.py:244-269`); the envelope/special tokens are added as
raw IDs by `protocol.format_prompt_ids`, never by the tokenizer.

``HFTokenizer`` reads a ``tokenizer.json`` (and ``tokenizer_config.json``)
with the standard library alone and gives the ids of
``AutoTokenizer.encode(text, add_special_tokens=False)`` and the text of
its ``decode``: byte-level BPE (``merges`` as "a b" strings or as pairs,
``ignore_merges``), the ``ByteLevel`` pre-tokenizer with the GPT-2 pattern
or a ``Sequence`` of ``Split(<pattern>, "Isolated")`` and
``ByteLevel(use_regex=False)`` (Llama-3's, Orpheus's), added tokens split
out first (longest match, ``lstrip`` / ``rstrip`` / ``single_word`` /
``normalized``), the ``ByteLevel`` decoder and
``clean_up_tokenization_spaces``. Anything else in the file raises
``NotImplementedError`` rather than tokenizing differently.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Protocol, Sequence, Tuple


class TokenizerProtocol(Protocol):
    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: List[int]) -> str: ...


class ByteTokenizer:
    """Reversible byte-level tokenizer: id = byte + offset.

    Stands in for the Llama tokenizer when no checkpoint assets exist; keeps
    every id far below the special-token range so protocol invariants hold.
    """

    def __init__(self, offset: int = 256):
        self.offset = offset

    def encode(self, text: str) -> List[int]:
        return [b + self.offset for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        return bytes(
            max(0, min(255, i - self.offset)) for i in ids
        ).decode("utf-8", errors="replace")


# -- character classes the patterns need and Python's `re` lacks -------------

_CLASSES: Dict[str, str] = {}


def _classes() -> Dict[str, str]:
    """Character-class bodies (escaped ranges, no brackets) of \\p{L},
    \\p{N} and Unicode White_Space (the \\s of the Rust regex engines;
    Python's \\s also takes U+001C-U+001F), built once from unicodedata:
    runs of one general category, merged by class."""
    if not _CLASSES:
        ranges: Dict[str, List[List[int]]] = {"L": [], "N": [], "s": []}

        def add(key, a, b):
            r = ranges[key]
            if r and r[-1][1] == a - 1:
                r[-1][1] = b
            else:
                r.append([a, b])

        cp = 0
        cats = map(unicodedata.category, map(chr, range(sys.maxunicode + 1)))
        for cat, run in itertools.groupby(cats):
            n = sum(1 for _ in run)
            if cat[0] in "LN":
                add(cat[0], cp, cp + n - 1)
            elif cat in ("Zs", "Zl", "Zp"):
                add("s", cp, cp + n - 1)
            cp += n
        for c in (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x85):
            ranges["s"].append([c, c])
        for key, rs in ranges.items():
            _CLASSES[key] = "".join(
                f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                for a, b in sorted(rs))
    return _CLASSES


def translate_pattern(pat: str) -> str:
    """A tokenizers (Oniguruma) pattern → a Python `re` pattern: \\p{L},
    \\p{N}, \\P{..}, \\s and \\S become explicit classes. Other Unicode
    properties and \\w raise NotImplementedError."""
    cls = _classes()
    out: List[str] = []
    i, in_class = 0, False
    while i < len(pat):
        c = pat[i]
        if c == "\\" and i + 1 < len(pat):
            nxt = pat[i + 1]
            if nxt in "pP" and pat[i + 2:i + 3] == "{":
                j = pat.index("}", i)
                name = pat[i + 3:j]
                if name not in ("L", "N"):
                    raise NotImplementedError(f"\\{nxt}{{{name}}} in {pat!r}")
                neg = nxt == "P"
                if in_class and neg:
                    raise NotImplementedError(f"\\P in a class in {pat!r}")
                out.append(cls[name] if in_class
                           else f"[{'^' if neg else ''}{cls[name]}]")
                i = j + 1
                continue
            if nxt in "sS":
                if in_class and nxt == "S":
                    raise NotImplementedError(f"\\S in a class in {pat!r}")
                out.append(cls["s"] if in_class else
                           f"[{'^' if nxt == 'S' else ''}{cls['s']}]")
                i += 2
                continue
            if nxt in "wWbB":
                raise NotImplementedError(f"\\{nxt} in {pat!r}")
            out.append(pat[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            i += 1
            if pat[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pat[i:i + 1] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "]" and in_class:
            in_class = False
        elif c == "[" and in_class:
            out.append("\\[")
            i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


# the ByteLevel pre-tokenizer's own pattern (GPT-2)
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte → printable character table (the ByteLevel alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_CHAR = bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}


def _isolate(pieces: List[str], rx: "re.Pattern") -> List[str]:
    """Split each piece at `rx`'s matches, keeping the matches and the text
    between them as pieces of their own ("Isolated")."""
    out = []
    for p in pieces:
        pos = 0
        for m in rx.finditer(p):
            if m.start() > pos:
                out.append(p[pos:m.start()])
            if m.end() > m.start():
                out.append(m.group())
            pos = m.end()
        if pos < len(p):
            out.append(p[pos:])
    return out


class _PreTokenizer:
    """Splits a text into pre-tokens and maps each to the byte alphabet."""

    def __init__(self, spec: Optional[dict]):
        self.steps: List[Tuple[str, object]] = []
        self._add(spec)
        if not self.steps or self.steps[-1][0] != "bytes":
            raise NotImplementedError(
                "only byte-level pre-tokenizers are read (the last step must "
                f"be ByteLevel): {spec}")

    def _add(self, spec: Optional[dict]) -> None:
        kind = (spec or {}).get("type")
        if kind == "Sequence":
            for sub in spec["pretokenizers"]:
                self._add(sub)
        elif kind == "ByteLevel":
            rx = (re.compile(translate_pattern(GPT2_PATTERN))
                  if spec.get("use_regex", True) else None)
            self.steps.append(("bytes", (bool(spec.get("add_prefix_space")),
                                         rx)))
        elif kind == "Split":
            if spec.get("behavior") != "Isolated" or spec.get("invert"):
                raise NotImplementedError(f"Split {spec}")
            pat = spec["pattern"]
            rx = (translate_pattern(pat["Regex"]) if "Regex" in pat
                  else re.escape(pat["String"]))
            self.steps.append(("split", re.compile(rx)))
        else:
            raise NotImplementedError(f"pre-tokenizer {spec}")

    def __call__(self, text: str) -> List[str]:
        pieces = [text]
        for kind, arg in self.steps:
            if kind == "split":
                pieces = _isolate(pieces, arg)
                continue
            prefix_space, rx = arg
            if prefix_space:
                pieces = [p if p.startswith(" ") else " " + p
                          for p in pieces]
            if rx is not None:
                pieces = _isolate(pieces, rx)
            pieces = ["".join(_BYTE_CHAR[b] for b in p.encode("utf-8"))
                      for p in pieces]
        return pieces


class _BPE:
    """tokenizers' BPE model: merges by rank, leftmost first among equal
    ranks (``Word::merge_all``), with a per-pre-token cache."""

    CACHE = 10_000

    def __init__(self, spec: dict):
        for key in ("dropout", "unk_token", "continuing_subword_prefix",
                    "end_of_word_suffix"):
            if spec.get(key):
                raise NotImplementedError(f"BPE {key}={spec[key]!r}")
        if spec.get("byte_fallback"):
            raise NotImplementedError("BPE byte_fallback")
        self.vocab: Dict[str, int] = spec["vocab"]
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                pair = (self.vocab[a], self.vocab[b])
                self.merges[pair] = (rank, self.vocab[a + b])
            except KeyError as e:
                raise ValueError(f"merge {m!r}: {e} is not in the vocab")
        self.cache: Dict[str, List[int]] = {}

    def __call__(self, word: str) -> List[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        hit = self.cache.get(word)
        if hit is None:
            hit = self._merge(word)
            if len(self.cache) < self.CACHE:
                self.cache[word] = hit
        return hit

    def _merge(self, word: str) -> List[int]:
        syms = [self.vocab[c] for c in word if c in self.vocab]
        n = len(syms)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, i, new = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j >= n:
                continue
            m = merges.get((syms[i], syms[j]))
            if m is None or m[1] != new:
                continue      # an expired entry
            syms[i] = new
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] < n:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                m = merges.get((syms[prv[i]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if nxt[i] < n:
                m = merges.get((new, syms[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        return [s for s, a in zip(syms, alive) if a]


def _is_word_char(c: str) -> bool:
    """Rust regex's Unicode \\w: letters, marks, digits, connectors."""
    cat = unicodedata.category(c)
    return cat[0] in "LMN" and cat != "No" or cat == "Pc" \
        or c in "‌‍"


def _is_space(c: str) -> bool:
    o = ord(c)
    return 0x09 <= o <= 0x0D or o == 0x85 or \
        unicodedata.category(c) in ("Zs", "Zl", "Zp")


class _AddedTokens:
    """Added tokens matched leftmost-longest (as the Aho-Corasick automaton
    of tokenizers does) through an index of their lengths by first
    character: ~28k tokens of a few lengths cost a few dict lookups per
    candidate position."""

    def __init__(self, tokens: Sequence[dict]):
        self.by_content = {t["content"]: t for t in tokens}
        self.lengths: Dict[str, List[int]] = {}
        for c in self.by_content:
            if c:
                self.lengths.setdefault(c[0], []).append(len(c))
        for k, v in self.lengths.items():
            self.lengths[k] = sorted(set(v), reverse=True)

    def matches(self, s: str):
        i, n = 0, len(s)
        while i < n:
            for ln in self.lengths.get(s[i], ()):
                t = self.by_content.get(s[i:i + ln])
                if t is not None:
                    yield i, i + ln, t
                    i += ln
                    break
            else:
                i += 1

    def split(self, s: str) -> List[Tuple[Optional[int], str]]:
        """`s` → pieces (id of an added token or None, text), as
        ``AddedVocabulary::find_matches``."""
        if not s:
            return [(None, "")]
        out: List[Tuple[Optional[int], str]] = []
        pos = 0
        for start, stop, t in self.matches(s):
            if t.get("single_word"):
                if (start > 0 and _is_word_char(s[start - 1])) or (
                        stop < len(s) and _is_word_char(s[stop])):
                    continue
            if t.get("lstrip"):
                k = start
                while k > 0 and _is_space(s[k - 1]):
                    k -= 1
                start = max(k, pos)
            if t.get("rstrip"):
                while stop < len(s) and _is_space(s[stop]):
                    stop += 1
            if pos < start:
                out.append((None, s[pos:start]))
            out.append((t["id"], s[start:stop]))
            pos = stop
        if pos != len(s):
            out.append((None, s[pos:]))
        return out


def _clean_up_tokenization(s: str) -> str:
    """transformers' ``clean_up_tokenization``."""
    return (s.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


class HFTokenizer:
    """A checkpoint's ``tokenizer.json``, read with no library: the ids of
    ``AutoTokenizer.encode(add_special_tokens=False)`` and the text of its
    ``decode``. `path` is the directory (or the ``tokenizer.json``)."""

    def __init__(self, path: str):
        d = path if os.path.isdir(path) else os.path.dirname(path)
        fname = os.path.join(path, "tokenizer.json") if os.path.isdir(path) \
            else path
        if not os.path.exists(fname):
            raise FileNotFoundError(
                f"{fname}: the port reads tokenizer.json only (no "
                "sentencepiece or slow tokenizer)")
        with open(fname, encoding="utf-8") as f:
            spec = json.load(f)
        conf: dict = {}
        conf_path = os.path.join(d, "tokenizer_config.json")
        if os.path.exists(conf_path):
            with open(conf_path, encoding="utf-8") as f:
                conf = json.load(f)
        self.clean_up_tokenization_spaces = bool(
            conf.get("clean_up_tokenization_spaces", False))
        model = spec["model"]
        if model.get("type", "BPE") != "BPE":
            raise NotImplementedError(f"model type {model.get('type')}")
        if spec.get("normalizer") is not None:
            raise NotImplementedError(f"normalizer {spec['normalizer']}")
        dec = spec.get("decoder")
        if (dec or {}).get("type") != "ByteLevel":
            raise NotImplementedError(f"decoder {dec}")
        self.bpe = _BPE(model)
        self.pre = _PreTokenizer(spec.get("pre_tokenizer"))
        added = spec.get("added_tokens") or []
        # without a normalizer the two passes of tokenizers (tokens not
        # normalized, then normalized ones on what is left) still differ in
        # which token wins an overlap
        self.raw_added = _AddedTokens(
            [t for t in added if not t.get("normalized", True)])
        self.norm_added = _AddedTokens(
            [t for t in added if t.get("normalized", True)])
        self.added_by_id = {t["id"]: t["content"] for t in added}
        self.id_to_token = {i: t for t, i in self.bpe.vocab.items()}

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tid, piece in self.raw_added.split(text):
            if tid is not None:
                ids.append(tid)
                continue
            for tid2, sub in self.norm_added.split(piece):
                if tid2 is not None:
                    ids.append(tid2)
                elif sub:
                    for word in self.pre(sub):
                        ids.extend(self.bpe(word))
        return ids

    def _bytes_of(self, tokens: List[str]) -> str:
        out = bytearray()
        for t in tokens:
            try:
                out += bytes(_CHAR_BYTE[c] for c in t)
            except KeyError:
                out += t.encode("utf-8")
        return out.decode("utf-8", errors="replace")

    def decode(self, ids: List[int],
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        text, chunk = [], []
        for i in ids:
            if i in self.added_by_id:
                text.append(self._bytes_of(chunk))
                chunk = []
                text.append(self.added_by_id[i])
            elif i in self.id_to_token:
                chunk.append(self.id_to_token[i])
        text.append(self._bytes_of(chunk))
        out = "".join(text)
        clean = (self.clean_up_tokenization_spaces
                 if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        return _clean_up_tokenization(out) if clean else out


def load_tokenizer(path: str | None) -> TokenizerProtocol:
    if path:
        return HFTokenizer(path)
    return ByteTokenizer()

"""The port's ``HFTokenizer`` (``tts_inference_tpu_torch/utils/tokenizer.py``,
no library) against ``transformers`` / ``tokenizers`` on three files: the
repo's fixture (``tts_inference_tpu/tools/tokenizer_fixture.py``, GPT-2
pre-tokenizer), a Llama-3-style file trained here (Split on Llama-3's
pattern + ByteLevel without regex, ``ignore_merges``, added tokens special
and not, with ``lstrip`` / ``rstrip`` / ``single_word`` / ``normalized``)
and the port's own ``write_tokenizer`` output. Ids equal exactly; decoded
text equal with ``clean_up_tokenization_spaces`` on and off."""

import json
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from tts_inference_tpu_torch.utils import tokenizer as ttok  # noqa: E402

# Llama-3's (and Orpheus's) Split pattern
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")

# ASCII, Devanagari, Cyrillic, emoji, digits, CR LF, the four separators
# Python calls space and Unicode does not, NEL, NBSP, a few other spaces,
# the long s and Kelvin sign (case folding in the contractions)
ALPHABET = (
    [chr(c) for c in range(0x20, 0x7F)]
    + [chr(c) for c in range(0x900, 0x980)]
    + [chr(c) for c in range(0x400, 0x460)]
    + [chr(c) for c in range(0x1F600, 0x1F610)] + ["\U0001F44D\U0001F3FD"]
    + list("0123456789٣४") + ["\r", "\n", "\r\n", "\t"]
    + ["\x1c", "\x1d", "\x1e", "\x1f", "\x85", "\xa0", " ", "　",
       "​", "ſ", "K", "'S", "'ll", "'VE"]
)

ADDED = [
    # content, special, lstrip, rstrip, single_word, normalized
    ("<|begin_of_text|>", True, False, False, False, False),
    ("<|eot_id|>", True, False, False, False, False),
    ("<custom_token_1>", True, False, False, False, False),
    ("<custom_token_12>", True, False, False, False, False),
    ("<custom_token_123>", True, False, False, False, False),
    ("[L]", False, True, False, False, True),
    ("[R]", False, False, True, False, True),
    ("[LR]", False, True, True, False, False),
    ("word", False, False, False, True, True),
    ("<norm>", False, False, False, False, True),
    ("<norm>x", False, False, False, False, False),
    # a normalized token that starts before a raw one: tokenizers matches
    # the raw tokens first, so "@@long" is "@@" + "long"
    ("@@long", False, False, False, False, True),
    ("long", False, False, False, False, False),
]


def _texts():
    return [
        "tara: Hello there, how are you doing today?",
        "नमस्ते, आप कैसे हैं? मैं ठीक हूँ। 1234567 рублей",
        "Привет, мир! Это тест.\r\n\r\n  spaces   and\ttabs\n",
        "emoji 😀👍🏽 and numbers 3.14159, 1,000,000",
        "it's we'll THEY'RE I'M you'd she'S a'ſ",
        "x\x1cy\x1dz\x1e\x1f\x85\xa0end",
        "<|begin_of_text|>tara: hi<custom_token_12><custom_token_123>",
        "a \x1c.b x\x1c\x1c y .\x1c! a\x1c\n \x1f \x85. \xa0\xa0x",
        "say @@long word, words [L]  [R]  [LR]  <norm>x",
    ]


def _train_llama3_style(tmp_path, with_added=True) -> str:
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers

    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), "isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    trainer = tokenizers.trainers.BpeTrainer(
        vocab_size=1500, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = [t * 3 for t in _texts()] + [
        "the quick brown fox jumps over the lazy dog " * 5,
        "हिंदी में एक वाक्य और उसका अनुवाद " * 5,
        "русский текст для обучения токенизатора " * 5]
    tok.train_from_iterator(corpus, trainer)
    if with_added:
        tok.add_tokens([tokenizers.AddedToken(
            c, special=s, lstrip=ls, rstrip=rs, single_word=sw, normalized=n)
            for c, s, ls, rs, sw, n in ADDED])
    d = tmp_path / "llama3"
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "clean_up_tokenization_spaces": True}))
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from tts_inference_tpu.tools.tokenizer_fixture import write_tiny_tokenizer
    from tts_inference_tpu_torch.tools.make_checkpoint import write_tokenizer

    root = tmp_path_factory.mktemp("tok")
    out = {"fixture": write_tiny_tokenizer(str(root / "fixture")),
           "llama3": _train_llama3_style(root),
           "port": write_tokenizer(str(root / "port"))}
    return {k: (v, ttok.HFTokenizer(v),
                transformers.AutoTokenizer.from_pretrained(
                    v, local_files_only=True)) for k, v in out.items()}


KINDS = ["fixture", "llama3", "port"]


@pytest.mark.parametrize("kind", KINDS)
def test_ids_equal_on_fixed_texts(dirs, kind):
    _, port, ref = dirs[kind]
    for text in _texts() + [t + " " + t for t in _texts()] + ["", " ", "a"]:
        assert port.encode(text) == ref.encode(
            text, add_special_tokens=False), text


_pieces = hst.lists(
    hst.one_of(hst.sampled_from(ALPHABET),
               hst.sampled_from([a[0] for a in ADDED] + [" [L] ", " [R] ",
                                 "words", " word ", "<norm>x", "@@long"])),
    max_size=40)
# few characters, so that the separators meet punctuation, spaces and
# line breaks often
_dense = hst.lists(hst.sampled_from(
    ["\x1c", "\x1f", "\x85", "\xa0", " ", "  ", "\r", "\n", ".", "!",
     "'s", "a", "b", "7", "क", "ा", "😀", "[L]", "[R]"]), max_size=20)


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(pieces=_pieces, dense=_dense)
def test_ids_equal_on_generated_text(dirs, kind, pieces, dense):
    _, port, ref = dirs[kind]
    for text in ("".join(pieces), "".join(dense)):
        assert port.encode(text) == ref.encode(text,
                                               add_special_tokens=False)


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=100, deadline=None, derandomize=True, database=None)
@given(data=hst.data())
def test_decode_equal(dirs, kind, data):
    """Any ids, added tokens and partial UTF-8 sequences among them; with
    ``clean_up_tokenization_spaces`` from the config, on and off."""
    _, port, ref = dirs[kind]
    n = len(ref)
    ids = data.draw(hst.lists(hst.integers(0, n - 1), max_size=30))
    assert port.decode(ids) == ref.decode(ids)
    for clean in (True, False):
        assert port.decode(ids, clean_up_tokenization_spaces=clean) == \
            ref.decode(ids, clean_up_tokenization_spaces=clean)
    text = data.draw(hst.sampled_from(_texts()))
    toks = ref.encode(text, add_special_tokens=False)
    assert port.decode(toks) == ref.decode(toks)


def test_config_flags_and_ids(dirs):
    _, port, ref = dirs["llama3"]
    assert port.clean_up_tokenization_spaces is True
    assert dirs["fixture"][1].clean_up_tokenization_spaces is False
    spec = json.load(open(os.path.join(dirs["llama3"][0], "tokenizer.json")))
    assert spec["model"]["ignore_merges"] is True
    for c, *_ in ADDED:
        assert port.encode(c) == ref.encode(c, add_special_tokens=False)


def test_ignore_merges_takes_a_vocab_word_whole(dirs, tmp_path):
    """With ``ignore_merges`` (Llama-3's files) a pre-token that is in the
    vocab is one id even where the merges would not build it."""
    src = dirs["llama3"][0]
    spec = json.load(open(os.path.join(src, "tokenizer.json")))
    vocab = spec["model"]["vocab"]
    n = max(max(vocab.values()), max(t["id"] for t in spec["added_tokens"]))
    vocab["qzx"] = n + 1
    for flag in (True, False):
        spec["model"]["ignore_merges"] = flag
        d = tmp_path / str(flag)
        d.mkdir()
        (d / "tokenizer.json").write_text(json.dumps(spec))
        ref = tokenizers.Tokenizer.from_file(str(d / "tokenizer.json"))
        port = ttok.HFTokenizer(str(d))
        for text in ("qzx", "a qzx qzxqzx"):
            assert port.encode(text) == ref.encode(
                text, add_special_tokens=False).ids
        assert (port.encode("qzx") == [n + 1]) == flag


def test_merges_as_strings_read_the_same(dirs, tmp_path):
    """Older files list merges as "a b" strings."""
    src, port, _ = dirs["fixture"]
    spec = json.load(open(os.path.join(src, "tokenizer.json")))
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    old = ttok.HFTokenizer(str(tmp_path))
    for t in _texts():
        assert old.encode(t) == port.encode(t)


def test_many_added_tokens_load_and_match_fast(tmp_path):
    """~28k added tokens (Orpheus declares <custom_token_0..28k>): loading
    and matching stay fast, and each is one id."""
    import time

    from tts_inference_tpu_torch.tools.make_checkpoint import write_tokenizer

    d = write_tokenizer(str(tmp_path / "t"), merges=50)
    spec = json.load(open(os.path.join(d, "tokenizer.json")))
    base = len(spec["model"]["vocab"])
    spec["added_tokens"] = [
        {"id": base + i, "content": f"<custom_token_{i}>", "single_word":
         False, "lstrip": False, "rstrip": False, "normalized": False,
         "special": True} for i in range(28_682)]
    json.dump(spec, open(os.path.join(d, "tokenizer.json"), "w"))
    t0 = time.perf_counter()
    tok = ttok.HFTokenizer(d)
    ids = tok.encode("a<custom_token_28681>b<custom_token_7><custom_token_")
    elapsed = time.perf_counter() - t0
    assert ids[1] == base + 28_681 and base + 7 in ids
    assert elapsed < 5.0, elapsed


def test_unsupported_files_raise(dirs, tmp_path):
    src = dirs["fixture"][0]
    spec = json.load(open(os.path.join(src, "tokenizer.json")))
    for key, val in (("normalizer", {"type": "NFC"}),
                     ("pre_tokenizer", {"type": "Whitespace"}),
                     ("decoder", {"type": "WordPiece"})):
        bad = dict(spec, **{key: val})
        (tmp_path / "tokenizer.json").write_text(json.dumps(bad))
        with pytest.raises(NotImplementedError):
            ttok.HFTokenizer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ttok.HFTokenizer(str(tmp_path / "missing"))


def test_load_tokenizer_picks_the_file(dirs):
    assert isinstance(ttok.load_tokenizer(dirs["port"][0]), ttok.HFTokenizer)
    assert isinstance(ttok.load_tokenizer(None), ttok.ByteTokenizer)


def test_port_tokenizer_compresses(dirs):
    """The port's trained file gives far fewer ids than bytes on the
    serving prompts."""
    _, port, _ = dirs["port"]
    text = "tara: Stream 0: the quick brown fox jumps over the dog."
    assert len(port.encode(text)) * 3 < len(text.encode())
    assert port.decode(port.encode(text)) == text

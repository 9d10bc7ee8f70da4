"""The port's byte-level BPE against the JAX package's, on the CPU.

The port's pre-tokenizer runs GPT-2's pattern on the standard library's
``re`` with the character classes spelled out from committed tables;
the JAX package's runs it on the third-party ``regex``. Here the tables
are held to ``regex`` over every code point, the splits to
``regex.findall`` on the corpus, on hand-written edge cases and on
random text, and the trainer, encoder and files to the JAX tokenizer's.
Tests that need ``regex`` skip without it.
"""

import pathlib
import subprocess
import sys
import unicodedata

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from replicatinggpt_tpu import tokenizers as jtok
from replicatinggpt_tpu_torch import pretoken_tables, tokenizers as ttok

REPO = pathlib.Path(__file__).resolve().parents[1]
SLICE = 50_000       # corpus characters the trainer tests learn from
VOCAB = 400


@pytest.fixture(scope="module")
def rx():
    return pytest.importorskip("regex")


@pytest.fixture(scope="module")
def every_code_point():
    return "".join(map(chr, range(sys.maxunicode + 1)))


@pytest.fixture(scope="module")
def trained(rx, corpus_text):
    """The JAX and port tokenizers trained on the same corpus slice."""
    text = corpus_text[:SLICE]
    return (jtok.ByteBPETokenizer.train(text, VOCAB),
            ttok.ByteBPETokenizer.train(text, VOCAB))


def _ranges(engine, pattern, text):
    return [(m.start(), m.end() - 1) for m in engine.finditer(pattern, text)]


@pytest.mark.parametrize("name,cls", [("SPACE", r"\s"), ("LETTER", r"\p{L}"),
                                      ("NUMBER", r"\p{N}")])
def test_class_tables_equal_regex_on_every_code_point(rx, every_code_point,
                                                      name, cls):
    """The committed ranges are regex's class, and the ``re`` class the
    port builds from them matches exactly those code points."""
    import re
    table = [tuple(r) for r in getattr(pretoken_tables, name)]
    assert _ranges(rx, f"{cls}+", every_code_point) == table
    assert _ranges(re, f"[{ttok._class_body(table)}]+",
                   every_code_point) == table


def test_tables_differ_from_unicodedata_where_measured():
    """Why the tables exist: ``str.isspace`` counts U+001C-U+001F as
    whitespace and regex does not, and regex knows letters the
    interpreter's Unicode tables leave unassigned."""
    spaces = {cp for a, b in pretoken_tables.SPACE for cp in range(a, b + 1)}
    assert [cp for cp in range(0x20) if chr(cp).isspace()
            and cp not in spaces] == [0x1C, 0x1D, 0x1E, 0x1F]
    assert any(unicodedata.category(chr(cp)) == "Cn"
               for a, b in pretoken_tables.LETTER for cp in range(a, b + 1))


def test_pretokenize_equals_regex_on_the_corpus(rx, corpus_text):
    got = ttok.pretokenize(corpus_text)
    assert got == rx.findall(jtok._PRETOKEN_PAT, corpus_text)
    assert "".join(got) == corpus_text


def _newer_than_unicodedata(table, n):
    """``n`` code points of ``table`` that ``unicodedata`` calls
    unassigned (added to Unicode after the interpreter's tables)."""
    out = [cp for a, b in table for cp in range(a, b + 1)
           if unicodedata.category(chr(cp)) == "Cn"]
    return "".join(map(chr, out[:n]))


ADVERSARIAL = [
    "",
    "I'm don't they're we've I'll he'd it's",
    "'S 'T 'RE 'Ll 'D", "''s'''t ' 's x's 'x",
    "a  b", "a \t\n b", "end   ", "  \n\n  x", " ", "\n", "x \n",
    "a\u00a0b", "x\u00a0 y", "a \u00a0b", "\u00a0\u00a0word",
    "\u3000\u3000x\u2028y",
    "\x1c\x1d\x1e\x1fa \x1c b\x1f", "a\x1c\x1c b", "\x1f ",
    "cafe\u0301 e\u0301te\u0301 \u0915\u094d\u0937 a\u0308\u0308",
    "\u0663\u0664 \u0967\u0968 \uff11\uff12 \u00b2\u00b3 \u00bd \u216b 12a3",
    "\U0001f468\u200d\U0001f469\u200d\U0001f467 family "
    "\U0001f3f3\ufe0f\u200d\U0001f308 ok\U0001f44d\U0001f3fd!",
    "\u65e5\u672c\u8a9e\u306e\u30c6\u30ad\u30b9\u30c8\u3001\u6f22\u5b57"
    "\u3002 \u4e2d\u6587 \ud55c\uad6d\uc5b4",
    "Hello,  world!!! 123abc 'sup'  \r\n\tTabs\x0b\x0c",
    "\ud800x \udfff",
    "NEWER",   # replaced below by letters and numbers newer than unicodedata
]


@pytest.mark.parametrize("i", range(len(ADVERSARIAL)))
def test_pretokenize_equals_regex_on_edge_cases(rx, i):
    s = ADVERSARIAL[i]
    if s == "NEWER":
        letters = _newer_than_unicodedata(pretoken_tables.LETTER, 8)
        digits = _newer_than_unicodedata(pretoken_tables.NUMBER, 4)
        s = f"{letters} x{letters}{digits} {digits}!{letters[:2]}"
    assert ttok.pretokenize(s) == rx.findall(jtok._PRETOKEN_PAT, s)


_EDGES = st.sampled_from(list(" \t\n\r\u00a0\u3000\x1c\x1f'sStdlmrev1\u0663"
                              "a.!\u00e9\u0301\u200d\U0001f600\u4e2d"))


@settings(max_examples=300, deadline=None, database=None)
@given(st.text(st.one_of(_EDGES, st.characters()), max_size=60))
def test_pretokenize_equals_regex_on_random_text(s):
    regex = pytest.importorskip("regex")
    assert ttok.pretokenize(s) == regex.findall(jtok._PRETOKEN_PAT, s)


def test_trainer_merges_match_jax(trained):
    jt, tt = trained
    assert len(tt.merges) == VOCAB - 256
    assert tt.merges == jt.merges and tt.vocab == jt.vocab


def test_encode_on_the_corpus_matches_jax(trained, corpus_text):
    jt, tt = trained
    want = np.asarray(jt.encode(corpus_text), np.int32)
    got = tt.encode_np(corpus_text)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    head = corpus_text[:20_000]
    assert tt.encode(head) == jt.encode(head)
    assert tt.decode(got) == corpus_text
    s = "caf\u00e9 \U0001f600 \u4e2d"
    assert tt.decode(tt.encode(s)) == s == jt.decode(jt.encode(s))


def test_decode_refuses_ids_past_the_vocabulary_like_jax(trained):
    """A model whose vocabulary is wider than the BPE's (the GPT-2
    presets) can sample ids no token has: both tokenizers refuse them."""
    jt, tt = trained
    for tok in (jt, tt):
        with pytest.raises(KeyError):
            tok.decode([65, tok.vocab_size])


def test_files_interchange_with_jax(trained, corpus_text, tmp_path):
    jt, tt = trained
    head = corpus_text[:20_000]
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jt.save(str(jpath))
    tt.save(str(tpath))
    assert jpath.read_text() == tpath.read_text()
    loaded = ttok.get_tokenizer(f"bpe:{jpath}")
    assert loaded.encode(head) == jt.encode(head)
    assert jtok.ByteBPETokenizer.load(str(tpath)).encode(head) == \
        tt.encode(head)


def test_get_tokenizer_trains_caches_and_refuses(tmp_path, corpus_text):
    text = corpus_text[:3000]
    tok = ttok.get_tokenizer("bpe", corpus_text=text, cache_dir=str(tmp_path))
    cache = tmp_path / "bpe_1024.json"
    assert cache.exists() and tok.vocab_size <= 1024
    again = ttok.get_tokenizer("bpe", cache_dir=str(tmp_path),
                               corpus_text="unused")
    assert again.merges == tok.merges
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttok.get_tokenizer("tiktoken:gpt2")
    with pytest.raises(ValueError):
        ttok.get_tokenizer("sentencepiece")
    with pytest.raises(ValueError):
        ttok.get_tokenizer("bpe", cache_dir=str(tmp_path / "empty"))


def test_tokenizer_needs_no_regex():
    """With ``regex`` made unimportable, the port's tokenizer module
    imports, trains, encodes and decodes, and pulls in no jax."""
    code = (
        "import sys\n"
        "sys.modules['regex'] = None\n"
        "from replicatinggpt_tpu_torch.tokenizers import ByteBPETokenizer\n"
        "text = 'To be, or not to be: that is the question. ' * 40\n"
        "tok = ByteBPETokenizer.train(text, 300)\n"
        "ids = tok.encode(text)\n"
        "assert tok.decode(ids) == text and len(ids) < len(text) // 2\n"
        "assert not any(m.split('.')[0] in ('jax', 'replicatinggpt_tpu')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

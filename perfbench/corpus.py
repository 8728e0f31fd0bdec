"""Canterbury-shaped synthetic text and binaries: a frozen copy of the program's corpus generators.

The generators below are copied from ``raisin_tpu_torch/utils/corpus.py``
(itself a copy of the JAX package's), so that the benchmark's inputs stay
the same whatever later changes make to the program. One generator a
Canterbury content class (go-compression/raisin's CI benchmarks the
Canterbury corpus: .travis.yml:19, Dockerfile:19-20); each is
deterministic in its ``seed``. ``SPEC`` lists the corpus's 11 files with
their sizes at scale 1.0, and ``TEXT_CLASSES`` the seven text generators.
"""

from __future__ import annotations

import numpy as np

_WORDS = (
    "the of and a to in is was he for it with as his on be at by i this had "
    "not are but from or have an they which one you were her all she there "
    "would their we him been has when who will more no if out so said what "
    "up its about into than them can only other new some could time these "
    "two may then do first any my now such like our over man me even most "
    "made after also did many before must through back years where much "
    "your way well down should because each just those people mr how too "
    "little state good very make world still own see men work long get "
    "here between both life being under never day same another know while "
    "last might us great old year off come since against go came right "
    "used take three"
).split()

_SPEAKERS = ["HAMLET", "OPHELIA", "KING", "QUEEN", "POLONIUS", "HORATIO", "LAERTES"]


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _words(rng, n, words=None):
    ws = words or _WORDS
    idx = rng.integers(0, len(ws), size=n)
    return [ws[i] for i in idx]


def _prose(size: int, seed: int) -> bytes:
    rng = _rng(seed)
    out = []
    total = 0
    while total < size:
        sent = _words(rng, int(rng.integers(5, 18)))
        sent[0] = sent[0].capitalize()
        s = " ".join(sent) + ". "
        if rng.random() < 0.12:
            s += "\n\n"
        out.append(s)
        total += len(s)
    return "".join(out).encode("ascii")[:size]


def _play(size: int, seed: int) -> bytes:
    rng = _rng(seed)
    out = []
    total = 0
    while total < size:
        sp = _SPEAKERS[int(rng.integers(0, len(_SPEAKERS)))]
        line = " ".join(_words(rng, int(rng.integers(4, 12))))
        s = f"  {sp}. {line}\n"
        out.append(s)
        total += len(s)
    return "".join(out).encode("ascii")[:size]


def _html(size: int, seed: int) -> bytes:
    rng = _rng(seed)
    out = ["<html>\n<head><title>synthetic</title></head>\n<body>\n"]
    total = len(out[0])
    while total < size:
        kind = rng.random()
        if kind < 0.5:
            s = "<p>" + " ".join(_words(rng, int(rng.integers(6, 20)))) + "</p>\n"
        elif kind < 0.75:
            s = '<a href="http://example.com/%s.html">%s</a>\n' % tuple(_words(rng, 2))
        else:
            s = "<li><b>" + " ".join(_words(rng, 3)) + "</b></li>\n"
        out.append(s)
        total += len(s)
    out.append("</body>\n</html>\n")
    return "".join(out).encode("ascii")[:size]


def _csrc(size: int, seed: int) -> bytes:
    rng = _rng(seed)
    out = ["#include <stdio.h>\n#include <stdlib.h>\n\n"]
    total = len(out[0])
    fn = 0
    while total < size:
        fn += 1
        body = "".join(
            f"    x{j} = x{j} * {int(rng.integers(2, 97))} + {int(rng.integers(0, 255))};\n"
            for j in range(int(rng.integers(2, 7)))
        )
        s = (
            f"static int field_{fn}(int x0, int x1, int x2) {{\n"
            f"    int x3 = 0, x4 = 1, x5 = 2, x6 = 3;\n{body}"
            f"    return x0 + x1 + x2;\n}}\n\n"
        )
        out.append(s)
        total += len(s)
    return "".join(out).encode("ascii")[:size]


def _lisp(size: int, seed: int) -> bytes:
    rng = _rng(seed)
    out = []
    total = 0
    while total < size:
        args = " ".join(_words(rng, int(rng.integers(1, 4))))
        body = " ".join(_words(rng, int(rng.integers(2, 8))))
        s = f"(defun {_words(rng, 1)[0]}-{int(rng.integers(0, 99))} ({args})\n  (list {body}))\n"
        out.append(s)
        total += len(s)
    return "".join(out).encode("ascii")[:size]


def _xls(size: int, seed: int) -> bytes:
    # spreadsheet-like: repetitive 16-byte binary records with slowly
    # varying fields (kennedy.xls is mostly such record structure)
    rng = _rng(seed)
    n = size // 16 + 1
    rec = np.zeros((n, 16), dtype=np.uint8)
    rec[:, 0] = 0x09
    rec[:, 1] = 0x04
    counter = np.arange(n, dtype=np.uint32)
    rec[:, 2] = counter & 0xFF
    rec[:, 3] = (counter >> 8) & 0xFF
    vals = rng.integers(0, 1000, size=n).astype(np.uint32)
    rec[:, 4] = vals & 0xFF
    rec[:, 5] = (vals >> 8) & 0xFF
    rec[:, 8] = rng.integers(0, 4, size=n)
    return rec.tobytes()[:size]


def _poetry(size: int, seed: int) -> bytes:
    rng = _rng(seed)
    out = []
    total = 0
    while total < size:
        line = " ".join(_words(rng, int(rng.integers(4, 9))))
        s = line + ",\n" if rng.random() < 0.7 else line + ".\n\n"
        out.append(s)
        total += len(s)
    return "".join(out).encode("ascii")[:size]


def _fax(size: int, seed: int) -> bytes:
    # ptt5-like: sparse bilevel scan data — long zero runs with bursts
    rng = _rng(seed)
    out = np.zeros(size, dtype=np.uint8)
    pos = 0
    while pos < size:
        run = int(rng.integers(50, 2000))
        pos += run
        burst = int(rng.integers(2, 30))
        end = min(pos + burst, size)
        if pos < size:
            out[pos:end] = rng.integers(1, 256, size=end - pos)
        pos += burst
    return out.tobytes()[:size]


def _sum(size: int, seed: int) -> bytes:
    # SPARC executable-like: interleaved machine-ish words and strings
    rng = _rng(seed)
    chunks = []
    total = 0
    while total < size:
        if rng.random() < 0.6:
            n = int(rng.integers(64, 512)) & ~3
            ops = rng.integers(0, 2**32, size=n // 4, dtype=np.uint32)
            ops = (ops & 0xC1F83FFF) | 0x80102000  # repetitive opcode fields
            c = ops.astype("<u4").tobytes()
        else:
            c = (" ".join(_words(rng, int(rng.integers(4, 20)))) + "\x00").encode()
        chunks.append(c)
        total += len(c)
    return b"".join(chunks)[:size]


def _man(size: int, seed: int) -> bytes:
    rng = _rng(seed)
    out = ['.TH SYN 1 "synthetic corpus"\n.SH NAME\nsyn \\- synthetic man page\n']
    total = len(out[0])
    while total < size:
        s = ".PP\n" + " ".join(_words(rng, int(rng.integers(8, 25)))) + "\n"
        if rng.random() < 0.2:
            s += ".B " + " ".join(_words(rng, 2)) + "\n"
        out.append(s)
        total += len(s)
    return "".join(out).encode("ascii")[:size]


# (name, generator, canterbury-scale size, text?)
SPEC = [
    ("alice29.txt", _prose, 152089, True),
    ("asyoulik.txt", _play, 125179, True),
    ("cp.html", _html, 24603, True),
    ("fields.c", _csrc, 11150, True),
    ("grammar.lsp", _lisp, 3721, True),
    ("kennedy.xls", _xls, 1029744, False),
    ("lcet10.txt", _prose, 426754, True),
    ("plrabn12.txt", _poetry, 481861, True),
    ("ptt5", _fax, 513216, False),
    ("sum", _sum, 38240, False),
    ("xargs.1", _man, 4227, True),
]

# the seven generators of the corpus's text files (alice29.txt and lcet10.txt share one)
TEXT_CLASSES = (_prose, _play, _html, _csrc, _lisp, _poetry, _man)

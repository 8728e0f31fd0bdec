"""The port's Canterbury-shaped corpus and its file-level round trips, against the JAX package.

``raisin_tpu_torch.utils.corpus`` is the port's copy of
``raisin_tpu.utils.corpus``: ``generate``, ``text_files`` and the files of
``write_corpus`` must equal the original's byte for byte. Then the port's
``compress_file``/``decompress_file`` (``device="cpu"``: the kernels' plain
versions, the native C copy and the host copies) run the reference CI's
algorithm list over the corpus as ``tests/test_corpus.py`` runs the JAX
package's. Where that test skips a case that is lossy by reference parity
(Huffman on binary files, the ``<`` escapes of the LZSS layer under
Huffman, the dmc stub decoder, ``arithmetic,huffman``), the port's decoded
bytes, or its error, must equal the JAX package's. Tolerance 0: bytes.
"""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

from raisin_tpu.engine import core as jax_core
from raisin_tpu.utils import corpus as jax_corpus
from raisin_tpu_torch import utils
from raisin_tpu_torch.engine import core as port_core
from raisin_tpu_torch.utils import corpus as port_corpus
from tests.test_corpus import FILES_FAST, FILES_SLOW, TRAVIS_ALGOS

torch.set_num_threads(1)

SCALE = 0.02  # the round trips' corpus: the plain versions on the CPU take seconds for each 50 KB
CORPUS = port_corpus.generate(SCALE)
TEXT = port_corpus.text_files()


@pytest.mark.parametrize("scale", [0.01, 0.05, 0.25])
def test_generate_equals_jax(scale):
    port, jax = port_corpus.generate(scale), jax_corpus.generate(scale)
    assert list(port) == list(jax)
    for name in jax:
        assert port[name] == jax[name], name


def test_text_files_and_exports_equal_jax():
    assert port_corpus.text_files() == jax_corpus.text_files()
    assert (utils.generate, utils.text_files, utils.write_corpus) == (
        port_corpus.generate, port_corpus.text_files, port_corpus.write_corpus)


def test_write_corpus_equals_jax(tmp_path):
    port = port_corpus.write_corpus(str(tmp_path / "port"), scale=0.01)
    jax = jax_corpus.write_corpus(str(tmp_path / "jax"), scale=0.01)
    assert [Path(p).name for p in port] == [Path(p).name for p in jax] == list(jax_corpus.generate(0.01))
    for p, j in zip(port, jax):
        assert Path(p).read_bytes() == Path(j).read_bytes()


def _lossy_by_parity(algos: list[str], name: str) -> bool:
    """The cases tests/test_corpus.py skips or expects to differ (reference parity)."""
    uses_huffman = "huffman" in algos
    return (algos in (["dmc"], ["arithmetic", "huffman"]) or (uses_huffman and name not in TEXT)
            or (uses_huffman and len(algos) > 1 and name in ("cp.html", "fields.c")))


def _outcome(fn):
    """fn()'s bytes, or the name and message of what it raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared with the JAX package's outcome
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("algos", TRAVIS_ALGOS, ids=lambda a: ",".join(a))
def test_port_file_round_trips_on_the_corpus(tmp_path, algos):
    for name in FILES_SLOW if "lzw" in algos else FILES_FAST:
        data = CORPUS[name]
        src = tmp_path / name
        src.write_bytes(data)
        comp = _outcome(lambda: port_core.compress_file(algos, str(src), str(src) + ".rsn", quiet=True, device="cpu"))
        assert comp == _outcome(lambda: jax_core.compress_bytes(data, list(algos))), (algos, name)
        if isinstance(comp, str):  # dmc on binary input: the reference panics, both packages raise
            continue
        back = _outcome(lambda: port_core.decompress_file(algos, str(src) + ".rsn", str(src) + ".back", quiet=True,
                                                          device="cpu"))
        if _lossy_by_parity(algos, name):
            assert back == _outcome(lambda: jax_core.decompress_bytes(comp, list(algos))), (algos, name)
        else:
            assert back == data and (tmp_path / f"{name}.back").read_bytes() == data, (algos, name)

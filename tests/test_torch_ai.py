"""The port's ai/ (features, dataset, benchmark records, picker) against raisin_tpu.ai.

Features and the dataset are copies, so they must agree exactly; the
benchmark records agree in every field but the timings; a flax picker
fitted by the JAX package and carried across with
``AlgorithmPicker.from_jax_params`` gives the same logits within 1e-5
(float32) and the same predictions; the port's own ``fit`` meets the JAX
test's thresholds (tests/test_ai_harness.py).
"""

from __future__ import annotations

import pickle

import jax
import numpy as np
import pytest

from raisin_tpu import ai as jax_ai
from raisin_tpu_torch import ai as port_ai

CPU = "cpu"
ALGORITHMS = [["flate"], ["huffman"], ["lzss"]]
NAMES = ["plain.txt", "repetitive.txt", "random.bin", "zeros.bin", "structured.csv", "halfhalf.bin"]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("ai")
    return port_ai.generate_dataset(str(root / "port")), jax_ai.generate_dataset(str(root / "jax"))


@pytest.fixture(scope="module")
def records(datasets):
    port_files, jax_files = datasets
    return (port_ai.benchmark_files(port_files, algorithms=ALGORITHMS, device=CPU),
            jax_ai.benchmark_files(jax_files, algorithms=ALGORITHMS))


def test_generate_dataset_writes_the_same_files(datasets):
    port_files, jax_files = datasets
    assert [f.rsplit("/", 1)[1] for f in port_files] == NAMES
    for a, b in zip(port_files, jax_files):
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), a


@pytest.mark.parametrize("name", NAMES + ["empty", "png", "rsnb"])
def test_file_features_equal_jax(name, datasets):
    if name in NAMES:
        with open(datasets[0][NAMES.index(name)], "rb") as f:
            data = f.read()
    else:
        data = {"empty": b"", "png": b"\x89PNG\r\n\x1a\nxxxx", "rsnb": b"RSNB\x01..."}[name]
    got, want = port_ai.file_features(data), jax_ai.file_features(data)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert port_ai.sniff_mime(data) == jax_ai.sniff_mime(data)
    assert port_ai.entropy_nats(data) == jax_ai.entropy_nats(data)


def test_benchmark_records_agree_but_for_the_timings(records, tmp_path):
    port_recs, jax_recs = records

    def untimed(recs):
        return [{**r, "results": [{k: v for k, v in x.items() if k != "seconds"} for x in r["results"]]}
                for r in recs]

    assert untimed(port_recs) == untimed(jax_recs)
    assert all("seconds" in x for r in port_recs for x in r["results"])
    out = tmp_path / "data.json"
    port_ai.benchmark_files(port_ai.generate_dataset(str(tmp_path / "c"))[:1], [["flate"]], str(out), device=CPU)
    assert out.read_text().startswith("[")


def _labelled(recs: list[dict]) -> list[dict]:
    """The records with their best pipelines spread over three classes, so the picker has to separate them."""
    return [{**r, "best": ALGORITHMS[i % 3]} for i, r in enumerate(recs)]


def test_flax_picker_carried_across_gives_the_same_logits(records, tmp_path):
    recs = _labelled(records[1])
    jp = jax_ai.AlgorithmPicker()
    jp.fit(recs, epochs=200)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jp.params))
    picker = port_ai.AlgorithmPicker.from_jax_params(params, jp.classes, jp._norm, device=CPU)
    X = np.array([r["features"] for r in recs] + [port_ai.file_features(b"the quick brown fox " * 200)], np.float32)
    mu, sd = jp._norm
    want = np.asarray(jp._model.apply(jp.params, (X - mu) / sd))
    got = picker.logits(X)
    assert got.dtype == np.float32 and np.abs(got - want).max() <= 1e-5
    assert (got.argmax(1) == want.argmax(1)).all()
    assert picker.accuracy(recs) == jp.accuracy(recs)
    for data in (b"the quick brown fox " * 200, bytes(range(256)) * 8):
        assert picker.predict(data) == jp.predict(data)
    # save writes the flax layout: it loads back into the same logits
    path = tmp_path / "picker.pkl"
    picker.save(str(path))
    with open(path, "rb") as f:
        saved = pickle.load(f)
    again = port_ai.AlgorithmPicker.from_jax_params(saved["params"], saved["classes"], saved["norm"], device=CPU)
    assert np.array_equal(again.logits(X), got)


@pytest.mark.parametrize("labelled", [False, True], ids=["harness", "three-classes"])
def test_port_picker_fits_like_the_jax_test(records, labelled):
    recs = _labelled(records[0]) if labelled else records[0]
    picker = port_ai.AlgorithmPicker(device=CPU)
    loss = picker.fit(recs, epochs=200)
    assert loss < 2.0
    assert picker.accuracy(recs) >= 0.5
    pred = picker.predict(b"the quick brown fox " * 200)
    assert isinstance(pred, list) and all(isinstance(a, str) for a in pred)
    again = port_ai.AlgorithmPicker(device=CPU)
    assert again.fit(recs, epochs=200) == loss  # the seed fixes the run


def test_picker_refuses_what_it_cannot_do():
    picker = port_ai.AlgorithmPicker(device=CPU)
    with pytest.raises(RuntimeError, match="fit"):
        picker.predict(b"x")
    with pytest.raises(ValueError, match="no trainable records"):
        picker.fit([{"features": [0.0] * 20}])

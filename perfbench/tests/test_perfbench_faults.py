"""A run with the timed path broken underneath comes out not correct, once for each fault a cell can
have: a step that returns its input unchanged, half of the batch left out, and a token or an answer
altered where it is produced. (No cell runs over several cards, so none can leave out the exchange
between them.)

The runs skip the look for a card and run the program's plain versions on the CPU, at a size a test
holds."""

import json

import pytest

from perfbench import cells, run

TEXT = {"clients": 2, "loop": "closed",
        "phases": [{"direction": "compress", "share": 0.5}, {"direction": "decompress", "share": 0.5}],
        "requests": {"kind": "text_blocks", "bytes": 6144, "block": 2048, "source_bytes": 8192},
        "order": "cycle", "check": {"kept": 1}}
FILES = {"clients": 1, "loop": "closed", "phases": [{"direction": "compress", "share": 1.0}],
         "requests": {"kind": "canterbury_files", "scale": 0.001}, "order": "shuffle", "check": {"kept": "all"}}


def _run(tmp_path, workload, mix, **config):
    cell = cells.find(workload)
    cell.config = {**cell.config, **config}
    cell.traffic_path = tmp_path / "mix.json"
    cell.traffic_path.write_text(json.dumps(mix))
    return run.run_cell(cell, 2**31 + 5, 0.5, False, "cpu")


def _unchanged(monkeypatch):
    from raisin_tpu_torch.parallel import blocks

    monkeypatch.setattr(blocks, "compress_container", lambda data, *a, **k: bytes(data))


def _half_batch(monkeypatch):
    from raisin_tpu_torch.ops import pipeline

    whole = pipeline.lzss_arith_encode_rows

    def half(x, n, window):
        h = max(1, x.shape[0] // 2)  # the first half's answers, repeated over the rest
        return [t.repeat((2,) + (1,) * (t.dim() - 1))[: x.shape[0]] for t in whole(x[:h], n[:h], window)]

    monkeypatch.setattr(pipeline, "lzss_arith_encode_rows", half)


def _token_altered(monkeypatch):
    from raisin_tpu_torch.ops import lzss_commit

    commit = lzss_commit.commit_tokens

    def altered(*a, **k):
        tok, tok_len = commit(*a, **k)
        tok = tok.clone()
        tok[:, 0] ^= 1
        return tok, tok_len

    monkeypatch.setattr(lzss_commit, "commit_tokens", altered)


def _decoded_altered(monkeypatch):
    from raisin_tpu_torch.ops import lzss_decode

    decode = lzss_decode.decode_tokens

    def altered(*a, **k):
        rows, lens = decode(*a, **k)
        rows = rows.clone()
        rows[:, 0] ^= 1
        return rows, lens

    monkeypatch.setattr(lzss_decode, "decode_tokens", altered)


def test_a_sound_container_run_is_correct(tmp_path):
    result = _run(tmp_path, "rsnb-lzss-arith.text", TEXT, block_size=2048)
    assert result["correct"], result["checks"]
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _token_altered, _decoded_altered])
def test_a_broken_container_run_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    result = _run(tmp_path, "rsnb-lzss-arith.text", TEXT, block_size=2048)
    assert result["correct"] is False, result["checks"]


def test_a_stream_run_with_an_altered_token_is_not_correct(tmp_path, monkeypatch):
    assert _run(tmp_path, "stream-lzss-arith.canterbury", FILES)["correct"]
    _token_altered(monkeypatch)
    result = _run(tmp_path, "stream-lzss-arith.canterbury", FILES)
    assert result["correct"] is False and result["checks"]["streams_differing"]["value"] > 0

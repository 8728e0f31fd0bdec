"""Cheap per-file features (parity with reference ai/helpers/files.py): the port's copy of raisin_tpu/ai/features.py.

The reference computes Shannon entropy and a libmagic MIME type per file
(files.py:37-59). This environment has no libmagic and no network, so MIME
sniffing is signature-based.
"""

from __future__ import annotations

import math

import numpy as np

_SIGNATURES = [
    (b"\x89PNG\r\n\x1a\n", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"%PDF", "application/pdf"),
    (b"GIF8", "image/gif"),
    (b"PK\x03\x04", "application/zip"),
    (b"\x1f\x8b", "application/gzip"),
    (b"RSNB", "application/x-rsnb"),
]


def sniff_mime(data: bytes) -> str:
    for magic, mime in _SIGNATURES:
        if data.startswith(magic):
            return mime
    head = data[:4096]
    if not head:
        return "application/x-empty"
    try:
        head.decode("utf-8")
        return "text/plain"
    except UnicodeDecodeError:
        return "application/octet-stream"


def entropy_nats(data: bytes) -> float:
    """Order-0 byte entropy in nats (reference convention, engine.go:410)."""
    if not data:
        return 0.0
    counts = np.bincount(np.frombuffer(data, dtype=np.uint8), minlength=256)
    p = counts[counts > 0] / len(data)
    return float(-(p * np.log(p)).sum())


def file_features(data: bytes) -> np.ndarray:
    """Feature vector for the algorithm picker: entropy, size, histogram stats."""
    if not data:
        return np.zeros(20, dtype=np.float32)
    arr = np.frombuffer(data, dtype=np.uint8)
    counts = np.bincount(arr, minlength=256).astype(np.float64)
    p = counts / len(arr)
    ent = entropy_nats(data)
    ascii_frac = float(p[32:127].sum())
    zero_frac = float(p[0])
    hi_frac = float(p[128:].sum())
    top8 = np.sort(p)[-8:]  # mass of the 8 most common bytes
    # short-range repetition proxy: fraction of positions equal to lag-1..4
    reps = [float((arr[k:] == arr[:-k]).mean()) if len(arr) > k else 0.0 for k in (1, 2, 3, 4)]
    feats = np.array(
        [
            ent,
            math.log1p(len(data)),
            ascii_frac,
            zero_frac,
            hi_frac,
            float(np.count_nonzero(counts)) / 256.0,
            *top8.tolist(),
            *reps,
            float(p.max()),
            float((counts > 0).argmax()) / 255.0,
        ],
        dtype=np.float32,
    )
    return feats

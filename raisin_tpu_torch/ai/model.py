"""Best-algorithm picker on PyTorch: the port of raisin_tpu/ai/model.py.

The reference stops at an untrained Keras model (Normalization + Dense(16),
never fit: ai/helpers/ai.py:6-24). As in the JAX package, this is the
working version: an MLP over the cheap file features (Linear 20 -> 32,
ReLU, Linear 32 -> 16, ReLU, Linear 16 -> classes), fitted full-batch with
Adam on softmax cross-entropy over harness records. The weights start as
flax's ``Dense`` starts them (truncated-normal LeCun weights, zero biases),
drawn from an explicit ``torch.Generator`` seeded by ``seed``.

:meth:`AlgorithmPicker.from_jax_params` takes a flax picker's parameters
(``Dense_i/kernel`` of shape (in, out), ``Dense_i/bias``) as numpy arrays,
so the two packages compute the same logits.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
from torch import nn

from raisin_tpu_torch.ai.features import file_features
from raisin_tpu_torch.ops.device import resolve_device

N_FEATURES = 20
HIDDEN = (32, 16)


def _mlp(n_out: int) -> nn.Sequential:
    widths = (N_FEATURES, *HIDDEN)
    layers: list[nn.Module] = []
    for a, b in zip(widths, widths[1:]):
        layers += [nn.Linear(a, b), nn.ReLU()]
    return nn.Sequential(*layers, nn.Linear(widths[-1], n_out))


def _linears(mlp: nn.Sequential) -> list[nn.Linear]:
    return [m for m in mlp if isinstance(m, nn.Linear)]


class AlgorithmPicker:
    """Predicts the best codec pipeline from file features, on ``device`` (None: the card)."""

    def __init__(self, classes: list[str] | None = None, device: torch.device | str | None = None) -> None:
        self.classes = classes or []
        self.device = resolve_device(device)
        self.mlp: nn.Sequential | None = None
        self._norm = (np.zeros(N_FEATURES, np.float32), np.ones(N_FEATURES, np.float32))

    @staticmethod
    def _label(algorithms: list[str]) -> str:
        return ",".join(algorithms)

    @classmethod
    def from_jax_params(cls, params: dict, classes: list[str], norm: tuple[np.ndarray, np.ndarray],
                        device: torch.device | str | None = None) -> "AlgorithmPicker":
        """A picker with a flax picker's weights: ``params`` as its ``params`` tree (with or
        without the top ``"params"`` key) of numpy arrays, its classes and its (mean, std)."""
        tree = params.get("params", params)
        picker = cls(list(classes), device)
        picker.mlp = _mlp(len(classes))
        with torch.no_grad():
            for i, layer in enumerate(_linears(picker.mlp)):
                layer.weight.copy_(torch.from_numpy(np.array(tree[f"Dense_{i}"]["kernel"], np.float32).T))
                layer.bias.copy_(torch.from_numpy(np.array(tree[f"Dense_{i}"]["bias"], np.float32)))
        picker.mlp.to(picker.device)
        picker._norm = (np.asarray(norm[0], np.float32), np.asarray(norm[1], np.float32))
        return picker

    def fit(self, records: list[dict], epochs: int = 300, lr: float = 3e-3, seed: int = 0) -> float:
        """Train on harness records (see ai.harness.benchmark_files); -> the last step's loss."""
        feats, labels = [], []
        for rec in records:
            if "best" not in rec:
                continue
            feats.append(rec["features"])
            labels.append(self._label(rec["best"]))
        if not feats:
            raise ValueError("no trainable records (no lossless results)")
        self.classes = sorted(set(labels))
        X = np.array(feats, dtype=np.float32)
        mu, sd = X.mean(0), X.std(0) + 1e-6
        self._norm = (mu, sd)
        xb = torch.from_numpy((X - mu) / sd).to(self.device)
        yb = torch.tensor([self.classes.index(label) for label in labels], dtype=torch.int64, device=self.device)

        self.mlp = _mlp(len(self.classes))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in _linears(self.mlp):
                # flax Dense: LeCun normal truncated at two standard deviations, zero bias
                std = (1.0 / layer.in_features) ** 0.5 / 0.87962566103423978
                w = torch.empty(layer.weight.shape)
                layer.weight.copy_(torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen) * std)
                layer.bias.zero_()
        self.mlp.to(self.device)
        opt = torch.optim.Adam(self.mlp.parameters(), lr=lr)
        loss = None
        for _ in range(epochs):
            opt.zero_grad()
            loss = nn.functional.cross_entropy(self.mlp(xb), yb)
            loss.backward()
            opt.step()
        return loss.item()

    def logits(self, features: np.ndarray) -> np.ndarray:
        """(n, 20) raw feature rows -> (n, classes) float32 logits, after the fitted normalisation."""
        if self.mlp is None:
            raise RuntimeError("fit() first")
        mu, sd = self._norm
        x = torch.from_numpy((np.asarray(features, np.float32) - mu) / sd).to(self.device)
        with torch.no_grad():
            return self.mlp(x).cpu().numpy()

    def predict(self, data: bytes) -> list[str]:
        return self.classes[int(self.logits(file_features(data)[None, :]).argmax())].split(",")

    def accuracy(self, records: list[dict]) -> float:
        rows = [rec for rec in records if "best" in rec]
        if not rows:
            return 0.0
        pred = self.logits(np.array([rec["features"] for rec in rows], np.float32)).argmax(1)
        return sum(self.classes[p] == self._label(rec["best"]) for p, rec in zip(pred, rows)) / len(rows)

    def save(self, path: str) -> None:
        """Classes, normalisation and weights, as numpy arrays in the flax layout (loadable by from_jax_params)."""
        params = {f"Dense_{i}": {"kernel": layer.weight.detach().cpu().numpy().T,
                                 "bias": layer.bias.detach().cpu().numpy()}
                  for i, layer in enumerate(_linears(self.mlp))}
        with open(path, "wb") as f:
            pickle.dump({"classes": self.classes, "norm": self._norm, "params": {"params": params}}, f)

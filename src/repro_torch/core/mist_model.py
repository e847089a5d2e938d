"""MIST stage-2 contextual classifier, as a PyTorch model.

Port of ``repro/core/mist_model.py``. The paper prescribes "a local small
language model" for contextual classification (public/internal/
confidential/restricted). Here that is a hashed char-trigram logistic
classifier trained with the port's training substrate (its AdamW) on a
synthetic labeled corpus, from zeros with full-batch steps and the
reference's hyperparameters, so training is deterministic in both
packages. ``featurize`` and the corpus are the reference's, word for
word. Training and inference run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import random
import zlib

import numpy as np
import torch

from repro_torch.models.model import resolve_device
from repro_torch.training import optim

CLASSES = ("public", "internal", "confidential", "restricted")
DIM = 2048


def featurize(text: str, dim: int = DIM) -> np.ndarray:
    """Hashed char-trigram counts, l2-normalized."""
    v = np.zeros(dim, np.float32)
    t = f"  {text.lower()}  "
    for i in range(len(t) - 2):
        # crc32, not hash(): python's hash is salted per-process
        h = zlib.crc32(t[i:i + 3].encode()) % dim
        v[h] += 1.0
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


# --------------------------------------------------- synthetic labeled data

_PUBLIC = [
    "what is the capital of {c}", "explain how photosynthesis works",
    "best hiking trails near mountains", "how do i sort a list in python",
    "what are common {x} complications", "history of the roman empire",
    "recipe for vegetable soup", "how far is the moon",
    "difference between tcp and udp", "tips for learning guitar",
]
_INTERNAL = [
    "summarize our team meeting notes from the retro",
    "draft the q3 roadmap for review", "our codebase uses module {x}",
    "deploy checklist for the staging cluster",
    "rewrite this paragraph for the internal wiki",
    "what did our team decide about the api redesign",
]
_CONFIDENTIAL = [
    "customer data export for account {x} shows churn risk",
    "the proprietary pricing model uses factor {x}",
    "salary bands for level {x} engineers",
    "our confidential acquisition target list",
    "source code for the licensing server module {x}",
    "unreleased product specs for project {c}",
]
_RESTRICTED = [
    "patient {c} was diagnosed with diabetes, HbA1c elevated",
    "ssn and date of birth for the claimant",
    "privileged and confidential: case strategy for docket {x}",
    "password for the production database is {x}",
    "lab results show elevated markers, adjust insulin dosage",
    "private key material for the signing service",
]
_FILL_C = ["France", "Japan", "Chicago", "Berlin", "Alice Johnson", "Acme"]
_FILL_X = ["alpha", "7", "42", "delta", "omega", "13b"]


def synth_corpus(n_per_class: int = 200, seed: int = 0):
    rng = random.Random(seed)
    data = []
    for label, temps in enumerate((_PUBLIC, _INTERNAL, _CONFIDENTIAL,
                                   _RESTRICTED)):
        for _ in range(n_per_class):
            t = rng.choice(temps)
            t = t.replace("{c}", rng.choice(_FILL_C)).replace(
                "{x}", rng.choice(_FILL_X))
            # noise: shuffle-in a few random words
            words = t.split()
            if rng.random() < 0.5:
                words.insert(rng.randrange(len(words)), rng.choice(
                    ["please", "asap", "thanks", "urgent", "note"]))
            data.append((" ".join(words), label))
    rng.shuffle(data)
    return data


class NgramClassifier:
    def __init__(self, params=None):
        self.params = params

    @staticmethod
    def _logits(params, x):
        return x @ params["w"] + params["b"]

    def _features(self, text):
        return torch.from_numpy(featurize(text)).to(
            self.params["w"].device)[None]

    def classify(self, text: str) -> str:
        logits = self._logits(self.params, self._features(text))[0]
        return CLASSES[int(torch.argmax(logits))]

    def probs(self, text: str):
        return torch.softmax(
            self._logits(self.params, self._features(text))[0], dim=-1)


def _loss(params, xb, yb):
    logits = xb @ params["w"] + params["b"]
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, 1, yb[:, None])[:, 0]
    return (lse - ll).mean()


def train_classifier(seed: int = 0, steps: int = 300,
                     n_per_class: int = 200,
                     device=None) -> NgramClassifier:
    dev = resolve_device(device)
    data = synth_corpus(n_per_class, seed)
    X = np.stack([featurize(t) for t, _ in data])
    y = np.array([l for _, l in data], np.int32)
    params = {"w": torch.zeros((DIM, len(CLASSES)), dtype=torch.float32,
                               device=dev),
              "b": torch.zeros((len(CLASSES),), dtype=torch.float32,
                               device=dev)}
    ocfg = optim.AdamWConfig(lr=0.05, weight_decay=1e-4, warmup_steps=10,
                             total_steps=steps, clip_norm=10.0)
    state = optim.init_state(ocfg, params)
    Xt = torch.from_numpy(X).to(dev)
    yt = torch.from_numpy(y).long().to(dev)
    for _ in range(steps):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            g = torch.autograd.grad(_loss(live, Xt, yt),
                                    [live["b"], live["w"]])
        params, state, _ = optim.apply_updates(
            ocfg, params, {"b": g[0], "w": g[1]}, state)
    clf = NgramClassifier(params)
    acc = float((torch.argmax(Xt @ params["w"] + params["b"], -1) == yt)
                .float().mean())
    clf.train_accuracy = acc
    return clf

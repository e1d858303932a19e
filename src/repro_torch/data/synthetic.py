"""Seeded synthetic datasets (port of ``repro.data.synthetic``).

``mnist_like``: 784-dim, 10 classes (logistic regression). ``cifar_like``:
32×32×3, 10 classes (CNN). Classes are Gaussian clusters around random
prototype directions. Drawn with a ``torch.Generator``, so the samples
differ from the reference's ``jax.random`` draws; the law is the same.
"""
from __future__ import annotations

import math

import torch


def make_classification_dataset(
    kind: str,
    n_samples: int,
    generator: torch.Generator,
    n_classes: int = 10,
    noise: float = 0.8,
    proto_seed: int = 42,
    dim: int | None = None,
    channel_bias: float = 0.0,
):
    """Returns (features, labels): features (n, dim) for 'mnist_like' and
    (n, 32, 32, 3) for 'cifar_like', labels int64.

    Class prototypes are fixed by ``proto_seed`` (not by ``generator``) so
    train and test sets drawn from different generators share one
    distribution. ``channel_bias`` (cifar_like only) adds a per-class
    per-channel offset that survives the CNN's global average pool.
    """
    if kind == "mnist_like":
        dim = 784 if dim is None else int(dim)
        shape = (dim,)
    elif kind == "cifar_like":
        if dim is not None:
            raise ValueError("dim override only supported for mnist_like")
        dim = 32 * 32 * 3
        shape = (32, 32, 3)
    else:
        raise ValueError(kind)

    proto_gen = torch.Generator().manual_seed(proto_seed)
    prototypes = torch.randn(n_classes, dim, generator=proto_gen) / math.sqrt(dim)
    labels = torch.randint(0, n_classes, (n_samples,), generator=generator)
    eps = torch.randn(n_samples, dim, generator=generator) / math.sqrt(dim)
    # per-sample scale variation (mimics stroke-thickness / luminance variety)
    scale = 1.0 + 0.3 * torch.randn(n_samples, 1, generator=generator)
    feats = (scale * (prototypes[labels] + noise * eps)).reshape((n_samples,) + shape)
    if channel_bias:
        if kind != "cifar_like":
            raise ValueError("channel_bias is an image-channel feature (cifar_like only)")
        bias = torch.randn(n_classes, shape[-1], generator=proto_gen)
        feats = feats + channel_bias * bias[labels][:, None, None, :]
    return feats, labels


def pad_with_wrong_labels(features, labels, n_pad: int, n_classes: int = 10):
    """Append ``n_pad`` pad rows whose labels are deliberately wrong.

    The pad rows cycle the real features but carry labels shifted by +1 mod
    ``n_classes``, so a model that predicts the true class gets every pad
    row wrong: an eval that counts pad rows shifts measurably, one that
    honours the valid prefix (``n_valid = len(labels)``) does not.
    """
    feats, labs = torch.as_tensor(features), torch.as_tensor(labels)
    idx = torch.arange(n_pad, device=feats.device) % feats.shape[0]
    return (torch.cat([feats, feats[idx]], dim=0),
            torch.cat([labs, (labs[idx] + 1) % n_classes], dim=0))

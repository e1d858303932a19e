"""Seeded synthetic datasets (port of ``repro.data.synthetic``).

``mnist_like``: 784-dim, 10 classes (logistic regression). ``cifar_like``:
32×32×3, 10 classes (CNN). Classes are Gaussian clusters around random
prototype directions. ``make_token_dataset``: a Markov-chain token corpus
for the LM trainer. Drawn with a ``torch.Generator``, so the samples
differ from the reference's ``jax.random`` draws; the law is the same.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.scheduling import gumbel


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


def make_token_dataset(
    n_sequences: int,
    seq_len: int,
    vocab_size: int,
    generator: torch.Generator,
    order: int = 2,
) -> torch.Tensor:
    """Synthetic LM corpus (n_sequences, seq_len) int64: a random Markov
    chain over a small effective vocabulary, ``min(vocab_size, 256)``
    tokens, so next-token prediction has learnable signal.

    The transition table is Gumbel logits kept where they exceed 1 (about
    31% of each row; the rest -1e9), the first token uniform, and each next
    token a categorical draw from its row (``argmax(row + Gumbel)``), all
    from ``generator``, so the samples differ from the reference's
    ``jax.random`` draws and the law is the same. ``order`` is accepted as
    the reference's signature has it; as there, the chain reads the current
    token only.
    """
    del order
    eff_vocab = min(vocab_size, 256)
    dev = generator.device
    table = gumbel((eff_vocab, eff_vocab), generator)
    table = torch.where(table > 1.0, table, -1e9)  # keep only likely transitions
    tok = torch.randint(0, eff_vocab, (n_sequences,), generator=generator, device=dev)
    seq = [tok]
    for _ in range(seq_len - 1):
        tok = torch.argmax(table[tok] + gumbel((n_sequences, eff_vocab), generator), dim=-1)
        seq.append(tok)
    return torch.stack(seq, dim=1)

"""Federated partitions (port of ``repro.data.partition``).

numpy-seeded exactly as the reference, so the same inputs and seed give the
same shards, bit for bit: the paper's sort-by-label shards, the IID split,
Dirichlet(β) label skew (``partition_dirichlet``), Dirichlet(β) shard sizes
(``partition_dirichlet_sized``) and both skews at once
(``partition_dirichlet_mixed``). The sized and mixed presets wrap-pad every
shard to the largest one and record the true counts in
``DeviceData.n_samples``; rows past them are never drawn.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pofl import DeviceData


def _device_data(features: np.ndarray, labels: np.ndarray, n_samples=None) -> DeviceData:
    return DeviceData(
        features=torch.from_numpy(np.ascontiguousarray(features, np.float32)),
        labels=torch.from_numpy(np.ascontiguousarray(labels, np.int64)),
        n_samples=None if n_samples is None else torch.from_numpy(
            np.asarray(n_samples, np.int64)),
    )


def partition_noniid_shards(
    features, labels, n_devices: int, shards_per_device: int = 2, seed: int = 0,
) -> DeviceData:
    """Sort by label, split into ``n_devices * shards_per_device`` shards and
    give each device ``shards_per_device`` random ones (paper Sec. V-A)."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    n_shards = n_devices * shards_per_device
    shard_size = labels.shape[0] // n_shards

    order = np.argsort(labels, kind="stable")
    rng = np.random.default_rng(seed)
    shard_ids = rng.permutation(n_shards)

    per_dev = []
    for d in range(n_devices):
        idx = np.concatenate([
            order[s * shard_size : (s + 1) * shard_size]
            for s in shard_ids[d * shards_per_device : (d + 1) * shards_per_device]
        ])
        rng.shuffle(idx)
        per_dev.append(idx)
    idx = np.stack(per_dev)
    return _device_data(features[idx], labels[idx])


def partition_iid(features, labels, n_devices: int, seed: int = 0) -> DeviceData:
    """IID control: uniformly random equal split."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    m_total = labels.shape[0]
    per = m_total // n_devices
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m_total)[: per * n_devices].reshape(n_devices, per)
    return _device_data(features[perm], labels[perm])


def _apportion_by_label(labels, sizes, beta: float, rng) -> list[np.ndarray]:
    """Device d gets ``sizes[d]`` sample indices whose labels follow
    q_d ~ Dir(β·1_K): largest-remainder apportionment of its slots to
    classes, drawn from per-class pools, topping up from the fullest pool
    when a class runs dry (every sample used at most once)."""
    classes = np.unique(labels)
    pools = {c: rng.permutation(np.flatnonzero(labels == c)).tolist() for c in classes}
    props = rng.dirichlet(np.full(len(classes), beta), size=len(sizes))

    per_dev_idx = []
    for d, per in enumerate(sizes):
        per = int(per)
        raw = props[d] * per
        counts = np.floor(raw).astype(int)
        short = per - counts.sum()
        counts[np.argsort(raw - counts)[::-1][:short]] += 1

        idx = []
        for c, want in zip(classes, counts):
            take = min(want, len(pools[c]))
            idx.extend(pools[c][:take])
            pools[c] = pools[c][take:]
        while len(idx) < per:  # top up from whatever classes still have samples
            c = max(pools, key=lambda c: len(pools[c]))
            idx.append(pools[c].pop(0))
        idx = np.asarray(idx[:per])
        rng.shuffle(idx)
        per_dev_idx.append(idx)
    return per_dev_idx


def partition_dirichlet(
    features, labels, n_devices: int, beta: float = 0.5, seed: int = 0,
) -> DeviceData:
    """Dirichlet(β) label proportions per device over equal M//N shards."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    per = labels.shape[0] // n_devices
    rng = np.random.default_rng(seed)
    idx = np.stack(_apportion_by_label(labels, [per] * n_devices, beta, rng))
    return _device_data(features[idx], labels[idx])


def dirichlet_sizes(
    m_total: int, n_devices: int, beta: float = 0.5, min_per_device: int = 1,
    seed: int = 0,
) -> np.ndarray:
    """Unequal shard sizes m_i ~ Dir(β·1_N)·M with Σm_i = M: largest-remainder
    apportionment, then devices below ``min_per_device`` lifted by taking
    from the largest shards."""
    if n_devices * min_per_device > m_total:
        raise ValueError(
            f"cannot give {n_devices} devices ≥{min_per_device} of {m_total} samples"
        )
    rng = np.random.default_rng(seed)
    props = rng.dirichlet(np.full(n_devices, beta))
    raw = props * m_total
    sizes = np.floor(raw).astype(int)
    short = m_total - sizes.sum()
    sizes[np.argsort(raw - sizes)[::-1][:short]] += 1
    while (sizes < min_per_device).any():
        sizes[np.argmax(sizes)] -= 1
        sizes[np.argmin(sizes)] += 1
    return sizes


def _wrap_padded(features, labels, per_dev_idx, sizes) -> DeviceData:
    """Each device's indices wrap-padded to the largest shard; the true
    counts ride in ``n_samples``."""
    m_max = int(sizes.max())
    idx = np.stack([np.resize(i, m_max) for i in per_dev_idx])
    return _device_data(features[idx], labels[idx], n_samples=sizes)


def partition_dirichlet_mixed(
    features, labels, n_devices: int, beta: float = 0.5, beta_size: float = 0.5,
    min_per_device: int = 1, seed: int = 0,
) -> DeviceData:
    """Label skew × size skew: Dir(β) class proportions over
    :func:`dirichlet_sizes`(β_size) shard sizes, wrap-padded."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    sizes = dirichlet_sizes(labels.shape[0], n_devices, beta=beta_size,
                            min_per_device=min_per_device, seed=seed)
    rng = np.random.default_rng(seed + 1)
    return _wrap_padded(features, labels, _apportion_by_label(labels, sizes, beta, rng),
                        sizes)


def partition_dirichlet_sized(
    features, labels, n_devices: int, beta: float = 0.5, min_per_device: int = 1,
    seed: int = 0,
) -> DeviceData:
    """Dirichlet(β) shard sizes over a global random permutation (IID
    content), wrap-padded."""
    features = np.asarray(features)
    labels = np.asarray(labels)
    m_total = labels.shape[0]
    sizes = dirichlet_sizes(m_total, n_devices, beta=beta,
                            min_per_device=min_per_device, seed=seed)
    perm = np.random.default_rng(seed + 1).permutation(m_total)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return _wrap_padded(features, labels,
                        [perm[bounds[d]:bounds[d + 1]] for d in range(n_devices)], sizes)

"""Client data partitioners (Section 5.3.1 / Appendix H.1; port of
``repro.data.partition``, numpy only).

Each partitioner is registered in the port's ``PARTITIONS`` registry
(:mod:`repro_torch.scenario.registry`), so data layouts are selectable by
name (``PARTITIONS.get("dirichlet")``), and new ones plug in with
``@partition("name")``.
"""
from __future__ import annotations

import numpy as np

from ..scenario.registry import partition


@partition("iid")
def iid_partition(y: np.ndarray, n_clients: int,
                  seed: int = 0) -> list[np.ndarray]:
    """Uniform shuffle-and-split: identical class mix per client."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    return [np.sort(part) for part in np.array_split(idx, n_clients)]


@partition("dirichlet")
def dirichlet_partition(y: np.ndarray, n_clients: int, alpha: float = 0.2,
                        seed: int = 0, min_size: int = 2) -> list[np.ndarray]:
    """Label-skew partition: per class k, client shares ~ Dir_n(alpha)
    (Yurochkin et al. / Li et al., as used in Section 5.3.1)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    while True:
        buckets: list[list[int]] = [[] for _ in range(n_clients)]
        for k in classes:
            idx_k = np.flatnonzero(y == k)
            rng.shuffle(idx_k)
            q = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(q)[:-1] * len(idx_k)).astype(int)
            for j, part in enumerate(np.split(idx_k, cuts)):
                buckets[j].extend(part.tolist())
        if min(len(b) for b in buckets) >= min_size:
            return [np.sort(np.asarray(b)) for b in buckets]


@partition("pathological")
def pathological_partition(y: np.ndarray, n_clients: int,
                           classes_per_client: int = 3,
                           seed: int = 0) -> list[np.ndarray]:
    """Extreme label skew: each client sees only ``classes_per_client``
    labels (Appendix H.1 'Highly Heterogeneous')."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    assignment = [rng.choice(classes, size=classes_per_client, replace=False)
                  for _ in range(n_clients)]
    # round-robin samples of each class over the clients that own it
    owners: dict[int, list[int]] = {int(k): [] for k in classes}
    for j, ks in enumerate(assignment):
        for k in ks:
            owners[int(k)].append(j)
    for k in classes:  # ensure every class has at least one owner
        if not owners[int(k)]:
            owners[int(k)].append(int(rng.integers(n_clients)))
    buckets: list[list[int]] = [[] for _ in range(n_clients)]
    for k in classes:
        idx_k = np.flatnonzero(y == k)
        rng.shuffle(idx_k)
        own = owners[int(k)]
        for t, i in enumerate(idx_k):
            buckets[own[t % len(own)]].append(int(i))
    return [np.sort(np.asarray(b)) for b in buckets]

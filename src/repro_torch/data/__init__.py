"""repro_torch.data — the offline datasets and client partitioners (port of
``repro.data``; numpy only, bit for bit the JAX package's arrays).  The
token dataset of the LM scaffold is not ported yet."""
from .emnist import emnist_cache_path, load_emnist
from .partition import (dirichlet_partition, iid_partition,
                        pathological_partition)
from .synthetic import (ImageDataset, make_synthetic_image_dataset,
                        train_test_split)

# dataset builders by name: (num_classes, samples_per_class, seed)
# -> ImageDataset, registered beside the partitioners
DATASETS = {
    "synthetic": lambda num_classes, samples_per_class, seed:
        make_synthetic_image_dataset(num_classes=num_classes,
                                     samples_per_class=samples_per_class,
                                     seed=seed),
    "emnist": lambda num_classes, samples_per_class, seed:
        load_emnist(num_classes=num_classes,
                    samples_per_class=samples_per_class, seed=seed),
}


def get_dataset(name: str, *, num_classes: int, samples_per_class: int,
                seed: int):
    """Build a registered dataset; unknown names list the options."""
    builder = DATASETS.get(name)
    if builder is None:
        raise ValueError(f"unknown dataset: {name!r}; registered datasets: "
                         f"{sorted(DATASETS)}")
    return builder(num_classes, samples_per_class, seed)


__all__ = [
    "ImageDataset", "make_synthetic_image_dataset", "train_test_split",
    "load_emnist", "emnist_cache_path", "DATASETS", "get_dataset",
    "dirichlet_partition", "iid_partition", "pathological_partition",
]

"""Package data (the frozen Butterfly200 taxonomy, a copy of the JAX
package's ``data/butterfly200_taxonomy.json``), the ETHEC records
(``records.py``), the index samplers (``sampling.py``), the host input
pipeline (``pipeline.py``, with the C++ JPEG loader of
``native_loader.py``), the CIFAR / FashionMNIST workloads
(``workloads.py``) and the offline tools: image crops (``preprocess.py``)
and the database build (``build_db.py``)."""

from .pipeline import ImagePipeline
from .records import (
    EncodedDataset,
    encode_records,
    filter_to_labelmap,
    image_relpath,
    leaf_name,
    load_ethec_json,
    multihot_from_level_labels,
    save_ethec_json,
    stratified_split,
)
from .sampling import WeightedResampler, shuffled_order
from .workloads import (
    ArrayDataset,
    cifar10_labelmap,
    cifar100_labelmap,
    fmnist_labelmap,
    load_cifar10,
    load_cifar100,
    load_fmnist,
    stratified_index_split,
    synthetic_array_dataset,
)

__all__ = [
    "ArrayDataset",
    "EncodedDataset",
    "ImagePipeline",
    "WeightedResampler",
    "cifar10_labelmap",
    "cifar100_labelmap",
    "encode_records",
    "filter_to_labelmap",
    "fmnist_labelmap",
    "image_relpath",
    "leaf_name",
    "load_cifar10",
    "load_cifar100",
    "load_ethec_json",
    "load_fmnist",
    "multihot_from_level_labels",
    "save_ethec_json",
    "shuffled_order",
    "stratified_index_split",
    "stratified_split",
    "synthetic_array_dataset",
]

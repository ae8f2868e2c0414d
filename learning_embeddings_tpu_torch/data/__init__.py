"""Package data (the frozen Butterfly200 taxonomy, a copy of the JAX
package's ``data/butterfly200_taxonomy.json``), the ETHEC records
(``records.py``), the index samplers (``sampling.py``) and the host input
pipeline (``pipeline.py``)."""

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

__all__ = [
    "EncodedDataset",
    "ImagePipeline",
    "WeightedResampler",
    "encode_records",
    "filter_to_labelmap",
    "image_relpath",
    "leaf_name",
    "load_ethec_json",
    "multihot_from_level_labels",
    "save_ethec_json",
    "shuffled_order",
    "stratified_split",
]

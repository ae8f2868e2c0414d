from .labelmap import (
    LabelMap,
    build_labelmap,
    butterfly200_labelmap,
    labelmap_from_records,
    toy_labelmap,
)

__all__ = [
    "LabelMap",
    "build_labelmap",
    "butterfly200_labelmap",
    "labelmap_from_records",
    "toy_labelmap",
]

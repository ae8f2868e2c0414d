"""The port's copy of hierarchy/labelmap.py equals the JAX package's."""

import numpy as np
import pytest

from learning_embeddings_tpu import hierarchy as jax_h
from learning_embeddings_tpu_torch import hierarchy as port_h

RECORDS = [
    {"family": f"F{i % 2}", "subfamily": f"S{i % 4}", "genus": f"G{i % 8}",
     "specific_epithet": f"e{i % 3}"}
    for i in range(24)
]

CASES = {
    "toy_3_3": lambda h: h.toy_labelmap(3, 3),
    "toy_2_4": lambda h: h.toy_labelmap(2, 4),
    "butterfly200": lambda h: h.butterfly200_labelmap(),
    "from_records": lambda h: h.labelmap_from_records(RECORDS),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_labelmap_equals_jax(case):
    ours, ref = CASES[case](port_h), CASES[case](jax_h)
    assert ours.levels == ref.levels
    assert ours.level_names == ref.level_names
    assert ours.ix_to_name == ref.ix_to_name
    np.testing.assert_array_equal(ours.parent_ix, ref.parent_ix)
    assert len(ours.child_masks) == len(ref.child_masks)
    for a, b in zip(ours.child_masks, ref.child_masks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.leaf_paths(), ref.leaf_paths())
    np.testing.assert_array_equal(ours.level_start, ref.level_start)


def test_butterfly200_ships_with_the_port():
    assert port_h.butterfly200_labelmap().levels == (5, 23, 116, 200)

"""The column-parallel head on a (2, 2) mesh of 4 gloo ranks (an even 14
classes: each 'model' rank computes 7 of the logits, gathered), against
the JAX package's meshed step and the port's one-device step, with the
helpers and tolerances of ``test_torch_mesh_classifier.py``; the
checkpoint payload holds the head whole, and restoring it gives the
blocks back."""

import numpy as np

from learning_embeddings_tpu_torch.parallel.launch import run_ranks

from test_torch_mesh_classifier import _cases, _check

SPECS = [("multi_level_ce", (2, 3)), ("masked_ce", (2, 3))]


def test_column_parallel_head_matches_jax_and_one_device(tmp_path):
    jax_out, one, cases = _cases(2, 2, SPECS)
    for kw in cases:
        kw["checkpoint_roundtrip"] = True
    res = run_ranks("learning_embeddings_tpu_torch.parallel.programs:"
                    "classifier_cases", 4,
                    dict(n_data=2, n_model=2, cases=cases),
                    workdir=str(tmp_path), threads=1, timeout_s=240)
    _check(res, jax_out, one, SPECS, tp_tol=1e-4)
    for r in res:
        for case in r:
            assert case["counts"]["collective_gather_cols"] == 1
            assert "collective_reduce_from_group" not in case["counts"]
            # whole in the payload; the restored blocks gather to it again
            np.testing.assert_array_equal(
                case["payload_params"]["fc.weight"],
                case["state_dict"]["fc.weight"])
            assert case["payload_params"]["fc.weight"].shape == (14, 512)

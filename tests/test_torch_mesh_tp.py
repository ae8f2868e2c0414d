"""The port's tensor-parallel classifier head on a (2, 2) mesh of 4 gloo
ranks against the JAX package's meshed step on (2, 2) and the port's
one-device step (float32 ResNet-18@32, batch 8, one Adam step from the
JAX trainer's initial weights; helpers and tolerances of
``test_torch_mesh_classifier.py``, the TP head's loss within 1e-4 as JAX
``tests/test_classifier.py:255-287``): every criterion with the toy
taxonomy's odd 39 classes (27 leaves), where the head is row-parallel on
its 512 fan-in and the partial logits are summed over 'model'. The
column-parallel head is ``test_torch_mesh_tp_column.py``'s."""

from learning_embeddings_tpu_torch.parallel.launch import run_ranks

from test_torch_mesh_classifier import CRITERIA, _cases, _check

SPECS = [(c, (3, 3)) for c in CRITERIA]


def test_tp_step_all_criteria_match_jax_and_one_device(tmp_path):
    jax_out, one, cases = _cases(2, 2, SPECS)
    res = run_ranks("learning_embeddings_tpu_torch.parallel.programs:"
                    "classifier_cases", 4,
                    dict(n_data=2, n_model=2, cases=cases),
                    workdir=str(tmp_path), threads=1, timeout_s=240)
    _check(res, jax_out, one, SPECS, tp_tol=1e-4)
    for r in res:
        for case in r:
            c = case["counts"]
            # the partial logits summed over 'model', the trunk's feature
            # gradient summed back
            assert c["collective_reduce_from_group"] == 1
            assert c["collective_copy_to_group_grad"] == 1
            assert c["collective_bn_stats"] == c["collective_bn_corr"] == 20

"""The reference's pieces against the measured package on the CPU: the
frozen sampler draws what the program's draws, and the taxonomy and the
joint graph are the program's. (The reference's training and eval steps
against the program's are held in ``test_bench_runs.py``.)"""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib import inputs  # noqa: E402
from benchmark.reference import sampler  # noqa: E402
from benchmark.reference.taxonomy import (Taxonomy,  # noqa: E402
                                          observed_closure)
from learning_embeddings_tpu_torch.hierarchy import \
    butterfly200_labelmap  # noqa: E402
from learning_embeddings_tpu_torch.losses import \
    joint_sampling  # noqa: E402


@pytest.fixture(scope="module")
def graphs():
    tax, lm = Taxonomy(), butterfly200_labelmap()
    paths = tax.leaf_paths[np.random.RandomState(3).randint(0, 200, 600)]
    glob = paths + tax.level_start[None, :]
    program, edges = joint_sampling.build_joint_graph(lm, paths)
    ref = sampler.Graph(observed_closure(glob, tax.n_classes), glob,
                        tax.level_start, tax.level_stop)
    return tax, lm, program, edges, ref


def test_taxonomy_is_the_programs(graphs):
    tax, lm, *_ = graphs
    assert tax.levels == tuple(lm.levels)
    np.testing.assert_array_equal(tax.level_start, lm.level_start)
    np.testing.assert_array_equal(tax.parent, lm.parent_ix)
    np.testing.assert_array_equal(tax.leaf_paths, lm.leaf_paths())


def test_joint_graph_is_the_programs(graphs):
    tax, _, program, edges, ref = graphs
    np.testing.assert_array_equal(ref.label_closure, program.label_closure)
    np.testing.assert_array_equal(ref.image_paths_global,
                                  program.image_paths_global)
    ours = inputs.joint_edges(ref.image_paths_global, tax.n_classes)
    assert sorted(map(tuple, ours)) == sorted(map(tuple, edges))


def test_frozen_sampler_draws_the_programs_negatives(graphs):
    tax, _, program, edges, ref = graphs
    rng = np.random.RandomState(11)
    for _ in range(5):
        e = edges[rng.randint(0, len(edges), 16)]
        a, b = np.random.RandomState(7), np.random.RandomState(7)
        got = joint_sampling.sample_joint_negatives_np(
            program, 5, a, e[:, 0], e[:, 1], pick_per_level=True)
        want = sampler.sample_joint_negatives_np(ref, 5, b, e[:, 0], e[:, 1])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

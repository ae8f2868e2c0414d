"""host_prep_ms.joint: the mean host time of one
``JointCNNTrainer.prepare_batch`` call (negative sampling, the
unique-image gather and the copies to the card) in the window's untraced
part, timed by the host clock around the instance's bound method. Layer:
trainer host path. Moves joint_edges_per_s."""


def read(window, info):
    prep = info.get("host", {}).get("prep_s")
    if not prep:
        return None
    return 1e3 * sum(prep) / len(prep)

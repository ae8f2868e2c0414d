"""Joint hyperbolic entailment-cone CLI, the paper's method: the port
of ``learning_embeddings_tpu/cli/oe_h.py``. The fc7 path reads the
features that ``cli/image_emb.py`` wrote (``<data_dir>/embeddings`` by
default):

    python -m learning_embeddings_tpu_torch.cli.image_emb \\
        --data_dir splits --image_dir images --output_dir feats
    python -m learning_embeddings_tpu_torch.cli.oe_h \\
        --data_dir splits --image_dir images --features_dir feats \\
        --set_mode train --experiment_dir exp --experiment_name joint \\
        --n_epochs 2

and ``--use_CNN`` trains the image tower on the pixels instead.
"""

from ._joint_main import joint_main


def main(args=None):
    return joint_main(args, default_energy="hyp_cones_loss")


if __name__ == "__main__":
    main()

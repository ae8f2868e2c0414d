"""Joint hyperbolic entailment-cone CLI, the paper's method: the port
of ``learning_embeddings_tpu/cli/oe_h.py`` (``--use_CNN`` only).

    python -m learning_embeddings_tpu_torch.cli.oe_h --use_CNN \\
        --data_dir splits --image_dir images --set_mode train \\
        --experiment_dir exp --experiment_name joint --n_epochs 2
"""

from ._joint_main import joint_main


def main(args=None):
    return joint_main(args, default_energy="hyp_cones_loss")


if __name__ == "__main__":
    main()

"""Joint Euclidean order-embedding CLI: the port of
``learning_embeddings_tpu/cli/oe.py`` (the fc7 path, and ``--use_CNN``)."""

from ._joint_main import joint_main


def main(args=None):
    return joint_main(args, default_energy="order_emb_loss")


if __name__ == "__main__":
    main()

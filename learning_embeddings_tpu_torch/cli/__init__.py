"""Command-line entry points: the label-only embeddings (``order_embeddings``,
``order_embeddings_h``, ``embed_toy``), their re-scoring
(``validate_embedding``) and the ``--use_CNN`` joint embeddings (``oe``,
``oe_h``), the classifiers (``ethec_experiments``, ``fashion_mnist``,
``cifar``), the fc7 features (``image_emb``), inference and reports
(``inference``, ``post_process``, ``convert_tblog``). Run one as
``python -m learning_embeddings_tpu_torch.cli.<name>``; each takes the JAX
package's flags, plus ``--device`` (default ``cuda``) where it runs a
model (the two report CLIs only read files)."""

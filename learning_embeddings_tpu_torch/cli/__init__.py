"""Command-line entry points: the label-only embeddings (``order_embeddings``,
``order_embeddings_h``, ``embed_toy``), their re-scoring
(``validate_embedding``) and the ``--use_CNN`` joint embeddings (``oe``,
``oe_h``). Run one as ``python -m learning_embeddings_tpu_torch.cli.<name>``;
each takes the JAX package's flags plus ``--device`` (default ``cuda``)."""

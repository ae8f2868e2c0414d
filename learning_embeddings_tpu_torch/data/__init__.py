"""Package data (the frozen Butterfly200 taxonomy, a copy of the JAX
package's ``data/butterfly200_taxonomy.json``) and the host input pipeline
(``pipeline.py``)."""

"""learning_embeddings_tpu_torch — the PyTorch / CUDA port of
``learning_embeddings_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference: every module here keeps the
path and names of its JAX counterpart and is tested against it on the CPU
(``tests/test_torch_*.py``). Every Pallas kernel of the JAX package becomes
a kernel written by hand for the card (``ops/bn_triton.py``); its plain
PyTorch version runs only for tensors that lie on the CPU.

This package imports ``torch`` and numpy, never JAX or the JAX package,
and imports ``triton`` only inside the CUDA path.

Subpackages
-----------
hierarchy  taxonomy core: labelmaps (a copy of the JAX package's)
ops        on-device image scaling, train-mode BatchNorm + its kernels
models     ResNet family (torchvision names), hierarchical heads,
           weight carry-over from the JAX package's trees
losses     hierarchical classification losses
train      classifier trainer
entry      flagship forward and taxonomy (twin of __graft_entry__)
"""

__version__ = "0.1.0"

"""learning_embeddings_tpu_torch — the PyTorch / CUDA port of
``learning_embeddings_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference: every module here keeps the
path and names of its JAX counterpart and is tested against it on the CPU
(``tests/test_torch_*.py``). Every Pallas kernel of the JAX package becomes
a kernel written by hand for the card (``ops/bn_triton.py`` in Triton,
``csrc/pairwise_order.cu`` in CUDA C++); its plain PyTorch version runs
only for tensors that lie on the CPU.

This package imports ``torch`` and numpy, never JAX or the JAX package,
and imports ``triton``, and builds its CUDA library with nvcc, only
inside the CUDA path.

Subpackages
-----------
hierarchy  taxonomy core: labelmaps, graphs and edge splits (copies of
           the JAX package's)
ops        on-device image scaling, train-mode BatchNorm + its kernels,
           the all-pairs order energy + its kernel
csrc       CUDA C++ kernel sources (built with nvcc on first use)
geometry   entailment energies, all-pairs energies, Poincaré-ball maps
optim      Riemannian optimizers on the Poincaré ball (torch.optim)
models     ResNet family (torchvision names), hierarchical heads, the
           joint trainers' label table, fc7 projectors and image tower,
           weight carry-over from the JAX package's trees
losses     classification losses, margin losses, the joint (host and
           device) and label-only (device) negative samplers
eval       threshold sweep, joint ranking metrics, reconstruction
data       package data, host prefetch
train      classifier trainer, fc7 and --use_CNN joint trainers,
           label-only embedding trainer, runners
viz        embedding and 2-d head plots (matplotlib, imported lazily)
entry      flagship forward and taxonomy (twin of __graft_entry__)
"""

__version__ = "0.1.0"

"""taxtk_torch: the PyTorch and CUDA port of taxtk for NVIDIA Hopper GPUs.

It imports nothing of JAX and nothing of the taxtk package; taxtk stays
the reference it is tested against.  It runs taxator (nucleotide and
protein), the binner, the binning pipeline and the companion CLIs
(python -m taxtk_torch.cli.<name>), with hand-written CUDA kernels
(taxtk_torch/csrc) built with nvcc at first use.
"""

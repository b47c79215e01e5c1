"""taxtk_torch: the PyTorch and CUDA port of taxtk for NVIDIA Hopper GPUs.

It imports nothing of JAX and nothing of the taxtk package; taxtk stays
the reference it is tested against.  It runs taxator (nucleotide and
protein), the binner, the binning pipeline and the companion CLIs
(python -m taxtk_torch.cli.<name>), with hand-written CUDA kernels
(taxtk_torch/csrc) built with nvcc at first use.
"""

# version string reported by CLI tools; tracks reference behaviour parity
# (reference: core/src/constants.hh:46 program_version = "1.5.0")
REFERENCE_COMPAT_VERSION = "1.5.0"

"""Row 4, the v5 BLOSUM62 wavefront kernel (csrc/protein_wavefront.cu):
one launch a call of ops.protein_cuda.protein_inputs (the SWAR kernel is
off unless TAXTK_PROTEIN_SWAR=1)."""

import numpy as np

from taxbench.bounds import protein_bound_s

MODULE = "taxtk_torch.ops.protein_cuda"
ENTRY = "protein_inputs"
KERNEL = "protein_wavefront_kernel"


def record(a_codes, b_codes, a_len, b_len, *rest, **kw):
    return dict(a_len=np.array(a_len), b_len=np.array(b_len),
                M=int(np.shape(a_codes)[1]), N=int(np.shape(b_codes)[1]))


def bound_s(call, card, launch):
    return protein_bound_s(call["a_len"], call["b_len"], call["M"],
                           call["N"], card["int_rate"])

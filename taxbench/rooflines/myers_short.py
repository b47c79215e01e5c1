"""Kernel 1, the short-pair Myers kernel (csrc/myers_short.cu): one launch
a call of ops.myers_cuda.short_inputs; the wire's bits are the kernel's
third template argument (<K, W, BITS>)."""

import numpy as np

from taxbench.bounds import myers_bound_s, template_args

MODULE = "taxtk_torch.ops.myers_cuda"
ENTRY = "short_inputs"
KERNEL = "myers_short_kernel"


def record(a_codes, b_codes, a_len, b_len, *rest, **kw):
    return dict(a_len=np.array(a_len), b_len=np.array(b_len))


def bound_s(call, card, launch):
    return myers_bound_s(call["a_len"], call["b_len"],
                         template_args(launch)[2], card["int_rate"])

"""Kernel 2, the block-systolic Myers kernel (csrc/myers_systolic.cu): one
launch a call of ops.myers_systolic.systolic_inputs; the wire's bits are
the kernel's first template argument (<BITS, KW>)."""

import numpy as np

from taxbench.bounds import myers_bound_s, template_args

MODULE = "taxtk_torch.ops.myers_systolic"
ENTRY = "systolic_inputs"
KERNEL = "myers_systolic_kernel"


def record(a_codes, b_codes, a_len, b_len, *rest, **kw):
    return dict(a_len=np.array(a_len), b_len=np.array(b_len))


def bound_s(call, card, launch):
    return myers_bound_s(call["a_len"], call["b_len"],
                         template_args(launch)[0], card["int_rate"])

"""Kernel 2, the block-systolic Myers kernel (csrc/myers_systolic.cu): one
launch a call of ops.myers_systolic.systolic_inputs."""

import numpy as np

from taxbench.bounds import myers_bound_s

MODULE = "taxtk_torch.ops.myers_systolic"
ENTRY = "systolic_inputs"
KERNEL = "myers_systolic_kernel"


def record(a_codes, b_codes, a_len, b_len, *rest, **kw):
    bits = 2 if (int(np.max(a_codes, initial=0)) < 4
                 and int(np.max(b_codes, initial=0)) < 4) else 4
    return dict(a_len=np.array(a_len), b_len=np.array(b_len), bits=bits)


def bound_s(call, card):
    return myers_bound_s(call["a_len"], call["b_len"], call["bits"],
                         card["int_rate"])

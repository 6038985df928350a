"""Hand-written CUDA kernels (`csrc/`) with their plain PyTorch versions.

`cmp_eval.eval_coeff0_gadget` (gadget-mode Eval) and
`ntt.negacyclic_mul` (fused negacyclic multiply) launch their kernels on
CUDA tensors and run their plain versions on CPU tensors.  `_build`
compiles the sources at first use and counts launches.
"""

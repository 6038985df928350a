"""Hand-written CUDA kernels (`csrc/`) with their plain PyTorch versions.

`cmp_eval.eval_coeff0_gadget` and `cmp_eval.eval_coeff0_paper` (the
Eval in both modes), `ntt.negacyclic_mul` (fused negacyclic multiply)
and `ntt.ntt_br` (the bit-reversed-order NTT, both directions) launch
their kernels on CUDA tensors and run their plain versions on CPU
tensors.  `_build` compiles the sources at first use and counts
launches.
"""

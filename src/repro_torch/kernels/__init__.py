"""Hand-written CUDA kernels (`csrc/`) with their plain PyTorch versions.

`cmp_eval.eval_coeff0_gadget` and `cmp_eval.eval_coeff0_paper` (the
Eval in both modes), `ntt.negacyclic_mul` and `ntt.negacyclic_mul_ntt`
(the fused negacyclic multiply, the second against a key already in the
NTT domain) and `ntt.ntt_br` (the bit-reversed-order NTT, both directions) launch
their kernels on CUDA tensors and run their plain versions on CPU
tensors.  `_build` compiles the sources at first use and counts
launches.
"""

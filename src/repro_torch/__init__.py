"""HADES encrypted query engine on PyTorch, with hand-written CUDA kernels.

The port of `repro` (JAX/Pallas) for an NVIDIA H100.  It mirrors the
reference's layout — `core/` (ring, keys, encryption, compare), `kernels/`
(CUDA kernels beside their plain PyTorch versions), `obs/` (spans,
metrics, launch signatures, exporters), `data/`, `db/` (tables, executor,
index, QueryServer, joins, logical shards, the always-on ServeLoop),
`baselines/` (Paillier, HOPE, POPE), and the dense GQA family of the LM
substrate (`configs/`, `models/`, `launch/`) — keeps its int64 [..., K, n]
residue layout, and imports neither JAX nor `repro`.

Entry points run on CUDA unless the caller passes `device="cpu"`; on a
CUDA tensor every kernel-backed function launches its kernel or raises.
"""

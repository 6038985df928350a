"""LM substrate of the port: every model family of the reference
(config, layers, transformer, MoE, RG-LRU, xLSTM, serving caches) on
PyTorch."""

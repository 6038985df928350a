"""LM substrate of the port: the dense GQA family (config, layers,
transformer, serving caches) on PyTorch."""

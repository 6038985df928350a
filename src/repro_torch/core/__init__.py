"""HADES core on PyTorch: RNS ring, keys, encryption, comparison."""

"""Training substrate of the port: optimizer, data pipeline,
checkpointing, gradient compression and the train step, in plain
PyTorch (autograd gives the backward pass; no fused optimizer)."""

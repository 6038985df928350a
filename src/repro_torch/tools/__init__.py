"""Checks that run the port end to end (`python -m repro_torch.tools.*`)."""

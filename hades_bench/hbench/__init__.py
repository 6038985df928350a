"""The harness of the port's benchmark (see `hades_bench/run.py`)."""

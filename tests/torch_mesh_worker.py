"""One rank of the two-rank gloo mesh of tests/test_torch_parallel.py.

Kept apart from the test module (which imports JAX) so that the ranks
`torch.multiprocessing.spawn` starts import only the port.  Each rank
joins a gloo group through a `file://` store, builds a (data=1, model=2)
DeviceMesh, places the parameters of a reduced config by the sharding
rules and runs the forward (and the loss) under the mesh; rank 0 writes
the largest differences from the plain forward to `out`.
"""
import json

import torch

ARCHES = ("smollm-360m", "deepseek-moe-16b")


def run(rank: int, store: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.constrain import (P, placements, set_batch_axes,
                                                use_mesh)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        mesh = DeviceMesh("cpu", [[0, 1]], mesh_dim_names=("data", "model"))
        set_batch_axes(None)
        ep_calls = []
        ep = MOE._moe_apply_ep

        def counted(*a, **k):
            ep_calls.append(1)
            return ep(*a, **k)
        MOE._moe_apply_ep = counted
        result = {}
        for arch in ARCHES:
            cfg = configs.get_reduced(arch)
            params = T.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
            tokens = torch.randint(0, cfg.vocab_size, (2, 24),
                                   generator=torch.Generator().manual_seed(1))
            batch = {"tokens": tokens}
            plain = T.forward(cfg, params, batch)
            plain_loss = T.loss_fn(cfg, params, batch)
            specs = SH.sanitize_specs(mesh, SH.param_specs(params), params)
            placed = SH.distribute(mesh, params, specs)
            dbatch = {"tokens": distribute_tensor(
                tokens, mesh, placements(mesh, P(("data",), None)))}
            with use_mesh(mesh):
                logits = T.forward(cfg, placed, dbatch).full_tensor()
                loss = T.loss_fn(cfg, placed, dbatch).full_tensor()
            result[arch] = {
                "forward": float((logits - plain).abs().max()),
                "loss": float((loss - plain_loss).abs()),
                "scale": float(plain.abs().max())}
        result["ep_calls"] = len(ep_calls)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()

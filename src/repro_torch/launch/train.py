"""Training driver (end to end; on the card unless `--device cpu`).

The port of `repro.launch.train`.  Fault tolerance:
  * atomic checkpoints every --ckpt-every steps (+ async writer; a
    failure waits for a checkpoint in flight to commit)
  * --resume auto: restart from the latest complete checkpoint; the
    counter-based data pipeline replays the exact batch sequence
  * watchdog: per-step wall-time EMA; a step exceeding
    --straggler-factor x EMA is logged as a straggler event
  * --fail-at-step N: crash injection for the restart tests
As the reference, it trains under the host mesh (`launch.mesh.
make_host_mesh`) over the default process group; where none is set up it
makes a one-rank group (NCCL on the card, gloo on the host), so one card
is a (1, 1) mesh, on which every anchor is the identity.  The result
(printed as the last line) adds each step's loss and wall to the
reference's first/last loss and step count.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --variant train_100m --steps 200 --batch 8 --seq 256 [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import time

import torch

from repro_torch import configs
from repro_torch.core.ring import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.constrain import use_mesh
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import data as DATA
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_lib as TL


def get_cfg(arch: str, variant: str | None) -> ModelConfig:
    if variant:
        mod = importlib.import_module(
            f"repro_torch.configs.{configs.canon(arch)}")
        return getattr(mod, variant)()
    return configs.get_reduced(arch)


@contextlib.contextmanager
def host_group(device: torch.device):
    """The default process group, or a one-rank group for the block
    (NCCL on a CUDA device, gloo on the host; an in-process store)."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--variant", default=None,
                    help="config factory name, e.g. train_100m / reduced")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default=None, choices=[None, "auto"])
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_cfg(args.arch, args.variant)
    tcfg = TL.TrainConfig(
        opt=OPT.OptimizerConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                                total_steps=args.steps),
        microbatches=args.microbatches,
        compress_grads=args.compress_grads)
    dcfg = DATA.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=args.seed)

    with host_group(device), use_mesh(make_host_mesh()):
        return _train(args, cfg, tcfg, dcfg, device)


def _train(args, cfg: ModelConfig, tcfg: TL.TrainConfig,
           dcfg: DATA.DataConfig, device: torch.device) -> dict:
    state = TL.init_state(cfg, tcfg, torch.Generator().manual_seed(
        args.seed), device=device)
    start_step = 0
    if args.resume == "auto" and args.ckpt_dir:
        CKPT.clean_incomplete(args.ckpt_dir)
        last = CKPT.latest_step(args.ckpt_dir)
        if last is not None:
            state = CKPT.restore(args.ckpt_dir, last, state)
            start_step = last
            print(f"[resume] restored step {last}")

    step_fn = TL.make_train_step(cfg, tcfg)
    losses, step_s = [], []
    ema = None
    writer = None
    try:
        for i, batch in enumerate(DATA.batches(dcfg,
                                               start_index=start_step)):
            step = start_step + i
            if step >= args.steps:
                break
            if args.fail_at_step is not None and step == args.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.time()
            state, metrics = step_fn(state, {k: v.to(device)
                                             for k, v in batch.items()})
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if (ema is not None and dt > args.straggler_factor * ema
                    and step > 3):
                print(f"[straggler] step {step} took {dt:.2f}s "
                      f"(ema {ema:.2f}s) — would trigger mitigation")
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            losses.append(loss)
            step_s.append(dt)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt:.2f}s")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                if writer is not None:
                    writer.join()
                writer = CKPT.save(args.ckpt_dir, step + 1, state,
                                   async_=True)
    finally:
        # an in-flight checkpoint commits before a failure propagates
        if writer is not None:
            writer.join()
    if args.ckpt_dir:
        CKPT.save(args.ckpt_dir, args.steps, state)
        CKPT.keep_last(args.ckpt_dir, 3)
    result = {"first_loss": losses[0] if losses else None,
              "last_loss": losses[-1] if losses else None,
              "steps_run": len(losses), "start_step": start_step,
              "device": str(device), "losses": losses, "step_s": step_s}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
